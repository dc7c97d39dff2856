"""The prologue's device time per K2 launch, in ms: every kernel other
than K2's and NCCL's in the traced window, over K2's launches (one a
block on a card).  On the hop = 1 chain that is the ``hop1_chain_body``
graph of ``ops.lti.roundtrip_hopped_chain``: K1's prologue (comb, totals
GEMM, tile prefix) and the refresh; and once a chain the entry's stack
of its blocks and the clone of the state carried out of it."""

from . import is_nccl
from .k2_roofline import is_k2, launches


def read(run):
    n = launches(run.trace)
    if not n:
        return None
    rest = run.trace.kernels(lambda k: not is_k2(k) and not is_nccl(k))
    return sum(d for _, d in rest) / n / 1e3
