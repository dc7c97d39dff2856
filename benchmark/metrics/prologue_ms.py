"""The K1 prologue's device time per block, in ms: every kernel other than
K1 and NCCL's in the traced window (the prologue graph of
``kernels.spectra``: comb, totals GEMM, tile prefix), over K1's launches
(one a block on a card)."""

from . import is_k1, is_nccl


def read(run):
    n = len(run.trace.kernels(is_k1))
    if not n:
        return None
    rest = run.trace.kernels(lambda k: not is_k1(k) and not is_nccl(k))
    return sum(d for _, d in rest) / n / 1e3
