"""NCCL's device time per block on this rank, in ms: the kernels of the
carry exchange between time shards (``parallel.sharded``), over K1's
launches (one a block on each card)."""

from . import is_k1, is_nccl


def read(run):
    n = len(run.trace.kernels(is_k1))
    nccl = run.trace.kernels(is_nccl)
    if not n or not nccl:
        return None
    return sum(d for _, d in nccl) / n / 1e3
