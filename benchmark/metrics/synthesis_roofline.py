"""The synthesis's share of its roofline, in %: its least time (every
packed float32 spectrum read once and every float32 sample written once,
C * M * (8m + 4) bytes, over the H100 SXM's 3.35 TB/s: ``cost.bound``)
over the device time per K1 launch of every kernel and device copy other
than K1, the carry kernel and NCCL's.  In the transform cell that is the
synthesis of ``ops.synthesis.isdft_block`` (the real plane's copy, the
product, the weight), the transform's own kernels and the prologue
graph's copies; it reads the same work whatever implements it.  One K1
launch covers a block's channels on a card."""

from .. import cost
from . import is_k1, is_nccl

#: bytes of one packed float32 bin read, and of one float32 sample written
BIN_BYTES, Y_BYTES = 8, 4


def is_carry(name: str) -> bool:
    """The carry kernel, ``sdft_tpu_torch/kernels/csrc/carry.cu``'s ``carry_front``."""
    return "carry_front" in name


def least_ms(config: dict, samples: int) -> float:
    """The synthesis's least time (ms) for one block of ``samples`` per channel."""
    C, m = int(config["channels"]), int(config["dftsize"])
    least, _ = cost.bound(C * samples * (BIN_BYTES * m + Y_BYTES))
    return least


def read(run):
    n = len(run.trace.kernels(is_k1))
    rest = run.trace.kernels(lambda k: not (is_k1(k) or is_carry(k) or is_nccl(k)))
    rest += run.trace.copies()
    if not n or not rest:
        return None
    ms = sum(d for _, d in rest) / n / 1e3
    return 100.0 * least_ms(run.cell.config, int(run.cell.traffic["samples_per_card"])) / ms
