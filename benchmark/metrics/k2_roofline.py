"""K2's share of its roofline, in %: the least time of one launch over
K2's mean device time per launch in the traced window.  A launch is
``sdft_tpu_torch/kernels/csrc/scan.cu``'s ``scan_kernel`` and the
``scan_kernel_rows`` that adds its chunks' partial rows (kernel names
that contain ``scan_kernel``), and covers a block's channels on a card.
Its least time: K1's (the samples and carried state read once and every
spectrum written once, ``cost.analysis_cost``) plus the synthesized
samples written once (4 bytes each), over the H100 SXM's 3.35 TB/s, or
its operations over 67 TFLOP/s of float32 where larger (``cost.bound``)."""

from .. import cost

#: bytes of one synthesized float32 sample
Y_BYTES = 4


def is_k2(name: str) -> bool:
    """Either kernel of a K2 launch."""
    return "scan_kernel" in name


def launches(trace) -> int:
    """K2's launches in the traced window (its first kernel's count)."""
    return len(trace.kernels(lambda n: is_k2(n) and "scan_kernel_rows" not in n))


def least_ms(config: dict, samples: int) -> float:
    """K2's least time (ms) for one launch on ``samples`` per channel."""
    p = config["precision"]
    C = int(config["channels"])
    c = cost.analysis_cost(int(config["dftsize"]), config["window"], p["td"], p["fd"], samples)
    least, _ = cost.bound(C * (c.hbm_bytes + samples * Y_BYTES), f32_flops=C * c.flops)
    return least


def read(run):
    n = launches(run.trace)
    if not n:
        return None
    ms = sum(d for _, d in run.trace.kernels(is_k2)) / n / 1e3
    return 100.0 * least_ms(run.cell.config, int(run.cell.traffic["samples_per_card"])) / ms
