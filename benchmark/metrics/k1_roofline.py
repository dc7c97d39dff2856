"""K1's share of its roofline, in %: the least time of one launch (the
samples and carried state read once and every spectrum written once, over
the H100 SXM's 3.35 TB/s, or its operations over 67 TFLOP/s of float32
where larger: ``cost``) over K1's mean device time per launch in the
traced window.  One launch covers a block's channels on a card."""

from .. import cost
from . import is_k1


def read(run):
    k1 = run.trace.kernels(is_k1)
    if not k1:
        return None
    ms = sum(d for _, d in k1) / len(k1) / 1e3
    cfg = run.cell.config
    p = cfg["precision"]
    C = int(cfg["channels"])
    c = cost.analysis_cost(int(cfg["dftsize"]), cfg["window"], p["td"], p["fd"],
                           int(run.cell.traffic["samples_per_card"]))
    least, _ = cost.bound(C * c.hbm_bytes, f32_flops=C * c.flops)
    return 100.0 * least / ms
