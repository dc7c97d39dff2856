"""Quality metrics for sliding-DFT round trips (counterpart of
``sdft_tpu.metrics``).

The reference's quantitative quality metric is the round-trip SNR in dB
after removing the algorithmic synthesis delay
(python/examples/latency.py:50-57):

    SNR = 10 * log10( mean(x^2) / mean((y - x)^2) )

where ``y`` is the synthesized signal aligned to the input ``x`` by dropping
its first ``(m - 1) * latency`` samples.  Inputs may be numpy arrays or
tensors on any device (copied to the host first).
"""

from __future__ import annotations

import numpy as np

from .cplx import to_numpy
from .plan import Plan

__all__ = ["snr_db", "roundtrip_snr_db", "align_roundtrip"]


def snr_db(x, y) -> float:
    """Signal-to-noise ratio of ``y`` against the aligned, equal-length
    reference ``x``, in dB."""
    x = to_numpy(x).astype(np.float64)
    y = to_numpy(y).astype(np.float64)
    if x.shape != y.shape:
        raise ValueError(f"shape mismatch: {x.shape} vs {y.shape}")
    err = np.mean(np.square(y - x))
    if err == 0:
        return float("inf")
    return float(10.0 * np.log10(np.mean(np.square(x)) / err))


def align_roundtrip(x, y, delay: int) -> tuple[np.ndarray, np.ndarray]:
    """Trim the pair so ``y[delay:]`` lines up with ``x[:-delay]``
    (python/examples/latency.py:52-54).  Works on (..., n) batches."""
    x = to_numpy(x)
    y = to_numpy(y)
    n = x.shape[-1]
    if not 0 <= delay < n:
        raise ValueError(f"delay {delay} out of range for length {n}")
    if delay == 0:
        return x, y
    return x[..., : n - delay], y[..., delay:]


def roundtrip_snr_db(x, y, plan: Plan | None = None, *,
                     delay: int | None = None) -> float:
    """Round-trip SNR with the synthesis delay removed: ``plan.synthesis_delay``,
    or ``delay`` when given."""
    if delay is None:
        if plan is None:
            raise ValueError("pass either plan or delay")
        delay = plan.synthesis_delay
    xa, ya = align_roundtrip(x, y, delay)
    return snr_db(xa, ya)
