"""The yardstick's own count of bytes and operations, and the card's peaks.

A frozen copy of ``analysis_cost``, ``bound`` and the published H100 SXM
peaks of ``sdft_tpu_torch.profiling`` that ``k1_roofline`` reads, as they
stood when the benchmark was defined, kept here so that a change
to the program cannot move the roofline it is measured against
(``tests/test_bench_cost.py`` holds the two equal at the cells' shapes).
Plain arithmetic on sizes: it imports nothing of the program.
"""

from __future__ import annotations

import dataclasses

#: published H100 SXM peaks (NVIDIA data sheet, at 700 W): HBM bytes/s and
#: FP32 flop/s outside the tensor cores
PEAK_BYTES, PEAK_F32 = 3.35e12, 67e12

#: neighbour bins each side that a window's bin convolution reads
WINDOW_HALO = {"boxcar": 0, "hann": 1, "hamming": 1, "blackman": 2}

_ITEMSIZE = {"float32": 4, "float64": 8, "float32x2": 4}


@dataclasses.dataclass(frozen=True)
class OpCost:
    """Analytic cost of one op invocation (per channel)."""

    flops: int
    hbm_bytes: int


def analysis_cost(m: int, window: str, td: str, fd: str, n_samples: int,
                  emit_dfts: bool = True) -> OpCost:
    """Flops and device-memory bytes of the forward analysis of one
    channel's ``n_samples``: the samples read, the carried state
    (delayline and accumulator) read and written, and with ``emit_dfts``
    every packed complex spectrum written once."""
    halo = WINDOW_HALO[window]
    per_bin = 2 + 2 + 2 + 6 + 2 * (1 + 2 * halo) + 4 * halo + 2
    flops = n_samples * m * per_bin
    state_bytes = 2 * m * _ITEMSIZE[td] + m * 2 * _ITEMSIZE[fd]
    nbytes = n_samples * _ITEMSIZE[td] + 2 * state_bytes
    if emit_dfts:
        nbytes += n_samples * m * 2 * _ITEMSIZE[fd]
    return OpCost(flops=flops, hbm_bytes=nbytes)


def bound(nbytes: float, f32_flops: float = 0.0) -> tuple:
    """The least time (ms) an H100 SXM could take for the work, and what
    bounds it: bytes over HBM's rate, or float32 operations over their
    peak."""
    t_bytes = nbytes / PEAK_BYTES * 1e3
    t_ops = f32_flops / PEAK_F32 * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")
