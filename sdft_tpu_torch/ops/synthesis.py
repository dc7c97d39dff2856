"""Inverse SDFT synthesis (counterpart of ``sdft_tpu.ops.synthesis``).

Per output sample the reference reduces over bins
(c/src/sdft/sdft.h:635-657):

  latency == 1 : y = 2 * sum_i Re(dft[i]) * (-1)^i
  latency <  1 : y = 2 * sum_i Re(dft[i] * polar(w, -pi*i*latency))

For a block this is one (M, m) @ (m,) product per real plane.
"""

from __future__ import annotations

import torch

from ..config import fp32_matmul
from ..plan import Plan
from .twiddle import synthesis_twiddles


def isdft_block(plan: Plan, dfts: torch.Tensor) -> torch.Tensor:
    """(..., M, m, 2) packed spectra -> (..., M) samples in TD precision."""
    fd = plan.precision.fd_dtype
    tw = synthesis_twiddles(plan, dfts.device)
    re = dfts[..., 0].to(fd)
    with fp32_matmul():
        y = re @ tw.real.contiguous()
        if plan.latency != 1.0:
            y = y - dfts[..., 1].to(fd) @ tw.imag.contiguous()
    y = y * plan.synthesis_weight
    return y.to(plan.precision.td_dtype)
