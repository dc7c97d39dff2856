"""Inverse SDFT synthesis (counterpart of ``sdft_tpu.ops.synthesis``).

Per output sample the reference reduces over bins
(c/src/sdft/sdft.h:635-657):

  latency == 1 : y = 2 * sum_i Re(dft[i]) * (-1)^i
  latency <  1 : y = 2 * sum_i Re(dft[i] * polar(w, -pi*i*latency))

For a block this is one (M, m) @ (m,) product per real plane.  Under a
profiler each call lies in a span ``sdft.ops.synthesis.isdft``
(``tracing``); ``BLOCKS`` counts the calls.
"""

from __future__ import annotations

import torch

from ..config import fp32_matmul
from ..plan import Plan
from ..tracing import spanned
from .twiddle import synthesis_twiddles

#: calls of ``isdft_block``: one a block synthesized from its spectra
BLOCKS = 0


@spanned("sdft.ops.synthesis.isdft")
def isdft_block(plan: Plan, dfts: torch.Tensor) -> torch.Tensor:
    """(..., M, m, 2) packed spectra -> (..., M) samples in TD precision."""
    global BLOCKS
    BLOCKS += 1
    fd = plan.precision.fd_dtype
    tw = synthesis_twiddles(plan, dfts.device)
    re = dfts[..., 0].to(fd)
    with fp32_matmul():
        y = re @ tw.real.contiguous()
        if plan.latency != 1.0:
            y = y - dfts[..., 1].to(fd) @ tw.imag.contiguous()
    y = y * plan.synthesis_weight
    return y.to(plan.precision.td_dtype)
