"""K2: fused analysis + synthesis (the hop=1 driver chain, and the fused
round trip).

Counterpart of ``_launch`` and ``_kernel`` (sdft_tpu/kernels/
analysis_pallas.py:900-1020, 147-370) as reached through
``forward_and_y_pallas`` (:1108) and ``roundtrip_block_fused`` (:1099).
The TPU kernel carries the accumulator from one grid step to the next; the
port derives every tile's carry up front with K1's prologue
(``spectra.spectra_prologue``), and the kernel (csrc/scan.cu) adds the
synthesis reduction y = 2 * (Re out . Re s - Im out . Im s) to K1's tile
body.  Each bin chunk's partial row sums go to a scratch buffer and a
second small kernel adds them in chunk order, so y repeats bit for bit
from launch to launch.  The next accumulator comes from the same prologue.

On a CPU tensor the wrapper runs the plain version
(``forward_and_y_reference``); on a CUDA tensor it launches the kernel or
raises.  ``LAUNCHES`` counts the kernel's launches, a graph's replays
included (``graphs``).
"""

from __future__ import annotations

import torch

from .. import graphs
from ..config import fp32_matmul
from ..ops.twiddle import synthesis_twiddles
from ..plan import Plan
from ..state import State
from ._build import check, library
from .spectra import (Prologue, allocate, emit, launch_args, reference_spectra,
                      spectra_prologue, vector_stores)

#: store codes of csrc/common.cuh (enum Store) that the scan kernel takes
STORES = {"packed": 0, "planar": 1, None: 5}
#: consecutive bins each K2 thread owns (csrc/common.cuh: K2_STRIP): half
#: K1's, so the small blocks of the hop=1 chain fill the card
STRIP = 2

#: launches of the CUDA kernel (the plain version does not count)
LAUNCHES = 0


@graphs.cached(maxsize=16)
def synthesis_row(plan: Plan, device) -> torch.Tensor:
    """(m, 2) float32 synthesis twiddles (latency and ROI folded in); one
    cached tensor per plan and device, which the kernels only read."""
    tw = synthesis_twiddles(plan, device).to(torch.complex64)
    return torch.view_as_real(tw).contiguous()


def forward_and_y_reference(plan: Plan, pro: Prologue, synth: torch.Tensor,
                            layout: str | None = "packed"):
    """The kernel's plain version: (spectra in ``layout`` or None, y)."""
    out = reference_spectra(plan, pro)
    s = torch.view_as_complex(synth)
    with fp32_matmul(plan.precision):
        y = out.real @ s.real.contiguous()
        if plan.latency != 1.0:
            y = y - out.imag @ s.imag.contiguous()
    y = plan.synthesis_weight * y
    return (emit(out, layout, "float32") if layout else None), y


def launch_scan(plan: Plan, pro: Prologue, synth: torch.Tensor,
                layout: str | None = "packed"):
    """Launch K2 on the prologue's CUDA tensors: (spectra or None, y)."""
    global LAUNCHES
    args = launch_args(plan, pro)
    dev = pro.c0.device
    m = plan.dftsize
    if (synth.dtype != torch.float32 or tuple(synth.shape) != (m, 2)
            or not synth.is_contiguous() or synth.device != dev):
        raise ValueError(f"synth: need contiguous float32 ({m}, 2) on {dev}")
    outs, (p0, p1) = (allocate(pro, m, layout, "float32") if layout
                      else (None, (None, None)))
    # each chunk's partial row sums, added in chunk order by the second
    # kernel of the launch (csrc/scan.cu: y in a fixed order); the launch
    # refuses a row count other than its build's chunk count
    y_part = torch.empty((-(-m // (32 * STRIP)), pro.M), dtype=torch.float32, device=dev)
    y = torch.empty(pro.M, dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = library().sdft_scan_launch(
            *args[:3], synth.data_ptr(), p0, p1, y_part.data_ptr(), y_part.shape[0],
            y.data_ptr(), *args[3:],
            plan.synthesis_weight, STORES[layout], int(vector_stores(m, STRIP)), stream)
    check(err, "sdft_scan_launch")
    LAUNCHES += 1
    return outs, y


def _scan(plan: Plan, pro: Prologue, layout: str | None):
    synth = synthesis_row(plan, pro.c0.device)
    if pro.c0.device.type == "cpu":
        return forward_and_y_reference(plan, pro, synth, layout)
    return launch_scan(plan, pro, synth, layout)


def forward_and_y(plan: Plan, state: State, samples: torch.Tensor,
                  layout: str = "packed"):
    """Spectra and synthesized samples of one channel's block from one K2
    launch: (state, dfts, y), dfts packed (M, m, 2) or a planar pair."""
    if layout not in ("packed", "planar"):
        raise ValueError(f"layout must be 'packed' or 'planar', got {layout!r}")
    pro = spectra_prologue(plan, state, samples)
    dfts, y = _scan(plan, pro, layout)
    return pro.state, dfts, y.to(plan.precision.td_dtype)


def _fused_block(plan: Plan, state: State, samples: torch.Tensor):
    pro = spectra_prologue(plan, state, samples)
    _, y = _scan(plan, pro, None)
    return pro.state, y.to(plan.precision.td_dtype)


def roundtrip_block_fused(plan: Plan, state: State, samples: torch.Tensor):
    """Analysis + synthesis with no spectra stored: (state, y).  On the card
    the prologue and K2 replay as one graph (``graphs``)."""
    if graphs.active(samples):
        return graphs.run("roundtrip_block_fused", (plan,),
                          lambda st, x: _fused_block(plan, st, x), state, samples)
    return _fused_block(plan, state, samples)
