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

import math

import torch

from .. import graphs
from ..config import fp32_matmul
from ..ops.twiddle import synthesis_twiddles
from ..plan import Plan
from ..state import State
from ._build import check, library
from .spectra import (Prologue, allocate, emit, fill, launch_args, reference_spectra,
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


def _y_output(pro: Prologue, y):
    """A new float32 y of shape ``pro.lead``, or ``y`` after checking it."""
    dev = pro.c0.device
    if y is None:
        return torch.empty(pro.lead, dtype=torch.float32, device=dev)
    if (y.dtype != torch.float32 or tuple(y.shape) != pro.lead or not y.is_contiguous()
            or y.device != dev):
        raise ValueError(f"y output: need contiguous float32 {pro.lead} on {dev}, got "
                         f"{y.dtype} {tuple(y.shape)} on {y.device}")
    return y


def forward_and_y_reference(plan: Plan, pro: Prologue, synth: torch.Tensor,
                            layout: str | None = "packed", out=None, y=None):
    """The kernel's plain version: (spectra in ``layout`` or None, y),
    written into ``out`` and ``y`` when given, as the kernel does."""
    spectra = reference_spectra(plan, pro)
    s = torch.view_as_complex(synth)
    with fp32_matmul():
        y_new = spectra.real @ s.real.contiguous()
        if plan.latency != 1.0:
            y_new = y_new - spectra.imag @ s.imag.contiguous()
    y_new = plan.synthesis_weight * y_new
    if y is not None:
        y_new = _y_output(pro, y).copy_(y_new)
    if not layout:
        return None, y_new
    packed = emit(spectra, layout, "float32")
    if out is not None:
        packed = fill(allocate(pro, plan.dftsize, layout, "float32", out, STRIP)[0], packed)
    return packed, y_new


def launch_scan(plan: Plan, pro: Prologue, synth: torch.Tensor,
                layout: str | None = "packed", out=None, y=None):
    """Launch K2 once on the prologue's CUDA tensors, for its whole batch:
    (spectra or None, y), y of shape ``pro.lead``.  ``out`` (see
    ``spectra.allocate``) and ``y`` receive the results in place, for
    example one block's slot of a chain's stacked outputs."""
    global LAUNCHES
    args = launch_args(plan, pro)
    dev = pro.c0.device
    m = plan.dftsize
    if (synth.dtype != torch.float32 or tuple(synth.shape) != (m, 2)
            or not synth.is_contiguous() or synth.device != dev):
        raise ValueError(f"synth: need contiguous float32 ({m}, 2) on {dev}")
    outs, (p0, p1) = (allocate(pro, m, layout, "float32", out, STRIP) if layout
                      else (None, (None, None)))
    y = _y_output(pro, y)
    # each chunk's partial row sums, added in chunk order by the second
    # kernel of the launch (csrc/scan.cu: y in a fixed order); the launch
    # refuses a row count other than its build's chunk count
    y_part = torch.empty((-(-m // (32 * STRIP)), math.prod(pro.lead)), dtype=torch.float32,
                         device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = library().sdft_scan_launch(
            *args[:3], synth.data_ptr(), p0, p1, y_part.data_ptr(), y_part.shape[0],
            y.data_ptr(), *args[3:],
            plan.synthesis_weight, STORES[layout], int(vector_stores(m, STRIP)), stream)
    check(err, "sdft_scan_launch")
    LAUNCHES += 1
    return outs, y


def _scan(plan: Plan, pro: Prologue, layout: str | None, out=None, y=None):
    synth = synthesis_row(plan, pro.c0.device)
    if pro.c0.device.type == "cpu":
        return forward_and_y_reference(plan, pro, synth, layout, out, y)
    return launch_scan(plan, pro, synth, layout, out, y)


def forward_and_y(plan: Plan, state: State, samples: torch.Tensor,
                  layout: str = "packed"):
    """Spectra and synthesized samples of one channel's (M,) block, or of a
    (C, M) batch with a batched state, from one prologue and one K2 launch:
    (state, dfts, y), dfts packed (M, m, 2) [(C, M, m, 2)] or a planar pair,
    y (M,) [(C, M)]."""
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
