"""The kernels' carry front on the card: one launch of ``csrc/carry.cu``
for the comb deltas, the exact-FP32 tile totals, the tile phase rows, the
prefix over tiles and the next state (offset, delayline, accumulator) of a
(C, M) block.

It is ``ops.carry.carry`` at K = 128 with the exact fine table of
``kernels.spectra._spectra_tables``, and the plain version stays that
module: ``kernels.spectra.spectra_prologue`` runs it on a CPU tensor and
this kernel on a CUDA tensor, and the wrapper checks device, dtypes,
shapes and contiguity and launches, or raises.  The two are held to each
other on the card (the ``-m cuda`` tests of ``tests/test_torch_kernels.py``).

The other callers of ``ops.carry`` keep the plain module on the card:
the collapsed round trip, the driver body and ``sdft_hopped`` of
``ops.lti``, and each rank of ``parallel.sharded``'s exact programs.
They take ``Split`` tables, tiles of up to 1024 samples and subsets of
bins, which this kernel's fixed front does not; the kernel serves the
kernels' prologue (``sdft``, ``sdft_power``, ``roundtrip(transform)``,
K2's routes, the sharded kernel programs) and nothing else.  The split is
by caller, seen in what the code calls, not by an option.

``LAUNCHES`` counts the kernel's launches, a graph's replays included
(``graphs``).
"""

from __future__ import annotations

import torch

from .. import graphs
from ..ops.twiddle import phasors
from ..plan import Plan
from ..state import State
from ._build import check, library

#: samples per tile of the kernel (csrc/carry.cu: K)
K = 128

#: launches of the CUDA kernel
LAUNCHES = 0
#: the launch counters a graph's replay adds to, by name (``graphs``)
COUNTERS = {"carry": "LAUNCHES"}


@graphs.cached(maxsize=16)
def roots(m: int, device: torch.device) -> torch.Tensor:
    """(2m, 2) float32 W[r] = exp(-j*pi*r/m) for r in [0, 2m): the angle,
    cos and sin of ``ops.twiddle.phasors`` in float64, then cast, so that
    both factors of a tile phase row the kernel indexes equal
    ``ops.carry.phase_rows``' bit for bit."""
    r = torch.arange(2 * m, device=device)
    return torch.view_as_real(phasors(m, r, -1.0, torch.float32)).contiguous()


def launch_carry(plan: Plan, state: State, samples: torch.Tensor, fine: torch.Tensor):
    """Launch the kernel once on a batched state and (C, M) samples, all
    CUDA tensors on one card: float32 samples, (C, 2m) float32 delayline,
    (C, m, 2) float32 accumulator, (C,) int32 offsets and the (K, 2m)
    float32 fine table, each contiguous.

    Returns (delta (C, nt*K), c0 (C, nt, m, 2), new_state), the fields of
    ``ops.carry.carry``'s result in the kernels' layout."""
    global LAUNCHES
    m = plan.dftsize
    dev = samples.device
    if samples.ndim != 2 or samples.shape[0] < 1 or samples.shape[1] < 1:
        raise ValueError(f"samples: need (C, M) with C >= 1 and M >= 1, "
                         f"got {tuple(samples.shape)}")
    C, M = samples.shape
    for name, t, shape, dtype in (("samples", samples, (C, M), torch.float32),
                                  ("delayline", state.delayline, (C, 2 * m), torch.float32),
                                  ("accumulator", state.accumulator, (C, m, 2), torch.float32),
                                  ("offset", state.offset, (C,), torch.int32),
                                  ("fine", fine, (K, 2 * m), torch.float32)):
        if (t.dtype != dtype or tuple(t.shape) != shape or not t.is_contiguous()
                or t.device != dev):
            raise ValueError(f"{name}: need contiguous {dtype} {shape} on {dev}, got "
                             f"{t.dtype} {tuple(t.shape)} on {t.device}")
    if dev.type != "cuda":
        raise ValueError(f"the carry kernel needs CUDA tensors, got {dev}")
    nt = -(-M // K)
    W = roots(m, dev)
    delta = torch.empty((C, nt * K), dtype=torch.float32, device=dev)
    line = torch.empty((C, 2 * m), dtype=torch.float32, device=dev)
    c0 = torch.empty((C, nt, m, 2), dtype=torch.float32, device=dev)
    end = torch.empty((C, m, 2), dtype=torch.float32, device=dev)
    offset = torch.empty_like(state.offset)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = library().sdft_carry_launch(
            samples.data_ptr(), state.delayline.data_ptr(), state.accumulator.data_ptr(),
            state.offset.data_ptr(), fine.data_ptr(), W.data_ptr(), delta.data_ptr(),
            line.data_ptr(), c0.data_ptr(), end.data_ptr(), offset.data_ptr(), m, C, M, nt,
            stream)
    check(err, "sdft_carry_launch")
    LAUNCHES += 1
    return delta, c0, State(offset, line, end)
