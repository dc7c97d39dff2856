"""K1: forward spectra of every sample of a block (api.sdft, api.sdft_power).

Counterpart of ``_launch_spectra_conv`` and ``_kernel_spectra_conv``
(sdft_tpu/kernels/analysis_pallas.py:781-897, 509-629).  The wrapper runs
the launcher-side prologue (``_spectra_prologue``, :632-748) in PyTorch:

  * the comb stage: delta[k] = x[k] - x[k-2m] and the next delayline;
  * the per-tile totals   S_t = delta_tile @ fine            (one FP32 GEMM)
  * the rotated prefix    c0_t = (acc + sum_{t'<t} row0_t' S_t') conj(row0_t)
  * the next carry        acc' = acc + sum_t row0_t S_t

with row0_t = T_i^((offset + t*K) mod 2m) and fine[k, i] = T_i^k (ROI bins
only).  That leaves the kernel (csrc/spectra.cu) a stateless map over tiles:
each tile's spectra follow from its carry c0_t, its K deltas and the exact
phase table T_i^k, k = 0..K.  The TPU prologue's padded bin axis and its
Hermitian fix columns are not needed: the kernel applies both Hermitian
edges explicitly.

A (C, M) channel batch is one prologue over all channels' tiles (the
totals GEMM on the (C*nt, K) deltas) and one launch, the counterpart of the
JAX package's vmap over its Pallas call (sdft_tpu/api.py:57-63): the
kernel walks the tiles of every channel.

On the card the prologue replays as a captured graph (``prologue``, the
counterpart of the JAX package's compiled ``_sdft_1d``/``_sdft_2d_pallas``,
sdft_tpu/api.py:38,58) and K1 is launched eagerly after the replay, on the
same stream, straight from the graph's static carries into the caller's
outputs: no spectra buffer is pinned in the graph's pool.

On a CPU tensor the wrapper runs the kernel's plain PyTorch version
(``spectra_reference``); on a CUDA tensor it launches the kernel or raises.
``LAUNCHES`` counts the kernel's launches, a graph's replays included
(``graphs``).
"""

from __future__ import annotations

import functools
import math
from typing import NamedTuple

import numpy as np
import torch

from .. import graphs
from ..config import fp32_matmul
from ..ops.convolve import window_convolve
from ..ops.twiddle import mulmod, phasors, roi_mask
from ..plan import Plan
from ..state import State, batch_state
from ..windows import WINDOW_HALO, WINDOW_TAPS
from ._build import check, library

#: samples per tile: the rows of the prologue's per-tile carries are M/K,
#: and the kernel keeps K/8 + 1 coarse phasor rows in shared memory
TILE_K = 128
#: largest dftsize the kernels take (as the JAX package's int32 phases)
MAX_DFTSIZE = 1 << 19
#: consecutive bins each K1 thread owns (csrc/common.cuh: K1_STRIP; a warp
#: covers 32 * STRIP bins); the kernels size their grid themselves
#: (common.cuh: launch_tiles)
STRIP = 4
#: rows per group of the two-level prefix sum over tiles
PREFIX_GROUP = 32
#: store codes of csrc/common.cuh (enum Store), by (form, element type)
STORES = {("packed", "float32"): 0, ("planar", "float32"): 1,
          ("planar", "bfloat16"): 2, ("power", "float32"): 3,
          ("power", "bfloat16"): 4}

#: launches of the CUDA kernel (the plain version does not count)
LAUNCHES = 0


def kernel_supported(plan: Plan, M: int, out_dtype: str | None = None) -> bool:
    """Whether ``plan`` takes the kernels (counterpart of ``plan_supported``,
    analysis_pallas.py:87-102): float32 TD and FD, 128 <= m <= 2^19.  Any
    block length M and either output element type."""
    del M, out_dtype
    p = plan.precision
    return (p.td == "float32" and p.fd == "float32"
            and 128 <= plan.dftsize <= MAX_DFTSIZE)


@graphs.cached(maxsize=16)
def _spectra_tables(plan: Plan, K: int, device: torch.device):
    """(fine, phase) for tile depth K, built in float64 from exact integer
    exponents (k*i mod 2m) and cast to float32:

      * fine (K, 2m), T_i^k on ROI bins (zero elsewhere) with (re, im)
        interleaved: the prologue's totals GEMM, whose (nt, 2m) product is
        then a complex (nt, m) tensor without a copy;
      * phase (K+1, m, 2), T_i^k for k = 0..K on every bin: the kernel's
        table (the demodulator T_i^-(k+1) is conj(phase[k+1]); the kernel
        reads rows 0..7 and every 8th row).
    """
    m = plan.dftsize
    i = np.arange(m)
    k = np.arange(K + 1)
    ang = (-np.pi / m) * ((k[:, None] * i[None, :]) % (2 * m))
    phase = np.stack([np.cos(ang), np.sin(ang)], axis=-1)
    first, last = plan.roi_bins
    mask = ((i >= first) & (i < last)).astype(np.float64)
    fine = (phase[:K] * mask[None, :, None]).reshape(K, 2 * m)
    as_dev = functools.partial(torch.as_tensor, dtype=torch.float32,
                               device=device)
    return as_dev(fine), as_dev(phase)


@graphs.cached(maxsize=16)
def _coarse_rows(plan: Plan, K: int, device: torch.device) -> torch.Tensor:
    """C[j, i] = T_i^(j*K mod 2m) for the q distinct coarse exponents
    (q = period of t*K mod 2m): (q, m) complex64."""
    m = plan.dftsize
    n2 = 2 * m
    q = n2 // math.gcd(K, n2)
    r = ((np.arange(q)[:, None] * K) * np.arange(m)[None, :]) % n2
    ang = (-np.pi / m) * r
    return torch.as_tensor(np.cos(ang) + 1j * np.sin(ang),
                           dtype=torch.complex64, device=device)


def _phase_rows(plan: Plan, offset: torch.Tensor, nt: int, K: int,
                coarse: torch.Tensor) -> torch.Tensor:
    """row0[..., t, i] = T_i^((offset + t*K) mod 2m) for an offset of shape
    () or (C,): one exact row per offset times the cached coarse rows
    (unit-phasor products); (..., nt, m)."""
    m = plan.dftsize
    i = torch.arange(m, device=offset.device)
    o = phasors(m, mulmod(offset[..., None], i, 2 * m), -1.0, torch.float32)
    q = coarse.shape[0]
    rows = coarse[:nt] if nt <= q else coarse[torch.arange(nt, device=offset.device) % q]
    return o[..., None, :] * rows


def _cumsum_complex(z: torch.Tensor, dim: int) -> torch.Tensor:
    """Cumulative sum of a complex tensor along a non-negative ``dim``."""
    return torch.view_as_complex(torch.cumsum(torch.view_as_real(z), dim=dim))


def _prefix_tiles(z: torch.Tensor) -> torch.Tensor:
    """Inclusive prefix sum over the rows of (..., nt, m) complex, in two
    levels: within groups of PREFIX_GROUP rows, then over the group totals.
    (A one-level scan along rows runs one thread per column.)"""
    *lead, nt, m = z.shape
    g = PREFIX_GROUP
    if nt <= g:
        return _cumsum_complex(z, z.ndim - 2)
    ng = -(-nt // g)
    r = torch.view_as_real(z)
    if ng * g != nt:
        r = torch.nn.functional.pad(r, (0, 0, 0, 0, 0, ng * g - nt))
    inner = torch.cumsum(r.reshape(*lead, ng, g, m, 2), dim=-3)
    totals = torch.cumsum(inner[..., -1, :, :], dim=-3)
    inner[..., 1:, :, :, :] += totals[..., :-1, None, :, :]
    return torch.view_as_complex(inner.reshape(*lead, ng * g, m, 2)[..., :nt, :, :])


class Prologue(NamedTuple):
    """Everything the kernels read for a batch of C channels (C = 1 for one
    channel's block), plus the state after the block."""

    delta: torch.Tensor   # (C, nt*K) f32 comb deltas, each row zero padded past M
    c0: torch.Tensor      # (C, nt, m, 2) f32 per-tile carry, demodulated frame
    phase: torch.Tensor   # (K+1, m, 2) f32 table T_i^k
    state: State          # the carry after the block (batched iff the input was)
    M: int                # samples in each channel's block

    @property
    def lead(self) -> tuple:
        """Leading shape of the outputs: (C, M) for a batch, (M,) else."""
        return (self.c0.shape[0], self.M) if self.state.offset.ndim else (self.M,)

    def channel(self, c: int) -> Prologue:
        """Channel c of a batch's prologue, as one channel's block: views of
        its carries and deltas (a launch on it writes that channel alone)."""
        return Prologue(self.delta[c:c + 1], self.c0[c:c + 1], self.phase,
                        batch_state(self.state, c), self.M)


def spectra_prologue(plan: Plan, state: State, samples: torch.Tensor) -> Prologue:
    """The sequential part of one block, as dense ops over all tiles of all
    channels (port of ``_spectra_prologue``, analysis_pallas.py:632-748,
    and of the JAX package's vmap over it).  ``samples`` is (M,) with an
    unbatched state or (C, M) with a batched one; channels may sit at
    different offsets."""
    m = plan.dftsize
    n2 = 2 * m
    K = TILE_K
    if samples.ndim not in (1, 2) or (samples.ndim == 2) != (state.offset.ndim == 1):
        raise ValueError(f"samples {tuple(samples.shape)} need a state batched iff "
                         f"they are (C, M), got offset {tuple(state.offset.shape)}")
    x = samples.to(torch.float32).reshape(-1, samples.shape[-1])
    C, M = x.shape
    nt = -(-M // K)
    dev = samples.device
    fine, phase = _spectra_tables(plan, K, dev)

    line = torch.cat([state.delayline.to(torch.float32).reshape(C, n2), x], dim=1)
    delta = x - line[:, :M]
    new_delayline = line[:, M:].to(plan.precision.td_dtype)
    if nt * K != M:     # each channel's row on its own
        delta = torch.nn.functional.pad(delta, (0, nt * K - M))

    with fp32_matmul():
        s = torch.view_as_complex((delta.view(C * nt, K) @ fine).view(C, nt, m, 2))
    offset = state.offset.reshape(C)
    row = _phase_rows(plan, offset, nt, K, _coarse_rows(plan, K, dev))   # (C, nt, m)
    rt = row * s
    acc_in = torch.view_as_complex(state.accumulator.to(torch.float32)
                                   .reshape(C, m, 2).contiguous())
    # exclusive prefix with the carried accumulator in front:
    # pre[c, t] = acc[c] + sum_{t' < t} row0_ct' S_ct'
    pre = _prefix_tiles(torch.cat([acc_in[:, None], rt[:, :-1]], dim=1))
    c0 = torch.view_as_real(pre * row.conj())
    new_state = State(
        offset=torch.remainder(offset + M, n2).to(state.offset.dtype).reshape(
            state.offset.shape),
        delayline=new_delayline.reshape(state.delayline.shape),
        accumulator=torch.view_as_real(pre[:, -1] + rt[:, -1]).to(
            state.accumulator.dtype).reshape(state.accumulator.shape),
    )
    return Prologue(delta, c0, phase, new_state, M)


def prologue(plan: Plan, state: State, samples: torch.Tensor) -> Prologue:
    """``spectra_prologue``, on the card as a replay of its graph
    (``graphs``; keyed on the plan and the input shapes).  The returned
    ``delta`` and ``c0`` are the graph's static outputs, not copies: the
    next replay of the graph overwrites them, so a kernel that reads them
    is enqueued on the current stream before that replay (the kernel
    wrappers launch straight after this call).  The next state is cloned,
    since the caller keeps it; ``phase`` is the cached table the graph
    holds.  Elsewhere (CPU tensors, ``graphs.disabled()``) it runs
    ``spectra_prologue`` eagerly."""
    if not graphs.active(samples):
        return spectra_prologue(plan, state, samples)
    pro = graphs.replay("spectra_prologue", (plan,),
                        functools.partial(spectra_prologue, plan), state, samples)
    return pro._replace(state=graphs.clone(pro.state))


def reference_spectra(plan: Plan, pro: Prologue) -> torch.Tensor:
    """Plain PyTorch version of the kernels' tile body: (M, m) or (C, M, m)
    complex64 spectra from the prologue's carries, deltas and phase table."""
    m = plan.dftsize
    C, nt = pro.c0.shape[:2]
    K = pro.phase.shape[0] - 1
    F = torch.view_as_complex(pro.phase)
    d = pro.delta.view(C, nt, K)
    u = (torch.view_as_complex(pro.c0)[:, :, None, :]
         + _cumsum_complex(d[..., None] * F[:K], 2))
    mask = roi_mask(plan, pro.c0.device, torch.float32)
    aux = (u * F[1:].conj()) * mask
    out = window_convolve(plan, aux.reshape(C, nt * K, m)[:, :pro.M])
    return (out * mask).reshape(pro.lead + (m,))


def emit(out: torch.Tensor, form: str, dtype: str):
    """The spectra in a store form: packed (M, m, 2), planar (re, im) or
    power |dft|^2, in float32 or bfloat16."""
    tdt = getattr(torch, dtype)
    if form == "packed":
        return torch.view_as_real(out)
    if form == "planar":
        return (out.real.contiguous().to(tdt), out.imag.contiguous().to(tdt))
    return (out.real * out.real + out.imag * out.imag).to(tdt)


def fill(outs, values):
    """Copy ``values`` (a tensor or a planar pair) into ``outs`` of the same
    form; returns ``outs``."""
    pairs = zip(outs if isinstance(outs, tuple) else (outs,),
                values if isinstance(values, tuple) else (values,))
    for o, v in pairs:
        o.copy_(v)
    return outs


def spectra_reference(plan: Plan, pro: Prologue, form: str = "packed",
                      dtype: str = "float32", out=None):
    """The kernel's plain version, in the kernel's output form (written into
    ``out`` when given, as the kernel does, see ``allocate``)."""
    spectra = emit(reference_spectra(plan, pro), form, dtype)
    if out is None:
        return spectra
    return fill(allocate(pro, plan.dftsize, form, dtype, out)[0], spectra)


def vector_stores(m: int, strip: int | None = None) -> bool:
    """Whether a kernel with strips of ``strip`` bins (K1's STRIP by
    default) runs its vector-store instantiation: every strip of every row
    starts aligned when m % strip == 0 (the launchers refuse it otherwise);
    else the scalar-store one runs."""
    return m % (strip or STRIP) == 0


def store_bytes(m: int, form: str, dtype: str, strip: int | None = None) -> int:
    """Bytes of one store instruction of a kernel thread in a store form:
    the vector store of its ``strip`` bins of a plane (K1's STRIP by
    default), capped at 16 bytes (K1's packed strip takes two), or with
    scalar stores one element (two floats for packed)."""
    strip = strip or STRIP
    elem = getattr(torch, dtype).itemsize * (2 if form == "packed" else 1)
    return min(16, strip * elem) if vector_stores(m, strip) else elem


def empty_outputs(lead: tuple, m: int, form: str, dtype: str, device):
    """Uninitialized outputs of a store form with leading shape ``lead``:
    packed lead + (m, 2), a planar (re, im) pair of lead + (m,), or power
    lead + (m,)."""
    tdt = getattr(torch, dtype)
    if form == "packed":
        return torch.empty(lead + (m, 2), dtype=tdt, device=device)
    if form == "planar":
        return tuple(torch.empty(lead + (m,), dtype=tdt, device=device)
                     for _ in range(2))
    return torch.empty(lead + (m,), dtype=tdt, device=device)


def allocate(pro: Prologue, m: int, form: str, dtype: str, out=None,
             strip: int | None = None):
    """Output tensors of a store form for the prologue's block or batch
    (``pro.lead`` + (m[, 2])), as (tensors to return, pointers).  ``out``
    (a tensor, or the planar pair; a view such as one block of a stack) is
    written in place instead of a new allocation, aligned for the stores of
    a kernel with strips of ``strip`` bins (K1's STRIP by default)."""
    dev = pro.c0.device
    outs = empty_outputs(pro.lead, m, form, dtype, dev) if out is None else out
    planes = outs if isinstance(outs, tuple) else (outs,)
    shape = pro.lead + ((m, 2) if form == "packed" else (m,))
    align = store_bytes(m, form, dtype, strip)
    for t in planes:
        if (tuple(t.shape) != shape or t.dtype != getattr(torch, dtype)
                or t.device != dev or not t.is_contiguous() or t.data_ptr() % align):
            raise ValueError(f"{form} output: need contiguous {dtype} {shape} on {dev}, "
                             f"{align}-byte aligned, got {t.dtype} {tuple(t.shape)} "
                             f"on {t.device}")
    if len(planes) != (2 if form == "planar" else 1):
        raise ValueError(f"{form} output: got {len(planes)} planes")
    return outs, (planes[0].data_ptr(), planes[1].data_ptr() if form == "planar" else None)


def launch_args(plan: Plan, pro: Prologue) -> tuple:
    """The TileArgs fields shared by both kernels (csrc/common.cuh), after
    checking device, dtypes, shapes and contiguity."""
    m = plan.dftsize
    dev = pro.c0.device
    if dev.type != "cuda":
        raise ValueError(f"the CUDA kernels need CUDA tensors, got {dev}")
    if not 128 <= m <= MAX_DFTSIZE:
        raise ValueError(f"dftsize {m} outside the kernels' range [128, {MAX_DFTSIZE}]")
    K = pro.phase.shape[0] - 1
    C, nt = pro.c0.shape[:2]
    for name, t, shape in (("delta", pro.delta, (C, nt * K)),
                           ("c0", pro.c0, (C, nt, m, 2)),
                           ("phase", pro.phase, (K + 1, m, 2))):
        if (t.dtype != torch.float32 or tuple(t.shape) != shape
                or not t.is_contiguous() or t.device != dev):
            raise ValueError(f"{name}: need contiguous float32 {shape} on "
                             f"{dev}, got {t.dtype} {tuple(t.shape)} on {t.device}")
    if not 0 < pro.M <= nt * K or K % 8 or K > 256:  # common.cuh: FINE, MAX_K
        raise ValueError(f"bad tiling: M={pro.M}, nt={nt}, K={K}")
    taps = [c * plan.analysis_weight for c in WINDOW_TAPS[plan.window]]
    first, last = plan.roi_bins
    return (pro.c0.data_ptr(), pro.delta.data_ptr(), pro.phase.data_ptr(),
            m, C, pro.M, K, nt, WINDOW_HALO[plan.window], *taps, first, last)


def launch_spectra(plan: Plan, pro: Prologue, form: str = "packed",
                   dtype: str = "float32", out=None):
    """Launch K1 once on the prologue's CUDA tensors, for its whole batch;
    returns the spectra (written into ``out`` when given, see
    ``allocate``)."""
    global LAUNCHES
    args = launch_args(plan, pro)
    dev = pro.c0.device
    outs, (p0, p1) = allocate(pro, plan.dftsize, form, dtype, out)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = library().sdft_spectra_launch(
            *args[:3], p0, p1, *args[3:], STORES[form, dtype],
            int(vector_stores(plan.dftsize)), stream)
    check(err, "sdft_spectra_launch")
    LAUNCHES += 1
    return outs


def _spectra(plan: Plan, pro: Prologue, form: str, dtype: str, out=None):
    if pro.c0.device.type == "cpu":
        return spectra_reference(plan, pro, form, dtype, out)
    return launch_spectra(plan, pro, form, dtype, out)


def _check_dtype(out_dtype):
    if out_dtype not in (None, "float32", "bfloat16"):
        raise ValueError(f"spectra dtype must be float32 or bfloat16, got {out_dtype!r}")
    return out_dtype or "float32"


def forward_block(plan: Plan, state: State, samples: torch.Tensor,
                  layout: str = "packed", out_dtype: str | None = None, out=None):
    """Forward analysis of one channel's (M,) block, or of a (C, M) batch
    with a batched state, through one prologue (a graph replay on the card,
    ``prologue``) and one K1 launch.

    Returns (state, dfts): packed (M, m, 2) [(C, M, m, 2)] float32, or with
    layout="planar" a (re, im) pair of (M, m) [(C, M, m)] planes, in
    bfloat16 if ``out_dtype="bfloat16"`` (the scan itself stays float32).
    ``out`` (tensors of those shapes) receives the spectra in place.
    """
    dtype = _check_dtype(out_dtype)
    if layout not in ("packed", "planar"):
        raise ValueError(f"layout must be 'packed' or 'planar', got {layout!r}")
    if dtype != "float32" and layout != "planar":
        raise ValueError("non-f32 spectra require layout='planar'")
    pro = prologue(plan, state, samples)
    return pro.state, _spectra(plan, pro, layout, dtype, out)


def forward_block_power(plan: Plan, state: State, samples: torch.Tensor,
                        out_dtype: str | None = None, out=None):
    """Forward analysis emitting |dft|^2 as one (M, m) [(C, M, m)] plane
    through K1."""
    dtype = _check_dtype(out_dtype)
    pro = prologue(plan, state, samples)
    return pro.state, _spectra(plan, pro, "power", dtype, out)
