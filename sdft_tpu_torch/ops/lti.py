"""The collapsed (LTI) round trip, the driver protocol at every hop, the
hopped analysis and the fused accumulator refresh (counterpart of
``sdft_tpu.ops.lti``).

Without a spectral transform between them, analysis and synthesis form a
linear time-invariant map of the comb deltas (c/src/sdft/sdft.h:562-657).
Cutting a block into nt tiles of K samples, with row0_t = T_i^(offset +
t*K) and fine[k, i] = T_i^k (exact integer phases), the round trip is

    totals_t = delta_t @ fine                      (one GEMM over all tiles)
    c0_t     = (acc + sum_{t' < t} row0_t' totals_t') * conj(row0_t)
    y_t      = delta_t @ GLT + c0_re_t @ P^T + c0_im_t @ Q^T

with the plan constants P, Q (the adjoint of demodulation, Hermitian
guards, window convolution and synthesis) and GLT = (G o L)^T, L the
causal mask of the prefix sum inside a tile (``_lti_constants``).  The
per-sample scan disappears: three GEMMs (cuBLAS in exact FP32, or
``split_mm`` in a split class, below) plus O(nt*m) elementwise work.
Channels fold into the GEMM rows.

The same carry gives each hop's spectrum when tiles are one hop long: the
accumulator right after a tile's first sample, demodulated, is
(c0_t + d0_t) * conj(T_i).  Hops shorter than 8 samples ride tiles of
``sub`` hops with a stepped partial-totals GEMM (``_stepped_consts_device``).
``roundtrip_hopped_chain`` runs the driver protocol (test/test.c:69-83)
block by block in a Python loop; at hop = 1 plans that the kernels take go
through K2 (``kernels.scan``) instead, straight into the stacked outputs.

The split classes (``Precision.passes``) take their tables split once on
the host into masked bf16 hi + lo pairs (``Split``) and each product
through ``kernels.split_mm``, which splits the activation in registers
and sums three ("high") or four ("split4") products of the halves in
float32 (on the CPU its plain version).  A "high" plan splits every
contraction where the JAX package reads ``mxu_precision``: the
collapsed round trip's totals and synthesis, the driver's totals,
stepped partial totals and synthesis, and ``sdft_hopped``'s
(``_hop_consts_device``, ``_lti_consts_device`` and
``_stepped_consts_device`` hold split tables for it), also in each rank
of the sharded programs.  A "split4" plan splits the collapsed round
trip's three GEMMs (``_lti_consts_split_device``), so its carried
accumulator is of the split class too, and the driver's synthesis only
(``_fused_driver_nd``), whose totals, carry and hop spectra equal an
exact plan's bit for bit.  As in the JAX package the hop=1 K2 chain, K1,
the refresh and the float32x2 tier take no split products on any plan,
nor do ``sdft_hopped`` and the sharded programs on a split4 plan.

The scan-free batched driver segment of the JAX package
(``_driver_segment_nd``, ``segment=True``) is not reachable from the API
and is not ported.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

from .. import graphs
from ..config import fp32_matmul
from ..cplx import pack
from ..kernels.scan import _scan
from ..kernels.spectra import _prefix_tiles, kernel_supported, spectra_prologue
from ..kernels.split_mm import Split, split_mask, split_mm
from ..plan import Plan
from ..state import State, batch_state
from ..windows import WINDOW_HALO, WINDOW_TAPS
from .convolve import window_convolve
from .twiddle import mulmod, phasors, roi_mask

#: tile length of the collapsed round trip for long blocks: the fastest
#: of the k_tile sweep on an H100 at m = 4096 (PERF.md section 6, PR 2)
K_TILE = 1024
#: bound on K*m: the fine and PQ tables hold 16*K*m bytes in float32
TABLE_ELEMS = 1 << 22
#: driver tiles of hops shorter than this many samples span several hops
DRIVER_TILE_TARGET = 8


def _pow2_floor(n: int) -> int:
    return 1 << max(0, n.bit_length() - 1)


def default_k_tile(M: int, m: int) -> int:
    """Tile length for a block of M samples at m bins: K_TILE, but at most
    M/16 (at least 16 tiles) and TABLE_ELEMS/m (the plan tables), as a
    power of two and never below 16."""
    return max(16, min(K_TILE, _pow2_floor(M // 16), _pow2_floor(TABLE_ELEMS // m)))


def driver_sub_factor(hop: int, tile_target: int = DRIVER_TILE_TARGET) -> int:
    """Inner-hop multiplicity for short hops: the smallest ``sub`` with
    hop*sub >= tile_target (1 for hop >= tile_target)."""
    return max(1, -(-tile_target // hop))


# -- plan constants (host numpy, float64) ---------------------------------------

@functools.lru_cache(maxsize=32)
def _fine_host(plan: Plan, K: int):
    """fine[k, j] = T_j^k for k in [0, K), exact integer phases (float64)."""
    m = plan.dftsize
    ang = (-np.pi / m) * ((np.arange(K)[:, None] * np.arange(m)[None, :])
                          % (2 * m))
    return np.cos(ang), np.sin(ang)


@functools.lru_cache(maxsize=32)
def _lti_constants(plan: Plan, K: int):
    """Host-side plan constants of the collapsed round trip:
    (fine_re, fine_im, P, Q, GLT) with shapes (K, m) x 4 and (K, K); the
    fine tables are zero outside the ROI and GLT = (G o L)^T is ready for
    ``delta_tile @ GLT``."""
    m = plan.dftsize
    n2 = 2 * m
    halo = WINDOW_HALO[plan.window]
    c = WINDOW_TAPS[plan.window]
    i = np.arange(m)
    k = np.arange(K)

    # fine[k, j] = T_j^k and dmf[k, j] = conj(T_j^(k+1)), exact integer phases
    ang = (-np.pi / m) * ((k[:, None] * i[None, :]) % n2)
    fine = np.cos(ang) + 1j * np.sin(ang)
    angd = (np.pi / m) * (((k[:, None] + 1) * i[None, :]) % n2)
    dmf = np.cos(angd) + 1j * np.sin(angd)

    # synthesis row (twiddle.synthesis_twiddles in float64)
    if plan.latency == 1.0:
        s_re = np.where(i % 2 == 0, 1.0, -1.0)
        s_im = np.zeros(m)
    else:
        w = 2.0 / (1.0 - np.cos(np.pi * plan.latency))
        angs = -np.pi * plan.latency * i
        s_re = w * np.cos(angs)
        s_im = w * np.sin(angs)
    if plan.roi is not None:
        first, last = plan.roi
        mask = ((i >= first) & (i < last)).astype(np.float64)
        s_re = s_re * mask
        s_im = s_im * mask

    # adjoint of synthesis and convolution: y = sw*(dft_re@s_re - dft_im@s_im),
    # dft = wgt * conv(aux); alpha/beta are the coefficients of aux_re/aux_im
    # on the guard-extended bin axis [-halo, m+halo)
    scale = plan.analysis_weight * plan.synthesis_weight
    aR = np.zeros(m + 2 * halo)
    aI = np.zeros(m + 2 * halo)
    for g in range(-halo, halo + 1):
        aR[halo + g: halo + g + m] += scale * c[abs(g)] * s_re
        aI[halo + g: halo + g + m] += -scale * c[abs(g)] * s_im
    # fold the Hermitian guards (c/src/sdft/sdft.h:589-595) onto their
    # mirror bins, imaginary part negated
    for g in range(1, halo + 1):
        aR[halo + g] += aR[halo - g]
        aI[halo + g] -= aI[halo - g]
        aR[halo + m - 1 - g] += aR[halo + m - 1 + g]
        aI[halo + m - 1 - g] -= aI[halo + m - 1 + g]
    alpha = aR[halo: halo + m]
    beta = aI[halo: halo + m]

    # adjoint of the demodulation aux = u * dmf
    P = alpha * dmf.real + beta * dmf.imag
    Q = beta * dmf.real - alpha * dmf.imag

    # bins outside the ROI are never accumulated (c/src/sdft/sdft.h:570)
    if plan.roi is not None:
        fine = fine * mask
    G = P @ fine.real.T + Q @ fine.imag.T
    GLT = (G * (k[None, :] <= k[:, None])).T
    return fine.real, fine.imag, P, Q, GLT


# -- device caches ---------------------------------------------------------------

def _interleave(re, im) -> np.ndarray:
    """(..., n) re and im -> (..., 2n) with (re, im) pairs adjacent, so a
    GEMM into it yields a complex tensor without a copy."""
    return np.stack([re, im], axis=-1).reshape(*re.shape[:-1], -1)


def _to_device(a: np.ndarray, dtype: torch.dtype, device) -> torch.Tensor:
    return torch.as_tensor(np.ascontiguousarray(a), dtype=dtype, device=device)


def _fine_interleaved(plan: Plan, K: int) -> np.ndarray:
    """(K, 2m) float64: T_i^k on ROI bins (zero elsewhere), (re, im)
    interleaved."""
    fre, fim = _fine_host(plan, K)
    if plan.roi is not None:
        mask = roi_mask(plan, "cpu").numpy()
        fre, fim = fre * mask, fim * mask
    return _interleave(fre, fim)


def _pq_host(plan: Plan, K: int) -> np.ndarray:
    """PQ (2m, K) float64 with rows P[:, j] and Q[:, j] interleaved, so
    that view_as_real(c0) @ PQ is c0_re @ P^T + c0_im @ Q^T in one GEMM."""
    _, _, P, Q, _ = _lti_constants(plan, K)
    return np.stack([P.T, Q.T], axis=1).reshape(2 * plan.dftsize, K)


def _split_host(a: np.ndarray, device) -> Split:
    """Split a float64 host table, rounded to float32, on the host and
    move both halves to ``device``.  Splitting an interleaved table gives
    the halves of re and im split apart."""
    halves = split_mask(torch.as_tensor(np.ascontiguousarray(a), dtype=torch.float32))
    return Split(*(h.to(device) for h in halves))


def _table(plan: Plan, a: np.ndarray, fd: torch.dtype, device):
    """A host table on ``device``: split for a "high" plan (the JAX
    package reads ``mxu_precision`` at every contraction these tables
    enter), else in ``fd``."""
    return _split_host(a, device) if plan.precision.high else _to_device(a, fd, device)


@graphs.cached(maxsize=32)
def _hop_consts_device(plan: Plan, K: int, fd: torch.dtype, device: torch.device):
    """The fine table of K-sample tiles on ``device`` (``_fine_interleaved``,
    ``_table``)."""
    return _table(plan, _fine_interleaved(plan, K), fd, device)


@graphs.cached(maxsize=32)
def _lti_consts_device(plan: Plan, K: int, fd: torch.dtype,
                       device: torch.device):
    """(fine, GLT, PQ) of the collapsed round trip on ``device``: fine as
    ``_hop_consts_device``; GLT (K, K); PQ (2m, K) (``_pq_host``); each
    split for a "high" plan (``_table``)."""
    return (_hop_consts_device(plan, K, fd, device),
            _table(plan, _lti_constants(plan, K)[4], fd, device),
            _table(plan, _pq_host(plan, K), fd, device))


@graphs.cached(maxsize=32)
def _lti_consts_split_device(plan: Plan, K: int, device: torch.device):
    """(fine, GLT, PQ) of ``_lti_consts_device`` for a split4 plan, each
    a ``Split`` pair on ``device`` (counterpart of
    ``sdft_tpu.ops.lti._lti_consts_split_device``)."""
    return (_split_host(_fine_interleaved(plan, K), device),
            _split_host(_lti_constants(plan, K)[4], device),
            _split_host(_pq_host(plan, K), device))


def _mm(plan: Plan, a: torch.Tensor, b) -> torch.Tensor:
    """a @ b for a contiguous (..., K) activation: by ``split_mm`` in the
    plan's split class where the table is ``Split``, else in exact FP32."""
    if isinstance(b, Split):
        out = split_mm(a.reshape(-1, a.shape[-1]), b, plan.precision.passes)
        return out.view(*a.shape[:-1], -1)
    with fp32_matmul():
        return a @ b


def _synthesis_mm(plan: Plan, d: torch.Tensor, GLT, c: torch.Tensor, PQ) -> torch.Tensor:
    """d @ GLT + c @ PQ for (rows, K) d and (rows, 2m) c: with split tables
    two ``split_mm`` launches, the second adding its finished sum to the
    first's output (the plain version's order); else one exact ``addmm``."""
    if isinstance(PQ, Split):
        return split_mm(c, PQ, plan.precision.passes, out=split_mm(d, GLT, plan.precision.passes))
    with fp32_matmul():
        return torch.addmm(d @ GLT, c, PQ)


@graphs.cached(maxsize=32)
def _stepped_consts_device(plan: Plan, hop: int, sub: int, fd: torch.dtype,
                           device: torch.device):
    """Tables for hops shorter than DRIVER_TILE_TARGET: tiles of
    K = hop*sub samples emit ``sub`` hop spectra each, so the GEMMs keep a
    usable depth at 1-sample hops.

    Returns (sf, dr):

      * sf (K, sub*2m): the inclusive partial fine tables
        sf[k, j, i] = T_i^k * [k <= j*hop] (ROI bins only), (re, im)
        interleaved — one GEMM dt @ sf gives every inner hop's partial
        totals, the hop-start delta included; split for a "high" plan
        (``_table``);
      * dr (sub, m) complex: the inner demodulation rows T_i^-(j*hop + 1),
        from exact integer exponents mod 2m.
    """
    m = plan.dftsize
    n2 = 2 * m
    K = hop * sub
    fre, fim = _fine_host(plan, K)
    if plan.roi is not None:
        mask = roi_mask(plan, "cpu").numpy()
        fre, fim = fre * mask, fim * mask
    causal = (np.arange(K)[:, None] <= np.arange(sub)[None, :] * hop)[..., None]
    sf = _interleave(fre[:, None, :] * causal, fim[:, None, :] * causal)
    e = (-(np.arange(sub, dtype=np.int64) * hop + 1)) % n2
    r = (e[:, None] * np.arange(m, dtype=np.int64)[None, :]) % n2
    ang = (-np.pi / m) * r
    cd = torch.complex128 if fd == torch.float64 else torch.complex64
    return (_table(plan, sf.reshape(K, -1), fd, device),
            _to_device(np.cos(ang) + 1j * np.sin(ang), cd, device))


def _fused_driver_consts(plan: Plan, hop: int, sub: int, device):
    """Device constants of the fused driver at tiles of K = hop*sub:
    (fine, GLT, PQ), plus the stepped tables when sub > 1.  A "high" plan
    takes them all split (``_table``); a split4 plan takes the split GLT
    and PQ of its synthesis and the exact fine table of its totals (the
    JAX package's (split, exact) pair, sdft_tpu/ops/lti.py:783-796)."""
    fd = plan.precision.fd_dtype
    K = hop * sub
    base = _lti_consts_device(plan, K, fd, device)
    if plan.precision.split4:
        base = (base[0], *_lti_consts_split_device(plan, K, device)[1:])
    if sub == 1:
        return base, None
    return base, _stepped_consts_device(plan, hop, sub, fd, device)


# -- the collapsed forms -----------------------------------------------------------

def _phase_rows(plan: Plan, offset: torch.Tensor, nt: int, K: int,
                bins: torch.Tensor | None = None):
    """row0[c, t, i] = T_i^((offset_c + t*K) mod 2m) for t in [0, nt) and
    the bins i of ``bins`` (default all m): (C, nt, bins) complex in the
    plan's FD precision.

    The exponents are periodic in t with period p = 2m / gcd(K, 2m), so
    only min(nt, p) rows of exact integer phases are evaluated and the rest
    repeat them (same exponent, same float)."""
    m = plan.dftsize
    n2 = 2 * m
    dev = offset.device
    if bins is None:
        bins = torch.arange(m, device=dev)
    q = min(nt, n2 // math.gcd(K, n2))
    e0 = torch.remainder(offset.to(torch.int64)[:, None]
                         + torch.arange(q, device=dev)[None, :] * K, n2)
    rows = phasors(m, mulmod(e0[..., None], bins, n2), -1.0, plan.precision.fd_dtype)
    if nt > q:
        rows = rows[:, torch.arange(nt, device=dev) % q]
    return rows


def _carry(plan: Plan, state: State, samples: torch.Tensor, fine):
    """The front shared by every collapsed form, for a batched state and
    (C, M) samples: the comb deltas in tiles of K (the rows of ``fine``),
    the per-tile carry in the demodulated frame and the state after the
    block.  The totals GEMM runs in the class of ``fine`` (``_mm``).

    Returns (dt (C, nt, K) FD real, c0 (C, nt, m) complex, new_state)."""
    m = plan.dftsize
    K = fine.shape[0]
    td, fd = plan.precision.td_dtype, plan.precision.fd_dtype
    C, M = samples.shape
    nt = -(-M // K)
    x = samples.to(td)
    line = torch.cat([state.delayline.to(td), x], dim=-1)
    delta = (x - line[:, :M]).to(fd)
    if nt * K != M:  # zero deltas do not perturb the carry
        delta = torch.nn.functional.pad(delta, (0, nt * K - M))
    dt = delta.view(C, nt, K)
    totals = torch.view_as_complex(_mm(plan, dt, fine).view(C, nt, m, 2))
    row0 = _phase_rows(plan, state.offset, nt, K)
    rt = row0 * totals
    acc = torch.view_as_complex(state.accumulator.to(fd).contiguous())
    # exclusive prefix with the carried accumulator in front
    pre = _prefix_tiles(torch.cat([acc[:, None], rt[:, :-1]], dim=1))
    new_state = State(
        offset=torch.remainder(state.offset + M, 2 * m).to(state.offset.dtype),
        delayline=line[:, M:].contiguous(),
        accumulator=torch.view_as_real(pre[:, -1] + rt[:, -1]).to(
            state.accumulator.dtype),
    )
    return dt, pre * row0.conj(), new_state


def _synthesize(plan: Plan, dt: torch.Tensor, c0: torch.Tensor, GLT, PQ,
                M: int) -> torch.Tensor:
    """y = delta @ GLT + c0_re @ P^T + c0_im @ Q^T: (C, M) in TD precision
    (``_synthesis_mm``)."""
    C, nt, K = dt.shape
    d2, c2 = dt.reshape(C * nt, K), torch.view_as_real(c0).reshape(C * nt, -1)
    y = _synthesis_mm(plan, d2, GLT, c2, PQ)
    return y.reshape(C, nt * K)[:, :M].to(plan.precision.td_dtype)


def _hop_aux(plan: Plan, dt: torch.Tensor, c0: torch.Tensor, stepped, hop: int,
             M: int, bins: torch.Tensor | None = None) -> torch.Tensor:
    """The demodulated accumulators at samples 0, hop, 2*hop, ... of the
    block, before the window: (C, ceil(M/hop), nbins) complex for the bins
    of ``bins`` (default all m), which are the columns of ``c0`` and of the
    ``stepped`` tables.  With tiles of one hop (``stepped`` None) tile t
    gives (c0_t + d0_t) * conj(T_i); with tiles of sub hops inner hop j
    gives (c0_t + ptotals_j) * T_i^-(j*hop+1)."""
    m = plan.dftsize
    fd = plan.precision.fd_dtype
    C, nt, K = dt.shape
    dev = dt.device
    if bins is None:
        bins = torch.arange(m, device=dev)
    if stepped is None:
        d0 = dt[:, :, :1]
        if plan.roi is not None:
            d0 = d0 * roi_mask(plan, dev, fd)[bins]
        return (c0 + d0) * phasors(m, bins, 1.0, fd)
    sf, dr = stepped
    sub, nbins = dr.shape
    pt = torch.view_as_complex(_mm(plan, dt, sf).view(C, nt, sub, nbins, 2))
    aux = ((c0[:, :, None, :] + pt) * dr).reshape(C, nt * sub, nbins)
    return aux[:, :-(-M // hop)]


def _hop_spectra(plan: Plan, dt: torch.Tensor, c0: torch.Tensor, stepped,
                 hop: int, M: int) -> torch.Tensor:
    """Packed spectra at samples 0, hop, 2*hop, ... of the block:
    (C, ceil(M/hop), m, 2)."""
    out = window_convolve(plan, _hop_aux(plan, dt, c0, stepped, hop, M))
    if plan.roi is not None:
        out = out * roi_mask(plan, dt.device, plan.precision.fd_dtype)
    return pack(out)


def _graphed(name: str, static: tuple, fn, state: State, samples: torch.Tensor):
    """``fn(state, samples)``, replayed as a graph on the card (``graphs``)
    and run eagerly elsewhere; ``static`` is what else ``fn`` depends on."""
    if graphs.active(samples):
        return graphs.run(name, static, fn, state, samples)
    return fn(state, samples)


def _batched(fn, state: State, samples: torch.Tensor):
    """Run ``fn(batched_state, (C, M) samples) -> (state, *outs)`` on a
    batched or an unbatched state; outputs lose the channel axis again
    for (M,) samples."""
    if samples.ndim == 2:
        return fn(state, samples)
    st, *outs = fn(State(*(a[None] for a in state)), samples[None])
    return (batch_state(st, 0), *(o[0] for o in outs))


def roundtrip_block_lti(plan: Plan, state: State, samples: torch.Tensor,
                        k_tile: int | None = None):
    """Fused forward + inverse round trip of one block (collapsed form).

    Args:
      plan: the plan.
      state: carry (unbatched for (M,) samples, batched for (C, M)).
      samples: (M,) or (C, M), any M (zero-padded to whole tiles inside).
      k_tile: samples per tile (default ``default_k_tile(M, m)``); the
        output does not depend on it beyond rounding.

    Returns (new_state, y) with y (M,) / (C, M) in TD precision, equal to
    ``isdft_block(sdft_block(...))`` up to rounding, with the same state
    (a "high" or split4 plan: up to its split class, in y and the
    accumulator).
    On the card the block replays as one graph (``graphs``).
    """
    M = samples.shape[-1]
    K = k_tile or default_k_tile(M, plan.dftsize)
    if plan.precision.split4:
        fine, GLT, PQ = _lti_consts_split_device(plan, K, samples.device)
    else:
        fine, GLT, PQ = _lti_consts_device(plan, K, plan.precision.fd_dtype,
                                           samples.device)

    def run(st, x):
        dt, c0, st = _carry(plan, st, x, fine)
        return st, _synthesize(plan, dt, c0, GLT, PQ, M)

    return _graphed("roundtrip_block_lti", (plan, K),
                    lambda st, x: _batched(run, st, x), state, samples)


def _fused_driver_nd(plan: Plan, state: State, samples: torch.Tensor, consts,
                     hop: int, refresh: bool):
    """One block of the driver protocol for a batched state in one pass:
    the hop spectra and the synthesized samples share one comb stage, one
    totals GEMM and one prefix; ``refresh`` rebuilds the accumulator from
    the delayline before returning.  ``consts`` come from
    ``_fused_driver_consts``, whose tiles span one or several hops.

    Returns (state, hop_dfts (C, ceil(M/hop), m, 2), y (C, M))."""
    (fine, GLT, PQ), stepped = consts
    M = samples.shape[-1]
    dt, c0, st = _carry(plan, state, samples, fine)
    y = _synthesize(plan, dt, c0, GLT, PQ, M)
    hd = _hop_spectra(plan, dt, c0, stepped, hop, M)
    if refresh:
        st = refresh_state_any(plan, st)
    return st, hd, y


def roundtrip_hopped_block(plan: Plan, state: State, samples: torch.Tensor,
                           hop: int, refresh: bool = False):
    """One block of the driver protocol: (state, hop_dfts, y).  Hops
    shorter than DRIVER_TILE_TARGET take multi-hop tiles."""
    sub = driver_sub_factor(hop)
    consts = _fused_driver_consts(plan, hop, sub, samples.device)
    return _graphed("roundtrip_hopped_block", (plan, hop, refresh), lambda st, x: _batched(
        lambda s, xx: _fused_driver_nd(plan, s, xx, consts, hop, refresh), st, x),
        state, samples)


def sdft_hopped(plan: Plan, state: State, samples: torch.Tensor, hop: int):
    """Forward analysis emitting one spectrum per hop (at samples 0, hop,
    2*hop, ... of the block; the reference driver keeps each hop's first
    spectrum, test/test.c:82).  The carry advances over every sample.

    Returns (new_state, dfts) with dfts packed (ceil(M/hop), m, 2) or
    (C, ceil(M/hop), m, 2), equal up to rounding to the full spectra
    sliced ``[..., ::hop, :, :]``."""
    if hop < 1:
        raise ValueError(f"hop must be >= 1, got {hop}")
    M = samples.shape[-1]
    fd = plan.precision.fd_dtype
    sub = driver_sub_factor(hop)
    fine = _hop_consts_device(plan, hop * sub, fd, samples.device)
    stepped = (_stepped_consts_device(plan, hop, sub, fd, samples.device)
               if sub > 1 else None)

    def run(st, x):
        dt, c0, st = _carry(plan, st, x, fine)
        return st, _hop_spectra(plan, dt, c0, stepped, hop, M)

    return _graphed("sdft_hopped", (plan, hop), lambda st, x: _batched(run, st, x),
                    state, samples)


# -- the exact refresh ------------------------------------------------------------

@graphs.cached(maxsize=16)
def _refresh_tables_device(plan: Plan, fd: torch.dtype, device: torch.device,
                           S: int = 128):
    """Split phase tables of the fused refresh: fineS[b, i] = T_i^b
    (S rows) and coarse2[a, i] = T_i^(a*S) (ceil(2m/S) rows), exact integer
    phases in float64, cast to ``fd``."""
    m = plan.dftsize
    n2 = 2 * m
    A = -(-n2 // S)
    i = np.arange(m)
    angf = (-np.pi / m) * ((np.arange(S)[:, None] * i[None, :]) % n2)
    angc = (-np.pi / m) * (((np.arange(A)[:, None] * S) * i[None, :]) % n2)
    as_dev = functools.partial(torch.as_tensor, dtype=fd, device=device)
    return (as_dev(np.cos(angf)), as_dev(np.sin(angf)),
            as_dev(np.cos(angc)), as_dev(np.sin(angc)))


def _exact_phase_row(plan: Plan, exponents: torch.Tensor, fd: torch.dtype):
    """row[c, i] = T_i^exponents[c] via exact integer phases; (C, m) planar."""
    m = plan.dftsize
    i = torch.arange(m, device=exponents.device)
    z = phasors(m, mulmod(exponents.reshape(-1, 1), i[None, :], 2 * m), -1.0, fd)
    return z.real, z.imag


def _refresh_fused(plan: Plan, state: State, fd: torch.dtype) -> State:
    """The exact accumulator refresh of a batched state in split-table form:
    acc[i] = T_i^offset * sum_j delayline[j] * T_i^j, with j = a*S + b."""
    S = 128
    dev = state.delayline.device
    fS_re, fS_im, c2_re, c2_im = _refresh_tables_device(plan, fd, dev, S)
    A = c2_re.shape[0]
    C = state.delayline.shape[0]
    dl = state.delayline.to(fd)
    if A * S != dl.shape[-1]:       # 2m not a multiple of S: zero-pad rows
        dl = torch.nn.functional.pad(dl, (0, A * S - dl.shape[-1]))
    dl = dl.reshape(C, A, S)
    with fp32_matmul():
        p_re = dl @ fS_re
        p_im = dl @ fS_im
    s_re = torch.sum(p_re * c2_re[None] - p_im * c2_im[None], dim=1)
    s_im = torch.sum(p_re * c2_im[None] + p_im * c2_re[None], dim=1)
    o_re, o_im = _exact_phase_row(plan, state.offset, fd)
    acc = torch.stack([s_re * o_re - s_im * o_im, s_re * o_im + s_im * o_re],
                      dim=-1)
    if plan.roi is not None:
        acc = acc * roi_mask(plan, dev, fd)[None, :, None]
    return State(offset=state.offset, delayline=state.delayline,
                 accumulator=acc.to(state.accumulator.dtype))


def refresh_state_any(plan: Plan, st: State) -> State:
    """``_refresh_fused`` over a batched or an unbatched state."""
    fd = plan.precision.fd_dtype
    if st.offset.ndim == 0:
        out = _refresh_fused(plan, State(*(a[None] for a in st)), fd)
        return batch_state(out, 0)
    return _refresh_fused(plan, st, fd)


def _chain_refresh(refresh, refresh_every: int, st: State, since: int):
    """Refresh cadence for ``refresh_every`` > 1: (state, since)."""
    since += 1
    if since >= refresh_every:
        return refresh(st), 0
    return st, since


# -- the driver protocol over stacked blocks -------------------------------------

def roundtrip_hopped_chain(plan: Plan, state: State, xs: torch.Tensor,
                           hop: int, k_tile: int | None = None,
                           refresh_every: int | None = 1):
    """The driver protocol over stacked blocks, one block after another.

    Args:
      plan: the plan.
      state: carry (unbatched for xs (nb, B), batched for (nb, C, B)).
      xs: stacked blocks, B a multiple of ``hop``.
      hop: hop size in samples.
      k_tile: hops shorter than DRIVER_TILE_TARGET only — the multi-hop
        tile target (default DRIVER_TILE_TARGET): tiles span
        ceil(k_tile/hop) hops.  Ignored for longer hops, whose tiles are
        the hop itself.
      refresh_every: rebuild the accumulator exactly from the delayline
        every N blocks (None: never).

    Returns (new_state, hop_dfts, ys): hop_dfts packed (nb, B//hop, m, 2)
    [(nb, C, B//hop, m, 2)], ys (nb, B) [(nb, C, B)].  At hop = 1, plans
    the kernels take run one prologue and one K2 launch per block, for all
    its channels, K2 writing the block's spectra and samples straight into
    the stacked outputs (the counterpart of ``_chain_hop1_pallas_jit``,
    sdft_tpu/ops/lti.py:945-982, whose scan outputs XLA writes in place).

    On the card one block's body is captured as a graph (the counterpart of
    the JAX package's ``lax.scan`` body) and replayed once per block: at
    hop = 1 the prologue and, at ``refresh_every=1``, the refresh, with K2
    launched after each replay straight from the graph's static carries;
    at other hops the whole block, whose outputs are copied into the
    stacked outputs.  A refresh every N > 1 blocks replays a graph of its
    own (``graphs``).
    """
    if refresh_every is not None and refresh_every < 1:
        raise ValueError(f"refresh_every must be None or >= 1, got {refresh_every}")
    if hop < 1 or xs.shape[-1] % hop:
        raise ValueError(f"block length {xs.shape[-1]} must be a multiple "
                         f"of hop {hop} >= 1")
    if xs.shape[0] < 1:
        raise ValueError("need at least one block")
    nb = xs.shape[0]
    hop1 = hop == 1 and kernel_supported(plan, int(xs.shape[-1]))
    if hop1:
        name, static = "hop1_chain_body", (plan, refresh_every == 1)
        hds = torch.empty((*xs.shape, plan.dftsize, 2), dtype=torch.float32,
                          device=xs.device)
        ys = torch.empty(xs.shape, dtype=torch.float32, device=xs.device)

        def block(st, x):
            pro = spectra_prologue(plan, st, x)
            if refresh_every == 1:
                pro = pro._replace(state=refresh_state_any(plan, pro.state))
            return pro
    else:
        sub = (1 if hop >= DRIVER_TILE_TARGET
               else driver_sub_factor(hop, k_tile or DRIVER_TILE_TARGET))
        consts = _fused_driver_consts(plan, hop, sub, xs.device)
        name, static = "driver_chain_body", (plan, hop, sub, refresh_every == 1)

        def block(st, x):
            return _batched(lambda s, xx: _fused_driver_nd(
                plan, s, xx, consts, hop, refresh_every == 1), st, x)
    refresh = functools.partial(refresh_state_any, plan)
    graphed = graphs.active(xs)
    if graphed:
        # held for the whole chain: each replay's carries are read by the
        # K2 launch enqueued straight after it (graphs: static outputs)
        block = graphs.get(name, static, block, state, xs[0])
        refresh = functools.partial(graphs.replay, "refresh_state_any", (plan,), refresh)
    since = 0
    for b in range(nb):
        if hop1:
            pro = block(state, xs[b])
            _scan(plan, pro, "packed", hds[b], ys[b])
            state = pro.state
        else:
            state, hd, y = block(state, xs[b])
            if b == 0:
                hds = hd.new_empty((nb, *hd.shape))
                ys = y.new_empty((nb, *y.shape))
            hds[b] = hd
            ys[b] = y
        if refresh_every not in (None, 1):
            state, since = _chain_refresh(refresh, refresh_every, state, since)
    return (graphs.clone(state) if graphed else state), hds, ys
