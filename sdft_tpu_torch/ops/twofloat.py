"""Double-word (two-float32) extended-precision FD tier (counterpart of
``sdft_tpu.ops.twofloat``).

Every value is an unevaluated sum hi + lo of two float32s, carried through
the rotate -> cumsum -> demodulate -> window-convolve pipeline with
Dekker/Knuth error-free transformations: products are made exact by 12-bit
bitmask mantissa splits, sums by TwoSum, for ~2^-48 relative accuracy.
Select it with ``Precision(fd="float32x2")``.

Exactness rests on every add, subtract and multiply being its own rounded
float32 operation.  Eager PyTorch runs each as a separate kernel, so none
is contracted into an FMA or reassociated; this module must not be run
under ``torch.compile`` or rewritten with ``addcmul``/``lerp``.  The splits
are bitmasks on the int32 view, not convert round trips.

The carry is not read from ``state.accumulator`` (a plain float32, which
would cap accuracy at ~6e-8): by the refresh identity

    acc[i] = sum_j delayline[j] * T_i^((offset + j) mod 2m)

it is rebuilt in double-word from the exactly carried delayline every block,
so streams of any length are drift-free.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..cplx import to_numpy
from ..plan import Plan
from ..state import State, batch_state, stack_states
from ..windows import WINDOW_HALO, WINDOW_TAPS, Window
from .twiddle import mulmod, roi_mask

# -- double-word primitives (each value is a (hi, lo) pair of same-shape f32)

#: keeps sign, exponent and 11 explicit mantissa bits (0xFFFFF000 as int32)
_MASK12 = -4096


def _split(a: torch.Tensor):
    """a = hi + lo with <= 12 significant mantissa bits each (exact)."""
    hi = (a.view(torch.int32) & _MASK12).view(torch.float32)
    return hi, a - hi


def two_sum(a, b):
    """s + e == a + b exactly (Knuth)."""
    s = a + b
    bb = s - a
    return s, (a - (s - bb)) + (b - bb)


def fast_two_sum(a, b):
    """Renormalize: requires |a| >= |b| (or a == 0)."""
    s = a + b
    return s, b - (s - a)


def two_prod(a, b):
    """p + e == a * b exactly (via 12-bit splits; no FMA needed)."""
    p = a * b
    ah, al = _split(a)
    bh, bl = _split(b)
    e = ((ah * bh - p) + ah * bl + al * bh) + al * bl
    return p, e


def df_add(x, y):
    """(hi, lo) + (hi, lo), error O(eps^2)."""
    s, e = two_sum(x[0], y[0])
    return fast_two_sum(s, e + (x[1] + y[1]))


def df_neg(x):
    return -x[0], -x[1]


def df_mul(x, y):
    """(hi, lo) * (hi, lo), error O(eps^2)."""
    p, e = two_prod(x[0], y[0])
    return fast_two_sum(p, e + (x[0] * y[1] + x[1] * y[0]))


def df_const(v: float):
    """Host float (f64) as a df pair of 0-dim float32 CPU tensors, which
    combine with tensors on any device."""
    hi = np.float32(v)
    lo = np.float32(np.float64(v) - np.float64(hi))
    return torch.tensor(hi), torch.tensor(lo)


def df_to_float64(x) -> np.ndarray:
    """Host-side: collapse a df pair (tensors or arrays) to float64."""
    return to_numpy(x[0]).astype(np.float64) + to_numpy(x[1]).astype(np.float64)


# complex df values are ((re_hi, re_lo), (im_hi, im_lo)) pairs

def cdf_mul(a, b):
    (ar, ai), (br, bi) = a, b
    re = df_add(df_mul(ar, br), df_neg(df_mul(ai, bi)))
    im = df_add(df_mul(ar, bi), df_mul(ai, br))
    return re, im


def cdf_add(a, b):
    return df_add(a[0], b[0]), df_add(a[1], b[1])


# -- phase tables: T_i^r = exp(-j*pi*r/m) at every integer r in [0, 2m), split
# hi/lo from the f64 evaluation (within 1 ulp(f64) of the true phasor — the
# accuracy floor of this tier)

def _split_f64(v: np.ndarray, device):
    hi = v.astype(np.float32)
    lo = (v - hi.astype(np.float64)).astype(np.float32)
    return torch.as_tensor(hi, device=device), torch.as_tensor(lo, device=device)


@functools.lru_cache(maxsize=16)
def _phase_tables(plan: Plan, device: torch.device):
    """(cos_hi, cos_lo, sin_hi, sin_lo), each (2m,) float32 on ``device``."""
    m = plan.dftsize
    ang = (-np.pi / m) * np.arange(2 * m, dtype=np.float64)
    return _split_f64(np.cos(ang), device) + _split_f64(np.sin(ang), device)


def _gather_phasor(tables, exps: torch.Tensor):
    """Complex df phasor at integer exponents ``exps`` (in [0, 2m))."""
    ch, cl, sh, sl = tables
    return (ch[exps], cl[exps]), (sh[exps], sl[exps])


# -- core pipeline

def _rotate(plan: Plan, tables, values_df, e_rows, bins, mask):
    """rot[k, i] = values[k] * T_i^e_rows[k] as complex df (planes (K, B)).
    Exponents are reduced mod 2m in int64 before the gather."""
    r = mulmod(e_rows[:, None], bins[None, :], 2 * plan.dftsize)
    cr, ci = _gather_phasor(tables, r)
    vh, vl = values_df
    v = (vh[:, None], vl[:, None])
    re = df_mul(v, cr)
    im = df_mul(v, ci)
    if mask is not None:
        re = (re[0] * mask, re[1] * mask)
        im = (im[0] * mask, im[1] * mask)
    return re, im


def _df_cumsum(re, im):
    """Inclusive cumsum along axis 0 of complex df planes: a Hillis–Steele
    scan (log2(M) steps over whole planes) with the df_add combiner, O(eps^2)
    per combine.  Real and imaginary planes are stacked so each step is one
    df_add."""
    h = torch.stack([re[0], im[0]])
    lo = torch.stack([re[1], im[1]])
    M = h.shape[1]
    d = 1
    while d < M:
        sh, sl = df_add((h[:, :-d], lo[:, :-d]), (h[:, d:], lo[:, d:]))
        h = torch.cat([h[:, :d], sh], dim=1)
        lo = torch.cat([lo[:, :d], sl], dim=1)
        d *= 2
    return (h[0], lo[0]), (h[1], lo[1])


def _df_sum_last(p):
    """Pairwise tree-sum of a df pair along the LAST axis (error O(eps^2)
    per level — the compensated reduction of the m-term synthesis sum)."""
    h, lo = p
    n = h.shape[-1]
    while n > 1:
        half = n // 2
        s = df_add((h[..., :half], lo[..., :half]),
                   (h[..., half:2 * half], lo[..., half:2 * half]))
        if n % 2:
            h = torch.cat([s[0], h[..., 2 * half:]], dim=-1)
            lo = torch.cat([s[1], lo[..., 2 * half:]], dim=-1)
            n = half + 1
        else:
            h, lo = s
            n = half
    return h[..., 0], lo[..., 0]


#: delayline samples per step of the carry rebuild: bounds its planes at
#: (CARRY_CHUNK, m)
CARRY_CHUNK = 512


def _carry_from_delayline(plan: Plan, tables, delayline, offset, bins, mask):
    """acc[i] = sum_j dl[j] * T_i^(offset + j) in double-word (the refresh
    identity), as a loop over chunks of CARRY_CHUNK delayline samples."""
    (N,) = delayline.shape
    dev = delayline.device
    chunk = min(N, CARRY_CHUNK)
    nch = -(-N // chunk)
    dl = torch.nn.functional.pad(delayline.to(torch.float32), (0, nch * chunk - N))
    dl = dl.reshape(nch, chunk)
    zero = torch.zeros(bins.shape[0], dtype=torch.float32, device=dev)
    cre, cim = (zero, zero), (zero, zero)
    for c in range(nch):
        e = offset + c * chunk + torch.arange(chunk, device=dev)
        re, im = _rotate(plan, tables, (dl[c], torch.zeros_like(dl[c])), e, bins,
                         mask)
        # tree-reduce the (chunk, B) planes over chunk, then df_add into the carry
        cre = df_add(cre, _df_sum_last((re[0].T, re[1].T)))
        cim = df_add(cim, _df_sum_last((im[0].T, im[1].T)))
    return cre, cim


def _window_convolve_df(plan: Plan, aux, mask):
    """Window bin convolution + analysis weight on complex df planes, with
    Hermitian mirror guards (``ops.convolve`` semantics)."""
    halo = WINDOW_HALO[plan.window]
    w = df_const(plan.analysis_weight)
    ar, ai = aux
    if plan.window is Window.BOXCAR:
        out = (df_mul(ar, w), df_mul(ai, w))
    else:
        c0, c1, c2 = WINDOW_TAPS[plan.window]

        def pad(p, conj_sign):
            return tuple(torch.cat([conj_sign * t[..., 1:halo + 1].flip(-1), t,
                                    conj_sign * t[..., -halo - 1:-1].flip(-1)], dim=-1)
                         for t in p)

        pr = pad(ar, 1.0)
        pi = pad(ai, -1.0)                       # Hermitian: conj mirrors
        n = pr[0].shape[-1]

        def shifted(p, s):
            return p[0][..., halo + s:n - halo + s], p[1][..., halo + s:n - halo + s]

        def stencil(p):
            out = df_mul(shifted(p, 0), df_const(c0))
            s1 = df_add(shifted(p, -1), shifted(p, 1))
            out = df_add(out, df_mul(s1, df_const(c1)))
            if halo >= 2:
                s2 = df_add(shifted(p, -2), shifted(p, 2))
                out = df_add(out, df_mul(s2, df_const(c2)))
            return out

        out = (df_mul(stencil(pr), w), df_mul(stencil(pi), w))
    if mask is not None:
        out = tuple((o[0] * mask, o[1] * mask) for o in out)
    return out


def _sdft_block_df_1d(plan: Plan, state: State, samples: torch.Tensor):
    m = plan.dftsize
    n2 = 2 * m
    (M,) = samples.shape
    dev = samples.device
    bins = torch.arange(m, device=dev)
    tables = _phase_tables(plan, dev)
    mask = None if plan.roi is None else roi_mask(plan, dev, torch.float32)

    samples = samples.to(torch.float32)
    line = torch.cat([state.delayline.to(torch.float32), samples])
    # comb delta as an EXACT df pair (the f32 subtraction alone rounds)
    d_hi, d_lo = two_sum(samples, -line[:M])

    off = state.offset.to(torch.int64)
    # carry rebuilt in double-word from the delayline (refresh identity):
    # state.accumulator (plain f32) is deliberately not read
    acc0_re, acc0_im = _carry_from_delayline(plan, tables, state.delayline, off,
                                             bins, mask)

    e = off + torch.arange(M, device=dev)
    rot_re, rot_im = _rotate(plan, tables, (d_hi, d_lo), e, bins, mask)
    # df_add the carry into row 0 (a plain hi+hi add would round at the f32
    # class and break the double-word invariant)
    r0 = df_add((rot_re[0][0], rot_re[1][0]), acc0_re)
    i0 = df_add((rot_im[0][0], rot_im[1][0]), acc0_im)
    for plane, row in zip(rot_re + rot_im, r0 + i0):
        plane[0] = row
    acc_re, acc_im = _df_cumsum(rot_re, rot_im)
    del rot_re, rot_im

    # demodulate by T_i^-(offset+k+1)
    r = mulmod(-(e + 1)[:, None], bins[None, :], n2)
    aux = cdf_mul((acc_re, acc_im), _gather_phasor(tables, r))
    del r
    or_, oi = _window_convolve_df(plan, aux, mask)
    del aux

    new_state = State(
        offset=torch.remainder(state.offset + M, n2).to(state.offset.dtype),
        delayline=line[M:].to(state.delayline.dtype),
        accumulator=torch.stack([acc_re[0][-1] + acc_re[1][-1],
                                 acc_im[0][-1] + acc_im[1][-1]], dim=-1
                                ).to(state.accumulator.dtype),
    )
    # packed (M, m, 2(re,im), 2(hi,lo))
    dfts = torch.stack([torch.stack(or_, dim=-1), torch.stack(oi, dim=-1)], dim=-2)
    return new_state, dfts


def sdft_block_df(plan: Plan, state: State, samples):
    """One block of forward analysis in the double-word tier.

    Returns (state, dfts) with dfts (M, m, 2, 2) [(C, M, m, 2, 2) for a
    (C, M) batch, one block per channel]: packed complex where each
    component is an unevaluated (hi, lo) float32 pair summing to the
    ~2^-48-accurate value (``df_to_float64`` recovers it).

    ``state`` is the ordinary State; the carry is rebuilt from the delayline
    every block, so chained calls are drift-free for streams of any length.
    """
    x = torch.as_tensor(samples, device=state.offset.device)
    if x.ndim == 1:
        return _sdft_block_df_1d(plan, state, x)
    outs = [_sdft_block_df_1d(plan, batch_state(state, c), xc)
            for c, xc in enumerate(x)]
    return stack_states([o[0] for o in outs]), torch.stack([o[1] for o in outs])


@functools.lru_cache(maxsize=16)
def _synthesis_tables_df(plan: Plan, device: torch.device):
    """Synthesis twiddles as (re_hi, re_lo, im_hi, im_lo) split from the f64
    host evaluation (c/src/sdft/sdft.h:440,445 constants; the ROI folds into
    the table as in ``ops.twiddle.synthesis_twiddles``)."""
    m = plan.dftsize
    i = np.arange(m, dtype=np.float64)
    if plan.latency == 1.0:
        re = np.where(np.arange(m) % 2 == 0, 1.0, -1.0)
        im = np.zeros(m)
    else:
        ang = -np.pi * plan.latency * i
        w = 2.0 / (1.0 - np.cos(np.pi * plan.latency))
        re = w * np.cos(ang)
        im = w * np.sin(ang)
    if plan.roi is not None:
        first, last = plan.roi
        mask = (np.arange(m) >= first) & (np.arange(m) < last)
        re = re * mask
        im = im * mask
    return _split_f64(re, device) + _split_f64(im, device)


def isdft_block_df(plan: Plan, dfts):
    """Inverse synthesis in the double-word tier: one sample per spectrum
    from the packed (hi, lo) spectra that ``sdft_block_df`` emits.

    Args:
      plan: the plan.
      dfts: (..., M, m, 2, 2), trailing axes (re/im, hi/lo).

    Returns:
      (hi, lo) float32 pair of shape (..., M): an unevaluated sum reaching
      the f64 class; ``hi`` alone is the correctly rounded float32 sample.
    """
    dfts = torch.as_tensor(dfts)
    if dfts.ndim < 3 or tuple(dfts.shape[-2:]) != (2, 2):
        raise ValueError(f"dfts must be (..., M, m, 2, 2) double-word packed, "
                         f"got {tuple(dfts.shape)}")
    dfts = dfts.to(torch.float32)
    rh, rl, ih, il = _synthesis_tables_df(plan, dfts.device)
    dre = (dfts[..., 0, 0], dfts[..., 0, 1])
    dim = (dfts[..., 1, 0], dfts[..., 1, 1])
    # Re(dft * tw) = Re(dft)*Re(tw) - Im(dft)*Im(tw), all in double-word
    terms = df_add(df_mul(dre, (rh, rl)), df_neg(df_mul(dim, (ih, il))))
    return df_mul(_df_sum_last(terms), df_const(plan.synthesis_weight))
