"""The carry front of a block: every tiled path's sequential part, written
once (counterpart of the launcher-side prologue of the JAX package's
kernels, sdft_tpu/kernels/analysis_pallas.py:632-748, and of the carry of
``sdft_tpu.ops.lti``).

Cutting a (C, M) block into nt tiles of K samples, with
row0_t = T_i^((offset + t*K) mod 2m) and fine[k, i] = T_i^k (ROI bins
only), the front runs in three parts:

  * ``comb``        delta[k] = x[k] - x[k-2m] and the next delayline;
  * ``tile_totals`` rt_t = row0_t * (delta_t @ fine)    (one GEMM, ``_mm``)
  * ``tile_prefix`` c0_t = (acc + sum_{t'<t} rt_t') * conj(row0_t), and
                    the end accumulator acc + sum_t rt_t.

``carry`` chains them for a batched state: the kernels' prologue
(``kernels.spectra.spectra_prologue``) and the collapsed forms of
``ops.lti`` call it; each rank of ``parallel.sharded`` calls the parts
around its own comb exchange and carry collective.  The GEMM runs in the
class of ``fine``: a ``Split`` table gives split products, any other table
exact FP32.
"""

from __future__ import annotations

import math

import torch

from ..config import fp32_matmul
from ..kernels.split_mm import Split, split_mm
from ..plan import Plan
from ..state import State
from .twiddle import mulmod, phasors

#: rows per group of the two-level prefix sum over tiles
PREFIX_GROUP = 32


def _mm(plan: Plan, a: torch.Tensor, b) -> torch.Tensor:
    """a @ b for a contiguous (..., K) activation: by ``split_mm`` in the
    plan's split class where the table is ``Split``, else in exact FP32."""
    if isinstance(b, Split):
        out = split_mm(a.reshape(-1, a.shape[-1]), b, plan.precision.passes)
        return out.view(*a.shape[:-1], -1)
    with fp32_matmul():
        return a @ b


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


def comb(plan: Plan, hist: torch.Tensor, samples: torch.Tensor, K: int):
    """The comb stage of (C, M) samples after the (C, 2m) history ``hist``
    (the 2m samples before the block): (dt, line) with dt (C, nt, K) the
    deltas in FD precision, zero past M (zero deltas do not perturb the
    carry), and line (C, 2m) the last 2m samples in TD precision (a view
    of the joined history and block)."""
    td = plan.precision.td_dtype
    C, M = samples.shape
    nt = -(-M // K)
    x = samples.to(td)
    line = torch.cat([hist.to(td), x], dim=-1)
    delta = (x - line[:, :M]).to(plan.precision.fd_dtype)
    if nt * K != M:
        delta = torch.nn.functional.pad(delta, (0, nt * K - M))
    return delta.view(C, nt, K), line[:, M:]


def phase_rows(plan: Plan, offset: torch.Tensor, nt: int, K: int,
               bins: torch.Tensor | None = None) -> torch.Tensor:
    """row0[c, t, i] = T_i^offset_c * R[t mod q, i] for t in [0, nt) and the
    bins i of ``bins`` (default all m), where R holds the rows
    T_i^(t*K mod 2m) of the period q = 2m / gcd(K, 2m): (C, nt, bins)
    complex in the plan's FD precision.  Both factors come from exact
    integer exponents, in one evaluation of C + min(nt, q) rows."""
    m = plan.dftsize
    n2 = 2 * m
    dev = offset.device
    if bins is None:
        bins = torch.arange(m, device=dev)
    C = offset.shape[0]
    q = min(nt, n2 // math.gcd(K, n2))
    e = torch.cat([offset.to(torch.int64), torch.arange(0, q * K, K, device=dev)])
    rows = phasors(m, mulmod(e[:, None], bins, n2), -1.0, plan.precision.fd_dtype)
    o, R = rows[:C], rows[C:]
    if nt > q:
        R = R[torch.arange(nt, device=dev) % q]
    return o[:, None, :] * R


def tile_totals(plan: Plan, dt: torch.Tensor, fine, offset: torch.Tensor,
                bins: torch.Tensor | None = None):
    """(rt, row0) of (C, nt, K) deltas: rt = row0 * (dt @ fine), the rotated
    tile totals, with the (K, 2*bins) interleaved ``fine`` table's columns
    the bins of ``bins`` (default all m) and row0 the block's ``phase_rows``
    from its start exponents ``offset`` (C,); both (C, nt, bins) complex."""
    C, nt, K = dt.shape
    totals = torch.view_as_complex(_mm(plan, dt, fine).view(C, nt, -1, 2))
    row0 = phase_rows(plan, offset, nt, K, bins)
    return row0 * totals, row0


def tile_prefix(acc: torch.Tensor, rt: torch.Tensor, row0: torch.Tensor):
    """(c0, end) from the (C, bins) complex accumulator in front of the
    block: c0 (C, nt, bins) the carry at each tile's start in the
    demodulated frame, end the accumulator after the block."""
    pre = _prefix_tiles(torch.cat([acc[:, None], rt[:, :-1]], dim=1))
    return pre * row0.conj(), pre[:, -1] + rt[:, -1]


def carry(plan: Plan, state: State, samples: torch.Tensor, fine):
    """The whole front for a batched state and (C, M) samples, in tiles of
    K (the rows of ``fine``).

    Returns (dt (C, nt, K) FD real, c0 (C, nt, m) complex, new_state)."""
    M = samples.shape[-1]
    dt, line = comb(plan, state.delayline, samples, fine.shape[0])
    rt, row0 = tile_totals(plan, dt, fine, state.offset)
    acc = torch.view_as_complex(state.accumulator.to(plan.precision.fd_dtype).contiguous())
    c0, end = tile_prefix(acc, rt, row0)
    new_state = State(
        offset=torch.remainder(state.offset + M, 2 * plan.dftsize).to(state.offset.dtype),
        delayline=line,
        accumulator=torch.view_as_real(end).to(state.accumulator.dtype),
    )
    return dt, c0, new_state
