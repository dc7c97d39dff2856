"""Frequency-domain window convolution with Hermitian edge guards
(counterpart of ``sdft_tpu.ops.convolve``).

At the spectrum edges the reference mirrors complex conjugates around bin 0
and bin m-1 (c/src/sdft/sdft.h:589-595): the guard cell at bin -k is
conj(bin +k) and at bin (m-1)+k is conj(bin (m-1)-k).
"""

from __future__ import annotations

import torch

from ..plan import Plan
from ..windows import WINDOW_HALO, WINDOW_TAPS


def hermitian_pad(aux: torch.Tensor, halo: int) -> torch.Tensor:
    """Pad the bin axis (last axis) with Hermitian mirror guards.

    aux: (..., m) complex.  Returns (..., m + 2*halo).
    """
    if halo == 0:
        return aux
    left = torch.conj(aux[..., 1:halo + 1].flip(-1))
    right = torch.conj(aux[..., -halo - 1:-1].flip(-1))
    return torch.cat([left, aux, right], dim=-1)


def window_convolve(plan: Plan, aux: torch.Tensor) -> torch.Tensor:
    """Apply the window's bin convolution, with Hermitian guards built from
    the data, and the analysis weight 1/(2m).  aux: (..., m) complex."""
    halo = WINDOW_HALO[plan.window]
    if halo == 0:
        return aux * plan.analysis_weight
    return convolve_padded(plan, hermitian_pad(aux, halo).resolve_conj())


def convolve_padded(plan: Plan, padded: torch.Tensor) -> torch.Tensor:
    """The window's bin convolution times 1/(2m) on columns already padded
    with ``halo`` guard columns on each side (Hermitian guards, or a bin
    shard's neighbour columns): (..., n + 2*halo) -> (..., n)."""
    halo = WINDOW_HALO[plan.window]
    w = plan.analysis_weight
    c0, c1, c2 = WINDOW_TAPS[plan.window]
    if halo == 0:
        return padded * w
    n = padded.shape[-1]
    out = c0 * padded[..., halo:n - halo]
    out = out + c1 * (padded[..., halo - 1:n - halo - 1]
                      + padded[..., halo + 1:n - halo + 1])
    if halo >= 2:
        out = out + c2 * (padded[..., halo - 2:n - halo - 2]
                          + padded[..., halo + 2:n - halo + 2])
    return out * w
