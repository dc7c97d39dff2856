"""Packed-complex boundary layout (counterpart of ``sdft_tpu.cplx``).

Spectra cross the public functions as a real tensor with a trailing axis of
size 2 holding (real, imag), the JAX package's layout, so that the two
packages compare like with like.  Inside, the port uses complex tensors.
"""

from __future__ import annotations

import numpy as np
import torch


def pack(z: torch.Tensor) -> torch.Tensor:
    """complex (...,) -> packed (..., 2), a view of ``z``'s storage."""
    return torch.view_as_real(z.resolve_conj())


def unpack(p: torch.Tensor) -> torch.Tensor:
    """packed (..., 2) -> complex (...)."""
    if p.shape[-1] != 2:
        raise ValueError(f"packed layout needs trailing axis 2, got {tuple(p.shape)}")
    return torch.view_as_complex(p.contiguous())


def to_numpy(a) -> np.ndarray:
    """Host-side: a tensor on any device (bfloat16 as float32) or an
    array-like -> numpy array."""
    if isinstance(a, torch.Tensor):
        a = a.detach().cpu()
        return (a.float() if a.dtype == torch.bfloat16 else a).numpy()
    return np.asarray(a)


def to_complex(p) -> np.ndarray:
    """Host-side: packed tensor or array -> numpy complex array."""
    p = to_numpy(p)
    if p.shape[-1] != 2:
        raise ValueError(f"packed layout needs trailing axis 2, got {p.shape}")
    return p[..., 0] + 1j * p[..., 1]


def planar_to_complex(re, im) -> np.ndarray:
    """Host-side: planar (re, im) pair (tensors on any device, bfloat16 as
    float32, or array-likes) -> numpy complex array."""
    return to_numpy(re) + 1j * to_numpy(im)


def from_complex(z, dtype=None) -> np.ndarray:
    """Host-side: complex array -> packed numpy array."""
    if isinstance(z, torch.Tensor):
        z = z.detach().cpu().numpy()
    z = np.asarray(z)
    if not np.iscomplexobj(z):
        z = z.astype(np.complex128)
    real_dtype = dtype or (np.float32 if z.dtype == np.complex64 else np.float64)
    return np.stack([z.real, z.imag], axis=-1).astype(real_dtype)
