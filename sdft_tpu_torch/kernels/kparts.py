"""Probes of K1's parts: a spectra tile split into its pure store, its
matrix products and its carry-rotation + window-convolution chain.

Counterpart of the archived TPU microbenchmarks ``make.<locals>.run``
(scripts/archive/exp_kparts.py:41; bodies ``store_only``, ``dots_only``,
``vpu_only``, ``full``) and ``mk.<locals>.run`` (:215; the ``full`` body
on table inputs), both in one CUDA kernel (csrc/kparts.cu: persistent
blocks, one wave, each owning 64 output columns of a range of tiles).
Variants:

  * "store"  — the table dmf[:, PAD:PAD+m], stored (the output floor);
  * "dots"   — (thi@b + thi@b + tlo@b)[:, PAD:PAD+m], b = bf16(dmf),
               bf16 products accumulated in f32;
  * "vpu"    — the window convolution of the carry rotation of dmf;
  * "full"   — the convolution of the products plus the rotation;
  * "tables" — "full" on the tables d1, d2, b1, b2 given as inputs.

Each tile t writes two (K, m) f32 planes of the (nt*K, m) outputs from its
rows 8t, 8t+1 of c0 and its (K, K) tiles of thi, tlo.

On a CPU tensor ``kparts`` runs the plain version (``kparts_reference``);
on a CUDA tensor it launches the kernel or raises.  ``LAUNCHES`` counts
the kernel's launches by the TPU function each variant ports: "make" for
the four bodies of ``make``, "tables" for ``mk``.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..config import fp32_matmul
from ..state import require_device
from ._build import check, library

VARIANTS = ("store", "dots", "vpu", "full", "tables")
#: body codes of csrc/kparts.cu (enum Body)
BODIES = {"store": 0, "dots": 1, "vpu": 2, "full": 3, "tables": 3}
#: output columns per thread block (csrc/kparts.cu: BN)
BLOCK_COLS = 64

#: launches of the CUDA kernel, by ported TPU function (the plain version
#: does not count)
LAUNCHES = {"make": 0, "tables": 0}


class Probe(NamedTuple):
    """Inputs of the probes (the shapes of exp_kparts.py:27-53, 178-235)."""

    c0: torch.Tensor    # (nt*8, W) f32 carry rows; rows 8t, 8t+1 are read
    thi: torch.Tensor   # (nt*K, K) bf16
    tlo: torch.Tensor   # (nt*K, K) bf16
    d1: torch.Tensor    # (K, W) f32 table inputs of "tables"
    d2: torch.Tensor    # (K, W) f32
    b1: torch.Tensor    # (K, W) bf16
    b2: torch.Tensor    # (K, W) bf16
    m: int
    pad: int

    @property
    def K(self) -> int:
        return self.thi.shape[1]

    @property
    def nt(self) -> int:
        return self.thi.shape[0] // self.K

    @property
    def W(self) -> int:
        return self.m + 2 * self.pad


def probe_inputs(nt: int, m: int = 4096, K: int = 128, pad: int = 64,
                 seed: int = 0, device="cuda:0") -> Probe:
    """Seeded inputs on ``device`` (the card unless the caller asks for the
    CPU; raises without one) at the script's shapes (m = 4096, K = 128,
    PAD = 64 by default): c0 uniform in [-1, 1], thi standard normal and tlo 2^-8 of
    that scale, both rounded to bf16; d1, d2 uniform in [-1, 1] and b1, b2
    their bf16 roundings (as the script derives b from d, :187-188)."""
    device = require_device(device)
    rng = np.random.default_rng(seed)
    W = m + 2 * pad

    def dev(a, dtype=torch.float32):
        return torch.as_tensor(a.astype(np.float32), device=device).to(dtype)

    d1 = dev(rng.uniform(-1, 1, (K, W)))
    d2 = dev(rng.uniform(-1, 1, (K, W)))
    return Probe(c0=dev(rng.uniform(-1, 1, (nt * 8, W))),
                 thi=dev(rng.standard_normal((nt * K, K)), torch.bfloat16),
                 tlo=dev(rng.standard_normal((nt * K, K)) / 256, torch.bfloat16),
                 d1=d1, d2=d2, b1=d1.to(torch.bfloat16), b2=d2.to(torch.bfloat16),
                 m=m, pad=pad)


def angle_scale(m: int) -> float:
    """float32(-pi/m), the factor of the table's f32 angle."""
    return float(np.float32(-np.pi / m))


def dmf_table(p: Probe):
    """(cos, sin) planes (K, W) of dmf[k, w] = exp(-i*pi/m * ((k*(w - PAD))
    mod 2m)), the angle formed in f32 (exp_kparts.py:82-87)."""
    dev = p.c0.device
    k = torch.arange(p.K, device=dev)[:, None]
    r = torch.remainder(k * (torch.arange(p.W, device=dev)[None, :] - p.pad), 2 * p.m)
    ang = torch.tensor(angle_scale(p.m), dtype=torch.float32, device=dev) * r.float()
    return torch.cos(ang), torch.sin(ang)


def _tables(variant: str, p: Probe):
    """(s1, s2, b1, b2) of a variant: the f32 table planes and the bf16
    operands of the products (as f32)."""
    if variant not in VARIANTS:
        raise ValueError(f"variant must be one of {VARIANTS}, got {variant!r}")
    if variant == "tables":
        return p.d1, p.d2, p.b1.float(), p.b2.float()
    s1, s2 = dmf_table(p)
    return s1, s2, s1.to(torch.bfloat16).float(), s2.to(torch.bfloat16).float()


def _dots(p: Probe, b: torch.Tensor) -> torch.Tensor:
    """(thi@b + thi@b) + tlo@b per tile: (nt, K, W).  The bf16 products
    are exact in f32; the sums run in f32."""
    th = p.thi.float().view(p.nt, p.K, p.K)
    tl = p.tlo.float().view(p.nt, p.K, p.K)
    with fp32_matmul():
        return (th @ b + th @ b) + tl @ b


def product_scale(variant: str, p: Probe) -> float:
    """max |thi@b + thi@b + tlo@b| over both planes: the size of the f32
    sums whose rounding bounds the dots, full and tables probes (the
    window convolution cancels most of it in the output)."""
    _, _, b1, b2 = _tables(variant, p)
    return max(_dots(p, b).abs().max().item() for b in (b1, b2))


def kparts_reference(variant: str, p: Probe):
    """The kernel's plain version: the (o1, o2) planes, (nt*K, m) f32."""
    m, pad, nt, K, W = p.m, p.pad, p.nt, p.K, p.W
    s1, s2, b1, b2 = _tables(variant, p)
    if variant == "store":
        return (s1[:, pad:pad + m].repeat(nt, 1), s2[:, pad:pad + m].repeat(nt, 1))

    if variant == "dots":
        return tuple(_dots(p, b)[:, :, pad:pad + m].reshape(nt * K, m) for b in (b1, b2))
    c = p.c0.view(nt, 8, W)
    cr, ci = c[:, 0:1], c[:, 1:2]
    aux = (cr * s1 - ci * s2, cr * s2 + ci * s1)
    if variant != "vpu":
        aux = (_dots(p, b1) + aux[0], _dots(p, b2) + aux[1])

    def conv(a):
        return (0.5 * a[:, :, pad:pad + m]
                + -0.25 * (a[:, :, pad - 1:pad + m - 1] + a[:, :, pad + 1:pad + m + 1]))

    return tuple(conv(a).reshape(nt * K, m) for a in aux)


def _check(p: Probe) -> None:
    dev = p.c0.device
    if dev.type != "cuda":
        raise ValueError(f"the CUDA kernels need CUDA tensors, got {dev}")
    K, nt, W = p.K, p.nt, p.W
    if K % 16 or not 16 <= K <= 128:
        raise ValueError(f"K must be a multiple of 16 in [16, 128] (the tensor-core "
                         f"tiles are 16 deep and a block holds 128 rows), got {K}")
    if p.pad < 1 or p.m < 1 or nt < 1:
        raise ValueError(f"need m >= 1, pad >= 1 and one tile or more, got m={p.m}, "
                         f"pad={p.pad}, nt={nt}")
    if K * W >= 2 ** 31:
        raise ValueError(f"K * (m + 2 pad) = {K * W} overflows the table's 32-bit index")
    for name, t, shape, dtype in (
            ("c0", p.c0, (nt * 8, W), torch.float32),
            ("thi", p.thi, (nt * K, K), torch.bfloat16),
            ("tlo", p.tlo, (nt * K, K), torch.bfloat16),
            ("d1", p.d1, (K, W), torch.float32), ("d2", p.d2, (K, W), torch.float32),
            ("b1", p.b1, (K, W), torch.bfloat16), ("b2", p.b2, (K, W), torch.bfloat16)):
        if (t.dtype != dtype or tuple(t.shape) != shape or not t.is_contiguous()
                or t.device != dev or t.data_ptr() % 32):
            raise ValueError(f"{name}: need contiguous 32-byte aligned {dtype} "
                             f"{shape} on {dev}, got {t.dtype} {tuple(t.shape)} "
                             f"on {t.device}")


def tile_splits(nt: int, m: int, wave: int) -> int:
    """How many blocks share a column span's nt tiles, so that the grid
    (spans x splits) is one wave of ``wave`` resident blocks or less.  Raises
    when m has more spans than a wave has blocks."""
    spans = -(-m // BLOCK_COLS)
    if spans > wave:
        raise ValueError(f"m={m} has {spans} spans of {BLOCK_COLS} columns, more than "
                         f"the {wave} blocks of one wave")
    return max(1, min(nt, wave // spans, 65535))


def tile_range(split: int, nt: int, splits: int) -> range:
    """The tiles block (span, split) walks (csrc/kparts.cu: t0, t1)."""
    return range(split * nt // splits, (split + 1) * nt // splits)


def wave_blocks(variant: str, p: Probe) -> int:
    """Resident blocks of the variant's instantiation on the card: SMs times
    blocks per SM."""
    per_sm = library().sdft_kparts_occupancy(BODIES[variant], int(variant == "tables"),
                                             p.m, p.K)
    if per_sm < 1:
        raise RuntimeError(f"kparts {variant}: no block fits an SM at m={p.m}, K={p.K}")
    return per_sm * torch.cuda.get_device_properties(p.c0.device).multi_processor_count


def launch_kparts(variant: str, p: Probe):
    """Launch the probe kernel on CUDA tensors; returns (o1, o2)."""
    if variant not in VARIANTS:
        raise ValueError(f"variant must be one of {VARIANTS}, got {variant!r}")
    _check(p)
    dev = p.c0.device
    o1 = torch.empty((p.nt * p.K, p.m), dtype=torch.float32, device=dev)
    o2 = torch.empty_like(o1)
    tables = variant == "tables"
    with torch.cuda.device(dev):
        splits = tile_splits(p.nt, p.m, wave_blocks(variant, p))
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = library().sdft_kparts_launch(
            p.c0.data_ptr(), p.thi.data_ptr(), p.tlo.data_ptr(),
            *((p.d1.data_ptr(), p.d2.data_ptr(), p.b1.data_ptr(), p.b2.data_ptr())
              if tables else (None,) * 4),
            o1.data_ptr(), o2.data_ptr(), p.m, p.K, p.pad, p.nt, BODIES[variant],
            angle_scale(p.m), splits, stream)
    check(err, "sdft_kparts_launch")
    LAUNCHES["tables" if tables else "make"] += 1
    return o1, o2


def kparts(variant: str, p: Probe):
    """One probe: the plain version on CPU tensors, the kernel on CUDA."""
    if p.c0.device.type == "cpu":
        return kparts_reference(variant, p)
    return launch_kparts(variant, p)
