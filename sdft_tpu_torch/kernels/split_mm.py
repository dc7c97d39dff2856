"""The split products of the "high" and "split4" matmul classes
(``Precision.passes``) on the card's bf16 tensor cores.

Counterpart of the TPU matrix unit's multi-pass dot, which has no Pallas
source: ``lax.Precision.HIGH`` on the JAX package's float32 contractions,
and its ``_dot4`` (sdft_tpu/ops/lti.py:242-263).  A float32 activation
``a`` (rows, K) and a table ``b`` split once on the host into masked bf16
halves (``Split``, ``split_mask``) give

    passes = 3:  (hh + hl) + lh
    passes = 4:  (hh + hl) + (lh + ll)

with hh = a.hi @ b.hi, hl = a.hi @ b.lo, and so on, each product summed in
float32.  The kernel (csrc/split_mm.cu) splits ``a`` in registers with
``split_mask``'s integer operations, runs each product into its own
float32 accumulators and writes the output once: no split activation,
partial product or sum of them goes through device memory, except the
split-K partial sums of the shapes whose output tiles would fill less
than half the card.  ``out`` given, the finished sum is added to it
(out + v, the plain version's order).

On a CPU tensor the wrapper runs the plain version (``split_mm_reference``:
float32 matmuls of the bf16 halves, each elementwise product exact in
float32, summed in the same order); on a CUDA tensor it launches the
kernel or raises.  ``LAUNCHES`` counts the kernel's launches, a graph's
replays included (``graphs``).
"""

from __future__ import annotations

import functools
import math
from typing import NamedTuple

import torch

from ..config import fp32_matmul
from ._build import check, library

#: the kernel's output tile (csrc/split_mm.cu: BM, BN) and K step (BK)
TILE_M, TILE_N, TILE_K = 64, 64, 32
#: least K a split-K chunk takes
MIN_CHUNK = 256

#: launches of the CUDA kernel (the plain version does not count)
LAUNCHES = 0
#: the launch counters a graph's replay adds to, by name (``graphs``)
COUNTERS = {"split_mm": "LAUNCHES"}


class Split(NamedTuple):
    """A float32 operand as two bf16 halves, hi + lo (``split_mask``)."""

    hi: torch.Tensor
    lo: torch.Tensor

    @property
    def shape(self) -> torch.Size:
        return self.hi.shape

    def map(self, fn) -> "Split":
        """``fn`` applied to both halves (slicing a table)."""
        return Split(fn(self.hi), fn(self.lo))


def split_mask(a: torch.Tensor) -> Split:
    """Masked bf16 hi + lo split of float32 ``a`` (counterpart of
    ``sdft_tpu.ops.lti._split_mask`` and ``_bf16_split_host``): hi is
    ``a`` with 0x8000 added to its bit pattern and the low half-word
    masked off, so the dropped half is rounded to nearest and a carry runs
    into the exponent; lo = (a - hi) rounded to bf16.  Integer operations
    on an int32 view, not a round trip through bfloat16, give hi."""
    a = a.to(torch.float32)
    hi = ((a.view(torch.int32) + 0x8000) & -0x10000).view(torch.float32)
    return Split(hi.to(torch.bfloat16), (a - hi).to(torch.bfloat16))


def _check_passes(passes: int) -> None:
    if passes not in (3, 4):
        raise ValueError(f"passes must be 3 or 4, got {passes}")


def split_mm_reference(a: torch.Tensor, b: Split, passes: int,
                       out: torch.Tensor | None = None) -> torch.Tensor:
    """The kernel's plain version: float32 (rows, N), added to ``out`` in
    place when given."""
    _check_passes(passes)
    x = split_mask(a)

    def d(u, v):
        return u.float() @ v.float()

    with fp32_matmul():
        hh, hl, lh = d(x.hi, b.hi), d(x.hi, b.lo), d(x.lo, b.hi)
        v = (hh + hl) + (lh + d(x.lo, b.lo)) if passes == 4 else (hh + hl) + lh
    return v if out is None else out.add_(v)


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


@functools.lru_cache(maxsize=8)
def _sms(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def k_chunks(rows: int, K: int, N: int, sms: int) -> tuple:
    """(splits, chunk): one chunk of all K where the output tiles fill at
    least half of the ``sms`` multiprocessors; else K cut into chunks of a
    multiple of TILE_K, at least MIN_CHUNK, until the blocks fill them
    once."""
    tiles = _cdiv(rows, TILE_M) * _cdiv(N, TILE_N)
    want = 1 if 2 * tiles >= sms else max(1, min(_cdiv(sms, tiles), K // MIN_CHUNK))
    chunk = _cdiv(_cdiv(K, want), TILE_K) * TILE_K
    return _cdiv(K, chunk), chunk


def _aligned(*ts) -> bool:
    return all(t.data_ptr() % 16 == 0 for t in ts)


def launch_split_mm(a: torch.Tensor, b: Split, passes: int,
                    out: torch.Tensor | None = None) -> torch.Tensor:
    """Launch the kernel once on CUDA tensors: a (rows, K) float32, b's
    halves (K, N) bf16, all contiguous on one card; returns out (rows, N)
    float32, a new tensor or ``out`` with the sum added."""
    global LAUNCHES
    _check_passes(passes)
    dev = a.device
    if a.dtype != torch.float32 or a.ndim != 2 or not a.is_contiguous():
        raise ValueError(f"a: need a contiguous 2-d float32 tensor, got {a.dtype} "
                         f"{tuple(a.shape)}")
    rows, K = a.shape
    for h in b:
        if (h.dtype != torch.bfloat16 or h.ndim != 2 or h.shape[0] != K
                or h.shape != b.hi.shape or not h.is_contiguous() or h.device != dev):
            raise ValueError(f"b: need contiguous bf16 halves ({K}, N) on {dev}, got "
                             f"{h.dtype} {tuple(h.shape)} on {h.device}")
    N = b.hi.shape[1]
    if out is None:
        out = torch.empty((rows, N), dtype=torch.float32, device=dev)
        accumulate = 0
    elif (out.dtype != torch.float32 or tuple(out.shape) != (rows, N)
          or not out.is_contiguous() or out.device != dev):
        raise ValueError(f"out: need contiguous float32 ({rows}, {N}) on {dev}, got "
                         f"{out.dtype} {tuple(out.shape)} on {out.device}")
    else:
        accumulate = 1
    splits, chunk = k_chunks(rows, K, N, _sms(dev))
    ws = (torch.empty((splits, passes, rows, N), dtype=torch.float32, device=dev)
          if splits > 1 else None)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = library().sdft_split_mm_launch(
            a.data_ptr(), b.hi.data_ptr(), b.lo.data_ptr(), out.data_ptr(),
            None if ws is None else ws.data_ptr(), rows, K, N, passes, splits, chunk,
            accumulate, int(K % 4 == 0 and _aligned(a)),
            int(N % 8 == 0 and _aligned(b.hi, b.lo)), stream)
    check(err, "sdft_split_mm_launch")
    LAUNCHES += 1
    return out


def split_mm(a: torch.Tensor, b: Split, passes: int,
             out: torch.Tensor | None = None) -> torch.Tensor:
    """a @ b in the ``passes``-product split class: the plain version on a
    CPU tensor, the kernel on a CUDA tensor."""
    if a.device.type == "cpu":
        return split_mm_reference(a, b, passes, out)
    return launch_split_mm(a, b, passes, out)


def launch_split_mask(a: torch.Tensor) -> Split:
    """The kernel's own split of a CUDA float32 tensor (the device function
    the products use), for holding its halves to ``split_mask``'s."""
    if a.dtype != torch.float32 or not a.is_contiguous() or a.device.type != "cuda":
        raise ValueError("a: need a contiguous float32 CUDA tensor")
    hi = torch.empty(a.shape, dtype=torch.bfloat16, device=a.device)
    lo = torch.empty_like(hi)
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        err = library().sdft_split_mask_launch(a.data_ptr(), hi.data_ptr(), lo.data_ptr(),
                                               math.prod(a.shape), stream)
    check(err, "sdft_split_mask_launch")
    return Split(hi, lo)
