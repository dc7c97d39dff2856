"""Precision configuration (counterpart of ``sdft_tpu.config``).

Time-domain (TD) and frequency-domain (FD) precision are independently
configurable (reference: c/src/sdft/sdft.h:21-37).  PyTorch has float64 on
the CPU and on the GPU, so ``resolve()`` is the identity here.

``mxu`` names the float32 matmul class, as in the JAX package.  Both split
classes apply on float32 FD plans only; float64 and float32x2 plans ignore
them.  A split operand is a pair of masked bf16 halves, hi + lo
(``kernels.split_mm.split_mask``), and each split product runs on the
card's bf16 tensor cores with float32 accumulators in one hand-written
kernel (``kernels.split_mm``), which splits the activations in registers:

  * "highest": true FP32 products, the class that meets the reference's
    1e-7 DFT gate;
  * "high": the JAX package's three-pass class (``lax.Precision.HIGH``):
    the products hh, hl and lh of the split operands, summed in float32 as
    (hh + hl) + lh, about 16 bits of each operand.  It applies exactly
    where the JAX package reads ``mxu_precision``: the collapsed round
    trip's totals and synthesis, the driver's totals, stepped partial
    totals and synthesis at every hop above 1, ``sdft_hopped``, and the
    same contractions in each rank of the sharded programs;
  * "split4": the JAX package's throughput mode (``Precision.split4``):
    the four cross products, summed as (hh + hl) + (lh + ll), in the
    collapsed round trip and in the driver's synthesis only.  Every other
    matmul of a split4 plan, the sharded programs' included, is true FP32,
    as the JAX package's other programs read split4 as HIGHEST.

Every other float32 matmul of the port (K1's prologue totals, K2's y, the
refresh, ``isdft``, the probes) is true FP32 on every plan, as the JAX
package pins HIGHEST there: ``fp32_matmul`` clears
``torch.backends.cuda.matmul.allow_tf32`` around them and restores the
caller's value.  No matmul of the port runs in TF32.
"""

from __future__ import annotations

import contextlib
import dataclasses

import torch

_REAL_DTYPES = ("float32", "float64")
#: FD-only extended tier (double-word float32 pairs, ``ops.twofloat``):
#: ``sdft``/``isdft`` run it; every other entry point treats it as float32.
_FD_DTYPES = _REAL_DTYPES + ("float32x2",)

_TORCH_DTYPES = {"float32": torch.float32, "float64": torch.float64,
                 "float32x2": torch.float32}
_COMPLEX_DTYPES = {"float32": torch.complex64, "float64": torch.complex128,
                   "float32x2": torch.complex64}


@dataclasses.dataclass(frozen=True)
class Precision:
    """Time-domain / frequency-domain dtype pair (see ``sdft_tpu.config``)."""

    td: str = "float32"
    fd: str = "float64"
    mxu: str = "highest"

    def __post_init__(self):
        if self.td not in _REAL_DTYPES:
            raise ValueError(f"unsupported td dtype {self.td!r}; pick from {_REAL_DTYPES}")
        if self.fd not in _FD_DTYPES:
            raise ValueError(f"unsupported fd dtype {self.fd!r}; pick from {_FD_DTYPES}")
        if self.mxu not in ("highest", "high", "split4"):
            raise ValueError(f"unsupported mxu mode {self.mxu!r}; "
                             f"pick 'highest', 'high' or 'split4'")

    def resolve(self) -> "Precision":
        """Identity: torch has float64 on every device the port targets."""
        return self

    @property
    def extended(self) -> bool:
        """True for the double-word FD tier (fd="float32x2")."""
        return self.fd == "float32x2"

    @property
    def split4(self) -> bool:
        """Whether the collapsed round trip and the driver's synthesis take
        the split bf16 products: "split4" on a float32 FD plan (float64
        and float32x2 plans ignore the mode, as in the JAX package)."""
        return self.mxu == "split4" and self.fd == "float32"

    @property
    def high(self) -> bool:
        """Whether the contractions where the JAX package reads
        ``mxu_precision`` take the three-pass split products: "high" on a
        float32 FD plan."""
        return self.mxu == "high" and self.fd == "float32"

    @property
    def passes(self) -> int:
        """bf16 products per split contraction: 3 for "high", 4 for
        "split4" (float32 FD plans), 0 where every product is exact FP32."""
        return 3 if self.high else 4 if self.split4 else 0

    @property
    def td_dtype(self) -> torch.dtype:
        return _TORCH_DTYPES[self.td]

    @property
    def fd_dtype(self) -> torch.dtype:
        return _TORCH_DTYPES[self.fd]

    @property
    def fdx_dtype(self) -> torch.dtype:
        return _COMPLEX_DTYPES[self.fd]


@contextlib.contextmanager
def fp32_matmul():
    """Run the enclosed float32 matmuls as true FP32 (TF32 off), whatever
    the caller set.  Restores the caller's flag."""
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved


@contextlib.contextmanager
def bf16_products():
    """Keep cuBLAS's bf16 GEMMs from reducing in bf16.  The port runs no
    cuBLAS bf16 GEMM; ``profiling.cublas_split_mm``, the yardstick
    chip_smoke.py times ``split_mm`` against (one bf16 GEMM with float32
    output per product), runs under it.  Restores the caller's flag."""
    saved = torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = saved


#: Reference-parity default: float TD, double FD (c/src/sdft/sdft.h:101-118).
DEFAULT_PRECISION = Precision(td="float32", fd="float64")

#: GPU fast path: everything in float32 / complex64.
FAST_PRECISION = Precision(td="float32", fd="float32")
