"""Precision configuration (counterpart of ``sdft_tpu.config``).

Time-domain (TD) and frequency-domain (FD) precision are independently
configurable (reference: c/src/sdft/sdft.h:21-37).  PyTorch has float64 on
the CPU and on the GPU, so ``resolve()`` is the identity here.

``mxu`` names the float32 matmul class, as in the JAX package:

  * "highest": true FP32 products (TF32 off) — the class that meets the
    reference's 1e-7 DFT gate;
  * "high": TF32 tensor-core products (about 10 mantissa bits);
  * "split4": the JAX package's throughput mode (``Precision.split4``):
    in the collapsed round trip, and in the driver's synthesis, both GEMM
    operands are split into masked bf16 hi + lo halves and the four cross
    products are summed in float32 (``ops.lti._dot4``).  On the card each
    product is a bf16 tensor-core GEMM with float32 output, so the operands
    keep about 16 bits, not TF32's 10 (ROADMAP queue 1, item 5).  Every
    other matmul of a split4 plan is true FP32, as in the JAX package,
    whose other programs read split4 as HIGHEST.

``fp32_matmul`` sets ``torch.backends.cuda.matmul.allow_tf32`` for the
duration of the port's float32 matmuls, and ``bf16_products`` clears
``allow_bf16_reduced_precision_reduction`` for split4's bf16 products;
both restore the caller's value.
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
    def allow_tf32(self) -> bool:
        """Whether float32 matmuls may use TF32 ("high" only)."""
        return self.mxu == "high"

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
def fp32_matmul(precision: Precision):
    """Run the enclosed float32 matmuls in the plan's class: true FP32 for
    "highest" and "split4", TF32 for "high".  Restores the caller's flag."""
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = precision.allow_tf32
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved


@contextlib.contextmanager
def bf16_products():
    """Keep cuBLAS's bf16 GEMMs from reducing in bf16 (split4's products
    sum in float32).  Restores the caller's flag."""
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
