"""sdft_tpu_torch — the sliding-DFT framework of ``sdft_tpu`` in PyTorch,
with hand-written CUDA kernels for NVIDIA Hopper.

Same ``Plan``/``State`` semantics and return layouts as ``sdft_tpu``; the
two packages exchange plans (``plan_from_jax``) and checkpoints
(``state_to_arrays``/``state_from_arrays``).  This package imports torch
and numpy, never jax.
"""

from .api import (isdft, isdft_interleaved, refresh, roundtrip, roundtrip_hopped,
                  sdft, sdft_hopped, sdft_interleaved, sdft_power)
from .config import DEFAULT_PRECISION, FAST_PRECISION, Precision
from .cplx import from_complex, to_complex
from .kernels import kernel_supported
from .plan import Plan, plan_from_jax
from .state import State, init_state, reset_state, state_from_arrays, state_to_arrays
from .windows import Window

__version__ = "0.1.0"

__all__ = [
    "Plan",
    "State",
    "Window",
    "Precision",
    "DEFAULT_PRECISION",
    "FAST_PRECISION",
    "sdft",
    "sdft_power",
    "isdft",
    "refresh",
    "roundtrip",
    "roundtrip_hopped",
    "sdft_hopped",
    "sdft_interleaved",
    "isdft_interleaved",
    "kernel_supported",
    "to_complex",
    "from_complex",
    "init_state",
    "reset_state",
    "state_to_arrays",
    "state_from_arrays",
    "plan_from_jax",
    "__version__",
]
