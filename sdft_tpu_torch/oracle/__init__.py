"""The native oracle: two independently written CPU engines (C++17 and
C99) of the reference's per-sample recursion, built from the port's own
sources under ``sdft_tpu_torch/native/`` and bound through ctypes."""

from .build import ensure_library
from .oracle import NativeSDFT, NativeSDFT2

__all__ = ["NativeSDFT", "NativeSDFT2", "ensure_library"]
