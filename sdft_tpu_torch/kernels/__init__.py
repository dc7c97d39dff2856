"""Hand-written CUDA kernels for Hopper, with their wrappers and plain
PyTorch versions: K1 (``spectra``), K2 (``scan``), the probes of K1's
parts (``kparts``) and the split classes' products (``split_mm``)."""

from .scan import forward_and_y, forward_and_y_reference, roundtrip_block_fused
from .spectra import (forward_block, forward_block_power, kernel_supported,
                      spectra_prologue, spectra_reference)

__all__ = [
    "forward_block",
    "forward_block_power",
    "forward_and_y",
    "roundtrip_block_fused",
    "kernel_supported",
    "spectra_prologue",
    "spectra_reference",
    "forward_and_y_reference",
]
