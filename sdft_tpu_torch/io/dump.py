"""Raw complex128 matrix dump for cross-implementation diffing (a copy of
``sdft_tpu.io.dump``, which cannot be imported without jax).

The reference drivers dump DFT matrices as raw little-endian complex128 for
the comparator to reload with ``np.fromfile`` (reference: test/dump.h:12-28,
test/main.py:46-49).  Same format here so outputs are directly comparable.
"""

from __future__ import annotations

import numpy as np


def dump_complex(path: str, data) -> None:
    np.ascontiguousarray(np.asarray(data), dtype=np.complex128).tofile(path)


def load_complex(path: str, dftsize: int) -> np.ndarray:
    return np.fromfile(path, dtype=np.complex128).reshape(-1, dftsize)
