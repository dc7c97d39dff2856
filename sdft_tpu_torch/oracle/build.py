"""Lazy build of the native oracle shared libraries.

Compiles the native engines under sdft_tpu_torch/native/ with the system toolchain
on first use and caches each .so next to the source (rebuilt when the source
is newer).  No external build-system dependency.

Two engines exist so the differential triangle has three independently
written corners (reference: test/main.py:67-79 cross-checks three
implementations): ``native`` is the C++17 integer-exponent-phase engine,
``native2`` the C99 bin-major phasor-recurrence engine.
"""

from __future__ import annotations

import os
import pathlib
import subprocess
import threading

NATIVE_DIR = pathlib.Path(__file__).resolve().parent.parent / "native"

#: engine name -> (compiler env var, default compiler, source, std flag) —
#: honoring $CC/$CXX keeps this ctypes build path consistent with the
#: Makefile's toolchain overrides.
_ENGINES = {
    "native": ("CXX", "g++", "sdft_native.cpp", "-std=c++17"),
    "native2": ("CC", "gcc", "sdft_native2.c", "-std=c99"),
}

SOURCE = NATIVE_DIR / _ENGINES["native"][2]
LIBRARY = NATIVE_DIR / "_build" / "libsdft_native.so"

_lock = threading.Lock()


def ensure_library(engine: str = "native") -> pathlib.Path:
    """Compile the named engine if missing or stale; return the .so path."""
    env_var, default_cc, src_name, std = _ENGINES[engine]
    compiler = os.environ.get(env_var, default_cc)
    source = NATIVE_DIR / src_name
    library = NATIVE_DIR / "_build" / f"libsdft_{engine}.so"
    with _lock:
        if library.exists() and library.stat().st_mtime >= source.stat().st_mtime:
            return library
        library.parent.mkdir(parents=True, exist_ok=True)
        # -ffast-math matches the reference's own build flags
        # (test/CMakeLists.txt:38-44, cpp/examples/bench.cmake:12-17) and is
        # ~8x faster: without it every complex multiply goes through the
        # __muldc3 NaN-checking libcall.  Differential tolerances (1e-7) are
        # far above the reassociation noise this introduces at f64.
        cmd = [
            compiler, "-O3", "-march=native", "-ffast-math", std,
            "-fPIC", "-Wall", "-Wextra", "-shared",
            "-o", str(library), str(source),
        ]
        if engine == "native2":
            cmd.append("-lm")
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(
                f"native oracle build failed:\n{' '.join(cmd)}\n{proc.stderr}"
            )
        return library
