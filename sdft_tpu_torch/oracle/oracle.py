"""ctypes binding for the native C++ oracle engine.

The oracle mirrors the reference's native cores (c/src/sdft/sdft.h,
cpp/src/sdft/sdft.h) as the framework's golden CPU implementation: exact
integer-exponent phases, double-precision FD math, per-sample recursion.
Used for differential testing of the port (scripts/crosscheck_torch.py); it
loads no array library besides numpy.
"""

from __future__ import annotations

import ctypes

import numpy as np

from ..windows import Window
from .build import ensure_library

_WINDOW_CODE = {
    Window.BOXCAR: 0,
    Window.HANN: 1,
    Window.HAMMING: 2,
    Window.BLACKMAN: 3,
}

_libs: dict = {}


def _load(engine: str, prefix: str):
    if engine not in _libs:
        lib = ctypes.CDLL(str(ensure_library(engine)))
        fns = {}
        for name, restype, argtypes in [
            ("create", ctypes.c_void_p,
             [ctypes.c_int64, ctypes.c_int32, ctypes.c_double, ctypes.c_int32]),
            ("destroy", None, [ctypes.c_void_p]),
            ("reset", None, [ctypes.c_void_p]),
            ("sdft", None,
             [ctypes.c_void_p, ctypes.c_int64,
              ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_double)]),
            ("isdft", None,
             [ctypes.c_void_p, ctypes.c_int64,
              ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_double)]),
        ]:
            fn = getattr(lib, prefix + name)
            fn.restype = restype
            fn.argtypes = argtypes
            fns[name] = fn
        # extended-FD constructor (engine #1 only): fd_bits 64 | 80
        if hasattr(lib, prefix + "create_fd"):
            fn = getattr(lib, prefix + "create_fd")
            fn.restype = ctypes.c_void_p
            fn.argtypes = [ctypes.c_int64, ctypes.c_int32, ctypes.c_double,
                           ctypes.c_int32, ctypes.c_int32]
            fns["create_fd"] = fn
        _libs[engine] = fns
    return _libs[engine]


class NativeSDFT:
    """Stateful native-engine handle with the reference class API shape."""

    _ENGINE = "native"
    _PREFIX = "sdft_oracle_"

    def __init__(self, dftsize: int, window="hann", latency: float = 1.0,
                 td_bits: int = 32, fd_bits: int = 64):
        """td_bits=32 matches the reference TD default (float); 64 for
        all-double.  fd_bits=80 selects the extended-precision FD tier
        (x86 long double) mirroring the reference's third dtype tier
        (SDFT_FD_* long double, c/src/sdft/sdft.h:21-37,101-125)."""
        self._fns = _load(self._ENGINE, self._PREFIX)
        self.size = int(dftsize)
        self.window = Window.parse(window)
        self.latency = float(latency)
        if fd_bits not in (64, 80):
            raise ValueError(f"fd_bits must be 64 or 80, got {fd_bits}")
        if fd_bits == 64:
            self._h = self._fns["create"](
                self.size, _WINDOW_CODE[self.window], self.latency, td_bits)
        elif "create_fd" in self._fns:
            self._h = self._fns["create_fd"](
                self.size, _WINDOW_CODE[self.window], self.latency, td_bits,
                fd_bits)
        else:
            raise ValueError(
                f"engine {self._ENGINE!r} has no fd_bits={fd_bits} tier")
        if not self._h:
            raise ValueError(f"oracle rejected dftsize {dftsize}")

    def __del__(self):
        h = getattr(self, "_h", None)
        if h:
            self._fns["destroy"](h)
            self._h = None

    def reset(self) -> None:
        self._fns["reset"](self._h)

    def sdft(self, samples) -> np.ndarray:
        x = np.ascontiguousarray(np.atleast_1d(samples), dtype=np.float64)
        out = np.empty((x.size, self.size), dtype=np.complex128)
        self._fns["sdft"](
            self._h, x.size,
            x.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_double)))
        return out

    def isdft(self, dfts) -> np.ndarray:
        d = np.ascontiguousarray(np.atleast_2d(dfts), dtype=np.complex128)
        if d.shape[1] != self.size:
            raise ValueError(f"expected (n, {self.size}), got {d.shape}")
        y = np.empty(d.shape[0], dtype=np.float64)
        self._fns["isdft"](
            self._h, d.shape[0],
            d.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
            y.ctypes.data_as(ctypes.POINTER(ctypes.c_double)))
        return y


class NativeSDFT2(NativeSDFT):
    """Second, independently written native engine (C99, bin-major phasor
    recurrence — sdft_tpu_torch/native/sdft_native2.c).  Same API; exists so the
    differential triangle has three independent corners like the
    reference's C <-> C++ <-> Python cross-check (test/main.py:67-79)."""

    _ENGINE = "native2"
    _PREFIX = "sdft_oracle2_"
