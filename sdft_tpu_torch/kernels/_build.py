"""Build and load the CUDA kernels.

The sources under ``csrc/`` are compiled by ``nvcc``, one process per
source, all started together, and linked into one shared library with a
plain C interface, loaded through ``ctypes``.  The build runs at first use
and again whenever a source or the flags change: the library's file name
carries a hash of both.  A failed build raises with nvcc's output; nothing
falls back.  The build goes to ``_build/`` beside this file, together with
a log of ptxas's register and shared-memory report for each kernel.
"""

from __future__ import annotations

import concurrent.futures
import ctypes
import functools
import hashlib
import os
import pathlib
import re
import shutil
import subprocess
import tempfile

CSRC = pathlib.Path(__file__).resolve().parent / "csrc"
BUILD_DIR = pathlib.Path(__file__).resolve().parent / "_build"
SOURCES = ("spectra.cu", "scan.cu", "kparts.cu", "split_mm.cu")
HEADERS = ("common.cuh",)
ARCH = ("-gencode", "arch=compute_90a,code=sm_90a")
FLAGS = ARCH + ("-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_L = ctypes.c_longlong
#: C signatures of the entry points (csrc/spectra.cu, scan.cu, kparts.cu,
#: split_mm.cu)
SIGNATURES = {
    "sdft_spectra_launch": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                            _F, _F, _F, _I, _I, _I, _I, _P),
    "sdft_scan_launch": (_P, _P, _P, _P, _P, _P, _P, _I, _P, _I, _I, _I, _I, _I, _I,
                         _F, _F, _F, _I, _I, _F, _I, _I, _P),
    "sdft_kparts_launch": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                           _I, _F, _I, _P),
    "sdft_split_mm_launch": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _P),
    "sdft_split_mask_launch": (_P, _P, _P, _L, _P),
    "sdft_spectra_occupancy": (_I,),
    "sdft_scan_occupancy": (_I,),
    "sdft_kparts_occupancy": (_I, _I, _I, _I),
    "sdft_split_mm_occupancy": (_I,),
}


def nvcc() -> str:
    """Path of the CUDA compiler: $CUDA_HOME/bin/nvcc, then
    /usr/local/cuda/bin/nvcc, then the PATH."""
    for home in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if home and os.access(os.path.join(home, "bin", "nvcc"), os.X_OK):
            return os.path.join(home, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels build only on a "
                           "machine with the CUDA toolkit")
    return found


def library_path() -> pathlib.Path:
    """Where the library for the current sources and flags lives."""
    h = hashlib.sha256(" ".join(FLAGS).encode())
    for name in SOURCES + HEADERS:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    return BUILD_DIR / f"libsdft_kernels_{h.hexdigest()[:16]}.so"


def _run(cmd: list) -> str:
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}): "
                           f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
    return proc.stdout + proc.stderr


def build() -> pathlib.Path:
    """Compile the library unless it is already built; return its path."""
    out = library_path()
    if out.exists():
        return out
    compiler = nvcc()
    out.parent.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=out.parent) as tmp:
        objs = [os.path.join(tmp, s + ".o") for s in SOURCES]
        cmds = [[compiler, *FLAGS, "-c", str(CSRC / s), "-o", o]
                for s, o in zip(SOURCES, objs)]
        with concurrent.futures.ThreadPoolExecutor(len(cmds)) as pool:
            logs = list(pool.map(_run, cmds))
        lib = os.path.join(tmp, out.name)
        logs.append(_run([compiler, *ARCH, "-shared", "-o", lib, *objs]))
        out.with_suffix(".log").write_text("".join(logs))
        os.replace(lib, out)  # atomic: concurrent builders never see a partial file
    return out


@functools.lru_cache(maxsize=1)
def library() -> ctypes.CDLL:
    """The built library with its C signatures declared."""
    lib = ctypes.CDLL(str(build()))
    for name, args in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = list(args)
        fn.restype = ctypes.c_int
    return lib


def ptxas_report(log: pathlib.Path | None = None):
    """What ptxas said of each kernel in the build log: a list of (mangled
    name, registers, spill-store bytes, spill-load bytes, static shared
    bytes), and the list of its performance remarks."""
    text = (log or library_path().with_suffix(".log")).read_text()
    entries = []
    for block in text.split("Compiling entry function")[1:]:
        name = re.match(r" '(\w+)'", block)
        regs = re.search(r"Used (\d+) registers", block)
        spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", block)
        smem = re.search(r"(\d+) bytes smem", block)
        if name and regs and spill:
            entries.append((name.group(1), int(regs.group(1)), int(spill.group(1)),
                            int(spill.group(2)), int(smem.group(1)) if smem else 0))
    remarks = [ln.strip() for ln in text.splitlines() if "Potential Performance Loss" in ln]
    return entries, remarks


def check(err: int, what: str) -> None:
    """Raise if a launch returned a CUDA error code other than 0."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} (cudaError_t)")
