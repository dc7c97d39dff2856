"""Where a tile's time goes inside the probe kernel, by the kernel's own
clocks (the card's machine has no kernel profiler).

    python scripts/kparts_clocks_torch.py [variant ...]     (default: dots full)

Builds csrc/kparts.cu with -DSDFT_KPARTS_CLOCKS into a library of its own,
launches each variant at 512 tiles (m = 4096, K = 128, PAD = 64) and prints,
for each plane's warpgroup, the mean SM cycles per tile its warps spent
before the products (the carry rows' loads), waiting for a stage of the
ring, issuing wgmma, waiting for wgmma and in the epilogue, with the card's
name and power limit.  The clocks cost a few cycles per phase; the launch's
time is printed beside the uninstrumented library's.
"""

import ctypes
import pathlib
import subprocess
import sys

import torch

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

from sdft_tpu_torch import profiling  # noqa: E402
from sdft_tpu_torch.kernels import _build, kparts as P  # noqa: E402

PHASES = ("before", "wait stage", "issue wgmma", "wait wgmma", "epilogue")


def build_clocked() -> ctypes.CDLL:
    """The probe kernel alone, with its phase clocks compiled in."""
    out = _build.BUILD_DIR / "clocks"
    out.mkdir(parents=True, exist_ok=True)
    so = str(out / "libkparts_clocks.so")
    _build._run([_build.nvcc(), *_build.FLAGS, "-DSDFT_KPARTS_CLOCKS", "-shared", "-o", so,
                 str(_build.CSRC / "kparts.cu")])
    lib = ctypes.CDLL(so)
    for name in ("sdft_kparts_launch", "sdft_kparts_occupancy"):
        fn = getattr(lib, name)
        fn.argtypes = list(_build.SIGNATURES[name])
        fn.restype = ctypes.c_int
    lib.sdft_kparts_clocks.argtypes = [ctypes.c_void_p]
    lib.sdft_kparts_clocks.restype = ctypes.c_int
    return lib


def main(argv) -> int:
    if not torch.cuda.is_available():
        raise RuntimeError("kparts_clocks needs a CUDA device")
    variants = argv or ["dots", "full"]
    dev = torch.device("cuda", 0)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip()
    print(card, flush=True)
    plain_lib, clocked = P.library(), build_clocked()
    nt = 512
    p = P.probe_inputs(nt, seed=3, device=dev)
    for v in variants:
        plain_ms = profiling.wall_time(lambda: P.launch_kparts(v, p), 5, 2)
        P.library = lambda: clocked
        try:
            splits = P.tile_splits(nt, p.m, P.wave_blocks(v, p))
            blocks = -(-p.m // P.BLOCK_COLS) * splits
            buf = torch.zeros((blocks, 8, len(PHASES)), dtype=torch.int64, device=dev)
            _build.check(clocked.sdft_kparts_clocks(buf.data_ptr()), "sdft_kparts_clocks")
            P.launch_kparts(v, p)
            torch.cuda.synchronize()
            _build.check(clocked.sdft_kparts_clocks(None), "sdft_kparts_clocks")
            clocked_ms = profiling.wall_time(lambda: P.launch_kparts(v, p), 5, 2)
        finally:
            P.library = lambda: plain_lib
        per_tile = buf.double() / (nt / splits)
        print(f"kparts {v} nt={nt}: {blocks} blocks of {nt // splits} tiles; {plain_ms:.4f} ms "
              f"per launch, {clocked_ms:.4f} ms with the clocks compiled in [{card}]", flush=True)
        for g in (0, 1):
            mean = per_tile[:, 4 * g:4 * g + 4].mean(dim=(0, 1)).tolist()
            print(f"  plane {g}, cycles per tile: "
                  + ", ".join(f"{n} {c:.0f}" for n, c in zip(PHASES, mean))
                  + f"; total {sum(mean):.0f}", flush=True)
        totals = per_tile.sum(-1).mean(1)
        print(f"  blocks' totals: {totals.min().item():.0f} to {totals.max().item():.0f} cycles "
              f"per tile", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
