"""Build the split-product kernel (csrc/split_mm.cu) on a card and run
chip_smoke.py's checks and timings of it alone: ptxas's report, the
kernel's split bit for bit ``split_mask``'s, every shape of the main path
(profiling.SPLIT_MM_SHAPES) and the ragged ones with three and four
products against the plain version (2e-6 of scale; each beside the
float64 sum of the same products), then the times beside the bound,
cuBLAS's bf16 GEMMs summed the same way and torch.mm in FP32.

    python scripts/split_mm_check_torch.py [--no-time]

The short first call after an edit of csrc/split_mm.cu (about 50 s with
the build); it exits non-zero when a check fails.
"""

import pathlib
import sys

import torch

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

import chip_smoke as C  # noqa: E402
from sdft_tpu_torch.kernels import _build  # noqa: E402


def main(argv) -> int:
    card = C.require_cuda()
    print(card, flush=True)
    C.print_ptxas(_build.build().with_suffix(".log"))
    lib = _build.library()
    print(f"resident blocks per SM: passes 3 {lib.sdft_split_mm_occupancy(3)}, "
          f"passes 4 {lib.sdft_split_mm_occupancy(4)}", flush=True)
    dev = torch.device("cuda", 0)
    C.split_mm_vs_plain(dev)
    if "--no-time" not in argv:
        C.split_mm_timings(dev, card)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
