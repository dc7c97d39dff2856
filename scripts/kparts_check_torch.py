"""Build the probe kernel (csrc/kparts.cu) on a card, print ptxas's report
of each instantiation, hold the five variants against their plain version
at a few shapes (ragged ones included) and time them at 512 tiles.

    python scripts/kparts_check_torch.py [--no-time]

The limits are chip_smoke's: store and vpu 2e-6 abs; dots, full and tables
1e-5 of the products' size.  Times are CUDA events over 5 launches after a
warm-up, beside each variant's bound (profiling.kernel_part_bounds), with
the card's name and power limit.
"""

import pathlib
import re
import subprocess
import sys

import torch

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

from sdft_tpu_torch import profiling  # noqa: E402
from sdft_tpu_torch.kernels import _build, kparts as P  # noqa: E402

SHAPES = ((64, 16, 4, 3), (200, 48, 9, 5), (203, 128, 3, 7), (4096, 128, 64, 4),
          (1000, 128, 64, 37))


def main(argv) -> int:
    if not torch.cuda.is_available():
        raise RuntimeError("kparts_check needs a CUDA device")
    dev = torch.device("cuda", 0)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip()
    print(card, flush=True)
    entries, remarks = _build.ptxas_report(_build.build().with_suffix(".log"))
    for name, regs, st, ld, _ in entries:
        inst = re.match(r"_ZN6kparts13kparts_kernelILi(\d)ELb(\d)ELb(\d)E", name)
        if inst:
            print("ptxas: kparts_kernel<body={}, tables={}, fast={}>: ".format(*inst.groups())
                  + f"{regs} registers, spill {st}/{ld} B", flush=True)
    for line in remarks:
        print(f"ptxas: {line}", flush=True)
    bad = 0
    for m, K, pad, nt in SHAPES + ((4096, 128, 64, 512),):
        p = P.probe_inputs(nt, m, K, pad, seed=5, device=dev)
        for v in P.VARIANTS:
            splits = P.tile_splits(nt, m, P.wave_blocks(v, p))
            got = P.launch_kparts(v, p)
            torch.cuda.synchronize()
            want = P.kparts_reference(v, p)
            limit = 2e-6 if v in ("store", "vpu") else 1e-5 * P.product_scale(v, p)
            err = max((g.double() - w.double()).abs().max().item() for g, w in zip(got, want))
            ok = err <= limit
            bad += not ok
            print(f"m={m} K={K} pad={pad} nt={nt} {v}: splits {splits}, max abs err "
                  f"{err:.3e} (limit {limit:.3e}) {'ok' if ok else 'WRONG'}", flush=True)
            del got, want
    if "--no-time" not in argv:
        p = P.probe_inputs(512, seed=17, device=dev)
        bounds = profiling.kernel_part_bounds(512)
        for v in P.VARIANTS:
            ms = profiling.wall_time(lambda: P.launch_kparts(v, p), 5, 2)
            b_ms, by = bounds[v]
            print(f"timing: kparts {v} nt=512: {ms:.4f} ms, bound {b_ms:.4f} ms ({by}), "
                  f"{b_ms / ms:.1%} of the bound [{card}]", flush=True)
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
