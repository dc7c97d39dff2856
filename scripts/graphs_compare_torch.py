"""Another version's port (eager) against this tree's, eager and graphed,
on the chained paths, in turns on one card.

    git archive <commit> sdft_tpu_torch | tar -x -C local/old
    mv local/old/sdft_tpu_torch local/old/sdft_tpu_torch_old
    python scripts/graphs_compare_torch.py local/old

Prints wall ms per block between CUDA events in turns (other, eager,
graphed, graphed, eager, other) and device ms per block (profiler) for
the collapsed round trip (m=4096, 65536 samples), the hop=100 driver
(m=1000, 8 x 16000) and the hop=1 driver through K2 (m=1000, 8 x 8000).
Needs a card.
"""

import contextlib
import pathlib
import subprocess
import sys

import numpy as np
import torch

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))


def cells(P, x, dev) -> dict:
    big = P.Plan(4096, window="hann", precision=P.FAST_PRECISION)
    drv = P.Plan(1000, window="hann", precision=P.FAST_PRECISION)
    sb, sd = P.init_state(big, device=dev), P.init_state(drv, device=dev)
    return {"roundtrip 1x65536 m=4096": (lambda: P.roundtrip(big, sb, x[:65536]), 1),
            "hop=100 8x16000 m=1000": (
                lambda: P.roundtrip_hopped(drv, sd, x.reshape(8, 16000), 100), 8),
            "hop=1 8x8000 m=1000": (
                lambda: P.roundtrip_hopped(drv, sd, x[:64000].reshape(8, 8000), 1), 8)}


def main(other: str) -> int:
    sys.path.insert(0, str(pathlib.Path(other).resolve()))
    import sdft_tpu_torch as T
    import sdft_tpu_torch_old as O
    from sdft_tpu_torch import graphs
    from sdft_tpu_torch.profiling import device_time, wall_time

    dev = torch.device("cuda", 0)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip()
    print(card, torch.__version__, flush=True)
    x = torch.as_tensor(np.random.default_rng(0).standard_normal(8 * 16000).clip(-1, 1)
                        .astype(np.float32), device=dev)
    theirs, ours = cells(O, x, dev), cells(T, x, dev)

    def run(who, label, measure):
        call, nb = (theirs if who == "other" else ours)[label]
        with graphs.disabled() if who == "eager" else contextlib.nullcontext():
            return measure(call) / nb

    for label in ours:
        walls = {}
        for who in ("other", "eager", "graphed", "graphed", "eager", "other"):
            walls.setdefault(who, []).append(run(who, label, lambda c: wall_time(c, 10, 2)))
        for who, v in walls.items():
            d = run(who, label, lambda c: device_time(c, 3, 1))
            print(f"{label} {who}: wall {'/'.join(f'{t:.4f}' for t in v)} ms per block, "
                  f"device {d:.4f} ms per block [{card}]", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1]))
