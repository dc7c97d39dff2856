"""Another version's port against this tree's, eager and graphed,
on the chained paths, in turns on one card.

    git archive <commit> sdft_tpu_torch | tar -x -C local/old
    mv local/old/sdft_tpu_torch local/old/sdft_tpu_torch_old
    python scripts/graphs_compare_torch.py local/old

Prints wall ms per block between CUDA events in turns (other eager, eager,
graphed, [other graphed, other graphed,] graphed, eager, other eager; the
other version's graphed turns where it has ``graphs``) and device ms per
block (profiler) for ``sdft`` at m=4096 (planar f32 and bf16 on 65536
samples, planar f32 on 8 x 32768: the prologue's graph and one K1 launch),
the collapsed round trip (m=4096, 65536 samples), the hop=100 driver
(m=1000, 8 x 16000) and the hop=1 driver through K2 (m=1000, 8 blocks of
8000, and 8 blocks of 8 channels x 8000), and each call's peak memory
above its inputs, graphed and eager.  Needs a card.
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
    sd8 = P.init_state(drv, channels=8, device=dev)
    sb8 = P.init_state(big, channels=8, device=dev)
    return {"sdft planar f32 1x65536 m=4096": (lambda: P.sdft(big, sb, x[:65536], "planar"), 1),
            "sdft planar bf16 1x65536 m=4096": (
                lambda: P.sdft(big, sb, x[:65536], "planar", "bfloat16"), 1),
            "sdft planar f32 8x32768 m=4096": (
                lambda: P.sdft(big, sb8, x[:262144].reshape(8, 32768), "planar"), 1),
            "roundtrip 1x65536 m=4096": (lambda: P.roundtrip(big, sb, x[:65536]), 1),
            "hop=100 8x16000 m=1000": (
                lambda: P.roundtrip_hopped(drv, sd, x[:128000].reshape(8, 16000), 100), 8),
            "hop=1 8x8000 m=1000": (
                lambda: P.roundtrip_hopped(drv, sd, x[:64000].reshape(8, 8000), 1), 8),
            "hop=1 8x8x8000 m=1000": (
                lambda: P.roundtrip_hopped(drv, sd8, x.reshape(8, 8, 8000), 1), 8)}


def main(other: str) -> int:
    sys.path.insert(0, str(pathlib.Path(other).resolve()))
    import sdft_tpu_torch as T
    import sdft_tpu_torch_old as O
    from sdft_tpu_torch.profiling import device_time, wall_time

    dev = torch.device("cuda", 0)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip()
    print(card, torch.__version__, flush=True)
    x = torch.as_tensor(np.random.default_rng(0).standard_normal(8 * 64000).clip(-1, 1)
                        .astype(np.float32), device=dev)
    theirs, ours = cells(O, x, dev), cells(T, x, dev)
    # the other version's own graphs, where it has them, run as it would;
    # "eager" disables a version's graphs
    order = ["other eager", "eager", "graphed", "graphed", "eager", "other eager"]
    if getattr(O, "graphs", None) is not None:
        order[3:3] = ["other graphed", "other graphed"]

    def run(who, label, measure, per_block=True):
        pkg, table = (O, theirs) if who.startswith("other") else (T, ours)
        call, nb = table[label]
        graphs = getattr(pkg, "graphs", None)
        off = who.endswith("eager") and graphs is not None
        with graphs.disabled() if off else contextlib.nullcontext():
            return measure(call) / (nb if per_block else 1)

    for label in ours:
        walls = {}
        for who in order:
            walls.setdefault(who, []).append(run(who, label, lambda c: wall_time(c, 10, 2)))
        for who, v in walls.items():
            d = run(who, label, lambda c: device_time(c, 3, 1))
            peak = run(who, label, peak_mib, per_block=False)
            print(f"{label} {who}: wall {'/'.join(f'{t:.4f}' for t in v)} ms per block, "
                  f"device {d:.4f} ms per block, peak {peak:.1f} MiB above the inputs "
                  f"[{card}]", flush=True)
    for pkg, who in ((O, "other"), (T, "this")):
        graphs = getattr(pkg, "graphs", None)
        for e in graphs.entries() if graphs is not None else ():
            print(f"{who} graph {e.name}: pool +{e.pool_bytes / 2**20:.1f} MiB", flush=True)
    return 0


def peak_mib(call) -> float:
    """Peak device memory one call allocates above what was allocated before
    it (a graph's pool included in the latter), in MiB."""
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    out = call()
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    del out
    return peak / 2**20


if __name__ == "__main__":
    sys.exit(main(sys.argv[1]))
