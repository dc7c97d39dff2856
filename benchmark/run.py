"""Run one cell of ``BENCHMARK.json`` once, on the card:

    python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  It prints the card's name, power limit and
clocks (``nvidia-smi``) first, then, as its last lines on standard error,
each number compared with the reference beside its limit, and as the last
line of standard output one JSON object: ``correct``, ``attempted``,
``failed``, ``metrics`` (the cell's end-to-end metrics with ``--trace
0``, its per-layer metrics with ``--trace 1``), ``device`` (with
``--trace 1`` also ``busy_s`` and ``window_s``, and ``breakdown``), and
last ``checks``.  Without a card, or with fewer cards than the cell asks
for, it exits with 2 and prints no result; it exits with 1 and prints no
result if JAX or the JAX package was loaded.
"""

from __future__ import annotations

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402


def card_line() -> str:
    """The cards' name, power limit and clocks by nvidia-smi."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=index,name,power.limit,clocks.sm,clocks.max.sm,"
             "clocks.mem,temperature.gpu", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30)
        return " | ".join(out.stdout.strip().splitlines()) or out.stderr.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi not available: {e}"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m benchmark.run")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from . import harness, spec

    harness.cache_dirs(spec.ROOT)
    import torch

    cell = spec.cell(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"benchmark: {args.workload} needs {cell.chips} CUDA card(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    print(f"card: {card_line()}", flush=True)
    if cell.world > 1:
        from sdft_tpu_torch.kernels import _build

        _build.build()      # once, before the ranks start
    res = harness.run(args.workload, args.seed, args.seconds, bool(args.trace),
                      t_process=T_PROCESS, cell=cell)
    bad = harness.forbidden_modules()
    if bad:
        print(f"benchmark: loaded in the run's process: {bad}", file=sys.stderr)
        return 1
    line = json.dumps(res, allow_nan=False)
    print(f"correct: {res['correct']}", file=sys.stderr)
    for name, c in res["checks"].items():
        print(f"check {name}: {c['value']!r} limit {c['limit']!r} "
              f"{'ok' if c['value'] <= c['limit'] else 'FAILS'}", file=sys.stderr, flush=True)
    print(line, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
