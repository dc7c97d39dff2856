"""The control of a cell: the reference put in the program's place in the
next precision below the configuration's (``reference.Control``), run on
the cell's own stream and compared with the float64 reference exactly as
a run compares the program.  Its readings are the upper readings the
limits in ``limits/<cell>.json`` are set below.

    python3 -m benchmark.control --workload <cell> --seeds 1,2,3 --block <b>

streams blocks 0..b-1 of each seed's stream (``b``: about the block a
run checks) and prints one JSON line per seed.  A mesh cell's control runs
on one card, shard by shard.  The benchmark's own runs never run it.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import torch


def _outputs(ctl, cell) -> dict:
    """The control's reader of each output the cell's entry returns
    (``entries/<entry>.py``'s ``OUTPUTS``, named as ``checks.compare``
    reads them): ``Control`` has a method of each name, and the hop
    spectra are its spectra at every hop's first sample."""
    from . import spec as spec_

    got = {}
    for name in spec_.entry(cell.traffic["entry"]).OUTPUTS:
        if name == "hop_spectra":
            hop = int(cell.config["hop"])
            got.update(hop=hop, hop_spectra=lambda j: ctl.spectra(j * hop))
        else:
            got[name] = getattr(ctl, name)
    return got


def readings(cell, seed: int, b: int, device) -> dict:
    """The numbers ``checks.compare`` gives the control in block ``b`` of
    the cell's stream.  On a mesh that shards time the control stands where
    each rank's program stands: every time shard of a block rebuilds its
    carry from the 2m samples before it (``parallel.sharded``'s refresh
    identity), so the control streams the shards' sub-blocks, rebuilding
    at each, and each shard of block ``b`` is compared as its rank's is."""
    from . import checks, harness, reference

    C, L = int(cell.config["channels"]), harness.block_length(cell)
    T = cell.mesh[1]
    Lr = L // T
    stream = harness.Stream(seed, harness.make_pool(seed, int(cell.traffic["pool_blocks"]),
                                                   C, L, device))

    def sub(k: int) -> torch.Tensor:
        j = k % T
        return stream.block(k // T)[:, j * Lr:(j + 1) * Lr]

    spec = harness.ref_spec(cell.config)
    refresh = 1 if T > 1 else cell.config.get("refresh_every")
    xext = torch.cat([stream.history(b, spec.n2), stream.block(b)], dim=1).double()
    after = ((b + 1) * L) % spec.n2
    numbers: dict = {}
    for d in range(T):
        ctl = reference.Control(spec, sub, Lr, b * T + d, refresh)
        xr = xext[:, d * Lr:d * Lr + spec.n2 + Lr]
        got = _outputs(ctl, cell)
        for k, v in checks.compare(spec, xr, got, after).items():
            numbers[k] = max(numbers.get(k, v), v)
    # the state after the block, from the last shard once its outputs are done
    numbers.update(checks.compare(spec, xr, {"state": ctl.state()}, after))
    return numbers


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m benchmark.control")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--block", type=int, required=True)
    args = ap.parse_args(argv)
    from . import spec as spec_

    cell = spec_.cell(args.workload)
    if not torch.cuda.is_available():
        print("benchmark.control: needs a card", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        nums = readings(cell, seed, args.block, dev)
        print(json.dumps({"workload": args.workload, "seed": seed, "block": args.block,
                          "control": nums, "limits": cell.limits,
                          "seconds": time.perf_counter() - t0,
                          "card": torch.cuda.get_device_name(0)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
