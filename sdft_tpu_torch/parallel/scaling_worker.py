"""One process of ``profiling.measure_scaling_proxy``, on the CPU.

    python -m sdft_tpu_torch.parallel.scaling_worker single <cores> <out.json> <m> <block>
        the marginal time of ``ops.lti.roundtrip_block_lti`` over the whole
        global block (1 x block), in one process;
    python -m sdft_tpu_torch.parallel.scaling_worker pair <cores> <rank> <init URL> <out.json> <m> <block>
        one of two Gloo ranks on a (1, 2, 1) mesh: the marginal time of
        ``parallel.sharded_roundtrip`` over the same global block, every
        collective crossing the process boundary; rank 0 writes the result.

``cores`` is a comma-separated core list the process pins itself to, with
as many torch threads.  Both modes read the same seeded blocks, so
t_single / (2 * t_pair) is a strong-scaling efficiency.
"""

from __future__ import annotations

import json
import os
import sys

import torch


def main(argv) -> int:
    from ..config import FAST_PRECISION
    from ..plan import Plan
    from ..profiling import _blocks, benchmark_marginal
    from ..state import init_state

    mode, cores = argv[0], [int(c) for c in argv[1].split(",")]
    os.sched_setaffinity(0, cores)
    torch.set_num_threads(len(cores))
    if mode == "single":
        from ..ops.lti import roundtrip_block_lti

        out, m, block = argv[2], int(argv[3]), int(argv[4])
        plan = Plan(m, window="hann", precision=FAST_PRECISION)
        res = benchmark_marginal(lambda st, x: roundtrip_block_lti(plan, st, x),
                                 init_state(plan, channels=1, device="cpu"),
                                 _blocks(12, 1, block, "cpu"), repeats=3)
        rank = 0
    elif mode == "pair":
        import torch.distributed as dist

        from . import make_mesh, multihost, sharded_roundtrip

        rank, url, out = int(argv[2]), argv[3], argv[4]
        m, block = int(argv[5]), int(argv[6])
        multihost.initialize(url, 2, rank, device_type="cpu")
        try:
            mesh = make_mesh(1, 2, 1, device_type="cpu")
            plan = Plan(m, window="hann", precision=FAST_PRECISION)

            def step(st, x):
                st, y = sharded_roundtrip(plan, mesh, st, x)
                return st, y.to_local()

            res = benchmark_marginal(step, init_state(plan, channels=1, device="cpu"),
                                     _blocks(12, 1, block, "cpu"), repeats=3)
        finally:
            dist.destroy_process_group()
    else:
        raise SystemExit(f"unknown mode {mode!r}: single or pair")
    print(f"{mode} rank {rank}: {res['seconds'] * 1e3:.3f} ms/block", flush=True)
    if rank == 0:
        with open(out, "w") as f:
            json.dump({"seconds": res["seconds"]}, f)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
