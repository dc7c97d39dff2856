"""Ranks of ``sdft_tpu_torch.parallel`` on a Gloo CPU mesh, for
tests/test_torch_sharded.py and tests/test_torch_cli.py.

    python tests/helpers/torch_sharded_worker.py CxTxB inputs.npz results.npz
    python tests/helpers/torch_sharded_worker.py CxTxB --graphs results.npz
    python tests/helpers/torch_sharded_worker.py CxTxB --spans trace.json
    python tests/helpers/torch_sharded_worker.py CxTxB --cli <CLI arguments>

spawns C*T*B ranks (``torch.multiprocessing.spawn``).  Each joins one Gloo
process group through a file in a fresh temporary directory (no TCP port,
so concurrent runs cannot collide) and makes the ('channel', 'time',
'bins') mesh on the CPU.  The first form runs every case of ``cases`` on
the inputs and rank 0 writes each output, gathered whole, to results.npz
under "<case>/<name>"; a case that raises on purpose stores the message.
The second runs each case of ``GRAPH_CASES`` twice on every rank, graphed
through the CPU stand-in capture backend (tests/helpers/graph_stub.py:
each replay runs the rank's body, its Gloo collectives included, again)
and eagerly (``graphs.disabled()``), on inputs it makes itself, and rank 0
writes per case whether any output differed on any rank, the graphs
captured and their capture modes.  The third runs ``SPANS_CASE`` graphed
through the stand-in backend under the CPU profiler on every rank, and
rank 0 exports its Chrome trace (the port's ``sdft.*`` spans among its
events).  The fourth runs the port's CLI on every rank (``--mesh CxTxB
--device cpu`` among its arguments).  This module
imports numpy, torch and sdft_tpu_torch only: the test imports it for the
inputs and the case list.
"""

from __future__ import annotations

import os
import sys
import tempfile

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

#: the meshes of tests/test_sharded.py:27-32, and one more bins=1 mesh for
#: the kernel programs
MESHES = [(1, 1, 8), (1, 8, 1), (2, 2, 2), (1, 2, 4), (2, 4, 1)]


def mesh_id(axes) -> str:
    return "x".join(map(str, axes))


def _signal(c, n, seed, scale=1.0):
    return (np.random.default_rng(seed).standard_normal((c, n)) * scale).clip(-1, 1)


def make_inputs(axes) -> dict:
    """Every case's inputs for a mesh, made from fixed seeds."""
    nc, nt, _ = axes
    rng = np.random.default_rng(2)
    inp = {
        "sdft": _signal(2, 2 * 512, 0),
        "lti": _signal(2 * nc, 3 * max(2 * 32 * nt, 256), 7),
        "scan": _signal(2, 2 * 128, 3),
        "isdft": (rng.standard_normal((2, 128, 32)) + 1j * rng.standard_normal((2, 128, 32))) / 32,
        "hopped": _signal(2, 2 * 512, 31),
        "degenerate": _signal(2, 2 * 256, 41),
        "fallback": _signal(nc, 2 * 12 * nt, 43),
        "driver": _signal(2, 3 * 256, 33).reshape(2, 3, 256).transpose(1, 0, 2).copy(),
        "driver_h4": _signal(nc, 2 * 128, 34).reshape(nc, 2, 128).transpose(1, 0, 2).copy(),
        "transform": np.clip(np.random.default_rng(21).standard_normal((2, 2 * 384)), -3, 3) / 2,
        "short_lti": _signal(nc, 3 * 16 * nt, 23),
        "short_scan": _signal(2, 2 * 32 * nt, 29),
        "short_hopped": _signal(nc, 32 * nt, 37),
        "kernel": _signal(2, 2 * 2048, 9, 0.25).astype(np.float32),
        "kernel_y": _signal(2, 2 * 2048, 11, 0.25).astype(np.float32),
    }
    inp["isdft"] = np.stack([inp["isdft"].real, inp["isdft"].imag], axis=-1)
    return inp


# -- the cases: name -> (meshes it runs on, function) -------------------------------
#
# A function gets (T, par, mesh, axes, inp) and returns {name: output}; an
# output is a tensor, a DTensor, a State or a tuple of tensors.

def _f64(T, m, **kw):
    return T.Plan(m, precision=T.Precision("float64", "float64"), **kw)


def _f32(T, m, **kw):
    return T.Plan(m, precision=T.Precision("float32", "float32"), **kw)


def _high(T, m, **kw):
    return T.Plan(m, precision=T.Precision("float32", "float32", mxu="high"), **kw)


def _init(T, plan, C):
    return T.init_state(plan, channels=C, device="cpu")


def _blocks(x, n):
    M = x.shape[-1] // n
    return [x[..., b * M:(b + 1) * M] for b in range(n)]


def _sdft(window):
    def run(T, par, mesh, axes, inp):
        plan = _f64(T, 32, window=window)
        st = _init(T, plan, 2)
        out = {}
        for b, blk in enumerate(_blocks(inp["sdft"], 2)):
            st, out[f"d{b}"] = par.sharded_sdft(plan, mesh, st, blk)
            out[f"st{b}"] = st
        if window == "hann":
            # the State sdft_tpu's program left after block 0, continued here
            jst = T.State(*(inp[f"jax_st0/{k}"] for k in ("offset", "delayline", "accumulator")))
            out["st_cont"], out["d_cont"] = par.sharded_sdft(plan, mesh, jst,
                                                             _blocks(inp["sdft"], 2)[1])
        return out
    return run


def _roundtrip(window, make_plan=_f64):
    def run(T, par, mesh, axes, inp):
        plan = make_plan(T, 32, window=window)
        st = _init(T, plan, inp["lti"].shape[0])
        out = {}
        for b, blk in enumerate(_blocks(inp["lti"], 3)):
            st, out[f"y{b}"] = par.sharded_roundtrip(plan, mesh, st, blk)
        out["st"] = st
        return out
    return run


def _roundtrip_scan(T, par, mesh, axes, inp):
    plan = _f64(T, 32)
    st = _init(T, plan, 2)
    out = {}
    for b, blk in enumerate(_blocks(inp["scan"], 2)):
        st, out[f"y{b}"] = par.sharded_roundtrip(plan, mesh, st, blk, collapsed=False)
    out["st"] = st
    return out


def _isdft(latency):
    def run(T, par, mesh, axes, inp):
        return {"y": par.sharded_isdft(_f64(T, 32, latency=latency), mesh, inp["isdft"])}
    return run


def _hopped(key, m, hop, nblocks, window="hann", make_plan=_f64):
    def run(T, par, mesh, axes, inp):
        plan = make_plan(T, m, window=window)
        x = inp[key]
        st = _init(T, plan, x.shape[0])
        out = {}
        for b, blk in enumerate(_blocks(x, nblocks)):
            st, out[f"d{b}"] = par.sharded_sdft_hopped(plan, mesh, st, blk, hop)
        out["st"] = st
        return out
    return run


def _driver(key, hop, refresh_every, window="hann", make_plan=_f64):
    def run(T, par, mesh, axes, inp):
        plan = make_plan(T, 32, window=window)
        xs = inp[key]
        st, hd, ys = par.sharded_roundtrip_hopped(plan, mesh, _init(T, plan, xs.shape[1]), xs,
                                                  hop, refresh_every=refresh_every)
        return {"hd": hd, "ys": ys, "st": st}
    return run


def _mesh_lowpass(z, bins):
    return z * (bins < 48)


def _transform(T, par, mesh, axes, inp):
    plan = _f64(T, 96)
    st = _init(T, plan, 2)
    out = {}
    for b, blk in enumerate(_blocks(inp["transform"], 2)):
        st, out[f"y{b}"] = par.sharded_roundtrip(plan, mesh, st, blk, transform=_mesh_lowpass)
    out["st"] = st
    return out


def _short_lti(T, par, mesh, axes, inp):
    plan = _f64(T, 32)
    st = _init(T, plan, axes[0])
    out = {}
    for b, blk in enumerate(_blocks(inp["short_lti"], 3)):
        st, out[f"y{b}"] = par.sharded_roundtrip(plan, mesh, st, blk)
    out["st"] = st
    return out


def _short_scan(T, par, mesh, axes, inp):
    plan = _f64(T, 32, window="hamming")
    st = _init(T, plan, 2)
    out = {}
    for b, blk in enumerate(_blocks(inp["short_scan"], 2)):
        st, out[f"d{b}"] = par.sharded_sdft(plan, mesh, st, blk)
    out["st"] = st
    return out


def _kernel_sdft(T, par, mesh, axes, inp):
    plan = _f32(T, 256, window="hann")
    st = _init(T, plan, 2)
    out = {}
    blocks = _blocks(inp["kernel"], 2)
    for b, blk in enumerate(blocks):
        st, out[f"d{b}"] = par.sharded_sdft_pallas(plan, mesh, st, blk)
        out[f"st{b}"] = st
    _, out["planar"] = par.sharded_sdft_pallas(plan, mesh, _init(T, plan, 2), blocks[0],
                                               layout="planar")
    _, out["bf16"] = par.sharded_sdft_pallas(plan, mesh, _init(T, plan, 2), blocks[0],
                                             layout="planar", spectra_dtype="bfloat16")
    return out


def _kernel_roundtrip(T, par, mesh, axes, inp):
    plan = _f32(T, 256, window="hann")
    st = _init(T, plan, 2)
    out = {}
    for b, blk in enumerate(_blocks(inp["kernel_y"], 2)):
        st, out[f"d{b}"], out[f"y{b}"] = par.sharded_roundtrip_pallas(plan, mesh, st, blk)
        out[f"st{b}"] = st
    return out


def _errors(T, par, mesh, axes, inp):
    """Each refused layout: the message, or "" where the call ran."""
    nc, nt, nb = axes
    plan = _f64(T, 32)
    calls = {
        "channels": lambda: par.sharded_sdft(plan, mesh, _init(T, plan, 3), np.zeros((3, 128))),
        "time": lambda: par.sharded_sdft(plan, mesh, _init(T, plan, 2), np.zeros((2, 8 * 16 + 1))),
        "bins": lambda: par.sharded_sdft(_f64(T, 33), mesh, _init(T, _f64(T, 33), 2),
                                         np.zeros((2, 128))),
        "kernel_bins": lambda: par.sharded_sdft_pallas(_f32(T, 256), mesh,
                                                       _init(T, _f32(T, 256), 2),
                                                       np.zeros((2, 256), np.float32)),
        "kernel_y_bins": lambda: par.sharded_roundtrip_pallas(_f32(T, 256), mesh,
                                                              _init(T, _f32(T, 256), 2),
                                                              np.zeros((2, 256), np.float32)),
        "kernel_plan": lambda: par.sharded_sdft_pallas(plan, mesh, _init(T, plan, 2),
                                                       np.zeros((2, 128))),
        "hop": lambda: par.sharded_sdft_hopped(plan, mesh, _init(T, plan, 2),
                                               np.zeros((2, 24 * nt)), 16),
    }
    if nb >= 4:  # one bin per shard, inside Hann's halo (a plan needs m >= 3)
        calls["halo"] = lambda: par.sharded_roundtrip(_f64(T, nb), mesh, _init(T, _f64(T, nb), 2),
                                                      np.zeros((2, 128)))
    out = {}
    for name, call in calls.items():
        try:
            call()
            out[name] = ""
        except ValueError as e:
            out[name] = str(e)
    return out


def _bins1(axes):
    return axes[2] == 1


CASES = {
    "sdft_hann": (None, _sdft("hann")),
    "sdft_blackman": (None, _sdft("blackman")),
    "roundtrip_hann": (None, _roundtrip("hann")),
    "roundtrip_blackman": (None, _roundtrip("blackman")),
    "roundtrip_scan": (None, _roundtrip_scan),
    "isdft_lat1": (None, _isdft(1.0)),
    "isdft_lat05": (None, _isdft(0.5)),
    "hopped": (None, _hopped("hopped", 32, 16, 2)),
    "hopped_h1": (None, _hopped("degenerate", 32, 1, 2)),
    "hopped_h2": (None, _hopped("degenerate", 32, 2, 2)),
    "hopped_h4": (None, _hopped("degenerate", 32, 4, 2)),
    "hopped_fallback": (None, _hopped("fallback", 16, 4, 2)),
    "hopped_blackman_short": (None, _hopped("short_hopped", 32, 8, 1, "blackman")),
    "driver_refresh": (None, _driver("driver", 16, 1)),
    "driver_no_refresh": (None, _driver("driver", 16, None)),
    "driver_h4": (None, _driver("driver_h4", 4, 1, "hamming")),
    "transform": (None, _transform),
    "short_lti": (None, _short_lti),
    "short_scan": (None, _short_scan),
    "kernel_sdft": (_bins1, _kernel_sdft),
    "kernel_roundtrip": (_bins1, _kernel_roundtrip),
    "errors": (None, _errors),
    # mxu="high" (the three-pass split class), held to the unsharded calls
    "high_roundtrip": (None, _roundtrip("hann", _high)),
    "high_hopped": (None, _hopped("hopped", 32, 16, 2, make_plan=_high)),
    "high_hopped_h4": (None, _hopped("degenerate", 32, 4, 2, make_plan=_high)),
    "high_driver": (None, _driver("driver", 16, 1, make_plan=_high)),
    "high_driver_h4": (None, _driver("driver_h4", 4, 1, "hamming", make_plan=_high)),
}


def cases(axes) -> list:
    """The names of the cases that run on a mesh."""
    return [n for n, (where, _) in CASES.items() if where is None or where(axes)]


#: the stand-in graph mode's meshes (one bins-sharded, one time-sharded) and
#: cases: every public program, the scan and transform round trips, and
#: local blocks shorter than 2m (the comb history's all_gather)
GRAPH_MESHES = [(1, 2, 4), (2, 4, 1)]
GRAPH_CASES = ("sdft_blackman", "roundtrip_hann", "roundtrip_scan", "isdft_lat05",
               "hopped_h4", "driver_refresh", "transform", "short_lti", "kernel_sdft",
               "kernel_roundtrip")


def graph_cases(axes) -> list:
    return [n for n in cases(axes) if n in GRAPH_CASES]


# -- the ranks --------------------------------------------------------------------

def _numpy(v):
    """A case output as {suffix: numpy array}, gathered whole."""
    import torch
    from torch.distributed.tensor import DTensor

    from sdft_tpu_torch import State

    def arr(t):
        if isinstance(t, DTensor):
            t = t.full_tensor()
        if isinstance(t, str):
            return np.array(t)
        t = torch.as_tensor(t)
        return (t.float() if t.dtype == torch.bfloat16 else t).numpy()

    if isinstance(v, State):
        return {f"/{k}": arr(a) for k, a in zip(State._fields, v)}
    if isinstance(v, tuple):
        return {f"/{i}": arr(a) for i, a in enumerate(v)}
    return {"": arr(v)}


def _join(rank: int, world: int, init: str):
    import torch.distributed as dist

    from sdft_tpu_torch.parallel import multihost

    multihost.initialize(init, world, rank, device_type="cpu")
    return dist


def _outputs(T, par, mesh, axes, inp, name) -> dict:
    return {f"{key}{suffix}": a
            for key, v in CASES[name][1](T, par, mesh, axes, inp).items()
            for suffix, a in _numpy(v).items()}


def _cases_rank(rank: int, axes, init: str, inputs: str, results: str):
    import torch

    import sdft_tpu_torch as T
    from sdft_tpu_torch import parallel as par

    torch.set_num_threads(1)
    dist = _join(rank, int(np.prod(axes)), init)
    mesh = par.make_mesh(*axes, device_type="cpu")
    with np.load(inputs) as f:
        inp = {k: f[k] for k in f.files}
    out = {}
    for name in cases(axes):
        out.update({f"{name}/{k}": a for k, a in _outputs(T, par, mesh, axes, inp, name).items()})
    if rank == 0:
        np.savez(results, **out)
    dist.barrier()
    dist.destroy_process_group()


def _graphs_rank(rank: int, axes, init: str, results: str):
    import graph_stub
    import torch

    import sdft_tpu_torch as T
    from sdft_tpu_torch import graphs
    from sdft_tpu_torch import parallel as par

    torch.set_num_threads(1)
    dist = _join(rank, int(np.prod(axes)), init)
    mesh = par.make_mesh(*axes, device_type="cpu")
    inp = make_inputs(axes)
    out = {}
    for name in graph_cases(axes):
        with graph_stub.installed() as stub:
            graphed = _outputs(T, par, mesh, axes, inp, name)
            names = sorted({e.name for e in graphs.entries()})
        with graphs.disabled():
            eager = _outputs(T, par, mesh, axes, inp, name)
        differ = torch.tensor([float(graphed.keys() != eager.keys() or any(
            not np.array_equal(graphed[k], eager[k]) for k in graphed))])
        dist.all_reduce(differ, op=dist.ReduceOp.MAX)
        out[f"{name}/differ"] = differ.numpy()
        out[f"{name}/graphs"] = np.array(names)
        out[f"{name}/modes"] = np.array(sorted(set(stub.modes)))
    if rank == 0:
        np.savez(results, **out)
    dist.barrier()
    dist.destroy_process_group()


#: the case whose spans the third mode traces: a kernel program
SPANS_CASE = "kernel_sdft"


def _spans_rank(rank: int, axes, init: str, results: str):
    import graph_stub
    import torch
    from torch.profiler import ProfilerActivity, profile

    import sdft_tpu_torch as T
    from sdft_tpu_torch import parallel as par

    torch.set_num_threads(1)
    dist = _join(rank, int(np.prod(axes)), init)
    mesh = par.make_mesh(*axes, device_type="cpu")
    inp = make_inputs(axes)
    with graph_stub.installed():
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            _outputs(T, par, mesh, axes, inp, SPANS_CASE)
    if rank == 0:
        prof.export_chrome_trace(results)
    dist.barrier()
    dist.destroy_process_group()


def _cli_rank(rank: int, axes, init: str, args: list):
    import torch

    from sdft_tpu_torch.cli import main

    torch.set_num_threads(1)
    dist = _join(rank, int(np.prod(axes)), init)
    if main(args) != 0:
        raise RuntimeError(f"rank {rank}: the CLI failed")
    dist.barrier()
    dist.destroy_process_group()


def main(argv) -> int:
    import torch.multiprocessing as mp

    sys.path.insert(0, REPO)
    axes = tuple(int(a) for a in argv[0].split("x"))
    with tempfile.TemporaryDirectory() as tmp:
        init = f"file://{os.path.join(tmp, 'group')}"
        if argv[1] == "--cli":
            mp.spawn(_cli_rank, args=(axes, init, argv[2:]), nprocs=int(np.prod(axes)))
        elif argv[1] == "--graphs":
            mp.spawn(_graphs_rank, args=(axes, init, argv[2]), nprocs=int(np.prod(axes)))
        elif argv[1] == "--spans":
            mp.spawn(_spans_rank, args=(axes, init, argv[2]), nprocs=int(np.prod(axes)))
        else:
            mp.spawn(_cases_rank, args=(axes, init, argv[1], argv[2]), nprocs=int(np.prod(axes)))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
