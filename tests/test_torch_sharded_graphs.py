"""The sharded programs under graphs: each rank's body in
``sdft_tpu_torch.parallel.sharded`` replayed as a graph (``graphs``), held
bit for bit against its eager run and against ``sdft_tpu.parallel``.

On the CPU the stand-in capture backend (tests/helpers/graph_stub.py)
"captures" a body by running it and "replays" it by running it again into
the same static outputs, collectives included, so the graph plumbing of
every program runs here:

  * in this process, on a one-rank Gloo mesh, every case of
    tests/helpers/torch_sharded_worker.py (every public program) graphed
    and under ``graphs.disabled()``, bit for bit, and against the JAX
    programs on a one-device mesh at tests/test_torch_sharded.py's gates
    (float64 1e-12 abs, offsets and delaylines exactly; the kernel
    programs' classes);
  * in spawned Gloo ranks, on one bins-sharded and one time-sharded mesh
    (``GRAPH_MESHES``), where every rank replays its collectives inside
    the stand-in graph: graphed against eager, bit for bit.

The ``-m cuda`` tests run the programs on a one-rank NCCL mesh on the card.
"""

import contextlib
import importlib.util
import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

import sdft_tpu_torch as T
from sdft_tpu import parallel as jpar
from sdft_tpu.state import State as JState
from sdft_tpu_torch import graphs
from sdft_tpu_torch import parallel as par
from sdft_tpu_torch.kernels import scan, spectra
from sdft_tpu_torch.parallel import sharded

HERE = os.path.dirname(os.path.abspath(__file__))


def _load(name, path):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


W = _load("torch_sharded_worker", os.path.join(HERE, "helpers", "torch_sharded_worker.py"))
stub = _load("graph_stub", os.path.join(HERE, "helpers", "graph_stub.py"))
#: the JAX side of each case, as tests/test_torch_sharded.py runs it
J = _load("torch_sharded_jax_cases", os.path.join(HERE, "test_torch_sharded.py"))

ONE = (1, 1, 1)
ONE_CASES = [n for n in W.cases(ONE) if n in J.JAX_CASES]
#: seconds one mesh's spawned ranks may take (about 12 s here)
SPAWN_TIMEOUT = 300


def _graph_names(case: str) -> set:
    """The graphs a case's programs replay."""
    if case.startswith("kernel"):
        return {"sharded_kernel_prologue"}
    if case == "transform":
        return {"sharded_forward", "sharded_inverse"}
    for prefix, name in (("sdft", "sharded_forward"), ("short_scan", "sharded_forward"),
                         ("roundtrip_scan", "sharded_roundtrip_scan"),
                         ("roundtrip", "sharded_roundtrip_lti"),
                         ("short_lti", "sharded_roundtrip_lti"),
                         ("isdft", "sharded_inverse"), ("hopped", "sharded_hopped"),
                         ("driver", "sharded_driver_block")):
        if case.startswith(prefix):
            return {name}
    raise KeyError(case)


def _flat(case: str, outs: dict) -> dict:
    return {f"{case}/{key}{suffix}": a for key, v in outs.items()
            for suffix, a in W._numpy(v).items()}


# -- one rank in this process ----------------------------------------------------------

@contextlib.contextmanager
def _one_rank_group():
    """A one-rank Gloo group of this process and its 1x1x1 CPU mesh, for the
    block only (the card's tests below make an NCCL group of their own)."""
    from sdft_tpu_torch.parallel import multihost

    saved = {k: os.environ.pop(k) for k in ("MASTER_ADDR", "WORLD_SIZE") if k in os.environ}
    multihost.initialize(device_type="cpu")
    try:
        yield par.single_device_mesh("cpu")
    finally:
        multihost.shutdown()
        os.environ.update(saved)


@pytest.fixture
def mesh():
    with _one_rank_group() as m:
        yield m


@pytest.fixture(scope="module")
def one_rank():
    """runs(case): (graphed outputs, eager outputs, JAX outputs, graphs
    captured, their capture modes), each case run at its first request."""
    jmesh = jpar.make_mesh(*ONE)
    inp = W.make_inputs(ONE)
    cache = {}

    def get(case):
        if case not in cache:
            want = J._flatten(case, J.JAX_CASES[case](jmesh, ONE, inp))
            if case == "sdft_hann":   # the State the JAX program left after block 0
                inp.update({f"jax_st0/{k}": want[f"sdft_hann/st0/{k}"] for k in JState._fields})
            with _one_rank_group() as mesh:
                with stub.installed() as backend:
                    got = _flat(case, W.CASES[case][1](T, par, mesh, ONE, inp))
                    names = {e.name for e in graphs.entries()}
                with graphs.disabled():
                    eager = _flat(case, W.CASES[case][1](T, par, mesh, ONE, inp))
            cache[case] = (got, eager, want, names, set(backend.modes))
        return cache[case]
    return get


@pytest.mark.parametrize("case", ONE_CASES)
def test_graphed_program_equals_eager_bit_for_bit(one_rank, case):
    """Every output of the case, graphed through the stand-in backend, equals
    its run under ``graphs.disabled()`` bit for bit; the graphs it replayed
    are the program's own, captured in the thread-local mode."""
    got, eager, _, names, modes = one_rank(case)
    assert got.keys() == eager.keys()
    for k in got:
        np.testing.assert_array_equal(got[k], eager[k], err_msg=k)
    assert names == _graph_names(case)
    assert modes == {sharded.CAPTURE_MODE}


@pytest.mark.parametrize("case", ONE_CASES)
def test_graphed_program_matches_jax(one_rank, case):
    """The graphed outputs against the JAX program on a one-device mesh:
    float64 1e-12 abs, offsets and delaylines exactly; the kernel programs
    (K1's and K2's plain versions here) at spectra 5e-6 of max(1, scale),
    accumulators 5e-4, samples 1e-4 (tests/test_torch_sharded.py)."""
    got, _, want, _, _ = one_rank(case)
    keys = sorted(k for k in want if k.startswith(case + "/"))
    assert keys and all(k in got for k in keys), [k for k in keys if k not in got]
    for k in keys:
        g, w = got[k], want[k]
        assert g.shape == w.shape, (k, g.shape, w.shape)
        if k.endswith(("/offset", "/delayline")):
            np.testing.assert_array_equal(g, w, err_msg=k)
        elif not case.startswith("kernel"):
            np.testing.assert_allclose(g, w, atol=1e-12, rtol=0, err_msg=k)
        elif k.endswith("/accumulator"):
            np.testing.assert_allclose(g, w, atol=5e-4, rtol=0, err_msg=k)
        elif re.search(r"/y\d$", k):
            np.testing.assert_allclose(g, w, atol=1e-4, rtol=0, err_msg=k)
        else:
            scale = max(1.0, float(np.abs(w).max()))
            np.testing.assert_allclose(g, w, atol=5e-6 * scale, rtol=0, err_msg=k)


def test_keys_hold_the_coordinates_the_global_block_and_captured_groups(mesh):
    """Two time or bins coordinates give two keys, and so do two global block
    lengths on the same local shapes; a group enters the key only where the
    body captures its collectives (more than one rank on the axis)."""
    ax = sharded._axes(mesh)
    assert ax.key()[3] == (None, None)
    assert ax._replace(nt=2).key()[3] == (id(ax.time), None)
    assert ax._replace(nb=2).key()[3] == (None, id(ax.bins))
    plan = T.Plan(32, precision=T.Precision("float64", "float64"))
    st = T.init_state(plan, channels=1, device="cpu")
    x = torch.as_tensor(W._signal(1, 64, 5))
    with stub.installed() as backend:
        for a in (ax, ax._replace(d=1), ax._replace(b=1)):
            sharded._graphed("probe", a, (plan,), lambda s: s + 1, x)
        assert len(graphs.entries()) == backend.captures == 3
        graphs.clear()
        outs = [sharded._forward(plan, ax, st, x, m_total) for m_total in (64, 96, 64)]
        assert [e.name for e in graphs.entries()] == ["sharded_forward"] * 2
        assert backend.captures == 3 + 2
    # the global block length sets the next offset, (0 + m_total) mod 2m
    assert [int(o[0].offset[0]) for o in outs] == [0, 32, 0]
    assert torch.equal(outs[0][1], outs[1][1]) and torch.equal(outs[0][1], outs[2][1])


@pytest.mark.parametrize("graphed", [True, False], ids=["graphed", "eager"])
def test_driver_chain_writes_each_block_into_stacks_allocated_once(mesh, monkeypatch,
                                                                    graphed):
    """``sharded_roundtrip_hopped`` returns the stacks it allocated before
    its loop (whole, contiguous storages) and stacks no block outputs with
    ``torch.stack``."""
    plan = T.Plan(32, window="hann", precision=T.Precision("float64", "float64"))
    nblk, B, hop = 3, 256, 16
    xs = torch.as_tensor(W._signal(nblk, B, 33)).reshape(nblk, 1, B)
    stacked = []
    real = torch.stack

    def spy(tensors, *args, **kwargs):
        stacked.append([tuple(t.shape) for t in tensors])
        return real(tensors, *args, **kwargs)

    monkeypatch.setattr(torch, "stack", spy)
    with stub.installed():
        if not graphed:
            monkeypatch.setattr(graphs, "_DISABLED", 1)
        _, hd, ys = par.sharded_roundtrip_hopped(
            plan, mesh, T.init_state(plan, channels=1, device="cpu"), xs, hop)
        names = [e.name for e in graphs.entries()]
    assert names == (["sharded_driver_block"] if graphed else [])
    for out, block in ((hd.to_local(), (1, B // hop, 32, 2)), (ys.to_local(), (1, B))):
        assert tuple(out.shape) == (nblk, *block) and out.is_contiguous()
        assert out.untyped_storage().nbytes() == out.numel() * out.element_size()
        assert not any(len(c) == nblk and c[0] == block for c in stacked), stacked


def test_cpu_programs_never_reach_the_real_cache(mesh):
    """With the card's backend, CPU tensors run every program eagerly."""
    graphs.clear()
    plan = T.Plan(32, precision=T.Precision("float64", "float64"))
    st = T.init_state(plan, channels=2, device="cpu")
    x = W._signal(2, 256, 3)
    par.sharded_sdft(plan, mesh, st, x)
    par.sharded_roundtrip(plan, mesh, st, x)
    par.sharded_roundtrip_hopped(plan, mesh, st, x.reshape(2, 2, 128).transpose(1, 0, 2), 16)
    k32 = T.Plan(256, window="hann", precision=T.Precision("float32", "float32"))
    par.sharded_sdft_pallas(k32, mesh, T.init_state(k32, channels=2, device="cpu"),
                            x.astype(np.float32))
    assert graphs.entries() == []


def test_shutdown_drops_the_graphs_before_the_group(monkeypatch):
    """``multihost.shutdown`` empties the graph cache before it destroys the
    group: NCCL's destroy waits for every graph that captured one of its
    communicators."""
    from sdft_tpu_torch.parallel import multihost

    seen = []
    monkeypatch.setattr(multihost.dist, "destroy_process_group",
                        lambda: seen.append(len(graphs.entries())))
    with stub.installed():
        graphs.run("probe", (), lambda t: t + 1, torch.zeros(2))
        assert len(graphs.entries()) == 1
        multihost.shutdown()
    assert seen == [0]


# -- spawned ranks ----------------------------------------------------------------------

@pytest.fixture(scope="module")
def spawned(tmp_path_factory):
    """spawned(axes): the worker's stand-in graph mode on a mesh, run at the
    first test that asks for it."""
    cache = {}

    def get(axes):
        if axes not in cache:
            out = tmp_path_factory.mktemp(f"graphs_{W.mesh_id(axes)}") / "results.npz"
            proc = subprocess.run([sys.executable, W.__file__, W.mesh_id(axes), "--graphs",
                                   str(out)], capture_output=True, text=True,
                                  timeout=SPAWN_TIMEOUT)
            if proc.returncode != 0:
                cache[axes] = (proc.stdout + proc.stderr)[-4000:]
            else:
                with np.load(out) as f:
                    cache[axes] = {k: f[k] for k in f.files}
        if isinstance(cache[axes], str):
            pytest.fail(f"mesh {W.mesh_id(axes)}: {cache[axes]}")
        return cache[axes]
    return get


@pytest.mark.parametrize("axes,case", [
    pytest.param(axes, case, id=f"{W.mesh_id(axes)}-{case}")
    for axes in W.GRAPH_MESHES for case in W.graph_cases(axes)])
def test_spawned_ranks_graphed_equal_eager_bit_for_bit(spawned, axes, case):
    """On every rank of the mesh, the case's outputs (gathered whole) with
    each body replayed through the stand-in graph, its Gloo collectives
    included, equal the eager run bit for bit; the program's own graphs
    were captured, in the thread-local mode."""
    res = spawned(axes)
    assert float(res[f"{case}/differ"][0]) == 0.0
    assert set(res[f"{case}/graphs"].tolist()) == _graph_names(case)
    assert res[f"{case}/modes"].tolist() == [sharded.CAPTURE_MODE]


# -- the card ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def cuda_mesh(tmp_path_factory):
    """A one-rank NCCL group of this process on card 0 and its 1x1x1 mesh."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run: python -m pytest "
                    "tests/test_torch_sharded_graphs.py -m cuda on the card)")
    from sdft_tpu_torch.parallel import multihost

    tmp = tmp_path_factory.mktemp("nccl")
    multihost.initialize(f"file://{tmp}/group", 1, 0)
    graphs.clear()
    try:
        yield par.make_mesh(1, 1, 1)
    finally:
        multihost.shutdown()


def _card_programs(dev):
    """{name: (call, K1 launches, K2 launches per call)} on the card, at
    small shapes; the states carried (non-zero)."""
    f32 = T.FAST_PRECISION
    k = T.Plan(1024, window="hann", precision=f32)
    d = T.Plan(200, window="hann", precision=f32)
    x = torch.as_tensor(W._signal(2, 8192, 71), dtype=torch.float32, device=dev)
    sk = T.sdft(k, T.init_state(k, channels=2, device=dev), x[:, :1000])[0]
    sd = T.sdft(d, T.init_state(d, channels=2, device=dev), x[:, :1000])[0]
    low = lambda z, bins: z * (bins < 300)  # noqa: E731
    return {
        "sharded_sdft_pallas planar": (
            lambda mesh: par.sharded_sdft_pallas(k, mesh, sk, x, layout="planar"), 1, 0),
        "sharded_sdft_pallas bf16": (
            lambda mesh: par.sharded_sdft_pallas(k, mesh, sk, x, layout="planar",
                                                 spectra_dtype="bfloat16"), 1, 0),
        "sharded_roundtrip_pallas": (
            lambda mesh: par.sharded_roundtrip_pallas(d, mesh, sd, x[:, :4000]), 0, 1),
        "sharded_sdft scan": (
            lambda mesh: par.sharded_sdft(k, mesh, sk, x[:, :2048], use_pallas=False), 0, 0),
        "sharded_isdft": (
            lambda mesh: par.sharded_isdft(k, mesh, torch.ones(2, 512, 1024, 2, device=dev)),
            0, 0),
        "sharded_roundtrip": (lambda mesh: par.sharded_roundtrip(k, mesh, sk, x), 0, 0),
        "sharded_roundtrip scan": (
            lambda mesh: par.sharded_roundtrip(k, mesh, sk, x[:, :2048], collapsed=False), 0, 0),
        "sharded_roundtrip(transform)": (
            lambda mesh: par.sharded_roundtrip(k, mesh, sk, x[:, :2048], transform=low), 0, 0),
        "sharded_sdft_hopped": (
            lambda mesh: par.sharded_sdft_hopped(d, mesh, sd, x[:, :8000], 100), 0, 0),
        "sharded_roundtrip_hopped": (
            lambda mesh: par.sharded_roundtrip_hopped(d, mesh, sd, x[:, :8000].reshape(
                2, 4, 2000).transpose(0, 1).contiguous(), 100), 0, 0),
    }


def _locals(out):
    """The local tensors of a program's output (DTensors and States)."""
    items = out if isinstance(out, tuple) else (out,)
    flat = []
    for v in items:
        if isinstance(v, tuple):
            flat += _locals(v)
        else:
            flat.append(v.to_local() if hasattr(v, "to_local") else v)
    return flat


@pytest.mark.cuda
def test_cuda_sharded_graphed_equals_eager_bit_for_bit(cuda_mesh):
    """Every program on the card's one-rank NCCL mesh: graphed equals eager
    bit for bit, replays its own graphs, and launches K1/K2 once per time
    shard per call, replays included."""
    dev = torch.device("cuda", torch.cuda.current_device())
    for label, (call, k1, k2) in _card_programs(dev).items():
        graphs.clear()
        call(cuda_mesh)
        s, q = spectra.LAUNCHES, scan.LAUNCHES
        got = _locals(call(cuda_mesh))
        assert (spectra.LAUNCHES - s, scan.LAUNCHES - q) == (k1, k2), label
        names = {e.name for e in graphs.entries()}
        assert names and all(n.startswith("sharded_") for n in names), (label, names)
        with graphs.disabled():
            eager = _locals(call(cuda_mesh))
        assert len(got) == len(eager), label
        for a, b in zip(got, eager):
            assert torch.equal(a, b), label


@pytest.mark.cuda
def test_cuda_warm_sharded_calls_never_sync(cuda_mesh):
    """A warm graphed ``sharded_sdft_pallas`` and one warm
    ``sharded_roundtrip_hopped`` block enqueue without a host
    synchronisation."""
    dev = torch.device("cuda", torch.cuda.current_device())
    progs = _card_programs(dev)
    calls = [progs["sharded_sdft_pallas planar"][0], progs["sharded_roundtrip_pallas"][0],
             progs["sharded_roundtrip_hopped"][0]]
    for call in calls:
        call(cuda_mesh)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for call in calls:
            call(cuda_mesh)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
