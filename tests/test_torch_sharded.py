"""``sdft_tpu_torch.parallel`` against ``sdft_tpu.parallel`` on the same
meshes.

The JAX side runs on the 8-device virtual CPU mesh of tests/conftest.py;
its kernel programs run their Pallas kernels in interpret mode, as
tests/test_sharded.py does.  The port runs in 8 spawned Gloo processes
(tests/helpers/torch_sharded_worker.py), once per mesh, in a module-scoped
fixture that returns every case's outputs gathered whole; each comparison
is then its own test.  Both sides read the same numpy inputs.

Gates: float64 plans at 1e-12 abs, delaylines and offsets exactly (the
class of tests/test_sharded.py).  The kernel programs (float32, m = 256)
are held to the JAX kernel programs at that test's classes: spectra 5e-6
of max(1, scale), accumulators 5e-4, samples 1e-4, bfloat16 planes 3e-3
against the float32 spectra.
"""

import importlib.util
import os
import re
import subprocess
import sys
import types

import numpy as np
import pytest
import torch

import jax

from sdft_tpu import Plan, Precision, init_state
from sdft_tpu import parallel as jpar
from sdft_tpu.state import State as JState

import sdft_tpu_torch as T

HERE = os.path.dirname(os.path.abspath(__file__))
WORKER = os.path.join(HERE, "helpers", "torch_sharded_worker.py")
_spec = importlib.util.spec_from_file_location("torch_sharded_worker", WORKER)
W = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(W)

F64 = Precision("float64", "float64")
F32 = Precision("float32", "float32")
ATOL = 1e-12
#: seconds one mesh's spawned ranks may take (about 10-20 s here)
SPAWN_TIMEOUT = 400


# -- the JAX side of each case (tests/helpers/torch_sharded_worker.py) -------------

def _blocks(x, n):
    M = x.shape[-1] // n
    return [x[..., b * M:(b + 1) * M] for b in range(n)]


def _np_state(st):
    return {f"/{k}": np.asarray(a) for k, a in zip(JState._fields, st)}


def _sdft(window):
    def run(mesh, axes, inp):
        plan = Plan(32, window=window, precision=F64)
        st = init_state(plan, channels=2)
        out = {}
        for b, blk in enumerate(_blocks(inp["sdft"], 2)):
            st, out[f"d{b}"] = jpar.sharded_sdft(plan, mesh, st, blk)
            out[f"st{b}"] = st
        if window == "hann":
            out["st_cont"], out["d_cont"] = out["st1"], out["d1"]
        return out
    return run


def _roundtrip(window):
    def run(mesh, axes, inp):
        plan = Plan(32, window=window, precision=F64)
        st = init_state(plan, channels=inp["lti"].shape[0])
        out = {}
        for b, blk in enumerate(_blocks(inp["lti"], 3)):
            st, out[f"y{b}"] = jpar.sharded_roundtrip(plan, mesh, st, blk)
        out["st"] = st
        return out
    return run


def _roundtrip_scan(mesh, axes, inp):
    plan = Plan(32, precision=F64)
    st = init_state(plan, channels=2)
    out = {}
    for b, blk in enumerate(_blocks(inp["scan"], 2)):
        st, out[f"y{b}"] = jpar.sharded_roundtrip(plan, mesh, st, blk, collapsed=False)
    out["st"] = st
    return out


def _isdft(latency):
    def run(mesh, axes, inp):
        return {"y": jpar.sharded_isdft(Plan(32, latency=latency, precision=F64), mesh,
                                        inp["isdft"])}
    return run


def _hopped(key, m, hop, nblocks, window="hann"):
    def run(mesh, axes, inp):
        plan = Plan(m, window=window, precision=F64)
        x = inp[key]
        st = init_state(plan, channels=x.shape[0])
        out = {}
        for b, blk in enumerate(_blocks(x, nblocks)):
            st, out[f"d{b}"] = jpar.sharded_sdft_hopped(plan, mesh, st, blk, hop)
        out["st"] = st
        return out
    return run


def _driver(key, hop, refresh_every, window="hann"):
    def run(mesh, axes, inp):
        plan = Plan(32, window=window, precision=F64)
        xs = inp[key]
        st, hd, ys = jpar.sharded_roundtrip_hopped(
            plan, mesh, init_state(plan, channels=xs.shape[1]), xs, hop,
            refresh_every=refresh_every)
        return {"hd": hd, "ys": ys, "st": st}
    return run


def _mesh_lowpass(z, bins):
    return z * (bins < 48)


def _transform(mesh, axes, inp):
    plan = Plan(96, window="hann", precision=F64)
    st = init_state(plan, channels=2)
    out = {}
    for b, blk in enumerate(_blocks(inp["transform"], 2)):
        st, out[f"y{b}"] = jpar.sharded_roundtrip(plan, mesh, st, blk, transform=_mesh_lowpass)
    out["st"] = st
    return out


def _short_lti(mesh, axes, inp):
    plan = Plan(32, window="hann", precision=F64)
    st = init_state(plan, channels=axes[0])
    out = {}
    for b, blk in enumerate(_blocks(inp["short_lti"], 3)):
        st, out[f"y{b}"] = jpar.sharded_roundtrip(plan, mesh, st, blk)
    out["st"] = st
    return out


def _short_scan(mesh, axes, inp):
    plan = Plan(32, window="hamming", precision=F64)
    st = init_state(plan, channels=2)
    out = {}
    for b, blk in enumerate(_blocks(inp["short_scan"], 2)):
        st, out[f"d{b}"] = jpar.sharded_sdft(plan, mesh, st, blk)
    out["st"] = st
    return out


def _kernel_sdft(mesh, axes, inp):
    plan = Plan(256, window="hann", precision=F32)
    st = init_state(plan, channels=2)
    out = {}
    blocks = _blocks(inp["kernel"], 2)
    for b, blk in enumerate(blocks):
        st, out[f"d{b}"] = jpar.sharded_sdft_pallas(plan, mesh, st, blk, interpret=True)
        out[f"st{b}"] = st
    _, out["planar"] = jpar.sharded_sdft_pallas(plan, mesh, init_state(plan, channels=2),
                                                blocks[0], layout="planar", interpret=True)
    return out


def _kernel_roundtrip(mesh, axes, inp):
    plan = Plan(256, window="hann", precision=F32)
    st = init_state(plan, channels=2)
    out = {}
    for b, blk in enumerate(_blocks(inp["kernel_y"], 2)):
        st, out[f"d{b}"], out[f"y{b}"] = jpar.sharded_roundtrip_pallas(plan, mesh, st, blk,
                                                                       interpret=True)
        out[f"st{b}"] = st
    return out


JAX_CASES = {
    "sdft_hann": _sdft("hann"),
    "sdft_blackman": _sdft("blackman"),
    "roundtrip_hann": _roundtrip("hann"),
    "roundtrip_blackman": _roundtrip("blackman"),
    "roundtrip_scan": _roundtrip_scan,
    "isdft_lat1": _isdft(1.0),
    "isdft_lat05": _isdft(0.5),
    "hopped": _hopped("hopped", 32, 16, 2),
    "hopped_h1": _hopped("degenerate", 32, 1, 2),
    "hopped_h2": _hopped("degenerate", 32, 2, 2),
    "hopped_h4": _hopped("degenerate", 32, 4, 2),
    "hopped_fallback": _hopped("fallback", 16, 4, 2),
    "hopped_blackman_short": _hopped("short_hopped", 32, 8, 1, "blackman"),
    "driver_refresh": _driver("driver", 16, 1),
    "driver_no_refresh": _driver("driver", 16, None),
    "driver_h4": _driver("driver_h4", 4, 1, "hamming"),
    "transform": _transform,
    "short_lti": _short_lti,
    "short_scan": _short_scan,
    "kernel_sdft": _kernel_sdft,
    "kernel_roundtrip": _kernel_roundtrip,
}


def _flatten(name, outs) -> dict:
    flat = {}
    for key, v in outs.items():
        if isinstance(v, JState):
            for suffix, a in _np_state(v).items():
                flat[f"{name}/{key}{suffix}"] = a
        elif isinstance(v, tuple):
            for i, a in enumerate(v):
                flat[f"{name}/{key}/{i}"] = np.asarray(a, np.float32)
        else:
            flat[f"{name}/{key}"] = np.asarray(v)
    return flat


# -- one spawn of the port's ranks per mesh -------------------------------------------

def _spawn(axes, tmp_path_factory):
    """(axes, mesh, inputs, JAX outputs, port outputs) of every case on a mesh."""
    if len(jax.devices()) < 8:
        raise RuntimeError("the JAX side needs the 8 virtual CPU devices of tests/conftest.py")
    mesh = jpar.make_mesh(*axes)
    inp = W.make_inputs(axes)
    want = {}
    for name in W.cases(axes):
        if name in JAX_CASES:
            want.update(_flatten(name, JAX_CASES[name](mesh, axes, inp)))
    # the State sdft_tpu leaves after block 0, for the port to continue
    for k in JState._fields:
        inp[f"jax_st0/{k}"] = want[f"sdft_hann/st0/{k}"]
    tmp = tmp_path_factory.mktemp(f"sharded_{W.mesh_id(axes)}")
    np.savez(tmp / "inputs.npz", **inp)
    proc = subprocess.run([sys.executable, WORKER, W.mesh_id(axes), str(tmp / "inputs.npz"),
                           str(tmp / "results.npz")], capture_output=True, text=True,
                          timeout=SPAWN_TIMEOUT)
    if proc.returncode != 0:
        raise RuntimeError((proc.stdout + proc.stderr)[-4000:])
    with np.load(tmp / "results.npz") as f:
        got = {k: f[k] for k in f.files}
    return types.SimpleNamespace(axes=axes, mesh=mesh, inp=inp, want=want, got=got)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """runs(axes): one spawn of the port's ranks per mesh, made at the first
    test that asks for it; a failed spawn fails every test of its mesh."""
    cache = {}

    def get(axes):
        if axes not in cache:
            try:
                cache[axes] = _spawn(axes, tmp_path_factory)
            except (RuntimeError, subprocess.TimeoutExpired) as e:
                cache[axes] = e
        if isinstance(cache[axes], Exception):
            pytest.fail(f"mesh {W.mesh_id(axes)}: {cache[axes]}")
        return cache[axes]
    return get


def _pairs(meshes, case_filter):
    return [pytest.param(axes, name, id=f"{W.mesh_id(axes)}-{name}")
            for axes in meshes for name in W.cases(axes) if case_filter(name)]


def _keys(run, name):
    keys = sorted(k for k in run.want if k.startswith(name + "/"))
    assert keys, f"no JAX outputs for {name}"
    missing = [k for k in keys if k not in run.got]
    assert not missing, f"the port did not return {missing}"
    return keys


@pytest.mark.parametrize("axes,name", _pairs(W.MESHES, lambda n: n in JAX_CASES
                                              and not n.startswith("kernel")))
def test_float64_program_matches_jax(runs, axes, name):
    """Every float64 output (spectra, samples, accumulators) within 1e-12,
    offsets and delaylines exactly."""
    run = runs(axes)
    for k in _keys(run, name):
        got, want = run.got[k], run.want[k]
        assert got.shape == want.shape, (k, got.shape, want.shape)
        if k.endswith(("/offset", "/delayline")):
            np.testing.assert_array_equal(got, want, err_msg=k)
        else:
            np.testing.assert_allclose(got, want, atol=ATOL, rtol=0, err_msg=k)


@pytest.mark.parametrize("axes,name", _pairs(W.MESHES, lambda n: n.startswith("kernel")))
def test_kernel_program_matches_jax(runs, axes, name):
    """The kernel programs (K1's and K2's plain versions on the CPU) against
    the JAX kernel programs in interpret mode, at tests/test_sharded.py's
    classes; bfloat16 planes against the JAX float32 spectra."""
    run = runs(axes)
    for k in _keys(run, name):
        got, want = run.got[k], run.want[k]
        assert got.shape == want.shape, (k, got.shape, want.shape)
        if k.endswith(("/offset", "/delayline")):
            np.testing.assert_array_equal(got, want, err_msg=k)
        elif k.endswith("/accumulator"):
            np.testing.assert_allclose(got, want, atol=5e-4, rtol=0, err_msg=k)
        elif re.search(r"/y\d$", k):
            np.testing.assert_allclose(got, want, atol=1e-4, rtol=0, err_msg=k)
        else:
            scale = max(1.0, float(np.abs(want).max()))
            np.testing.assert_allclose(got, want, atol=5e-6 * scale, rtol=0, err_msg=k)
    if name == "kernel_sdft":
        want = run.want["kernel_sdft/d0"]
        for i in (0, 1):
            bf16 = run.got[f"kernel_sdft/bf16/{i}"]
            np.testing.assert_allclose(bf16, want[..., i], atol=3e-3, rtol=0)


@pytest.mark.parametrize("axes", [(1, 2, 4), (2, 2, 2)], ids=W.mesh_id)
def test_state_continues_across_the_packages(runs, axes):
    """A State the port's sharded_sdft wrote continues in sdft_tpu's, and
    the one sdft_tpu's wrote (an input of the ranks) continues in the
    port's: both equal the uninterrupted JAX stream at 1e-12."""
    run = runs(axes)
    plan = Plan(32, window="hann", precision=F64)
    port_st0 = JState(*(run.got[f"sdft_hann/st0/{k}"] for k in JState._fields))
    st, d1 = jpar.sharded_sdft(plan, run.mesh, port_st0, _blocks(run.inp["sdft"], 2)[1])
    np.testing.assert_allclose(np.asarray(d1), run.want["sdft_hann/d1"], atol=ATOL, rtol=0)
    np.testing.assert_allclose(np.asarray(st.accumulator),
                               run.want["sdft_hann/st1/accumulator"], atol=ATOL, rtol=0)
    np.testing.assert_allclose(run.got["sdft_hann/d_cont"], run.want["sdft_hann/d1"],
                               atol=ATOL, rtol=0)
    np.testing.assert_array_equal(run.got["sdft_hann/st_cont/delayline"],
                                  run.want["sdft_hann/st1/delayline"])


@pytest.mark.parametrize("axes", W.MESHES, ids=W.mesh_id)
def test_layout_validation(runs, axes):
    """The layouts the JAX programs refuse (tests/test_sharded.py:114) raise
    ValueError in the port, with the JAX messages; the others run."""
    run = runs(axes)
    nc, nt, nb = run.axes
    msg = {k.split("/", 1)[1]: str(run.got[k]) for k in run.got if k.startswith("errors/")}
    expect = {
        "channels": "not divisible by mesh channel" if nc > 1 else "",
        "time": "not divisible by mesh time" if nt > 1 else "",
        "bins": "not divisible by mesh bins" if nb > 1 else "",
        "kernel_bins": "bin-sharded" if nb > 1 else "",
        "kernel_y_bins": "bins=1" if nb > 1 else "",
        "kernel_plan": "bin-sharded" if nb > 1 else "not one the kernels take",
        "hop": "not a multiple of hop",
    }
    if nb >= 4:
        expect["halo"] = "smaller than window halo"
    assert set(msg) == set(expect)
    for k, want in expect.items():
        assert (want in msg[k]) if want else msg[k] == "", (k, msg[k])


class _Unsharded:
    """The port's unsharded calls under the sharded programs' names (the
    mesh ignored): the yardstick of the "high" cases."""

    @staticmethod
    def sharded_roundtrip(plan, mesh, st, blk):
        return T.roundtrip(plan, st, torch.as_tensor(blk))

    @staticmethod
    def sharded_sdft_hopped(plan, mesh, st, blk, hop):
        return T.sdft_hopped(plan, st, torch.as_tensor(blk), hop)

    @staticmethod
    def sharded_roundtrip_hopped(plan, mesh, st, xs, hop, refresh_every=1):
        return T.roundtrip_hopped(plan, st, torch.as_tensor(xs), hop, refresh_every)


@pytest.mark.parametrize("axes,name", _pairs(W.MESHES, lambda n: n.startswith("high")))
def test_high_program_matches_the_unsharded_call(runs, axes, name):
    """A mxu="high" plan through the sharded round trip, hopped analysis
    and driver chain (split tables sliced per bin shard, each rank's
    products by ``split_mm``'s plain version) against the same case run
    unsharded: offsets and delaylines exactly, samples within the class's
    1e-4 abs (as the kernel programs' y above), spectra and accumulators
    within 2e-6 of their scale, as split4 is held to the JAX package
    (tests/test_torch_split4.py).  The float32 sums run in another order,
    and an ulp of difference in an activation moves its split by the split
    class: up to 8.8e-6 on these samples, whose carry is ten times their
    size."""
    run = runs(axes)
    want = W._outputs(T, _Unsharded, None, axes, run.inp, name)
    assert want
    for k, w in want.items():
        got = run.got[f"{name}/{k}"]
        assert got.shape == w.shape, (k, got.shape, w.shape)
        if k.endswith(("/offset", "/delayline")):
            np.testing.assert_array_equal(got, w, err_msg=k)
        elif re.fullmatch(r"y\d|ys", k):
            np.testing.assert_allclose(got, w, atol=1e-4, rtol=0, err_msg=k)
        else:
            np.testing.assert_allclose(got, w, atol=2e-6 * np.abs(w).max(), rtol=0, err_msg=k)


# -- mesh and multihost (tests/test_multihost.py:32-77, torch.distributed mocked) ---

class _Recorder:
    def __init__(self, exc=None):
        self.calls = []
        self.exc = exc

    def __call__(self, *args, **kw):
        self.calls.append((args, kw))
        if self.exc is not None:
            raise self.exc


@pytest.fixture
def no_group(monkeypatch):
    """torch.distributed with no group, and a recorder for init_process_group."""
    from sdft_tpu_torch.parallel import multihost

    rec = _Recorder()
    monkeypatch.setattr(multihost.dist, "is_initialized", lambda: False)
    monkeypatch.setattr(multihost.dist, "init_process_group", rec)
    for k in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK", "LOCAL_RANK"):
        monkeypatch.delenv(k, raising=False)
    return multihost, rec


def test_initialize_forwards_cluster_args(no_group):
    multihost, rec = no_group
    multihost.initialize("10.0.0.1:1234", num_processes=4, process_id=2, device_type="cpu")
    assert rec.calls == [(("gloo",), dict(init_method="tcp://10.0.0.1:1234", world_size=4,
                                         rank=2))]


def test_initialize_idempotent_when_group_exists(no_group, monkeypatch):
    multihost, rec = no_group
    monkeypatch.setattr(multihost.dist, "is_initialized", lambda: True)
    multihost.initialize("localhost:1234", 2, 0, device_type="cpu")
    assert rec.calls == []


def test_initialize_explicit_args_failure_raises(no_group):
    # with an explicit coordinator a real failure surfaces; nothing falls
    # back to a one-rank group
    multihost, rec = no_group
    rec.exc = RuntimeError("connection refused")
    with pytest.raises(RuntimeError, match="connection refused"):
        multihost.initialize("localhost:1", 2, 0, device_type="cpu")
    assert len(rec.calls) == 1


def test_initialize_outside_a_launcher_makes_one_rank(no_group, monkeypatch):
    # no arguments and no torchrun environment: a one-rank group in memory;
    # under torchrun its environment is read
    multihost, rec = no_group
    multihost.initialize(device_type="cpu")
    (args, kw), = rec.calls
    assert args == ("gloo",) and kw["world_size"] == 1 and kw["rank"] == 0
    assert isinstance(kw["store"], multihost.dist.HashStore)
    monkeypatch.setenv("MASTER_ADDR", "localhost")
    monkeypatch.setenv("WORLD_SIZE", "4")
    multihost.initialize(device_type="cpu")
    assert rec.calls[1] == (("gloo",), {})


def test_initialize_and_make_mesh_need_a_card_for_cuda(no_group):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    from sdft_tpu_torch.parallel import make_mesh

    multihost, rec = no_group
    with pytest.raises(RuntimeError, match="device_type='cpu'"):
        multihost.initialize()
    with pytest.raises(RuntimeError, match="initialized process group"):
        make_mesh()
    assert rec.calls == []


def test_one_rank_cpu_mesh_and_placements(monkeypatch):
    """A real one-rank Gloo group: the 1x1x1 mesh, its axis groups, the
    'cuda' default refused without a card, and values placed with
    global_array / host_local_to_global."""
    from torch.distributed.tensor import Replicate, Shard

    from sdft_tpu_torch.parallel import (AXES, SAMPLE_SPEC, make_mesh, multihost,
                                         single_device_mesh)

    for k in ("MASTER_ADDR", "WORLD_SIZE"):
        monkeypatch.delenv(k, raising=False)
    assert not multihost.dist.is_initialized()
    multihost.initialize(device_type="cpu")
    try:
        mesh = single_device_mesh("cpu")
        assert mesh.mesh_dim_names == AXES and tuple(mesh.shape) == (1, 1, 1)
        assert multihost.dist.get_world_size(mesh.get_group("time")) == 1
        with pytest.raises(ValueError, match="needs 2 ranks"):
            make_mesh(2, 1, 1, device_type="cpu")
        with pytest.raises(ValueError, match="must use all"):
            multihost.global_mesh(time=2, device_type="cpu")
        if not torch.cuda.is_available():
            with pytest.raises(RuntimeError, match="no CUDA device"):
                make_mesh()
        x = np.arange(2 * 64, dtype=np.float32).reshape(2, 64)
        for g in (multihost.global_array(mesh, SAMPLE_SPEC, x),
                  multihost.host_local_to_global(mesh, (Shard(0), Replicate(), Shard(1)), x)):
            assert tuple(g.shape) == x.shape
            np.testing.assert_array_equal(g.full_tensor().numpy(), x)
    finally:
        multihost.dist.destroy_process_group()
