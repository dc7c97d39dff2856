"""The graphed paths (``sdft_tpu_torch.graphs``): the cache's key, bound and
switches, what a replay returns, and every graphed path against its JAX
counterpart.

On the CPU a stand-in capture backend (``StubBackend`` of
tests/helpers/graph_stub.py, put in ``graphs.BACKEND``) "captures" by
running the function once and "replays" by running it again into the same
static outputs, so the port's graph
plumbing (static inputs, the chain's state fed back, the stacked outputs,
the refresh cadence) runs here on CPU tensors.  With the real backend CPU
tensors never reach the cache.  Gates as the existing parity tests:
float64 plans 1e-12 of scale (tests/test_torch_lti.py), float32 kernel
plans the JAX hop=1 route's class (spectra 1.5e-5 of scale, samples atol
5e-4, tests/test_torch_slice.py) and the fused round trip's atol 5e-4,
rtol 1e-3 (tests/test_torch_kernels.py).  The ``-m cuda`` tests hold the
real graphs against the eager run on the card.
"""

import contextlib
import importlib.util
import os

import numpy as np
import pytest
import torch

import sdft_tpu as J
import sdft_tpu_torch as T
from sdft_tpu.kernels import roundtrip_block_fused as j_roundtrip_block_fused
from sdft_tpu.ops import lti as j_lti
from sdft_tpu.ops.lti import _chain_hop1_pallas_jit
from sdft_tpu_torch import graphs
from sdft_tpu_torch.kernels import scan, spectra
from sdft_tpu_torch.ops import lti
from sdft_tpu_torch.state import stack_states

_spec = importlib.util.spec_from_file_location(
    "graph_stub", os.path.join(os.path.dirname(os.path.abspath(__file__)), "helpers",
                               "graph_stub.py"))
_stub = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(_stub)
StubBackend = _stub.StubBackend

F64 = J.Precision("float64", "float64")


def _signal(n, seed=0):
    return np.random.default_rng(seed).standard_normal(n).clip(-1, 1).astype(np.float32)


def _np(a):
    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def _rel(got, want):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-300)


@pytest.fixture
def stub(monkeypatch):
    backend = StubBackend()
    monkeypatch.setattr(graphs, "BACKEND", backend)
    graphs.clear()
    yield backend
    graphs.clear()


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run: python -m pytest "
                    "tests/test_torch_graphs.py -m cuda on the card)")
    graphs.clear()
    yield torch.device("cuda", 0)
    graphs.clear()


def _names():
    return [e.name for e in graphs.entries()]


def _equal(a, b):
    la, lb = graphs.leaves(a), graphs.leaves(b)
    return len(la) == len(lb) and all(torch.equal(x, y) for x, y in zip(la, lb))


# -- the cache ---------------------------------------------------------------------

def test_key_separates_what_the_capture_depends_on_and_joins_equal_calls(stub):
    plan = T.Plan(128, window="hann", precision=T.FAST_PRECISION)
    high = plan.with_(precision=T.Precision("float32", "float32", mxu="high"))
    st = T.init_state(plan, device="cpu")
    st2 = T.init_state(plan, channels=2, device="cpu")
    x = torch.as_tensor(_signal(512))
    xs = x.reshape(4, 128)
    calls = [
        lambda: lti.roundtrip_block_lti(plan, st, x),
        lambda: lti.roundtrip_block_lti(high, st, x),                 # precision
        lambda: lti.roundtrip_block_lti(plan.with_(window="blackman"), st, x),  # plan
        lambda: lti.roundtrip_block_lti(plan, st, x, 16),             # k_tile
        lambda: lti.roundtrip_block_lti(plan, st, x[:500]),           # shape
        lambda: lti.roundtrip_block_lti(plan, st, x.double()),        # dtype
        lambda: lti.roundtrip_block_lti(plan, st2, xs[:2]),           # channel layout
        lambda: T.roundtrip_hopped(plan, st, xs, 8),                  # hop
        lambda: T.roundtrip_hopped(plan, st, xs, 16),
        lambda: T.roundtrip_hopped(plan, st, xs, 2, 1, 8),            # sub-hop tile
        lambda: T.roundtrip_hopped(plan, st, xs, 2, 1, 16),
        lambda: T.roundtrip_hopped(plan, st, xs, 8, refresh_every=None),  # refresh
    ]
    for n, call in enumerate(calls, 1):
        call()
        assert len(graphs.entries()) == n
    keys = [e.key for e in graphs.entries()]
    assert len(set(keys)) == len(keys)
    for call in calls:                      # equal calls join their graph
        call()
    assert stub.captures == len(calls) and len(graphs.entries()) == len(calls)
    # the chain replays one body graph for any number of blocks
    T.roundtrip_hopped(plan, st, torch.cat([xs, xs]), 8)
    assert stub.captures == len(calls)


def test_key_refuses_unhashable_statics_and_mixed_devices(stub):
    x = torch.zeros(4)
    with pytest.raises(TypeError, match="not hashable"):
        graphs.run("probe", ([1],), lambda t: t + 1, x)
    with pytest.raises(ValueError, match="one cpu device"):
        graphs.run("probe", (), lambda a, b: a + 1, x, torch.zeros(4, device="meta"))
    assert graphs.entries() == []


def test_cache_holds_at_most_max_graphs_least_recently_used_out(stub):
    def fn(t):
        return t * 2

    for n in range(1, graphs.MAX_GRAPHS + 5):
        graphs.get("probe", (), fn, torch.zeros(n))
        if n == graphs.MAX_GRAPHS:
            graphs.get("probe", (), fn, torch.zeros(5))      # 5 used again
    shapes = [e.key[2][0][0] for e in graphs.entries()]
    assert len(shapes) == graphs.MAX_GRAPHS
    assert shapes[0] == (6,) and (5,) in shapes and (4,) not in shapes
    assert shapes[-1] == (graphs.MAX_GRAPHS + 4,)
    graphs.clear()
    assert graphs.entries() == []


def test_disabled_nests_and_runs_eagerly(stub):
    plan = T.Plan(128, precision=T.FAST_PRECISION)
    x = torch.as_tensor(_signal(256))
    assert graphs.active(x)
    with graphs.disabled():
        with graphs.disabled():
            assert not graphs.active(x)
        assert not graphs.active(x)
        T.roundtrip(plan, T.init_state(plan, device="cpu"), x)
    assert graphs.active(x) and graphs.entries() == []


def test_cpu_tensors_never_reach_the_cache():
    """With the card's backend, every graphed entry point runs its eager
    code on CPU tensors, and ``graphs.run`` refuses them."""
    graphs.clear()
    plan = T.Plan(128, window="hann", precision=T.FAST_PRECISION)
    st = T.init_state(plan, device="cpu")
    xs = torch.as_tensor(_signal(512)).reshape(4, 128)
    T.roundtrip(plan, st, xs[0])
    T.roundtrip_hopped(plan, st, xs, 16, refresh_every=2)
    T.roundtrip_hopped(plan, st, xs, 1)
    scan.roundtrip_block_fused(plan, st, xs[0])
    T.sdft(plan, st, xs[0])
    T.sdft_power(plan, st, xs[0])
    T.roundtrip(plan, st, xs[0], lambda z: z)
    spectra.prologue(plan, st, xs[0])
    T.sdft_hopped(plan, st, xs[0], 16)
    lti.roundtrip_hopped_block(plan, st, xs[0], 16, True)
    T.refresh(plan, st)
    list(T.Streamer(plan, refresh_every=1, device="cpu").run(list(xs)))
    assert graphs.entries() == []
    with pytest.raises(ValueError, match="one cuda device"):
        graphs.run("probe", (), lambda t: t + 1, xs)


def test_returned_tensors_are_fresh_and_inputs_untouched(stub):
    plan = T.Plan(128, window="hann", precision=T.Precision("float64", "float64"))
    x = torch.as_tensor(_signal(300), dtype=torch.float64)
    st0 = T.init_state(plan, device="cpu")
    st0 = st0._replace(offset=torch.tensor(7, dtype=torch.int32))
    before = graphs.clone(st0)
    st1, y1 = T.roundtrip(plan, st0, x)
    held = graphs.clone((st1, y1))
    (entry,) = graphs._GRAPHS.values()
    for t in graphs.leaves(entry.outputs):       # a later replay's writes
        t.fill_(-1 if t.dtype == torch.int32 else float("nan"))
    assert _equal((st1, y1), held)
    st2, y2 = T.roundtrip(plan, st0, x)               # a state passed twice
    assert _equal((st2, y2), held)
    assert _equal(st0, before)


def test_failed_capture_raises_with_the_name_and_caches_nothing(stub):
    calls = []

    def fn(t):
        calls.append(1)
        if len(calls) > graphs.WARMUP_CALLS:
            raise RuntimeError("operation not permitted when stream is capturing")
        return t + 1

    with pytest.raises(RuntimeError, match="graph capture of probe failed"):
        graphs.run("probe", ("static",), fn, torch.zeros(3))
    assert graphs.entries() == []


def test_replay_adds_the_captured_launches_to_the_counters(stub):
    """A replay runs no wrapper, so the graph adds the launches it captured;
    the capture itself launched nothing and is not counted."""
    def fn(t):
        scan.LAUNCHES += 2
        spectra.LAUNCHES += 1
        return t + 1

    q, s = scan.LAUNCHES, spectra.LAUNCHES
    graphs.run("probe", (), fn, torch.zeros(3))
    # two eager warm-up calls, one replay
    assert (scan.LAUNCHES - q, spectra.LAUNCHES - s) == (6, 3)
    (entry,) = graphs.entries()
    assert entry.launches == {"scan": 2, "spectra": 1}
    graphs.run("probe", (), fn, torch.zeros(3))
    assert (scan.LAUNCHES - q, spectra.LAUNCHES - s) == (8, 4)


def test_replay_adds_the_captured_paced_k1_launches(stub):
    """K1's paced launches are counted apart (``spectra.PACED_LAUNCHES``),
    and a replay adds those it captured as it adds every launch."""
    def fn(t):
        spectra.LAUNCHES += 1
        spectra.PACED_LAUNCHES += 1
        return t + 1

    s, p = spectra.LAUNCHES, spectra.PACED_LAUNCHES
    graphs.run("probe", (), fn, torch.zeros(3))
    assert (spectra.LAUNCHES - s, spectra.PACED_LAUNCHES - p) == (3, 3)
    (entry,) = graphs.entries()
    assert entry.launches == {"spectra": 1, "spectra.paced": 1}
    graphs.run("probe", (), fn, torch.zeros(3))
    assert (spectra.LAUNCHES - s, spectra.PACED_LAUNCHES - p) == (4, 4)


def test_graphed_tables_are_held_past_a_cache_eviction(stub):
    """Device tables read from a cache during the capture belong to the
    graph, so clearing the cache frees nothing a replay reads."""
    plan = T.Plan(128, window="hann", precision=T.FAST_PRECISION)
    x = torch.as_tensor(_signal(256))
    scan.roundtrip_block_fused(plan, T.init_state(plan, device="cpu"), x)
    (graph,) = graphs._GRAPHS.values()
    held = graphs.leaves(graph._held)
    synth = scan.synthesis_row(plan, x.device)
    assert any(t is synth for t in held)
    scan.synthesis_row.cache_clear()
    assert scan.synthesis_row(plan, x.device) is not synth


def test_graphed_prologue_holds_its_tables_past_a_cache_eviction(stub):
    """The prologue graph holds the fine and phase tables it read, and
    hands the cached phase table to the kernel as its static output."""
    plan = T.Plan(256, window="hann", precision=T.FAST_PRECISION)
    st = T.init_state(plan, device="cpu")
    x = torch.as_tensor(_signal(2000, seed=2))
    first = T.sdft(plan, st, x)
    (graph,) = graphs._GRAPHS.values()
    fine, phase = spectra._spectra_tables(plan, spectra.TILE_K, x.device)
    held = graphs.leaves(graph._held)
    assert any(t is phase for t in held) and any(t is fine for t in held)
    assert graph.outputs.phase is phase
    spectra._spectra_tables.cache_clear()
    assert spectra._spectra_tables(plan, spectra.TILE_K, x.device)[1] is not phase
    assert _equal(T.sdft(plan, st, x), first) and graph.outputs.phase is phase


def test_prologue_replay_returns_static_carries_and_a_fresh_state(stub):
    """``spectra.prologue`` hands back the graph's static carries (the
    kernel reads them straight after the replay) and a clone of the next
    state, which a later replay leaves as it was."""
    plan = T.Plan(128, window="hann", precision=T.FAST_PRECISION)
    st = T.init_state(plan, channels=2, device="cpu")
    x1, x2 = torch.as_tensor(_signal(2 * 2 * 333, seed=3)).reshape(2, 2, 333)
    pro = spectra.prologue(plan, st, x1)
    (graph,) = graphs._GRAPHS.values()
    assert graph.name == "spectra_prologue"
    assert pro.c0 is graph.outputs.c0 and pro.delta is graph.outputs.delta
    assert all(a is not b for a, b in zip(pro.state, graph.outputs.state))
    held = graphs.clone(pro)
    with graphs.disabled():
        assert _equal(spectra.prologue(plan, st, x1), held)
    spectra.prologue(plan, pro.state, x2)
    assert _equal(pro.state, held.state)
    assert not torch.equal(pro.c0, held.c0)       # the carries are the next block's


def test_graphed_spectra_held_by_the_caller_survive_later_calls(stub):
    plan = T.Plan(256, window="hann", precision=T.FAST_PRECISION)
    st = T.init_state(plan, device="cpu")
    xs = torch.as_tensor(_signal(3 * 500, seed=4)).reshape(3, 500)
    first = T.sdft(plan, st, xs[0], "planar")
    held = graphs.clone(first)
    T.sdft(plan, st, xs[1], "planar")
    T.sdft_power(plan, first[0], xs[2])
    assert _equal(first, held)
    assert stub.captures == 1         # one prologue graph for the key


@pytest.mark.parametrize("C", [None, 2])
@pytest.mark.parametrize("mode", ["graphed", "eager"])
def test_hop1_chain_writes_each_block_into_its_stack(stub, monkeypatch, C, mode):
    """One K2 call (here its plain version) per block, whose outputs are the
    block's slots of the stacked outputs: no per-block copy.  The chain's
    graph holds the prologue and the refresh, and no K2 launch."""
    plan = T.Plan(256, window="hann", precision=T.FAST_PRECISION)
    nb = 3
    shape = (nb, 200) if C is None else (nb, C, 200)
    xs = torch.as_tensor(_signal(int(np.prod(shape)), seed=6)).reshape(shape)
    calls = []
    real = scan.forward_and_y_reference

    def spy(plan, pro, synth, layout="packed", out=None, y=None):
        calls.append((out, y))
        return real(plan, pro, synth, layout, out, y)

    monkeypatch.setattr(scan, "forward_and_y_reference", spy)
    with graphs.disabled() if mode == "eager" else contextlib.nullcontext():
        _, hds, ys = T.roundtrip_hopped(plan, T.init_state(plan, C, device="cpu"), xs, 1)
    assert len(calls) == nb
    for b, (out, y) in enumerate(calls):
        assert out.data_ptr() == hds[b].data_ptr() and y.data_ptr() == ys[b].data_ptr()
    if mode == "graphed":
        (body,) = graphs.entries()
        assert body.name == "hop1_chain_body" and body.launches == {}
    else:
        assert graphs.entries() == []


# -- every graphed path against its JAX counterpart ----------------------------------

def _case_roundtrip(C):
    jp = J.Plan(96, window="hamming", latency=0.5, precision=F64)
    tp = T.plan_from_jax(jp)
    shape = (3, 300) if C is None else (3, C, 300)
    xs = _signal(int(np.prod(shape)), seed=1).reshape(shape)

    def port():
        st, ys = T.init_state(tp, C, device="cpu"), []
        for x in xs:
            st, y = T.roundtrip(tp, st, x)
            ys.append(y)
        return st, torch.stack(ys)

    def jax():
        st, ys = J.init_state(jp, C), []
        for x in xs:
            st, y = J.roundtrip(jp, st, x)
            ys.append(np.asarray(y))
        return st, np.stack(ys)

    def check(got, want):
        assert _rel(got[1], want[1]) <= 1e-12
        assert _rel(got[0].accumulator, want[0].accumulator) <= 1e-12
    return "roundtrip_block_lti", port, jax, check


def _case_driver(hop, refresh_every, C=None):
    jp = J.Plan(96, window="hann", roi=(3, 90) if hop == 4 else None, precision=F64)
    tp = T.plan_from_jax(jp)
    B = 400 if hop == 100 else 16 * hop
    shape = (3, B) if C is None else (3, C, B)
    xs = _signal(int(np.prod(shape)), seed=hop).reshape(shape)

    def port():
        return T.roundtrip_hopped(tp, T.init_state(tp, C, device="cpu"), xs, hop,
                                  refresh_every=refresh_every)

    def jax():
        return J.roundtrip_hopped(jp, J.init_state(jp, C), xs, hop,
                                  refresh_every=refresh_every)

    def check(got, want):
        for g, w in zip(got[1:], want[1:]):
            assert _rel(g, w) <= 1e-12
        assert _rel(got[0].accumulator, want[0].accumulator) <= 1e-12
    return "driver_chain_body", port, jax, check


def _case_hop1(refresh_every, latency):
    jp = J.Plan(256, window="hann", latency=latency, precision=J.FAST_PRECISION)
    tp = T.plan_from_jax(jp)
    xs = _signal(3 * 200, seed=5).reshape(3, 200)

    def port():
        return T.roundtrip_hopped(tp, T.init_state(tp, device="cpu"), xs, 1,
                                  refresh_every=refresh_every)

    def jax():
        return _chain_hop1_pallas_jit(jp, J.init_state(jp), xs, refresh_every, True)

    def check(got, want):
        assert _rel(got[1], want[1]) <= 1.5e-5
        np.testing.assert_allclose(_np(got[2]), _np(want[2]), atol=5e-4)
        np.testing.assert_allclose(_np(got[0].accumulator), _np(want[0].accumulator),
                                   atol=4 * np.finfo(np.float32).eps * xs.size)
    return "hop1_chain_body", port, jax, check


def _case_fused(latency):
    jp = J.Plan(256, window="hann", latency=latency, precision=J.FAST_PRECISION)
    tp = T.plan_from_jax(jp)
    x = _signal(4 * 128, seed=1)

    def port():
        return scan.roundtrip_block_fused(tp, T.init_state(tp, device="cpu"),
                                          torch.as_tensor(x))

    def jax():
        return j_roundtrip_block_fused(jp, J.init_state(jp), x, interpret=True)

    def check(got, want):
        np.testing.assert_allclose(_np(got[1]), _np(want[1]), atol=5e-4, rtol=1e-3)
    return "roundtrip_block_fused", port, jax, check


def _case_sdft_hopped(hop, C=None):
    jp = J.Plan(96, window="blackman", roi=(4, 90), precision=F64)
    tp = T.plan_from_jax(jp)
    shape = (2, 250) if C is None else (2, C, 250)
    xs = _signal(int(np.prod(shape)), seed=13 + hop).reshape(shape)

    def port():
        st, ds = T.init_state(tp, C, device="cpu"), []
        for x in xs:
            st, d = T.sdft_hopped(tp, st, x, hop)
            ds.append(d)
        return st, torch.stack(ds)

    def jax():
        st, ds = J.init_state(jp, C), []
        for x in xs:
            st, d = J.sdft_hopped(jp, st, x, hop)
            ds.append(np.asarray(d))
        return st, np.stack(ds)

    def check(got, want):
        assert _rel(got[1], want[1]) <= 1e-12
        assert _rel(got[0].accumulator, want[0].accumulator) <= 1e-12
    return "sdft_hopped", port, jax, check


def _case_hopped_block(hop, refresh):
    jp = J.Plan(96, window="blackman", latency=0.5, precision=F64)
    tp = T.plan_from_jax(jp)
    x = _signal(3 * 96, seed=10).astype(np.float64)

    def port():
        return lti.roundtrip_hopped_block(tp, T.init_state(tp, device="cpu"),
                                          torch.as_tensor(x), hop, refresh)

    def jax():
        return j_lti.roundtrip_hopped_block(jp, J.init_state(jp), x, hop, refresh)

    def check(got, want):
        for g, w in zip(got[1:], want[1:]):
            assert _rel(g, w) <= 1e-12
        assert _rel(got[0].accumulator, want[0].accumulator) <= 1e-12
    return "roundtrip_hopped_block", port, jax, check


def _case_refresh(C):
    jp = J.Plan(96, window="hann", precision=F64)
    tp = T.plan_from_jax(jp)
    x = _signal(700 if C is None else 700 * C, seed=3)
    x = x if C is None else x.reshape(C, 700)
    js, _ = J.sdft(jp, J.init_state(jp, C), x)
    arrays = J.state_to_arrays(js)

    def port():
        return T.refresh(tp, T.state_from_arrays(arrays, device="cpu"))

    def jax():
        return J.refresh(jp, J.state_from_arrays(arrays))

    def check(got, want):
        assert _rel(got.accumulator, want.accumulator) <= 1e-12
        assert _rel(got.delayline, want.delayline) == 0
    return "refresh", port, jax, check


def _case_spectra(entry, C):
    """``sdft``, ``sdft_power`` and ``roundtrip(transform)`` on a float32
    kernel plan: the prologue graph, then K1's plain version.  Two chained
    calls on different ragged inputs; a batch's channels sit at different
    offsets (states made by the JAX package, channel c after 100 + 70*c
    samples).  Gates: the f32 class of tests/test_torch_slice.py (packed
    2e-6 abs and 1e-4 rel), bf16 planes 8e-3 and |dft|^2 6e-6 of scale
    (chip_smoke's gates against float64), transform round trip 1e-5."""
    jp = J.Plan(256, window="blackman", latency=0.5, precision=J.FAST_PRECISION)
    tp = T.plan_from_jax(jp)
    lead = _signal(300, seed=50)
    leads = [J.sdft(jp, J.init_state(jp), lead[:100 + 70 * c])[0]
             for c in range(C or 1)]
    arrays = {k: np.stack([np.asarray(a) for a in v]) if C else np.asarray(v[0])
              for k, v in zip(("offset", "delayline", "accumulator"), zip(*leads))}
    xs = _signal(2 * (C or 1) * 300, seed=51).reshape((2, C, 300) if C else (2, 300))
    bins = np.arange(256) < 40
    calls = {
        "sdft": (lambda st, x: T.sdft(tp, st, x), lambda st, x: J.sdft(jp, st, x)),
        "sdft-planar-bf16": (lambda st, x: T.sdft(tp, st, x, "planar", "bfloat16"),
                             lambda st, x: J.sdft(jp, st, x, "planar", "bfloat16")),
        "sdft_power": (lambda st, x: T.sdft_power(tp, st, x),
                       lambda st, x: J.sdft_power(jp, st, x)),
        "roundtrip-transform": (
            lambda st, x: T.roundtrip(tp, st, x, lambda z: z * torch.as_tensor(bins)),
            lambda st, x: J.roundtrip(jp, st, x, lambda z: z * bins)),
    }
    t_call, j_call = calls[entry]

    def chain(call, st):
        outs = []
        for x in xs:
            st, out = call(st, x)
            outs.append(out)
        return st, outs

    def port():
        return chain(t_call, T.state_from_arrays(arrays, device="cpu"))

    def jax():
        return chain(j_call, J.state_from_arrays(arrays))

    def check(got, want):
        for g, w in zip(got[1], want[1]):
            if entry == "sdft":
                np.testing.assert_allclose(_np(g), _np(w), atol=2e-6, rtol=1e-4)
            elif entry == "sdft-planar-bf16":
                g = T.planar_to_complex(*g)
                w = np.asarray(w[0], np.float32) + 1j * np.asarray(w[1], np.float32)
                assert _rel(g, w) <= 8e-3
            elif entry == "sdft_power":
                assert _rel(g, w) <= 6e-6
            else:
                np.testing.assert_allclose(_np(g), _np(w), atol=1e-5)
        np.testing.assert_allclose(_np(got[0].accumulator), _np(want[0].accumulator),
                                   atol=4 * np.finfo(np.float32).eps * 900)
    return "spectra_prologue", port, jax, check


CASES = {
    "roundtrip": lambda: _case_roundtrip(None),
    "roundtrip-batch": lambda: _case_roundtrip(2),
    "driver-hop100-refresh1": lambda: _case_driver(100, 1),
    "driver-hop4-refresh2": lambda: _case_driver(4, 2),
    "driver-hop8-no-refresh-batch": lambda: _case_driver(8, None, C=2),
    "hop1-k2-refresh1": lambda: _case_hop1(1, 1.0),
    "hop1-k2-refresh2": lambda: _case_hop1(2, 0.5),
    "fused-k2": lambda: _case_fused(1.0),
    "fused-k2-latency": lambda: _case_fused(0.5),
    "sdft_hopped-hop3": lambda: _case_sdft_hopped(3),
    "sdft_hopped-hop100-batch": lambda: _case_sdft_hopped(100, C=2),
    "hopped_block-refresh": lambda: _case_hopped_block(32, True),
    "hopped_block-subhop": lambda: _case_hopped_block(3, False),
    "refresh": lambda: _case_refresh(None),
    "refresh-batch": lambda: _case_refresh(3),
    "sdft": lambda: _case_spectra("sdft", None),
    "sdft-batch": lambda: _case_spectra("sdft", 3),
    "sdft-planar-bf16": lambda: _case_spectra("sdft-planar-bf16", None),
    "sdft-planar-bf16-batch": lambda: _case_spectra("sdft-planar-bf16", 3),
    "sdft_power": lambda: _case_spectra("sdft_power", None),
    "sdft_power-batch": lambda: _case_spectra("sdft_power", 3),
    "roundtrip-transform": lambda: _case_spectra("roundtrip-transform", None),
    "roundtrip-transform-batch": lambda: _case_spectra("roundtrip-transform", 2),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_graphed_path_matches_jax_and_the_eager_run(stub, case):
    name, port, jax, check = CASES[case]()
    got = port()
    assert name in _names(), _names()
    with graphs.disabled():
        eager = port()
    assert _equal(got, eager)
    check(got, jax())


@pytest.mark.parametrize("hop", [1, 100])
def test_jax_made_state_continues_graphed_as_eager(stub, hop):
    """A state made by the JAX package, carried over with
    ``state_from_arrays``, runs four graphed blocks exactly as the eager
    port does."""
    jp = J.Plan(256, window="hann", precision=J.FAST_PRECISION)
    tp = T.plan_from_jax(jp)
    x = _signal(1000 + 4 * 400, seed=21)
    js, _ = J.sdft(jp, J.init_state(jp), x[:1000])
    ts = T.state_from_arrays(J.state_to_arrays(js), device="cpu")
    xs = x[1000:].reshape(4, 400)
    got = T.roundtrip_hopped(tp, ts, xs, hop)
    with graphs.disabled():
        eager = T.roundtrip_hopped(tp, ts, xs, hop)
    assert _equal(got, eager)
    assert ("hop1_chain_body" if hop == 1 else "driver_chain_body") in _names()


def test_streamer_runs_through_the_graphs(stub):
    plan = T.Plan(128, window="hann", precision=T.FAST_PRECISION)
    blocks = list(_signal(4 * 512, seed=9).reshape(4, 512))
    s = T.Streamer(plan, refresh_every=2, device="cpu")
    got = list(s.run(blocks))
    hopped = list(T.Streamer(plan, refresh_every=1, device="cpu").run_hopped(blocks, 64, 2))
    assert {"refresh", "driver_chain_body"} <= set(_names())
    # run's round trip replays a graph of the Streamer's own, outside the cache
    assert [g.graph.name for g in s._carried.values()] == ["roundtrip_block_lti"]
    with graphs.disabled():
        want = list(T.Streamer(plan, refresh_every=2, device="cpu").run(blocks))
        want_h = list(T.Streamer(plan, refresh_every=1, device="cpu").run_hopped(blocks, 64, 2))
    assert all(np.array_equal(a, b) for a, b in zip(got, want))
    assert all(np.array_equal(a[0], b[0]) and np.array_equal(a[1], b[1])
               for a, b in zip(hopped, want_h))


def test_streamer_carries_its_state_in_its_own_graph(stub, tmp_path):
    """``run``'s collapsed round trip keeps the state in the Streamer's own
    graph: one capture per block shape (a short last block takes a second),
    none in the cache, no clone a block; reading the state between two
    yields copies it out, and a checkpoint taken there resumes as eager;
    two Streamers on one plan and shape never share a state."""
    plan = T.Plan(128, window="hann", precision=T.FAST_PRECISION)
    x = np.stack([_signal(5 * 512 + 200, seed=s) for s in (40, 41)])
    blocks = list(T.iter_blocks(x, 512, pad=False)) + [x[:, 5 * 512:]]
    with graphs.disabled():
        e = T.Streamer(plan, channels=2, device="cpu")
        want = list(e.run(blocks))
    a, b = (T.Streamer(plan, channels=2, device="cpu") for _ in range(2))
    ga, gb = a.run(blocks), b.run(blocks[::-1])
    got = [next(ga)]
    held = a.state                      # the state after blocks 0 and 1
    a.checkpoint(tmp_path / "ck.npz")
    got += [next(ga)]
    next(gb)
    got += list(ga)
    assert all(np.array_equal(p, q) for p, q in zip(got, want)) and len(got) == len(want)
    assert _equal(a.state, e.state)
    assert [k[0] for k in a._carried] == [(2, 512), (2, 200)]
    assert stub.captures == 4 and not _names()
    with graphs.disabled():
        e2 = T.Streamer(plan, channels=2, device="cpu")
        list(e2.run(blocks[:2]))
    assert _equal(held, e2.state)
    r = T.Streamer(plan, channels=2, device="cpu")
    r.restore(tmp_path / "ck.npz")
    assert all(np.array_equal(p, q) for p, q in zip(r.run(blocks[2:]), want[2:]))


@pytest.mark.parametrize("most", [1, 2])
def test_streamer_carried_graphs_are_bounded(stub, monkeypatch, most):
    """Past ``MAX_GRAPHS`` block shapes the Streamer drops the graph it
    used least recently; the state it held moves out with it."""
    monkeypatch.setattr(graphs, "MAX_GRAPHS", most)
    plan = T.Plan(128, window="hann", precision=T.FAST_PRECISION)
    x = _signal(4 * 300, seed=42)
    blocks = [x[:300], x[300:600], x[600:900], x[900:]]
    lengths = [256, 300, 280, 300]
    blocks = [np.concatenate([b, b])[:n] for b, n in zip(blocks, lengths)]
    s = T.Streamer(plan, device="cpu")
    got = list(s.run(blocks))
    with graphs.disabled():
        e = T.Streamer(plan, device="cpu")
        want = list(e.run(blocks))
    assert all(np.array_equal(p, q) for p, q in zip(got, want))
    assert _equal(s.state, e.state)
    assert [k[0] for k in s._carried] == [(280,), (300,)][2 - most:]


# -- on the card --------------------------------------------------------------------

def _card_paths(dev):
    """(name, call) of every graphed path at modest sizes on the card."""
    f32 = T.FAST_PRECISION
    big = T.Plan(4096, window="hann", precision=f32)
    drv = T.Plan(1000, window="hann", precision=f32)
    x = torch.as_tensor(_signal(4 * 16000, seed=30), device=dev)
    st_big = T.init_state(big, device=dev)
    st2 = T.init_state(big, channels=2, device=dev)
    st_drv = T.init_state(drv, device=dev)
    st_drv2 = T.init_state(drv, channels=2, device=dev)
    st_drv8 = T.init_state(drv, channels=8, device=dev)
    lead = x[:3000 + 3 * 700]
    st_lead = T.sdft(big, st_big, lead[:3000])[0]
    st_batch = stack_states([T.sdft(big, st_big, lead[:300 + 700 * c])[0] for c in range(3)])
    xb = x[:3 * 8229].reshape(3, 8229)
    low = torch.arange(4096, device=dev) < 400
    return {
        "sdft-packed": lambda: T.sdft(big, st_lead, x[:16384]),
        "sdft-planar": lambda: T.sdft(big, st_lead, x[:16384], "planar"),
        "sdft-planar-bf16": lambda: T.sdft(big, st_lead, x[:16384], "planar", "bfloat16"),
        "sdft_power": lambda: T.sdft_power(big, st_lead, x[:16384]),
        "sdft_power-bf16": lambda: T.sdft_power(big, st_lead, x[:16384], "bfloat16"),
        "sdft-batch": lambda: T.sdft(big, st_batch, xb, "planar"),
        "sdft-batch-bf16": lambda: T.sdft(big, st_batch, xb, "planar", "bfloat16"),
        "roundtrip-transform": lambda: T.roundtrip(big, st_batch, xb, lambda z: z * low),
        "hop1-k2-8ch": lambda: T.roundtrip_hopped(
            drv, st_drv8, x[:64000].reshape(4, 8, 2000), 1),
        "roundtrip": lambda: T.roundtrip(big, st_big, x[:16384]),
        "roundtrip-batch": lambda: T.roundtrip(big, st2, x[:32768].reshape(2, -1)),
        "driver-hop100": lambda: T.roundtrip_hopped(drv, st_drv, x.reshape(4, 16000), 100),
        "driver-hop4-refresh2": lambda: T.roundtrip_hopped(
            drv, st_drv, x[:16000].reshape(4, 4000), 4, refresh_every=2),
        "hop1-k2": lambda: T.roundtrip_hopped(drv, st_drv, x[:32000].reshape(4, 8000), 1),
        "hop1-k2-batch": lambda: T.roundtrip_hopped(
            drv, st_drv2, x[:16000].reshape(4, 2, 2000), 1, refresh_every=2),
        "fused-k2": lambda: scan.roundtrip_block_fused(big, st_big, x[:16384]),
        "sdft_hopped": lambda: T.sdft_hopped(drv, st_drv, x[:16000], 100),
        "hopped_block": lambda: lti.roundtrip_hopped_block(drv, st_drv, x[:16000], 100, True),
        "refresh": lambda: T.refresh(drv, T.roundtrip(drv, st_drv, x[:5000])[0]),
    }


CARD_PATHS = ["roundtrip", "roundtrip-batch", "driver-hop100", "driver-hop4-refresh2",
              "hop1-k2", "hop1-k2-batch", "fused-k2", "sdft_hopped", "hopped_block",
              "refresh", "sdft-packed", "sdft-planar", "sdft-planar-bf16", "sdft_power",
              "sdft_power-bf16", "sdft-batch", "sdft-batch-bf16", "roundtrip-transform",
              "hop1-k2-8ch"]


@pytest.mark.cuda
@pytest.mark.parametrize("path", CARD_PATHS)
def test_cuda_graphed_equals_eager_bit_for_bit(cuda_device, path):
    call = _card_paths(cuda_device)[path]
    got = call()
    assert graphs.entries(), "no graph was captured"
    again = call()
    with graphs.disabled():
        eager = call()
    torch.cuda.synchronize()
    assert _equal(got, eager) and _equal(again, eager)


@pytest.mark.cuda
@pytest.mark.parametrize("channels", [1, 8])
def test_cuda_streamer_carried_graph_equals_the_cached_one(cuda_device, channels):
    """At the collapsed cells' shape (C x 44100, m = 1000, FP32), ``run``'s
    carried graph gives the samples and the state of ``roundtrip``'s cached
    graph bit for bit over five blocks, a state read after the second block
    included; no yielded array aliases another."""
    plan = T.Plan(1000, window="hann",
                  precision=T.Precision("float32", "float32", mxu="highest"))
    blocks = [np.stack([_signal(44100, seed=50 + 10 * b + c) for c in range(channels)])
              for b in range(5)]
    s = T.Streamer(plan, channels=channels)
    run = s.run(blocks)
    got = [next(run)]
    mid = s.state
    got += list(run)
    st = T.init_state(plan, channels=channels, device=cuda_device)
    want = []
    for k, b in enumerate(blocks):
        st, y = T.roundtrip(plan, st, torch.as_tensor(b, device=cuda_device))
        want.append(y.cpu().numpy())
        if k == 1:
            assert _equal(mid, st)
    assert len(got) == 5 and all(np.array_equal(p, q) for p, q in zip(got, want))
    assert _equal(s.state, st)
    assert len({a.__array_interface__["data"][0] for a in got}) == len(got)


@pytest.mark.cuda
def test_cuda_held_outputs_survive_later_calls(cuda_device):
    plan = T.Plan(1000, window="hann", precision=T.FAST_PRECISION)
    xs = torch.as_tensor(_signal(3 * 4 * 4000, seed=31), device=cuda_device).reshape(3, 4, 4000)
    st = T.init_state(plan, device=cuda_device)
    first = T.roundtrip_hopped(plan, st, xs[0], 100)
    held = graphs.clone(first)
    T.roundtrip_hopped(plan, st, xs[1], 100)
    T.roundtrip_hopped(plan, st, xs[2], 100)
    again = T.roundtrip_hopped(plan, st, xs[0], 100)
    torch.cuda.synchronize()
    assert _equal(first, held) and _equal(again, held)


@pytest.mark.cuda
def test_cuda_two_precisions_never_share_a_graph(cuda_device):
    x = torch.as_tensor(_signal(65536, seed=32), device=cuda_device)
    outs = {}
    for mxu in ("highest", "high"):
        plan = T.Plan(4096, window="hann", precision=T.Precision("float32", "float32", mxu=mxu))
        st = T.init_state(plan, device=cuda_device)
        outs[mxu] = T.roundtrip(plan, st, x)
        with graphs.disabled():
            assert _equal(outs[mxu], T.roundtrip(plan, st, x))
    assert _names().count("roundtrip_block_lti") == 2
    assert not torch.equal(outs["highest"][1], outs["high"][1])


@pytest.mark.cuda
@pytest.mark.parametrize("hop", [1, 100])
def test_cuda_jax_made_state_continues_graphed_as_eager(cuda_device, hop):
    jp = J.Plan(1000, window="hann", precision=J.FAST_PRECISION)
    tp = T.plan_from_jax(jp)
    x = _signal(3000 + 4 * 8000, seed=33)
    js, _ = J.sdft(jp, J.init_state(jp), x[:3000])
    ts = T.state_from_arrays(J.state_to_arrays(js), device=cuda_device)
    xs = torch.as_tensor(x[3000:], device=cuda_device).reshape(4, 8000)
    got = T.roundtrip_hopped(tp, ts, xs, hop)
    with graphs.disabled():
        eager = T.roundtrip_hopped(tp, ts, xs, hop)
    torch.cuda.synchronize()
    assert _equal(got, eager)


@pytest.mark.cuda
def test_cuda_k2_launches_count_every_replay(cuda_device):
    plan = T.Plan(1000, window="hann", precision=T.FAST_PRECISION)
    xs = torch.as_tensor(_signal(4 * 2 * 2000, seed=34), device=cuda_device)
    # one K2 launch per block, whatever the channels
    for shape, per_block in (((4, 2000), 1), ((2, 2, 4000), 1)):
        st = T.init_state(plan, None if len(shape) == 2 else 2, device=cuda_device)
        blocks = xs[:int(np.prod(shape))].reshape(shape)
        T.roundtrip_hopped(plan, st, blocks, 1)
        # the body graph holds the prologue (one carry kernel) and the
        # refresh; K2 is launched after each replay, into the stacked outputs
        body = [e for e in graphs.entries() if e.name == "hop1_chain_body"][-1]
        assert body.launches == {"carry": 1}
        q = scan.LAUNCHES
        T.roundtrip_hopped(plan, st, blocks, 1)
        assert scan.LAUNCHES - q == shape[0] * per_block
    q = scan.LAUNCHES
    scan.roundtrip_block_fused(plan, T.init_state(plan, device=cuda_device), xs[:4000])
    scan.roundtrip_block_fused(plan, T.init_state(plan, device=cuda_device), xs[:4000])
    # two warm-up launches and one replay, then one replay
    assert scan.LAUNCHES - q == graphs.WARMUP_CALLS + 2


@pytest.mark.cuda
def test_cuda_prologue_graph_eviction_frees_no_pending_carries(cuda_device, monkeypatch):
    """With one graph kept, two shapes alternating back to back evict each
    other's prologue graph on every call, with no synchronisation between
    the calls: every output equals the eager one."""
    monkeypatch.setattr(graphs, "MAX_GRAPHS", 1)
    plan = T.Plan(4096, window="hann", precision=T.FAST_PRECISION)
    st = T.init_state(plan, device=cuda_device)
    xs = [torch.as_tensor(_signal(n, seed=35 + n), device=cuda_device) for n in (16384, 12288)]
    with graphs.disabled():
        want = [T.sdft(plan, st, x, "planar") for x in xs]
    got = [T.sdft(plan, st, xs[i % 2], "planar") for i in range(6)]
    torch.cuda.synchronize()
    assert [e.name for e in graphs.entries()] == ["spectra_prologue"]
    for i, g in enumerate(got):
        assert _equal(g, want[i % 2]), i


@pytest.mark.cuda
def test_cuda_warm_graphed_sdft_and_chain_block_never_sync(cuda_device):
    """A warm graphed ``sdft`` and one warm hop=1 chain block enqueue their
    work without a host synchronisation."""
    big = T.Plan(4096, window="hann", precision=T.FAST_PRECISION)
    drv = T.Plan(1000, window="hann", precision=T.FAST_PRECISION)
    st, sd = T.init_state(big, device=cuda_device), T.init_state(drv, device=cuda_device)
    x = torch.as_tensor(_signal(65536, seed=36), device=cuda_device)
    block = x[:8000].reshape(1, 8000)
    for _ in range(2):
        T.sdft(big, st, x, "planar")
        T.roundtrip_hopped(drv, sd, block, 1)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        T.sdft(big, st, x, "planar")
        T.roundtrip_hopped(drv, sd, block, 1)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()


@pytest.mark.cuda
def test_cuda_host_sync_inside_a_capture_raises(cuda_device):
    """Last in the file: a failed capture is the one state the card's
    graph machinery only partly recovers from."""
    x = torch.ones(64, device=cuda_device)
    with pytest.raises(RuntimeError, match="graph capture of item_probe failed"):
        graphs.run("item_probe", (), lambda t: t * t.sum().item(), x)
    assert "item_probe" not in _names()
    # the card goes on working, graphs included
    plan = T.Plan(1000, window="hann", precision=T.FAST_PRECISION)
    st = T.init_state(plan, device=cuda_device)
    got = T.roundtrip(plan, st, x.repeat(100))
    with graphs.disabled():
        want = T.roundtrip(plan, st, x.repeat(100))
    assert _equal(got, want)
