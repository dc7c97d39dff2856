"""The graphed paths (``sdft_tpu_torch.graphs``): the cache's key, bound and
switches, what a replay returns, and every graphed path against its JAX
counterpart.

On the CPU a stand-in capture backend (``StubBackend``, put in
``graphs.BACKEND``) "captures" by running the function once and "replays"
by running it again into the same static outputs, so the port's graph
plumbing (static inputs, the chain's state fed back, the stacked outputs,
the refresh cadence) runs here on CPU tensors.  With the real backend CPU
tensors never reach the cache.  Gates as the existing parity tests:
float64 plans 1e-12 of scale (tests/test_torch_lti.py), float32 kernel
plans the JAX hop=1 route's class (spectra 1.5e-5 of scale, samples atol
5e-4, tests/test_torch_slice.py) and the fused round trip's atol 5e-4,
rtol 1e-3 (tests/test_torch_kernels.py).  The ``-m cuda`` tests hold the
real graphs against the eager run on the card.
"""

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

F64 = J.Precision("float64", "float64")


def _signal(n, seed=0):
    return np.random.default_rng(seed).standard_normal(n).clip(-1, 1).astype(np.float32)


def _np(a):
    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def _rel(got, want):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-300)


class _StubGraph:
    def __init__(self, fn, args, out):
        self.fn, self.args, self.out = fn, args, out

    def replay(self):
        saved = spectra.LAUNCHES, scan.LAUNCHES
        new = self.fn(*self.args)
        spectra.LAUNCHES, scan.LAUNCHES = saved     # a replay runs no Python
        for s, t in zip(graphs.leaves(self.out), graphs.leaves(new)):
            s.copy_(t)


class StubBackend:
    """Captures on the CPU: one eager call fixes the static outputs, each
    replay recomputes them in place."""

    device_type = "cpu"

    def __init__(self):
        self.captures = 0

    def warmup(self, fn, args, device):
        for _ in range(graphs.WARMUP_CALLS):
            fn(*args)

    def capture(self, fn, args, device):
        self.captures += 1
        out = fn(*args)
        return _StubGraph(fn, args, out), out

    def reserved(self, device):
        return 0

    def clear(self):
        pass


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
    tf32 = plan.with_(precision=T.Precision("float32", "float32", mxu="high"))
    st = T.init_state(plan, device="cpu")
    st2 = T.init_state(plan, channels=2, device="cpu")
    x = torch.as_tensor(_signal(512))
    xs = x.reshape(4, 128)
    calls = [
        lambda: lti.roundtrip_block_lti(plan, st, x),
        lambda: lti.roundtrip_block_lti(tf32, st, x),                 # precision
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
    got = list(T.Streamer(plan, refresh_every=2, device="cpu").run(blocks))
    hopped = list(T.Streamer(plan, refresh_every=1, device="cpu").run_hopped(blocks, 64, 2))
    assert {"roundtrip_block_lti", "refresh", "driver_chain_body"} <= set(_names())
    with graphs.disabled():
        want = list(T.Streamer(plan, refresh_every=2, device="cpu").run(blocks))
        want_h = list(T.Streamer(plan, refresh_every=1, device="cpu").run_hopped(blocks, 64, 2))
    assert all(np.array_equal(a, b) for a, b in zip(got, want))
    assert all(np.array_equal(a[0], b[0]) and np.array_equal(a[1], b[1])
               for a, b in zip(hopped, want_h))


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
    return {
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
              "refresh"]


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
    for shape, per_block in (((4, 2000), 1), ((2, 2, 4000), 2)):
        st = T.init_state(plan, None if len(shape) == 2 else 2, device=cuda_device)
        blocks = xs[:int(np.prod(shape))].reshape(shape)
        T.roundtrip_hopped(plan, st, blocks, 1)
        body = [e for e in graphs.entries() if e.name == "hop1_chain_body"][-1]
        assert body.launches == {"scan": per_block}
        q = scan.LAUNCHES
        T.roundtrip_hopped(plan, st, blocks, 1)
        assert scan.LAUNCHES - q == shape[0] * per_block
    q = scan.LAUNCHES
    scan.roundtrip_block_fused(plan, T.init_state(plan, device=cuda_device), xs[:4000])
    scan.roundtrip_block_fused(plan, T.init_state(plan, device=cuda_device), xs[:4000])
    # two warm-up launches and one replay, then one replay
    assert scan.LAUNCHES - q == graphs.WARMUP_CALLS + 2


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
