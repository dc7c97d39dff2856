"""The port's spans and counters (``sdft_tpu_torch.tracing``): the spans a
CPU ``torch.profiler`` trace holds for the Streamer, the graphs (through
the stand-in capture backend of tests/helpers/graph_stub.py) and a
sharded program on spawned Gloo ranks, their nesting, that none is open
across a generator's ``yield``, that a span enters no record function
while no profiler records, and the counters."""

import importlib.util
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function

import sdft_tpu_torch as T
from sdft_tpu_torch import graphs, tracing
from sdft_tpu_torch.cli import main as t_main
from sdft_tpu_torch.io.wav import write_wav

HERE = os.path.dirname(os.path.abspath(__file__))


def _load(name, path):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


stub = _load("graph_stub", os.path.join(HERE, "helpers", "graph_stub.py"))
W = _load("torch_sharded_worker", os.path.join(HERE, "helpers", "torch_sharded_worker.py"))

F32 = T.Precision("float32", "float32")
#: the consumer's span around each pull from a Streamer's generator
PULL = "test.pull"


def _spans(path, prefixes=("sdft.", PULL)) -> list:
    """(name, start, end) of the Chrome trace's events named with a prefix,
    in start order."""
    events = json.loads(open(path).read())["traceEvents"]
    return sorted(((e["name"], float(e["ts"]), float(e["ts"]) + float(e["dur"]))
                   for e in events if e.get("ph") == "X" and e["name"].startswith(prefixes)),
                  key=lambda s: s[1])


def _traced(tmp_path, fn):
    """fn() under a CPU profiler; its result and the trace's spans."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    path = str(tmp_path / "trace.json")
    prof.export_chrome_trace(path)
    return out, _spans(path)


def _inside(inner, outer) -> bool:
    return outer[1] <= inner[1] and inner[2] <= outer[2]


def _pulled(gen) -> list:
    """Every output of ``gen``, each pull inside the consumer's span."""
    out = []
    while True:
        with record_function(PULL):
            try:
                item = next(gen)
            except StopIteration:
                return out
        out.append(item)


def _blocks(n, C=2, M=512):
    return [np.random.default_rng(k).standard_normal((C, M)).astype(np.float32) / 4
            for k in range(n)]


def _check_pulls(spans) -> list:
    """The sdft spans, after checking each lies inside one pull (so none
    stayed open across a yield into the consumer's time)."""
    pulls = [s for s in spans if s[0] == PULL]
    ours = [s for s in spans if s[0].startswith("sdft.")]
    assert pulls and ours
    for s in ours:
        assert any(_inside(s, p) for p in pulls), s
    return ours


@pytest.fixture
def stubbed(monkeypatch):
    backend = stub.StubBackend()
    monkeypatch.setattr(graphs, "BACKEND", backend)
    graphs.clear()
    yield backend
    graphs.clear()


@pytest.mark.parametrize("graphed", [False, True], ids=["eager", "graphed"])
def test_streamer_run_spans(tmp_path, request, graphed):
    """Each block of ``Streamer.run``: its upload, the round trip (eager:
    the api span; on graphs: a replay of the Streamer's own graph, which
    keeps the state, captured inside the first upload, with no clone), the
    copy back enqueued and the wait, 4 spans a block, none open across a
    yield."""
    if graphed:
        request.getfixturevalue("stubbed")
    plan = T.Plan(128, window="hann", precision=F32)
    s = T.Streamer(plan, channels=2, device="cpu")
    n = 4
    out, spans = _traced(tmp_path, lambda: _pulled(s.run(_blocks(n))))
    assert len(out) == n
    ours = _check_pulls(spans)
    names = [s[0] for s in ours]
    for name in ("sdft.stream.upload", "sdft.stream.download", "sdft.stream.wait"):
        assert names.count(name) == n, (name, names)
    graph = [s for s in ours if s[0].startswith("sdft.graphs.")]
    if graphed:
        replays = [s for s in graph if s[0].startswith("sdft.graphs.replay.")]
        captures = [s for s in graph if s[0].startswith("sdft.graphs.capture.")]
        assert len(replays) == n and len(captures) == 1
        assert "sdft.api.roundtrip" not in names and "sdft.graphs.clone" not in names
        uploads = [s for s in ours if s[0] == "sdft.stream.upload"]
        assert _inside(captures[0], uploads[0])
    else:
        assert not graph
        assert names.count("sdft.api.roundtrip") == n
    assert len([s for s in ours if ".capture." not in s[0]]) == 4 * n


def test_streamer_run_hopped_spans(tmp_path, stubbed):
    """A ``run_hopped`` group: its upload, the chain's api span with one
    replay a block inside it, its copy home enqueued and the wait for its
    outputs, none open across a yield."""
    plan = T.Plan(128, window="hann", precision=F32)
    s = T.Streamer(plan, channels=2, refresh_every=1, device="cpu")
    out, spans = _traced(tmp_path, lambda: _pulled(s.run_hopped(_blocks(4), hop=16,
                                                                chain=2)))
    assert len(out) == 4
    ours = _check_pulls(spans)
    names = [s[0] for s in ours]
    for name in ("sdft.stream.upload", "sdft.api.roundtrip_hopped", "sdft.stream.download",
                 "sdft.stream.wait"):
        assert names.count(name) == 2, (name, names)
    api = [s for s in ours if s[0] == "sdft.api.roundtrip_hopped"]
    replays = [s for s in ours if s[0].startswith("sdft.graphs.replay.")]
    assert len(replays) == 4
    assert all(any(_inside(r, a) for a in api) for r in replays)


def test_graph_spans_and_counters(tmp_path, stubbed):
    """``run``: a replay span per call, the capture nested in the first,
    a clone span per call; ``CAPTURES`` counts a new key once, and
    ``EVICTIONS`` counts once past ``MAX_GRAPHS`` keys."""
    def fn(x):
        return (x * 2,)

    c0, e0 = graphs.CAPTURES, graphs.EVICTIONS

    def calls():
        for _ in range(3):
            graphs.run("double", (), fn, torch.ones(4))

    _, spans = _traced(tmp_path, calls)
    names = [s[0] for s in spans]
    assert names.count("sdft.graphs.replay.double") == 3
    assert names.count("sdft.graphs.capture.double") == 1
    assert names.count("sdft.graphs.clone") == 3
    cap = next(s for s in spans if s[0] == "sdft.graphs.capture.double")
    assert _inside(cap, next(s for s in spans if s[0] == "sdft.graphs.replay.double"))
    assert (graphs.CAPTURES, graphs.EVICTIONS) == (c0 + 1, e0)
    for k in range(2, graphs.MAX_GRAPHS + 1):
        graphs.run("double", (), fn, torch.ones(4 + k))
    assert (graphs.CAPTURES, graphs.EVICTIONS) == (c0 + graphs.MAX_GRAPHS, e0)
    graphs.run("double", (), fn, torch.ones(3))
    assert (graphs.CAPTURES, graphs.EVICTIONS) == (c0 + graphs.MAX_GRAPHS + 1, e0 + 1)
    graphs.run("double", (), fn, torch.ones(3))
    assert graphs.CAPTURES == c0 + graphs.MAX_GRAPHS + 1


def test_held_graph_call_is_a_replay_span(tmp_path, stubbed):
    """A caller holding the graph (``get``, then calls) replays inside the
    same span as ``replay`` does."""
    g = graphs.get("held", (), lambda x: x + 1, torch.zeros(3))
    _, spans = _traced(tmp_path, lambda: [g(torch.full((3,), float(k))) for k in range(2)])
    assert [s[0] for s in spans] == ["sdft.graphs.replay.held"] * 2


def test_sharded_program_spans_on_two_gloo_ranks(tmp_path):
    """On a 1x2x1 Gloo mesh, each call of a sharded kernel program on rank 0
    holds its DTensor steps in and out, and its graph's replay, inside
    its program span, in that order."""
    out = tmp_path / "trace.json"
    proc = subprocess.run([sys.executable, W.__file__, "1x2x1", "--spans", str(out)],
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, (proc.stdout + proc.stderr)[-4000:]
    spans = _spans(str(out), ("sdft.",))
    programs = [s for s in spans if s[0] == "sdft.parallel.sharded_sdft_pallas"]
    assert len(programs) == 4
    for p in programs:
        inner = [s[0] for s in spans if s is not p and _inside(s, p)]
        steps = [n for n in inner if n in ("sdft.parallel.in", "sdft.parallel.out")
                 or n.startswith("sdft.graphs.replay.")]
        assert steps == ["sdft.parallel.in", "sdft.graphs.replay.sharded_kernel_prologue",
                         "sdft.parallel.out"], inner
    assert not [s for s in spans if s[0] in ("sdft.parallel.in", "sdft.parallel.out")
                and not any(_inside(s, p) for p in programs)]


def test_no_profiler_no_record_function(monkeypatch):
    """With no profiler recording, a span is one check of the profiler's
    state and the shared no-op: no record function is entered, on any
    path (monkeypatched to raise)."""
    checks = []

    def recording():
        checks.append(1)
        return torch._C._autograd._profiler_enabled()

    def refuse(name):
        raise AssertionError(f"record function entered for {name}")

    monkeypatch.setattr(tracing, "_recording", recording)
    monkeypatch.setattr(tracing, "_Record", refuse)
    with tracing.span("sdft.x") as a:
        assert a is None
    assert tracing.span("sdft.y") is tracing.span("sdft.z") is tracing._OFF
    assert len(checks) == 3
    plan = T.Plan(128, window="hann", precision=F32)
    s = T.Streamer(plan, channels=2, device="cpu")
    assert len(list(s.run(_blocks(2)))) == 2
    st = T.init_state(plan, channels=2, device="cpu")
    st, _ = T.sdft(plan, st, _blocks(1)[0])
    T.refresh(plan, st)


def test_span_records_under_a_profiler(tmp_path):
    """Under a profiler a span enters the record function and lands in the
    exported trace."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with tracing.span("sdft.test.outer"):
            with tracing.span("sdft.test.inner"):
                torch.ones(2) + 1
    path = str(tmp_path / "t2.json")
    prof.export_chrome_trace(path)
    spans = _spans(path)
    outer, inner = (next(s for s in spans if s[0] == n)
                    for n in ("sdft.test.outer", "sdft.test.inner"))
    assert _inside(inner, outer)


def test_counters_keys():
    got = tracing.counters()
    assert list(got) == ["graphs.captures", "graphs.evictions", "kernels.spectra.launches",
                         "kernels.spectra.paced_launches", "kernels.scan.launches",
                         "kernels.split_mm.launches", "kernels.carry.launches",
                         "stream.pinned_copies", "stream.overlapped_copies",
                         "ops.lti.k2_blocks", "ops.lti.body_blocks", "ops.synthesis.blocks",
                         "api.roundtrip.collapsed", "api.roundtrip.materialized"]
    assert all(isinstance(v, int) and v >= 0 for v in got.values())


def _chain_blocks(n=3, C=2, M=512):
    return torch.as_tensor(np.stack(_blocks(n, C=C, M=M)))


@pytest.mark.parametrize("hop,refresh_every", [(1, 1), (1, 2), (16, 1), (16, 2)])
def test_chain_block_spans(tmp_path, stubbed, hop, refresh_every):
    """Under a profiler each block of ``roundtrip_hopped``'s chain lies in
    one ``sdft.ops.lti.chain_block`` span inside the call's api span,
    holding that block's graph replay and the refresh due after it; the
    K2 route (hop 1) and the driver body (hop 16) alike."""
    plan = T.Plan(128, window="hann", precision=F32)
    st = T.init_state(plan, channels=2, device="cpu")
    xs = _chain_blocks()
    T.roundtrip_hopped(plan, st, xs, hop, refresh_every=refresh_every)     # captures
    _, spans = _traced(tmp_path, lambda: T.roundtrip_hopped(plan, st, xs, hop,
                                                            refresh_every=refresh_every))
    (api,) = [s for s in spans if s[0] == "sdft.api.roundtrip_hopped"]
    blocks = [s for s in spans if s[0] == "sdft.ops.lti.chain_block"]
    assert len(blocks) == len(xs) and all(_inside(b, api) for b in blocks)
    body = "hop1_chain_body" if hop == 1 else "driver_chain_body"
    for b in blocks:
        inner = [s[0] for s in spans if s is not b and _inside(s, b)]
        want = [f"sdft.graphs.replay.{body}"]
        if refresh_every == 2 and b is blocks[1]:
            want.append("sdft.graphs.replay.refresh_state_any")
        assert [n for n in inner if n.startswith("sdft.graphs.replay.")] == want, inner


def test_chain_block_span_enters_nothing_without_a_profiler(monkeypatch):
    """No profiler records: the chain's per-block span enters no record
    function (monkeypatched to raise) at hop 1 and at other hops."""
    def refuse(name):
        raise AssertionError(f"record function entered for {name}")

    monkeypatch.setattr(tracing, "_Record", refuse)
    plan = T.Plan(128, window="hann", precision=F32)
    st = T.init_state(plan, channels=2, device="cpu")
    for hop in (1, 16):
        _, hd, _ = T.roundtrip_hopped(plan, st, _chain_blocks(), hop)
        assert hd.shape[:3] == (3, 2, 512 // hop)


@pytest.mark.parametrize("hop,m,route", [(1, 128, "k2"), (100, 128, "body"), (1, 64, "body")])
def test_chain_route_counters(hop, m, route):
    """``ops.lti.k2_blocks`` counts the blocks of a hop = 1 chain on a plan
    the kernels take (K2, its plain version here), ``ops.lti.body_blocks``
    those of any other chain: hop 100, or hop 1 on a plan below the
    kernels' range."""
    plan = T.Plan(m, window="hann", precision=F32)
    st = T.init_state(plan, channels=2, device="cpu")
    before = tracing.counters()
    T.roundtrip_hopped(plan, st, _chain_blocks(M=1000), hop)
    after = tracing.counters()
    moved = {k: after[k] - before[k] for k in ("ops.lti.k2_blocks", "ops.lti.body_blocks")}
    assert moved == {"ops.lti.k2_blocks": 3 if route == "k2" else 0,
                     "ops.lti.body_blocks": 3 if route == "body" else 0}


def test_trace_subcommand_prints_the_counters(tmp_path, capsys):
    src = tmp_path / "src.wav"
    write_wav(str(src), np.random.default_rng(5).standard_normal(2000).clip(-3, 3) / 3, 44100)
    assert t_main(["trace", str(tmp_path / "tb"), "64", "1", "hann", "1", str(src),
                   str(tmp_path / "t.wav"), str(tmp_path / "t.dft"), "--device", "cpu"]) == 0
    last = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(last["counters"]) == set(tracing.counters())
    (trace,) = (tmp_path / "tb").glob("*.pt.trace.json")
    assert "sdft.api.roundtrip_hopped" in {s[0] for s in _spans(str(trace))}


@pytest.mark.cuda
def test_kernel_spans_on_the_card(tmp_path):
    """On the card: ``sdft``'s prologue replay, clone and K1 launch inside
    its api span; the hop=1 chain's K2 launches inside its own."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run: python -m pytest "
                    "tests/test_torch_tracing.py -m cuda on the card)")
    plan = T.Plan(1000, window="hann", precision=F32)
    dev = torch.device("cuda", 0)
    st = T.init_state(plan, channels=2, device=dev)
    x = torch.as_tensor(_blocks(1, M=4096)[0], device=dev)
    xs = torch.as_tensor(np.stack(_blocks(2, M=1024)), device=dev)
    graphs.clear()
    T.sdft(plan, st, x, layout="planar")
    T.roundtrip_hopped(plan, st, xs, 1)

    def calls():
        T.sdft(plan, st, x, layout="planar")
        T.roundtrip_hopped(plan, st, xs, 1)
        torch.cuda.synchronize()

    _, spans = _traced(tmp_path, calls)
    api = next(s for s in spans if s[0] == "sdft.api.sdft")
    inner = [s[0] for s in spans if s is not api and _inside(s, api)]
    assert inner == ["sdft.graphs.replay.spectra_prologue", "sdft.graphs.clone",
                     "sdft.kernels.spectra"], inner
    chain = next(s for s in spans if s[0] == "sdft.api.roundtrip_hopped")
    k2 = [s for s in spans if s[0] == "sdft.kernels.scan"]
    assert len(k2) == 2 and all(_inside(k, chain) for k in k2)
    graphs.clear()
