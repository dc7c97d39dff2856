"""The readers of the program's spans (``spans.py`` and the six metrics
that read it) on a hand-built Chrome trace: nested spans counted once,
spans clipped to the traced step, values over the window's blocks, and
None where the trace holds no such span."""

import pytest

from benchmark import harness, spec
from benchmark.tracing import Trace

#: the traced step, in the trace's microseconds
T0, T1 = 10_000.0, 14_000.0


def _x(name, ts, dur, cat="cpu_op"):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur}


def _run(events, blocks=4):
    doc = {"traceEvents": [_x("ProfilerStep#1", T0, T1 - T0, "user_annotation"), *events]}
    return harness.TracedRun(None, Trace(doc, (0.0, 1.0), blocks), harness.Records())


EVENTS = [
    # a replay with its capture and a copy inside, then a clone: 400 + 100 us
    _x("sdft.graphs.replay.g", T0 + 100, 400),
    _x("sdft.graphs.capture.g", T0 + 150, 200),
    _x("aten::copy_", T0 + 120, 20),
    _x("sdft.graphs.clone", T0 + 500, 100),
    # a replay that began before the step: 50 us inside it
    _x("sdft.graphs.replay.g", T0 - 150, 200),
    # one after the step: none of it
    _x("sdft.graphs.replay.g", T1 + 10, 100),
    # the Streamer's steps, one crossing the step's end: 300 + 60 + 100 us
    _x("sdft.stream.upload", T0 + 1000, 300),
    _x("sdft.stream.download", T0 + 1400, 60),
    _x("sdft.stream.upload", T1 - 100, 400),
    _x("sdft.stream.wait", T0 + 2000, 800),
    _x("sdft.stream.wait", T0 + 2500, 100),
    # the DTensor steps inside a program span: 120 + 80 us
    _x("sdft.parallel.sharded_sdft_pallas", T0 + 3000, 900),
    _x("sdft.parallel.in", T0 + 3010, 120),
    _x("sdft.parallel.out", T0 + 3800, 80),
    # the harness's own span and an api span count for none of them
    _x("bench.call", T0 + 50, 3900, "user_annotation"),
    _x("sdft.api.sdft", T0 + 60, 3000),
]

#: ms per block over 4 blocks
WANT = {
    "graph_host_ms": (400 + 100 + 50) / 4 / 1e3,
    "graph_host_ms.streamer": (400 + 100 + 50) / 4 / 1e3,
    "graph_host_ms.mesh": (400 + 100 + 50) / 4 / 1e3,
    "stream_copy_ms.streamer": (300 + 60 + 100) / 4 / 1e3,
    "stream_wait_ms.streamer": 800 / 4 / 1e3,
    "dtensor_ms.mesh": (120 + 80) / 4 / 1e3,
}


@pytest.mark.parametrize("name", list(WANT))
def test_reader_counts_nested_spans_once_inside_the_step(name):
    assert spec.reader(name)(_run(EVENTS)) == pytest.approx(WANT[name], rel=1e-12)


@pytest.mark.parametrize("name", list(WANT))
def test_reader_divides_by_the_windows_blocks(name):
    assert spec.reader(name)(_run(EVENTS, blocks=8)) == pytest.approx(WANT[name] / 2,
                                                                      rel=1e-12)


@pytest.mark.parametrize("name", list(WANT))
def test_reader_without_spans_gives_none(name):
    bare = [e for e in EVENTS if not e["name"].startswith("sdft.")]
    assert spec.reader(name)(_run(bare)) is None
    assert spec.reader(name)(_run(EVENTS, blocks=0)) is None


def test_the_six_metrics_are_appended_and_read_program_spans():
    names = [m["name"] for m in spec.benchmark_json()["per_layer"]]
    assert names[-6:] == list(WANT)
    for m in spec.benchmark_json()["per_layer"][-6:]:
        assert m["source"] == "program_span" and m["unit"] == "ms/block"
