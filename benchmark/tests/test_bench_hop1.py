"""The hop = 1 chain cell (``m1000-c8-hop1.chain``): rehearsed end to end
at a tiny size on the CPU with hop kept at 1 (``tiny.cell`` sets every
cell's hop to 16), ``correct`` false under a broken
``sdft_tpu_torch.roundtrip_hopped``, K2's byte count at the cell's shape,
and the readers of ``k2_roofline``, ``k2_prologue_ms`` and
``chain_host_ms`` on a hand-built trace."""

import copy

import pytest
import torch

import sdft_tpu_torch as T
from benchmark import checks, control, cost, harness, spec
from benchmark.metrics import k2_roofline
from benchmark.tracing import Trace

from . import tiny

CELL = "m1000-c8-hop1.chain"
NEW = ["k2_roofline", "k2_prologue_ms", "chain_host_ms", "chain_host_ms.streamer"]


def _cell() -> spec.Cell:
    """The cell at m = 128, 2 channels, blocks of 512, chains of 4, a pool
    of 4 blocks; hop 1 and the refresh after every block as configured."""
    c = copy.deepcopy(spec.cell(CELL))
    c.config.update(dftsize=128, channels=2)
    c.traffic.update(samples_per_card=512, pool_blocks=4, chain=4)
    return c


def _run(trace: bool = False) -> dict:
    return harness.run(CELL, tiny.SEED, 1.0, trace, device_type="cpu", cell=_cell())


@pytest.mark.parametrize("trace", [False, True])
def test_tiny_cell_agrees_with_the_reference(trace):
    c = _cell()
    assert (c.config["hop"], c.config["refresh_every"]) == (1, 1)
    res = _run(trace)
    assert res["correct"], res["checks"]
    # whole chains; on a loaded CPU a chain can outlast the 1 s window
    assert res["failed"] == 0 and res["attempted"] >= 4
    assert res["attempted"] % 4 == 0 and res["blocks_delivered"] % 4 == 0
    assert set(res["checks"]) == {"hop_spectra_err", "samples_err", "acc_err",
                                  "delayline_err", "offset_err"}
    assert res["checks"]["delayline_err"]["value"] == 0.0
    want = {m["name"] for m in (c.per_layer if trace else c.end_to_end)}
    if trace:           # no kernel on the CPU: the program's span alone
        assert set(res["metrics"]) == {"chain_host_ms", "device_idle_share.streamer"} <= want
    else:
        assert set(res["metrics"]) == want == {"samples_per_s.streamer", "setup_s"}


def _broken(monkeypatch, fault: str):
    f = T.roundtrip_hopped

    def broken(plan, state, blocks, hop, **kw):
        st, hd, ys = f(plan, state, blocks, hop, **kw)
        if fault == "state_unchanged":
            return state, hd, ys
        ys.view(-1)[-1] += 1.0
        return st, hd, ys

    monkeypatch.setattr(T, "roundtrip_hopped", broken)


@pytest.mark.parametrize("fault", ["altered", "state_unchanged"])
def test_broken_entry_is_caught(monkeypatch, fault):
    _broken(monkeypatch, fault)
    res = _run()
    assert not res["correct"], res["checks"]


def test_control_fails_the_limits():
    """The reference in TF32 products in the program's place, its
    accumulator rebuilt after every block as the program's, fails the
    cell's limits at the tiny size too."""
    c = _cell()
    nums = control.readings(c, tiny.SEED, 400, torch.device("cpu"))
    ok, rows = checks.verdict(nums, c.limits)
    assert not ok, rows
    assert all(v > lim for k, v, lim in rows if lim > 0), rows


def test_k2_bound_at_the_cells_shape():
    """8 x 44100 packed float32 spectra at m = 1000 written once, the
    samples and state read once and the synthesized samples written once:
    2.8255 GB, 0.843 ms at 3.35 TB/s, bytes-bound."""
    c = cost.analysis_cost(1000, "hann", "float32", "float32", 44100)
    nbytes = 8 * (c.hbm_bytes + 44100 * k2_roofline.Y_BYTES)
    assert nbytes == 2_825_478_400
    ms, by = cost.bound(nbytes, f32_flops=8 * c.flops)
    assert by == "bytes" and ms == pytest.approx(0.84343, abs=1e-5)
    cfg = spec.cell(CELL).config
    assert k2_roofline.least_ms(cfg, 44100) == ms


#: the traced step, in the trace's microseconds
T0, T1 = 10_000.0, 14_000.0
K2 = "void sdft::scan_kernel<0, true, 1>(sdft::TileArgs, void*, void*, float2 const*, float*, float)"
ROWS = "sdft::scan_kernel_rows(float const*, float*, int, long long)"


def _x(name, ts, dur, cat):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur}


def _traced(events, blocks=4, cell=CELL):
    doc = {"traceEvents": [_x("ProfilerStep#1", T0, T1 - T0, "user_annotation"), *events]}
    return harness.TracedRun(spec.cell(cell), Trace(doc, (0.0, 1.0), blocks), harness.Records())


def _blocks_events(n=4):
    """n blocks: a prologue graph's kernels (200 us), K2 (800 + 20 us), a
    chain_block span of 300 us around each block's host work."""
    ev = []
    for b in range(n):
        t = T0 + 50 + 900 * b
        ev += [_x("sdft.ops.lti.chain_block", t, 300, "cpu_op"),
               _x("sdft.graphs.replay.hop1_chain_body", t + 10, 150, "cpu_op"),
               _x("sm80_xmma_gemm_f32f32_f32f32_f32_nn_n", t, 120, "kernel"),
               _x("void at::native::elementwise_kernel<128, 2>", t + 120, 80, "kernel"),
               _x(K2, t + 200, 800, "kernel"), _x(ROWS, t + 1000 - 20, 20, "kernel")]
    return ev


def test_k2_readers_on_a_synthetic_trace():
    run = _traced(_blocks_events())
    least = k2_roofline.least_ms(run.cell.config, 44100)
    assert spec.reader("k2_roofline")(run) == pytest.approx(100 * least / 0.82, rel=1e-12)
    assert spec.reader("k2_prologue_ms")(run) == pytest.approx(0.2, rel=1e-12)
    assert spec.reader("chain_host_ms")(run) == pytest.approx(0.3, rel=1e-12)
    assert spec.reader("chain_host_ms.streamer")(run) == pytest.approx(0.3, rel=1e-12)
    assert spec.reader("chain_host_ms")(_traced(_blocks_events(), blocks=8)) == pytest.approx(
        0.15, rel=1e-12)


def test_k2_readers_without_k2_or_spans_give_none():
    """A trace with no K2 launch (a program on another route, or the CPU)
    and no chain span (a program older than the span) reads None."""
    bare = [e for e in _blocks_events() if "scan_kernel" not in e["name"]
            and not e["name"].startswith("sdft.")]
    for name in NEW:
        assert spec.reader(name)(_traced(bare)) is None


def test_the_cell_and_its_metrics_are_appended():
    bench = spec.benchmark_json()
    assert bench["workloads"][-1]["name"] == CELL
    assert bench["configs"][-1]["name"] == spec.cell(CELL).config["name"] == "m1000-c8-hop1"
    assert [m["name"] for m in bench["per_layer"]][-4:] == NEW
    c = spec.cell(CELL)
    assert c.chips == 1
    assert {m["name"] for m in c.end_to_end} == {"samples_per_s.streamer", "setup_s"}
    assert {m["name"] for m in c.per_layer} == {"device_idle_share.streamer", *NEW[:3]}
    assert {m["moves"] for m in c.per_layer} == {"samples_per_s.streamer"}
    assert "chain_host_ms.streamer" in {m["name"] for m in
                                        spec.cell("m1000-c8-hop100.driver").per_layer}


def test_entry_reads_the_function_on_the_package_at_each_call(monkeypatch):
    """The entry calls ``sdft_tpu_torch.roundtrip_hopped`` as it stands at
    each call (so a test's replacement reaches it), with the configured
    hop and refresh cadence."""
    seen = []
    f = T.roundtrip_hopped

    def spy(plan, state, blocks, hop, **kw):
        seen.append((tuple(blocks.shape), hop, kw))
        return f(plan, state, blocks, hop, **kw)

    c = _cell()
    ctx = harness.Ctx(c, harness.make_plan(c.config), torch.device("cpu"),
                      harness.Stream(5, harness.make_pool(5, 4, 2, 512, "cpu")))
    runner = spec.entry(c.traffic["entry"]).make(ctx)
    monkeypatch.setattr(T, "roundtrip_hopped", spy)
    runner.warm()
    assert seen == [((4, 2, 512), 1, {"refresh_every": 1})] * 2
