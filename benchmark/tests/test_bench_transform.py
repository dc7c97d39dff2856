"""The cells ``m1000-c8.transform`` and ``m1000-c1.collapsed`` at a tiny
size on the CPU (``tiny.cell``, at each cell's own channel count), the
mono configuration against the one it narrows, and the transform cell's
readers: the synthesis span read per block, the synthesis roofline's
arithmetic on a trace made by hand."""

import json

import pytest

from benchmark import harness, spec
from benchmark import tracing as btracing

from . import tiny

CELL = "m1000-c8.transform"
MONO = "m1000-c1.collapsed"


def _run(trace: bool, workload: str = CELL) -> dict:
    c = tiny.cell(workload)
    c.config["channels"] = spec.cell(workload).config["channels"]
    return harness.run(workload, tiny.SEED, 1.0, trace, device_type="cpu", cell=c)


@pytest.mark.parametrize("workload", [CELL, MONO])
@pytest.mark.parametrize("trace", [False, True])
def test_new_cell_agrees_with_the_reference(trace, workload):
    res = _run(trace, workload)
    assert res["correct"], res["checks"]
    assert res["failed"] == 0 and res["attempted"] >= 1
    assert res["checks"]["delayline_err"]["value"] == 0.0
    assert res["checks"]["offset_err"]["value"] == 0.0
    if not trace:
        assert set(res["metrics"]) == {m["name"] for m in spec.cell(workload).end_to_end}


def test_mono_config_is_the_c8_deployment_on_one_stream():
    """``m1000-c1`` is bench.cpp's own single stream: the plan of
    ``m1000-c8`` with one channel, so its only departure is the precision."""
    bench = json.loads((spec.ROOT / "BENCHMARK.json").read_text())
    entry = next(c for c in bench["configs"] if c["name"] == "m1000-c1")
    assert entry["reduced"] == ["precision"]
    mono, c8 = spec.cell(MONO).config, spec.cell("m1000-c8.collapsed").config
    assert mono["channels"] == mono["source_values"]["channels"] == 1
    assert set(mono["departures"]) == {"precision"}
    same = ("dftsize", "window", "latency", "precision", "mesh", "source", "source_values")
    assert {k: mono[k] for k in same} == {k: c8[k] for k in same}
    assert spec.cell(MONO).traffic == spec.cell("m1000-c8.collapsed").traffic


def test_transform_cell_reads_the_synthesis_span():
    """On the CPU the synthesis's host span is read per block; the device
    readers find no kernel there and leave their metrics out."""
    import sdft_tpu_torch as T

    before = T.api.ROUNDTRIP_MATERIALIZED
    res = _run(True)
    assert T.api.ROUNDTRIP_MATERIALIZED > before
    assert res["metrics"]["synthesis_host_ms"]["value"] > 0
    assert "synthesis_roofline" not in res["metrics"]
    assert "k1_roofline.transform" not in res["metrics"]


def _trace(kernels) -> btracing.Trace:
    events = [{"ph": "X", "cat": "cpu_op", "name": "ProfilerStep#1", "ts": 0.0, "dur": 1e6}]
    events += [{"ph": "X", "cat": cat, "name": name, "ts": 10.0 + i, "dur": dur}
               for i, (cat, name, dur) in enumerate(kernels)]
    return btracing.Trace({"traceEvents": events}, (0.0, 1.0), blocks=2)


def test_synthesis_roofline_counts_all_but_k1_carry_and_nccl():
    """Its least time over the device time per K1 launch of every other
    kernel and copy: two launches, 1 ms of synthesis and copies a block."""
    from benchmark.metrics import synthesis_roofline as S

    cell = spec.cell(CELL)
    tr = _trace([("kernel", "void sdft::spectra_kernel<0, true, 1, false>", 1100.0)] * 2
                + [("kernel", "void sdft::front::carry_front<true, true>", 60.0)] * 2
                + [("kernel", "ncclDevKernel_Broadcast", 500.0)]
                + [("kernel", "direct_copy_kernel", 700.0)] * 2
                + [("kernel", "gemv2T_kernel_val", 290.0)] * 2
                + [("gpu_memcpy", "Memcpy DtoD (Device -> Device)", 10.0)] * 2
                + [("gpu_memset", "Memset (Device)", 50.0)])
    run = harness.TracedRun(cell, tr, harness.Records())
    least = 8 * 44100 * (8 * 1000 + 4) / 3.35e12 * 1e3
    assert S.least_ms(cell.config, 44100) == pytest.approx(least)
    assert S.read(run) == pytest.approx(100.0 * least / 1.0)
    assert S.read(harness.TracedRun(cell, _trace([("kernel", "gemv", 1.0)]),
                                    harness.Records())) is None
