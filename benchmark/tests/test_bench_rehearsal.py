"""Each cell run end to end at a tiny size on the CPU, the port's plain
versions in place of the kernels: its traffic against the reference, and
the shape of the result line.  A measuring run without a card fails."""

import json
import os
import shutil
import subprocess
import sys

import pytest

from benchmark import spec

from . import tiny

BENCH = json.loads((spec.ROOT / "BENCHMARK.json").read_text())


def _check_line(res: dict, workload: str, trace: bool):
    keys = list(res)
    assert keys[:3] == ["correct", "attempted", "failed"] and keys[-1] == "checks"
    assert {"metrics", "device"} <= set(keys)
    c = spec.cell(workload)
    want = c.per_layer if trace else c.end_to_end
    for name, m in res["metrics"].items():
        assert m["unit"] == next(x["unit"] for x in want if x["name"] == name)
    if not trace:
        assert set(res["metrics"]) == {m["name"] for m in want}
        assert all(m["value"] > 0 for m in res["metrics"].values()), res["metrics"]
    dev = res["device"]
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(dev)
    assert dev["count"] == c.chips
    if trace:
        assert dev["window_s"] > 0 and "busy_s" in dev
        assert set(res["breakdown"]) == {"device_ops", "idle_gaps"}
        assert all(len(res["breakdown"][k]) <= 10 for k in res["breakdown"])
    for name, v in res["checks"].items():
        assert set(v) == {"value", "limit"}
    json.dumps(res, allow_nan=False)


@pytest.mark.parametrize("trace", [False, True])
@pytest.mark.parametrize("workload", tiny.CELLS)
def test_cell_agrees_with_the_reference(workload, trace):
    res = tiny.run(workload, trace=trace)
    assert res["correct"], res["checks"]
    assert res["failed"] == 0 and res["attempted"] >= 1
    assert res["checks"]["delayline_err"]["value"] == 0.0
    assert res["checks"]["offset_err"]["value"] == 0.0
    _check_line(res, workload, trace)


def test_the_same_seed_gives_the_same_inputs():
    from benchmark import harness

    a = harness.make_pool(2**31 + 11, 3, 2, 64, "cpu")
    b = harness.make_pool(2**31 + 11, 3, 2, 64, "cpu")
    c = harness.make_pool(2**31 + 12, 3, 2, 64, "cpu")
    assert (a == b).all() and not (a == c).all()
    assert a.abs().max() <= 1.0 and len(a.unique()) > 300
    s = harness.Stream(2**31 + 11, a)
    assert {s.index(k) // 3 for k in range(64)} == {0, 1}     # both signs occur
    assert (s.block(4) == harness.Stream(2**31 + 11, b).block(4)).all()


def test_no_card_fails_and_prints_no_result():
    proc = subprocess.run([sys.executable, "-m", "benchmark.run", "--workload",
                           "m1000-c8.spectra", "--seed", "5", "--seconds", "1", "--trace", "0"],
                          cwd=spec.ROOT, capture_output=True, text=True, timeout=120,
                          env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
    assert proc.returncode != 0
    assert "{" not in proc.stdout


def test_the_benchmark_alone_fails(tmp_path):
    """A directory with BENCHMARK.json and the benchmark's files only has
    no program to run: it exits non-zero and prints no result."""
    shutil.copy(spec.ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(spec.ROOT / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    proc = subprocess.run([sys.executable, "-c",
                           "import sys; from benchmark import harness, spec; "
                           "c = spec.cell('m1000-c8.spectra'); "
                           "sys.exit(0 if harness.run(c.name, 1, 0.1, False, "
                           "device_type='cpu') else 0)"],
                          cwd=tmp_path, capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0 and "sdft_tpu_torch" in proc.stderr
