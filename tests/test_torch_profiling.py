"""The port's profiling module against ``sdft_tpu.profiling`` on the CPU.

Held against the JAX functions: the result keys of ``benchmark`` and
``benchmark_marginal`` (a CPU run has no device time and no peaks, as a
JAX CPU run has none), ``scaling_projection`` exactly on the same explicit
arguments, ``device_peaks`` of the CPU.  Smoke-run at tiny sizes: the
``bench`` and ``trace`` subcommands (the traced CLI's outputs equal the
untraced run's byte for byte), ``bench --mesh 1x1x1`` on a one-rank Gloo
group, and ``measure_scaling_proxy``'s two Gloo processes.  Times measured
here are CPU times and are checked only for being positive.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sdft_tpu as J
import sdft_tpu_torch as T
from sdft_tpu import profiling as jprof
from sdft_tpu_torch import profiling as tprof
from sdft_tpu_torch.cli import main as t_main
from sdft_tpu_torch.io.wav import write_wav


def _steps():
    def jstep(state, x):
        return state + jnp.sum(x), x * 2.0

    def tstep(state, x):
        return state + x.sum(), x * 2.0

    return jstep, tstep


def test_benchmark_keys_match_jax():
    jstep, tstep = _steps()
    plan = J.Plan(64, window="hann", precision=J.FAST_PRECISION)
    cost_j = jprof.roundtrip_cost(plan, 8)
    cost_t = tprof.roundtrip_cost(T.plan_from_jax(plan), 8)
    assert cost_t == tprof.OpCost(cost_j.flops, cost_j.hbm_bytes)
    jargs = (jnp.float32(0.0), jnp.ones((8,), jnp.float32))
    targs = (torch.zeros(()), torch.ones(8))
    for cost in (None, cost_j):
        want = jprof.benchmark(jax.jit(jstep), jargs, iters=2, warmup=1, cost=cost)
        got = tprof.benchmark(tstep, targs, iters=2, warmup=1,
                              cost=cost and cost_t)
        assert set(got) == set(want)
        assert got["seconds"] > 0 and got["median_seconds"] >= got["seconds"]
    assert got["flops_per_s"] == pytest.approx(cost_t.flops / got["seconds"])


def test_benchmark_marginal_keys_match_jax():
    jstep, tstep = _steps()
    xs = np.ones((12, 8), np.float32)
    want = jprof.benchmark_marginal(jstep, jnp.float32(0.0), jnp.asarray(xs),
                                    k_lo=2, k_hi=6, repeats=1)
    got = tprof.benchmark_marginal(tstep, torch.zeros(()), torch.as_tensor(xs),
                                   k_lo=2, k_hi=6, repeats=1)
    noise = {"marginal_noise_floor"}
    assert set(got) - noise == set(want) - noise
    assert np.isfinite(got["seconds"]) and got["seconds"] > 0
    if "marginal_noise_floor" not in got:
        assert got["seconds"] == pytest.approx(
            (got["chain_hi_seconds"] - got["chain_lo_seconds"]) / 4)


def test_benchmark_marginal_of_the_round_trip_with_cost():
    """The collapsed round trip through the marginal harness with the
    roofline keys of a CPU run (no peaks, no fractions)."""
    plan = T.Plan(64, window="hann", precision=T.FAST_PRECISION)
    from sdft_tpu_torch.ops.lti import roundtrip_block_lti

    xs = torch.as_tensor(np.random.default_rng(0).standard_normal((6, 256)),
                         dtype=torch.float32)
    res = tprof.benchmark_marginal(lambda st, x: roundtrip_block_lti(plan, st, x),
                                   T.init_state(plan, device="cpu"), xs,
                                   k_lo=2, k_hi=5, repeats=1,
                                   cost=tprof.roundtrip_cost(plan, 256))
    assert {"flops_per_s", "hbm_gb_per_s", "intensity_flop_per_byte"} <= set(res)
    assert "hbm_roofline_fraction" not in res and "mxu_roofline_fraction" not in res


@pytest.mark.parametrize("m,t_fixed,ns,block,link,lat", [
    (1000, 30.0, 0.5, 262144, 45.0, 2.0),
    (4096, 12.5, 0.02, 65536, 450.0, 8.0),
    (512, 100.0, 1.5, 16384, 25.0, 30.0),
])
def test_scaling_projection_equals_jax(m, t_fixed, ns, block, link, lat):
    want = jprof.scaling_projection(m, t_fixed, ns, block, ici_gb_per_s=link,
                                    coll_latency_us=lat)
    got = tprof.scaling_projection(m, t_fixed, ns, block, link_gb_per_s=link,
                                   coll_latency_us=lat)
    for key in ("m", "block", "strong", "weak"):
        assert got[key] == want[key]
    assert got["model"] == {"t_fixed_us": t_fixed, "ns_per_sample": ns,
                            "link_gb_per_s": link, "coll_latency_us": lat}


def test_scaling_projection_needs_the_interconnect():
    """The JAX defaults are a TPU ring's: the port takes no default."""
    with pytest.raises(TypeError):
        tprof.scaling_projection(1000, 30.0, 0.5)


def test_device_peaks_of_the_cpu():
    assert tprof.device_peaks("cpu") == (None, None)
    assert tprof.device_peaks(torch.device("cpu")) == (None, None)
    if not torch.cuda.is_available():
        assert tprof.device_peaks() == (None, None)
    # JAX on the CPU knows no peaks either
    assert jprof.device_peaks(jax.devices("cpu")[0]) == (None, None)


@pytest.mark.parametrize("name,peaks", [
    ("NVIDIA H100 80GB HBM3", (989e12, 3.35e12)),
    ("NVIDIA H200", (989e12, 4.8e12)),
    ("NVIDIA H100 PCIe", (None, None)),
    ("NVIDIA A100-SXM4-80GB", (None, None)),
])
def test_device_peaks_by_card_name(monkeypatch, name, peaks):
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda device=None: name)
    assert tprof.device_peaks("cuda:0") == peaks


def test_bound_picks_the_larger_time():
    assert tprof.bound(3.35e12) == (pytest.approx(1000.0), "bytes")
    assert tprof.bound(3.35e9, 67e12) == (pytest.approx(1000.0), "operations")
    assert tprof.bound(0, 0, 989e12)[0] == pytest.approx(1000.0)


@pytest.mark.parametrize("m,route", [(64, "ops sdft_block + isdft_block"),
                                     (256, "K2 roundtrip_block_fused")])
def test_bench_prints_both_rows(capsys, m, route):
    """bench through the CLI on the CPU: the header, the collapsed row, the
    scan-form row (K2's plain version where the plan takes the kernels)."""
    assert t_main(["bench", str(m), "1024", "1", "--device", "cpu"]) == 0
    out = capsys.readouterr().out.splitlines()
    assert out[0] == "device: cpu (cpu), kernels: off"
    assert out[1].startswith(f"roundtrip LTI    m={m} block=1024: ")
    assert out[2].startswith(f"roundtrip scan   m={m} block=1024: ")
    assert out[2].endswith(f"samples/s ({route})")
    assert out[3].startswith("achieved: ")
    assert len(out) == 4  # no peaks on the CPU: no fractions, no bound


def test_bench_mesh_prints_its_json_line(capsys):
    import torch.distributed as dist

    assert t_main(["bench", "--mesh", "1x1x1", "64", "1024", "1", "--device", "cpu"]) == 0
    assert not dist.is_initialized()  # the one-rank group it made is gone
    out = capsys.readouterr().out.strip().splitlines()
    assert "mesh channel=1 time=1 bins=1" in out[0]
    row = json.loads(out[-1])
    assert row["metric"] == "sharded_roundtrip_samples_per_s_m64"
    assert row["mesh"] == {"channel": 1, "time": 1, "bins": 1}
    assert row["value"] > 0 and row["per_device_samples_per_s"] == row["value"]
    assert row["scaling_efficiency_vs_1dev"] > 0


def test_bench_mesh_rejects_a_bad_spec():
    with pytest.raises(SystemExit, match="CxTxB"):
        t_main(["bench", "--mesh", "1x2", "--device", "cpu"])


def test_trace_over_the_cli(tmp_path):
    src = tmp_path / "src.wav"
    write_wav(str(src), np.random.default_rng(5).standard_normal(2000).clip(-3, 3) / 3, 44100)
    args = ["64", "1", "hann", "1", str(src)]
    tb = tmp_path / "tb"
    assert t_main(["trace", str(tb)] + args + [str(tmp_path / "t.wav"),
                                               str(tmp_path / "t.dft"), "--device", "cpu"]) == 0
    assert t_main(args + [str(tmp_path / "u.wav"), str(tmp_path / "u.dft"),
                          "--device", "cpu"]) == 0
    for ext in ("wav", "dft"):
        assert (tmp_path / f"t.{ext}").read_bytes() == (tmp_path / f"u.{ext}").read_bytes()
    (trace,) = tb.glob("*.pt.trace.json")
    events = json.loads(trace.read_text())["traceEvents"]
    names = {e.get("name") for e in events}
    assert any(n and n.startswith("aten::") for n in names)


def test_measure_scaling_proxy():
    res = tprof.measure_scaling_proxy(m=64, block=1024, timeout_s=120)
    assert set(res) == {"m", "block", "t1_ms", "t2_ms", "efficiency"}
    assert (res["m"], res["block"]) == (64, 1024)
    assert res["t1_ms"] > 0 and res["t2_ms"] > 0 and res["efficiency"] > 0


def test_measure_scaling_proxy_raises_with_the_workers_output():
    """Where the JAX proxy returns None, the port raises with the output."""
    with pytest.raises(RuntimeError, match="scaling worker .* exited"):
        tprof.measure_scaling_proxy(m=64, block=101, timeout_s=120)


@pytest.mark.cuda
def test_cuda_benchmark_reports_device_time():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    plan = T.Plan(4096, window="hann", precision=T.FAST_PRECISION)
    x = torch.randn(16384, device="cuda")
    st = T.init_state(plan)
    res = tprof.benchmark(lambda s, v: T.sdft(plan, s, v, "planar"), (st, x), iters=3,
                          cost=tprof.analysis_cost(plan, 16384))
    assert 0 < res["device_seconds"] <= res["median_seconds"]
    assert 0 < res["hbm_roofline_fraction"] <= 1.05
    assert tprof.wall_time(lambda: T.sdft(plan, st, x, "planar"), 3) > 0


class _FakeEvent:
    def __init__(self, key, count, us):
        self.key, self.count, self.self_device_time_total = key, count, us


class _FakeProfile:
    """A stand-in for ``torch.profiler.profile`` that hands out one
    recorded measurement after another (a list of events each)."""

    def __init__(self, measurements):
        self.measurements = measurements

    def __call__(self, **kw):
        self.events = self.measurements.pop(0)
        return self

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def step(self):
        pass

    def key_averages(self):
        return self.events


@pytest.mark.parametrize("first", [[], [_FakeEvent("k", 3, 30.0)]])
def test_device_time_measures_again_after_a_lost_measurement(monkeypatch, first):
    """A measurement that recorded no device time, or a kernel count that is
    not a multiple of the calls, is taken again; four such raise."""
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    monkeypatch.setattr(tprof.time, "sleep", lambda s: None)
    good = [_FakeEvent("k", 4, 40.0), _FakeEvent("copy", 8, 8.0)]
    monkeypatch.setattr(torch.profiler, "profile", _FakeProfile([first, good]))
    assert tprof.device_time(lambda: None, 4) == pytest.approx(0.012)
    monkeypatch.setattr(torch.profiler, "profile", _FakeProfile([first] * 4))
    with pytest.raises(RuntimeError, match="in 4 measurements"):
        tprof.device_time(lambda: None, 4)
