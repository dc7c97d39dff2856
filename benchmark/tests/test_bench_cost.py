"""The benchmark's frozen byte and operation count (``benchmark.cost``)
equals the port's ``profiling`` at the cells' shapes."""

import pytest

from benchmark import cost, spec

import sdft_tpu_torch as T
from sdft_tpu_torch import profiling


def _shapes():
    for w in spec.benchmark_json()["workloads"]:
        c = spec.cell(w["name"])
        yield w["name"], c.config, int(c.traffic["samples_per_card"])


@pytest.mark.parametrize("workload,config,n", list(_shapes()))
def test_costs_equal_the_ports(workload, config, n):
    p = config["precision"]
    plan = T.Plan(config["dftsize"], window=config["window"], latency=config["latency"],
                  precision=T.Precision(p["td"], p["fd"], p["mxu"]))
    args = (config["dftsize"], config["window"], p["td"], p["fd"], n)
    for emit in (True, False):
        a, b = cost.analysis_cost(*args, emit_dfts=emit), profiling.analysis_cost(plan, n, emit)
        assert (a.flops, a.hbm_bytes) == (b.flops, b.hbm_bytes)
    for nbytes, flops in ((2.6e9, 0.0), (1e6, 1e12), (8.6e9, 2.5e10)):
        assert cost.bound(nbytes, flops) == profiling.bound(nbytes, flops)


def test_peaks_equal_the_ports():
    assert (cost.PEAK_BYTES, cost.PEAK_F32) == (profiling.PEAK_BYTES, profiling.PEAK_F32)


def test_k1_bound_at_the_spectra_cell():
    """8 x 44100 planar float32 spectra at m = 1000: 2.82 GB written once,
    0.843 ms at 3.35 TB/s, bytes-bound."""
    c = cost.analysis_cost(1000, "hann", "float32", "float32", 44100)
    ms, by = cost.bound(8 * c.hbm_bytes, f32_flops=8 * c.flops)
    assert by == "bytes" and 0.84 < ms < 0.85
