"""The port's quality metrics against ``sdft_tpu.metrics`` (mirrors
tests/test_metrics.py case by case), on numpy arrays and on tensors, and
the port's ``__all__`` against the JAX package's."""

import numpy as np
import pytest
import torch

import sdft_tpu as J
import sdft_tpu_torch as T
from sdft_tpu import metrics as jm
from sdft_tpu_torch.metrics import align_roundtrip, roundtrip_snr_db, snr_db


def test_snr_db_known_values():
    x = np.ones(1000)
    assert snr_db(x, x) == float("inf")
    # noise at exactly -20 dB relative power
    y = x + np.full(1000, 0.1)
    assert snr_db(x, y) == pytest.approx(20.0, abs=1e-9)
    assert snr_db(torch.as_tensor(x), torch.as_tensor(y)) == jm.snr_db(x, y)
    with pytest.raises(ValueError):
        snr_db(x, x[:10])


def test_align_roundtrip_matches_reference_slicing():
    x = np.arange(10.0)
    y = np.arange(10.0) + 100
    xa, ya = align_roundtrip(x, y, 3)
    np.testing.assert_array_equal(xa, x[:7])
    np.testing.assert_array_equal(ya, y[3:])
    for d in (0, 3, 9):
        for got, want in zip(align_roundtrip(torch.as_tensor(x), y, d),
                             jm.align_roundtrip(x, y, d)):
            np.testing.assert_array_equal(got, want)
    with pytest.raises(ValueError):
        align_roundtrip(x, y, 10)


@pytest.mark.parametrize("latency", [1.0, 0.5])
def test_roundtrip_snr_gate(latency):
    """The SNR trend of the reference latency example
    (python/examples/latency.py:24-70), through the port, and equal to the
    JAX metric on the JAX package's round trip (f64 parity of the two)."""
    m = 256
    rng = np.random.default_rng(0)
    x = np.clip(rng.standard_normal(8 * m), -2, 2) / 2
    jp = J.Plan(m, window="hann", latency=latency)
    tp = T.plan_from_jax(jp)
    _, dfts = T.sdft(tp, T.init_state(tp, device="cpu"), x)
    y = T.isdft(tp, dfts).double()
    snr = roundtrip_snr_db(x, y, tp)
    assert snr > (20.0 if latency == 1.0 else 12.0), snr
    # delay= keyword is equivalent to passing the plan
    assert snr == pytest.approx(roundtrip_snr_db(x, y, delay=tp.synthesis_delay))
    _, jd = J.sdft(jp, J.init_state(jp), x)
    jy = np.asarray(J.isdft(jp, jd), np.float64)
    assert snr == pytest.approx(jm.roundtrip_snr_db(x, jy, jp), abs=1e-6)
    with pytest.raises(ValueError, match="plan or delay"):
        roundtrip_snr_db(x, y)


def test_port_exports_every_name_of_the_jax_package():
    assert set(J.__all__) <= set(T.__all__)
    assert {"kernel_supported", "plan_from_jax"} <= set(T.__all__)
    for name in T.__all__:
        assert hasattr(T, name), name
