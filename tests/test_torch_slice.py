"""The port's slice end to end against ``sdft_tpu``: the hop=1 driver chain,
channel batches, checkpoint exchange, and what the slice refuses.

Float64 plans take the reference path in both packages and are gated at
1e-12 of the output's scale.  Float32 plans run the kernels' plain versions
here and are held against the JAX hop=1 Pallas chain in interpret mode at
the JAX route's own class (spectra 1.5e-5 of scale, tests/test_tpu.py:
411-417; samples atol 5e-4, tests/test_pallas_kernels.py:78).
"""

import numpy as np
import pytest
import torch

import sdft_tpu as J
import sdft_tpu_torch as T
from sdft_tpu.ops.lti import _chain_hop1_pallas_jit

F64 = J.Precision("float64", "float64")


def _signal(n, seed=0):
    return np.random.default_rng(seed).standard_normal(n).clip(-1, 1).astype(np.float32)


def _rel(got, want):
    got = got.detach().cpu().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-300)


@pytest.mark.parametrize("m,window,latency,roi,refresh_every", [
    (130, "hann", 1.0, None, 1),
    (131, "blackman", 0.5, (5, 120), 2),
    (97, "boxcar", 1.0, None, None),
])
def test_hop1_chain_f64_matches_jax(m, window, latency, roi, refresh_every):
    """The JAX side runs its stepped XLA driver body; the port runs
    sdft_block + isdft_block per block.  Same math in float64."""
    jp = J.Plan(m, window=window, latency=latency, roi=roi, precision=F64)
    tp = T.plan_from_jax(jp)
    xs = _signal(3 * 120, seed=m).reshape(3, 120)
    js, jhd, jys = J.roundtrip_hopped(jp, J.init_state(jp), xs, 1,
                                      refresh_every=refresh_every)
    ts, thd, tys = T.roundtrip_hopped(tp, T.init_state(tp), xs, 1,
                                      refresh_every=refresh_every)
    assert _rel(thd, jhd) <= 1e-12
    assert _rel(tys, jys) <= 1e-12
    assert _rel(ts.accumulator, js.accumulator) <= 1e-12
    assert int(ts.offset) == int(js.offset)


@pytest.mark.parametrize("refresh_every,latency", [(1, 1.0), (2, 0.5)])
def test_hop1_chain_f32_matches_pallas_chain(refresh_every, latency):
    jp = J.Plan(256, window="hann", latency=latency, precision=J.FAST_PRECISION)
    tp = T.plan_from_jax(jp)
    xs = _signal(3 * 200, seed=5).reshape(3, 200)
    js, jhd, jys = _chain_hop1_pallas_jit(jp, J.init_state(jp), xs,
                                          refresh_every, True)
    ts, thd, tys = T.roundtrip_hopped(tp, T.init_state(tp), xs, 1,
                                      refresh_every=refresh_every)
    assert _rel(thd, jhd) <= 1.5e-5
    np.testing.assert_allclose(tys.numpy(), np.asarray(jys), atol=5e-4)
    np.testing.assert_allclose(ts.accumulator.numpy(), np.asarray(js.accumulator),
                               atol=4 * np.finfo(np.float32).eps * xs.size)


def test_hop1_chain_channel_batch_matches_jax():
    jp = J.Plan(130, window="hamming", precision=F64)
    tp = T.plan_from_jax(jp)
    xs = _signal(2 * 2 * 90, seed=8).reshape(2, 2, 90)
    js, jhd, jys = J.roundtrip_hopped(jp, J.init_state(jp, channels=2), xs, 1)
    ts, thd, tys = T.roundtrip_hopped(tp, T.init_state(tp, channels=2), xs, 1)
    assert tuple(thd.shape) == (2, 2, 90, 130, 2)
    assert _rel(thd, jhd) <= 1e-12 and _rel(tys, jys) <= 1e-12
    assert _rel(ts.accumulator, js.accumulator) <= 1e-12


def test_f32_channel_batch_through_the_kernel_wrappers():
    """(C, M) f32 batches run one wrapper call per channel; each channel
    equals its own single-channel run bit for bit."""
    jp = J.Plan(256, window="blackman", precision=J.FAST_PRECISION)
    tp = T.plan_from_jax(jp)
    x = torch.as_tensor(_signal(2 * 150, seed=6).reshape(2, 150))
    st, d = T.sdft(tp, T.init_state(tp, channels=2), x)
    _, p = T.sdft_power(tp, T.init_state(tp, channels=2), x, "bfloat16")
    _, (re, im) = T.sdft(tp, T.init_state(tp, channels=2), x, "planar")
    for c in range(2):
        sc, dc = T.sdft(tp, T.init_state(tp), x[c])
        assert torch.equal(d[c], dc) and torch.equal(re[c], dc[..., 0])
        assert torch.equal(st.accumulator[c], sc.accumulator)
        _, pc = T.sdft_power(tp, T.init_state(tp), x[c], "bfloat16")
        assert torch.equal(p[c], pc)
    # against the JAX XLA path on the same batch (f32 class)
    _, jd = J.sdft(jp, J.init_state(jp, channels=2), x.numpy())
    np.testing.assert_allclose(d.numpy(), np.asarray(jd), atol=2e-6, rtol=1e-4)


def test_stream_crosses_packages_mid_chain():
    """JAX runs two hop=1 blocks, the port continues from its checkpoint;
    the result equals JAX running all four blocks (f64)."""
    jp = J.Plan(131, window="hann", latency=0.5, precision=F64)
    tp = T.plan_from_jax(jp)
    xs = _signal(4 * 100, seed=12).reshape(4, 100)
    _, jhd, jys = J.roundtrip_hopped(jp, J.init_state(jp), xs, 1)
    js, _, _ = J.roundtrip_hopped(jp, J.init_state(jp), xs[:2], 1)
    ts = T.state_from_arrays(J.state_to_arrays(js))
    ts, thd, tys = T.roundtrip_hopped(tp, ts, xs[2:], 1)
    assert _rel(thd, np.asarray(jhd)[2:]) <= 1e-12
    assert _rel(tys, np.asarray(jys)[2:]) <= 1e-12
    # and back: JAX continues the port's stream with sdft
    js2, jd2 = J.sdft(jp, J.state_from_arrays(T.state_to_arrays(ts)), xs[0])
    ts2, td2 = T.sdft(tp, ts, xs[0])
    assert _rel(td2, jd2) <= 1e-12


def test_f32_state_continues_across_packages():
    jp = J.Plan(256, window="hann", precision=J.FAST_PRECISION)
    tp = T.plan_from_jax(jp)
    x = _signal(600, seed=13)
    js, _ = J.sdft(jp, J.init_state(jp), x[:300])
    _, jd = J.sdft(jp, js, x[300:])
    ts = T.state_from_arrays(J.state_to_arrays(js))
    assert ts.accumulator.dtype == torch.float32
    _, td = T.sdft(tp, ts, x[300:])
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), atol=2e-6, rtol=1e-4)


def test_slice_refuses_what_it_does_not_port():
    tp = T.Plan(256, precision=T.FAST_PRECISION)
    st = T.init_state(tp)
    xs = torch.zeros(2, 64)
    ext = T.Plan(256, precision=T.Precision("float32", "float32x2"))
    for call in (lambda s: T.sdft(ext, s, xs[0]), lambda s: T.roundtrip(ext, s, xs[0]),
                 lambda s: T.roundtrip_hopped(ext, s, xs, 8),
                 lambda s: T.sdft_hopped(ext, s, xs[0], 8)):
        with pytest.raises(NotImplementedError, match="item 9"):
            call(T.init_state(ext))
    with pytest.raises(ValueError):
        T.roundtrip_hopped(tp, st, torch.zeros(2, 63), 2)
    with pytest.raises(ValueError):
        T.sdft(tp, st, torch.zeros(1, 2, 3))
    with pytest.raises(ValueError):
        T.sdft(tp, st, xs[0], layout="interleaved")
