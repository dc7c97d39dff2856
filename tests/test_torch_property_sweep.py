"""The port's public surface over tests/test_property_sweep.py's odd shapes
(tests/test_property_sweep.py:21-82).

m not a tile multiple, hops that do not divide the block, a hop longer
than the block, a block shorter than 2m, every window and several
latencies: the same seeded inputs go through the port's ``sdft``,
``isdft``, ``roundtrip``, ``sdft_hopped`` and ``roundtrip_hopped`` on
float64 plans, through the naive per-sample oracle (tests/reference_impl.py,
written from the reference spec) and through ``sdft_tpu``.  Gates: the
oracle at atol 1e-11 (the JAX sweep's), ``sdft_tpu`` at 1e-12 of the
output's scale (the port's float64 gate against the JAX package).
"""

import numpy as np
import pytest
import torch

import sdft_tpu as J
import sdft_tpu_torch as T
from tests.reference_impl import NaiveSDFT
from tests.test_property_sweep import CASES

F64 = J.Precision("float64", "float64")


def _np(a):
    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def _complex(d):
    d = _np(d)
    return d[..., 0] + 1j * d[..., 1]


def _vs_jax(got, want):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    err = np.abs(got - want).max()
    assert err <= 1e-12 * max(np.abs(want).max(), 1e-300), (err, np.abs(want).max())


def _chained(J_or_T, fn, plan, x, block, nb, **kw):
    """``fn`` over nb blocks of one stream, the state carried: the list of
    each block's output."""
    st = J_or_T.init_state(plan, **kw)
    outs = []
    for b in range(nb):
        st, out = fn(plan, st, x[b * block:(b + 1) * block])
        outs.append(_np(out))
    return outs


@pytest.mark.parametrize("m,window,latency,block,hop", CASES)
@pytest.mark.parametrize("entry", ["sdft_isdft", "roundtrip", "sdft_hopped",
                                   "roundtrip_hopped"])
def test_odd_shapes_vs_naive_oracle_and_jax(m, window, latency, block, hop, entry):
    jp = J.Plan(m, window=window, latency=latency, precision=F64)
    tp = T.plan_from_jax(jp)
    rng = np.random.default_rng(m * 7 + block)
    nb = 3
    x = np.clip(rng.standard_normal(nb * block), -3, 3) / 2
    ref = NaiveSDFT(m, window, latency, td=np.float64)
    d_ref = ref.sdft(x)
    y_ref = ref.isdft(d_ref)
    cpu = dict(device="cpu")

    if entry == "sdft_isdft":
        got = _chained(T, T.sdft, tp, x, block, nb, **cpu)
        want = _chained(J, J.sdft, jp, x, block, nb)
        for g, w in zip(got, want):
            _vs_jax(g, w)
        got_d = np.concatenate(got)
        np.testing.assert_allclose(_complex(got_d), d_ref, atol=1e-11)
        y = T.isdft(tp, torch.as_tensor(got_d))
        _vs_jax(y, J.isdft(jp, np.concatenate(want)))
        np.testing.assert_allclose(_np(y), y_ref, atol=1e-11)
    elif entry == "roundtrip":
        got = _chained(T, T.roundtrip, tp, x, block, nb, **cpu)
        for g, w in zip(got, _chained(J, J.roundtrip, jp, x, block, nb)):
            _vs_jax(g, w)
        np.testing.assert_allclose(np.concatenate(got), y_ref, atol=1e-11)
    elif entry == "sdft_hopped":
        # the first spectrum of every hop, the partial last hop included
        _, hd = T.sdft_hopped(tp, T.init_state(tp, **cpu), x, hop)
        _vs_jax(hd, J.sdft_hopped(jp, J.init_state(jp), x, hop)[1])
        np.testing.assert_allclose(_complex(hd), d_ref[::hop], atol=1e-11)
    else:
        # the chained driver protocol: blocks a multiple of hop (rounded down)
        bh = max(hop, (block // hop) * hop)
        n2 = (x.size // (2 * bh)) * 2
        assert n2 >= 2
        xs = x[:n2 * bh].reshape(n2, bh)
        st, hd, ys = T.roundtrip_hopped(tp, T.init_state(tp, **cpu), xs, hop)
        jst, jhd, jys = J.roundtrip_hopped(jp, J.init_state(jp), xs, hop)
        _vs_jax(hd, jhd)
        _vs_jax(ys, jys)
        _vs_jax(st.accumulator, jst.accumulator)
        np.testing.assert_array_equal(_np(st.offset), _np(jst.offset))
        np.testing.assert_allclose(_complex(hd).reshape(-1, m), d_ref[:n2 * bh:hop],
                                   atol=1e-11)
        np.testing.assert_allclose(_np(ys).reshape(-1), y_ref[:n2 * bh], atol=1e-11)
