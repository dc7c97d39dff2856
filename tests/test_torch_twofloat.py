"""The port's double-word (float32x2) FD tier against ``sdft_tpu`` (mirrors
tests/test_twofloat.py case by case), and extended plans through every
entry point.

The same seeded numpy inputs go through both packages on the CPU (JAX in
x64).  Gates: the error-free primitives exact in float64 (and bit-equal to
the JAX primitives); the tier's spectra and samples within 1e-13 of scale
of the float64 path and of the JAX tier.  Entry points that treat an
extended plan as float32 are held at the tolerances of the port's float32
parity tests: spectra atol 2e-6 / rtol 1e-4 (tests/test_torch_slice.py),
round trip atol 1e-5 (tests/test_torch_lti.py), driver spectra 2e-7 and
samples 1e-4, accumulators 4*eps32 per summed term.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sdft_tpu as J
import sdft_tpu_torch as T
from sdft_tpu.ops import twofloat as jtf
from sdft_tpu.ops.analysis import sdft_block as j_sdft_block
from sdft_tpu.ops.synthesis import isdft_block as j_isdft_block
from sdft_tpu_torch.ops import twofloat as tf

F64 = J.Precision("float64", "float64")
F32 = J.FAST_PRECISION
XF = J.Precision("float32", "float32x2")
EPS32 = float(np.finfo(np.float32).eps)


def _signal(n, seed=0):
    rng = np.random.default_rng(seed)
    return np.clip(rng.standard_normal(n), -2, 2).astype(np.float32) / 2


def _np(a):
    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def _df64(d):
    """(..., 2) (hi, lo) packed spectra of either package -> float64."""
    d = _np(d)
    return tf.df_to_float64((d[..., 0], d[..., 1]))


def _rel(got, want):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-300)


def _plans(m, precision=F32, **kw):
    jp = J.Plan(m, precision=precision, **kw)
    return jp, T.plan_from_jax(jp)


# -- the error-free primitives ----------------------------------------------------

@pytest.mark.parametrize("scale", [1.0, 1e-6, 1e18])
def test_error_free_primitives(scale):
    """two_sum / two_prod are exact, at unit, small and large magnitudes
    (the products' low parts stay above the subnormal range, the products
    below overflow), two_sum also among subnormals, and the port's
    primitives equal the JAX ones bit for bit."""
    rng = np.random.default_rng(1)
    a = (rng.standard_normal(1000) * scale).astype(np.float32)
    b = (rng.standard_normal(1000) * 1e-6 * scale).astype(np.float32)
    ta, tb = torch.as_tensor(a), torch.as_tensor(b)
    a64, b64 = a.astype(np.float64), b.astype(np.float64)
    s, e = tf.two_sum(ta, tb)
    np.testing.assert_array_equal(tf.df_to_float64((s, e)), a64 + b64)
    p, pe = tf.two_prod(ta, tb)
    np.testing.assert_array_equal(tf.df_to_float64((p, pe)), a64 * b64)
    tiny = (ta * 1e-30 / scale, tb * 1e-30 / scale)
    np.testing.assert_array_equal(tf.df_to_float64(tf.two_sum(*tiny)),
                                  _np(tiny[0]).astype(np.float64) + _np(tiny[1]))
    # bit-equal to the JAX primitives (run op by op)
    ja, jb = jnp.asarray(a), jnp.asarray(b)
    for got, want in ((tf.two_sum(ta, tb), jtf.two_sum(ja, jb)),
                      (tf.two_prod(ta, tb), jtf.two_prod(ja, jb)),
                      (tf.df_add((ta, tb), (tb, tb)), jtf.df_add((ja, jb), (jb, jb))),
                      (tf.df_mul((ta, tb), (tb, ta * 1e-9)),
                       jtf.df_mul((ja, jb), (jb, jnp.asarray(_np(ta * 1e-9)))))):
        for g, w in zip(got, want):
            np.testing.assert_array_equal(_np(g), np.asarray(w))


def test_complex_df_and_constants():
    rng = np.random.default_rng(7)
    v = [rng.standard_normal(50).astype(np.float32) for _ in range(4)]
    a = ((torch.as_tensor(v[0]), torch.zeros(50)), (torch.as_tensor(v[1]), torch.zeros(50)))
    b = ((torch.as_tensor(v[2]), torch.zeros(50)), (torch.as_tensor(v[3]), torch.zeros(50)))
    za = v[0].astype(np.float64) + 1j * v[1]
    zb = v[2].astype(np.float64) + 1j * v[3]
    (re, im) = tf.cdf_mul(a, b)
    np.testing.assert_allclose(tf.df_to_float64(re) + 1j * tf.df_to_float64(im),
                               za * zb, rtol=1e-14, atol=0)
    (re, im) = tf.cdf_add(a, b)
    np.testing.assert_array_equal(tf.df_to_float64(re) + 1j * tf.df_to_float64(im), za + zb)
    hi, lo = tf.df_const(0.1)
    assert hi.dtype == torch.float32 and float(hi) + float(lo) == pytest.approx(0.1, abs=1e-16)
    assert tf.df_to_float64(tf.df_neg((hi, lo))) == -(float(hi) + float(lo))


# -- the tier against the float64 path and the JAX tier ---------------------------

@pytest.mark.parametrize("window", ["hann", "hamming", "blackman", "boxcar"])
def test_extended_tier_matches_f64(window):
    m, M, nb = 64, 160, 3
    p64 = J.Plan(m, window=window, precision=F64)
    jp, tp = _plans(m, window=window)
    x = _signal(nb * M, seed=2)
    _, d64s = J.sdft(p64, J.init_state(p64), x.astype(np.float64))
    js, ts = J.init_state(jp), T.init_state(tp, device="cpu")
    for b in range(nb):
        blk = x[b * M:(b + 1) * M]
        d64 = np.asarray(d64s)[b * M:(b + 1) * M]
        js, jd = jtf.sdft_block_df(jp, js, blk)
        ts, td = tf.sdft_block_df(tp, ts, blk)
        assert tuple(td.shape) == (M, m, 2, 2) and td.dtype == torch.float32
        assert _rel(_df64(td), d64) < 1e-13
        assert _rel(_df64(td), _df64(jd)) < 1e-13
        np.testing.assert_array_equal(_np(ts.delayline), _np(js.delayline))
        assert int(ts.offset) == int(js.offset)
        np.testing.assert_allclose(_np(ts.accumulator), _np(js.accumulator),
                                   atol=4 * EPS32)


def test_extended_tier_roi_and_channels():
    p64 = J.Plan(96, window="hann", precision=F64, roi=(8, 60))
    jp, tp = _plans(96, window="hann", roi=(8, 60))
    C, M = 2, 200
    x = _signal(C * M, seed=3).reshape(C, M)
    _, d64 = J.sdft(p64, J.init_state(p64, channels=C), x.astype(np.float64))
    _, jd = jtf.sdft_block_df(jp, J.init_state(jp, channels=C), x)
    ts, td = tf.sdft_block_df(tp, T.init_state(tp, channels=C, device="cpu"), x)
    got = _df64(td)
    assert got.shape == (C, M, 96, 2) and tuple(ts.offset.shape) == (C,)
    assert _rel(got, d64) < 1e-13 and _rel(got, _df64(jd)) < 1e-13
    # ROI: bins outside are exactly zero
    assert np.all(got[..., :8, :] == 0)
    assert np.all(got[..., 60:, :] == 0)


def test_extended_tier_drift_free_long_stream():
    """The carry is rebuilt from the delayline every block, so the error
    does not grow with stream length."""
    m, M, nb = 32, 64, 40
    p64 = J.Plan(m, window="hann", precision=F64)
    tp = T.Plan(m, window="hann", precision=T.FAST_PRECISION)
    x = _signal(nb * M, seed=4)
    _, d64 = J.sdft(p64, J.init_state(p64), x.astype(np.float64))
    ts = T.init_state(tp, device="cpu")
    errs = []
    for b in range(nb):
        ts, td = tf.sdft_block_df(tp, ts, x[b * M:(b + 1) * M])
        errs.append(_rel(_df64(td), np.asarray(d64)[b * M:(b + 1) * M]))
    assert errs[-1] < 1e-13 and max(errs) < 1e-13   # block 40 as accurate as block 1


@pytest.mark.parametrize("latency", [1.0, 0.5])
def test_extended_tier_isdft_matches_f64(latency):
    m, M = 64, 160
    p64 = J.Plan(m, window="hann", precision=F64, latency=latency)
    jp, tp = _plans(m, window="hann", latency=latency)
    x = _signal(M, seed=6)
    _, d64 = j_sdft_block(p64, J.init_state(p64), x.astype(np.float64))
    _, jd = jtf.sdft_block_df(jp, J.init_state(jp), x)
    _, td = tf.sdft_block_df(tp, T.init_state(tp, device="cpu"), x)
    y64 = np.asarray(j_isdft_block(p64, d64))
    got = tf.df_to_float64(tf.isdft_block_df(tp, td))
    assert _rel(got, y64) < 1e-13
    assert _rel(got, tf.df_to_float64(jtf.isdft_block_df(jp, jd))) < 1e-13
    # through the public API: correctly rounded float32 samples out
    jx, tx = _plans(m, precision=XF, window="hann", latency=latency)
    _, d = T.sdft(tx, T.init_state(tx, device="cpu"), x)
    y = T.isdft(tx, d)
    assert y.dtype == torch.float32
    np.testing.assert_allclose(_np(y), y64.astype(np.float32),
                               atol=2e-7 * np.abs(y64).max())
    _, jdx = J.sdft(jx, J.init_state(jx), x)
    np.testing.assert_allclose(_np(y), np.asarray(J.isdft(jx, jdx)),
                               atol=2e-7 * np.abs(y64).max())


def test_extended_tier_api_routing():
    """Precision(fd="float32x2") routes sdft to the double-word tier
    (packed only) and isdft to its synthesis leg; the shapes are checked."""
    jp, tp = _plans(64, precision=XF, window="hann")
    assert tp.precision.extended and tp.precision.fd_dtype == torch.float32
    st = T.init_state(tp, device="cpu")
    assert st.accumulator.dtype == torch.float32
    x = _signal(128, seed=5)
    st, d = T.sdft(tp, st, x)
    assert tuple(d.shape) == (128, 64, 2, 2)
    p64 = J.Plan(64, window="hann", precision=F64)
    _, d64 = j_sdft_block(p64, J.init_state(p64), x.astype(np.float64))
    assert _rel(_df64(d), d64) < 1e-13
    _, jd = J.sdft(jp, J.init_state(jp), x)
    assert _rel(_df64(d), _df64(jd)) < 1e-13
    # a (C, M) batch runs one block per channel
    xc = np.stack([x, _signal(128, seed=9)])
    sc, dc = T.sdft(tp, T.init_state(tp, channels=2, device="cpu"), xc)
    assert tuple(dc.shape) == (2, 128, 64, 2, 2)
    assert torch.equal(dc[0], d) and torch.equal(sc.accumulator[0], st.accumulator)
    for kw in ({"layout": "planar"}, {"layout": "planar", "spectra_dtype": "bfloat16"}):
        with pytest.raises(ValueError, match="packed"):
            T.sdft(tp, T.init_state(tp, device="cpu"), x, **kw)
    with pytest.raises(ValueError, match="spectra_dtype"):
        T.sdft(tp, T.init_state(tp, device="cpu"), x, spectra_dtype="bfloat16")
    for bad in (d[..., 0], d[0], torch.zeros(2, 3, 4, 8, 64, 2, 2)):
        with pytest.raises(ValueError, match=r"\(hi, lo\)"):
            T.isdft(tp, bad)
    with pytest.raises(ValueError, match="double-word"):
        tf.isdft_block_df(tp, d[..., 0])


# -- every other entry point treats an extended plan as float32 -------------------

def test_extended_plan_runs_every_entry_point_as_float32():
    """Same extended plan (m = 64) in both packages; the JAX calls return, so
    must the port's, with the same values at the float32 parity tolerances."""
    jp, tp = _plans(64, precision=XF, window="hann")
    acc_tol = 4 * EPS32 * 256
    x = _signal(256, seed=11)
    xs = _signal(3 * 64, seed=12).reshape(3, 64)
    xc = _signal(2 * 256, seed=13).reshape(2, 256)

    _, jp_pow = J.sdft_power(jp, J.init_state(jp), x)
    _, tp_pow = T.sdft_power(tp, T.init_state(tp, device="cpu"), x)
    np.testing.assert_allclose(_np(tp_pow), np.asarray(jp_pow), atol=2e-6, rtol=1e-4)

    js, jy = J.roundtrip(jp, J.init_state(jp), x)
    ts, ty = T.roundtrip(tp, T.init_state(tp, device="cpu"), x)
    assert ty.dtype == torch.float32
    np.testing.assert_allclose(_np(ty), np.asarray(jy), atol=1e-5)
    np.testing.assert_allclose(_np(ts.accumulator), np.asarray(js.accumulator), atol=acc_tol)

    def lowpass(z):
        return z * (jnp.arange(z.shape[-1]) < 16)

    def lowpass_t(z):
        return z * (torch.arange(z.shape[-1]) < 16)

    _, jy = J.roundtrip(jp, J.init_state(jp), x, lowpass)
    _, ty = T.roundtrip(tp, T.init_state(tp, device="cpu"), x, lowpass_t)
    np.testing.assert_allclose(_np(ty), np.asarray(jy), atol=1e-5)

    _, jh = J.sdft_hopped(jp, J.init_state(jp), x, 8)
    _, th = T.sdft_hopped(tp, T.init_state(tp, device="cpu"), x, 8)
    np.testing.assert_allclose(_np(th), np.asarray(jh), atol=2e-7)

    js, jhd, jys = J.roundtrip_hopped(jp, J.init_state(jp), xs, 8)
    ts, thd, tys = T.roundtrip_hopped(tp, T.init_state(tp, device="cpu"), xs, 8)
    np.testing.assert_allclose(_np(thd), np.asarray(jhd), atol=2e-7)
    np.testing.assert_allclose(_np(tys), np.asarray(jys), atol=1e-4)

    np.testing.assert_allclose(_np(T.refresh(tp, ts).accumulator),
                               np.asarray(J.refresh(jp, js).accumulator), atol=acc_tol)

    # interleaved: (M, C) frames in, the double-word spectra of sdft out
    _, jd = J.sdft_interleaved(jp, J.init_state(jp, channels=2), xc.T)
    _, td = T.sdft_interleaved(tp, T.init_state(tp, channels=2, device="cpu"), xc.T)
    assert tuple(td.shape) == (2, 256, 64, 2, 2)
    assert _rel(_df64(td), _df64(jd)) < 1e-13
    jyi = np.asarray(J.isdft_interleaved(jp, jd))
    tyi = T.isdft_interleaved(tp, td)
    assert tuple(tyi.shape) == (256, 2)
    np.testing.assert_allclose(_np(tyi), jyi, atol=1e-5)
