"""The collapsed-LTI round trip, the driver protocol at every hop and the
hopped analysis of the port against ``sdft_tpu`` (mirrors tests/test_lti.py).

The same seeded numpy inputs go through both packages on the CPU.  Float64
plans are gated at 1e-12 of the output's scale; float32 plans at atol 1e-5
for the round trip (tests/test_tpu.py:77) and at the driver's gates for the
hop spectra (2e-7) and samples (1e-4, tests/test_tpu.py:274-275).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sdft_tpu as J
import sdft_tpu_torch as T
from sdft_tpu.ops import lti as j_lti
from sdft_tpu_torch.ops import carry, lti

F64 = J.Precision("float64", "float64")


def _signal(n, seed=0):
    return np.clip(np.random.default_rng(seed).standard_normal(n), -3, 3) / 2


def _np(a):
    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def _close(got, want, tol=1e-12):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    err = np.abs(got - want).max()
    assert err <= tol * max(np.abs(want).max(), 1e-300), (err, np.abs(want).max())


def _plans(m, precision=F64, **kw):
    jp = J.Plan(m, precision=precision, **kw)
    return jp, T.plan_from_jax(jp)


def _same_state(ts, js, tol=1e-12):
    _close(ts.accumulator, js.accumulator, tol)
    np.testing.assert_array_equal(_np(ts.offset), _np(js.offset))
    np.testing.assert_array_equal(_np(ts.delayline), _np(js.delayline))


# -- the collapsed round trip ------------------------------------------------------

@pytest.mark.parametrize("window", ["boxcar", "hann", "hamming", "blackman"])
@pytest.mark.parametrize("latency", [1.0, 0.5])
def test_roundtrip_without_transform_matches_jax(window, latency):
    """Three chained blocks of 300 samples (not a multiple of the tile)."""
    jp, tp = _plans(128, window=window, latency=latency)
    x = _signal(900, seed=len(window))
    js, ts = J.init_state(jp), T.init_state(tp, device="cpu")
    for b in range(3):
        js, jy = J.roundtrip(jp, js, x[b * 300:(b + 1) * 300])
        ts, ty = T.roundtrip(tp, ts, x[b * 300:(b + 1) * 300])
        _close(ty, jy)
    _same_state(ts, js)


def test_roundtrip_roi_plan_matches_jax():
    jp, tp = _plans(128, window="hann", roi=(10, 100))
    x = _signal(512, seed=2)
    js, jy = J.roundtrip(jp, J.init_state(jp), x)
    ts, ty = T.roundtrip(tp, T.init_state(tp, device="cpu"), x)
    _close(ty, jy)
    _same_state(ts, js)


@pytest.mark.parametrize("k_tile", [16, 32, 64])
def test_k_tile_changes_nothing_beyond_rounding(k_tile):
    jp, tp = _plans(96, window="blackman", latency=0.5)
    x = _signal(2 * 333, seed=k_tile)
    js, ts = J.init_state(jp), T.init_state(tp, device="cpu")
    for b in range(2):
        js, jy = j_lti.roundtrip_block_lti(jp, js, x[b * 333:(b + 1) * 333])
        ts, ty = lti.roundtrip_block_lti(tp, ts, torch.as_tensor(x[b * 333:(b + 1) * 333]),
                                         k_tile)
        _close(ty, jy)
    _same_state(ts, js)


def test_roundtrip_channel_batch_with_desynchronized_offsets():
    """C = 3 channels fold into the GEMM rows; channel c first streams
    c*37 samples alone, so the offsets differ."""
    jp, tp = _plans(128, window="blackman", latency=0.5)
    C, M = 3, 256
    x = _signal(C * 2 * M, seed=7).reshape(C, 2 * M)
    jst, tst = [], []
    for c in range(C):
        js, ts = J.init_state(jp), T.init_state(tp, device="cpu")
        if c:
            js, _ = J.roundtrip(jp, js, np.zeros(37 * c))
            ts, _ = T.roundtrip(tp, ts, np.zeros(37 * c))
        jst.append(J.state_to_arrays(js))
        tst.append(ts)
    jb = J.state_from_arrays({k: np.stack([a[k] for a in jst]) for k in jst[0]})
    tb = T.State(*(torch.stack(list(a)) for a in zip(*tst)))
    for b in range(2):
        blk = x[:, b * M:(b + 1) * M]
        jb, jy = J.roundtrip(jp, jb, blk)
        tb, ty = T.roundtrip(tp, tb, blk)
        _close(ty, jy)
        for c in range(C):  # each channel equals its own stream
            tst[c], y1 = T.roundtrip(tp, tst[c], blk[c])
            _close(ty[c], y1, 1e-13)
    _same_state(tb, jb)


def test_roundtrip_f32_matches_jax_with_ragged_chunks():
    jp, tp = _plans(64, precision=J.FAST_PRECISION)
    x = _signal(1000, seed=1).astype(np.float32)
    js, ts = J.init_state(jp), T.init_state(tp, device="cpu")
    for lo, hi in [(0, 100), (100, 477), (477, 1000)]:
        js, jy = J.roundtrip(jp, js, x[lo:hi])
        ts, ty = T.roundtrip(tp, ts, x[lo:hi])
        assert ty.dtype == torch.float32
        np.testing.assert_allclose(_np(ty), _np(jy), atol=1e-5)
    np.testing.assert_allclose(_np(ts.accumulator), _np(js.accumulator), atol=5e-5)


def test_lti_state_continues_in_sdft_of_both_packages():
    """A stream can alternate between roundtrip() and sdft(): the carry
    means the same in both forms and in both packages."""
    jp, tp = _plans(64, window="hann")
    x = _signal(768, seed=3)
    js, _ = J.sdft(jp, J.init_state(jp), x[:256])
    _, jd = J.sdft(jp, js, x[256:])
    ts, _ = T.roundtrip(tp, T.init_state(tp, device="cpu"), x[:256])
    _same_state(ts, js, 1e-11)
    _, td = T.sdft(tp, ts, x[256:])
    _close(td, jd)
    _, jd2 = J.sdft(jp, J.state_from_arrays(T.state_to_arrays(ts)), x[256:])
    _close(jd2, jd)


# -- the driver protocol --------------------------------------------------------------

@pytest.mark.parametrize("hop", [2, 4, 8, 100])
@pytest.mark.parametrize("refresh_every", [None, 1, 2])
def test_roundtrip_hopped_matches_jax(hop, refresh_every):
    jp, tp = _plans(96, window="hann", roi=(3, 90) if hop == 4 else None)
    B = 400 if hop == 100 else 16 * hop
    xs = _signal(3 * B, seed=hop).reshape(3, B)
    js, jhd, jys = J.roundtrip_hopped(jp, J.init_state(jp), xs, hop,
                                      refresh_every=refresh_every)
    ts, thd, tys = T.roundtrip_hopped(tp, T.init_state(tp, device="cpu"), xs, hop,
                                      refresh_every=refresh_every)
    assert tuple(thd.shape) == (3, B // hop, 96, 2) and tuple(tys.shape) == (3, B)
    _close(thd, jhd)
    _close(tys, jys)
    _same_state(ts, js)


@pytest.mark.parametrize("hop", [2, 8])
def test_roundtrip_hopped_channel_batch_matches_jax(hop):
    jp, tp = _plans(64, window="hamming", latency=0.5)
    nb, C, B = 3, 2, 8 * hop
    xs = _signal(nb * C * B, seed=4).reshape(nb, C, B)
    js, jhd, jys = J.roundtrip_hopped(jp, J.init_state(jp, channels=C), xs, hop)
    ts, thd, tys = T.roundtrip_hopped(tp, T.init_state(tp, channels=C, device="cpu"), xs, hop)
    assert tuple(thd.shape) == (nb, C, B // hop, 64, 2)
    _close(thd, jhd)
    _close(tys, jys)
    _same_state(ts, js)


def test_k_tile_is_the_fifth_positional_argument():
    """roundtrip_hopped(plan, state, blocks, hop, refresh_every, k_tile):
    for hop < 8 it sets the multi-hop tile target, as in the JAX API."""
    jp, tp = _plans(64, window="hann")
    xs = _signal(3 * 48, seed=5).reshape(3, 48)
    js, jhd, jys = J.roundtrip_hopped(jp, J.init_state(jp), xs, 2, 1, 16)
    ts, thd, tys = T.roundtrip_hopped(tp, T.init_state(tp, device="cpu"), xs, 2, 1, 16)
    _close(thd, jhd)
    _close(tys, jys)
    _, thd8, tys8 = T.roundtrip_hopped(tp, T.init_state(tp, device="cpu"), xs, 2, 1)
    _close(thd8, thd, 1e-13)
    _close(tys8, tys, 1e-13)
    # ignored for hop >= 8
    _, a, _ = T.roundtrip_hopped(tp, T.init_state(tp, device="cpu"), xs, 8, 1, 64)
    _, b, _ = T.roundtrip_hopped(tp, T.init_state(tp, device="cpu"), xs, 8, 1)
    assert torch.equal(a, b)


def test_roundtrip_hopped_f32_matches_jax():
    jp, tp = _plans(128, precision=J.FAST_PRECISION, window="hann")
    xs = _signal(4 * 800, seed=9).astype(np.float32).reshape(4, 800)
    for hop in (100, 4):
        js, jhd, jys = J.roundtrip_hopped(jp, J.init_state(jp), xs, hop)
        ts, thd, tys = T.roundtrip_hopped(tp, T.init_state(tp, device="cpu"), xs, hop)
        np.testing.assert_allclose(_np(thd), _np(jhd), atol=2e-7)
        np.testing.assert_allclose(_np(tys), _np(jys), atol=1e-4)


def test_fused_driver_block_matches_jax():
    jp, tp = _plans(96, window="blackman", latency=0.5)
    x = _signal(3 * 96, seed=10)
    for hop, refresh in ((32, True), (3, False)):
        js, jhd, jy = j_lti.roundtrip_hopped_block(jp, J.init_state(jp), x, hop, refresh)
        ts, thd, ty = lti.roundtrip_hopped_block(tp, T.init_state(tp, device="cpu"), torch.as_tensor(x),
                                                 hop, refresh)
        _close(thd, jhd)
        _close(ty, jy)
        _same_state(ts, js)


# -- the hopped analysis ---------------------------------------------------------------

@pytest.mark.parametrize("hop", [1, 3, 100])
def test_sdft_hopped_matches_jax_and_the_sliced_spectra(hop):
    jp, tp = _plans(96, window="blackman", roi=(4, 90))
    B = 250  # a partial last hop still emits its spectrum
    x = _signal(2 * B, seed=13 + hop)
    js, ts, tf = J.init_state(jp), T.init_state(tp, device="cpu"), T.init_state(tp, device="cpu")
    for b in range(2):
        blk = x[b * B:(b + 1) * B]
        js, jd = J.sdft_hopped(jp, js, blk, hop)
        ts, td = T.sdft_hopped(tp, ts, blk, hop)
        tf, full = T.sdft(tp, tf, blk)
        assert tuple(td.shape) == (-(-B // hop), 96, 2)
        _close(td, jd)
        _close(td, full[::hop], 1e-11)
    _same_state(ts, js)


def test_sdft_hopped_channel_batch():
    jp, tp = _plans(64)
    x = _signal(3 * 256, seed=12).reshape(3, 256)
    _, jd = J.sdft_hopped(jp, J.init_state(jp, channels=3), x, 32)
    ts, td = T.sdft_hopped(tp, T.init_state(tp, channels=3, device="cpu"), x, 32)
    assert tuple(td.shape) == (3, 8, 64, 2)
    _close(td, jd)
    with pytest.raises(ValueError, match="hop"):
        T.sdft_hopped(tp, T.init_state(tp, device="cpu"), x[0], 0)


# -- interleaved frames ----------------------------------------------------------------

def test_interleaved_frames_match_jax():
    jp, tp = _plans(64, window="hann")
    frames = _signal(2 * 200, seed=14).reshape(200, 2)
    js, jd = J.sdft_interleaved(jp, J.init_state(jp, channels=2), frames)
    ts, td = T.sdft_interleaved(tp, T.init_state(tp, channels=2, device="cpu"), frames)
    assert tuple(td.shape) == (2, 200, 64, 2)
    _close(td, jd)
    _same_state(ts, js)
    y = T.isdft_interleaved(tp, td)
    assert tuple(y.shape) == (200, 2)
    _close(y, J.isdft_interleaved(jp, jd))
    with pytest.raises(ValueError, match="interleaved"):
        T.sdft_interleaved(tp, T.init_state(tp, channels=2, device="cpu"), frames[:, 0])
    with pytest.raises(ValueError, match="channel-batched"):
        T.isdft_interleaved(tp, td[0])


# -- constants ---------------------------------------------------------------------------

def test_plan_constants_match_jax():
    jp, tp = _plans(100, window="blackman", latency=0.5, roi=(2, 97))
    for K in (16, 40):
        for got, want in zip(lti._lti_constants(tp, K), j_lti._lti_constants(jp, K)):
            _close(got, want, 1e-15)
    for hop, sub in ((1, 8), (3, 3)):
        sf, dr = lti._stepped_consts_device(tp, hop, sub, torch.float64,
                                            torch.device("cpu"))
        j_sf_re, j_sf_im, j_dr_re, j_dr_im = j_lti._stepped_consts_device(
            jp, hop, sub, "float64")
        sfc = torch.view_as_complex(sf.view(hop * sub, sub, 100, 2))
        _close(sfc.real.reshape(hop * sub, -1), j_sf_re, 0)
        _close(sfc.imag.reshape(hop * sub, -1), j_sf_im, 0)
        _close(dr.real, j_dr_re, 1e-15)
        _close(dr.imag, j_dr_im, 1e-15)


def test_phase_rows_exact_at_a_large_dftsize():
    m = 50001
    tp = T.Plan(m, precision=T.Precision("float64", "float64"))
    jp = J.Plan(m, precision=F64)
    off = np.array([0, 99_991, 2 * m - 1])
    got = carry.phase_rows(tp, torch.as_tensor(off), 5, 777)
    want_re, want_im = j_lti._phase_rows(jnp.asarray(off, jnp.int32), 5, 777, m,
                                         jnp.float64)
    _close(got.real, want_re, 1e-13)
    _close(got.imag, want_im, 1e-13)


def test_tile_rules():
    assert [lti.driver_sub_factor(h) for h in (1, 2, 3, 7, 8, 100)] == [8, 4, 3, 2, 1, 1]
    assert lti.driver_sub_factor(3, 16) == j_lti.driver_sub_factor(3, 16) == 6
    assert lti.default_k_tile(65536, 4096) == lti.K_TILE
    assert lti.default_k_tile(512, 128) == 32 and lti.default_k_tile(10, 128) == 16
    assert lti.default_k_tile(65536, 1 << 19) == 16  # the tables stay small
    for M in (1, 100, 1000, 4096, 16384, 32768, 65536, 1 << 20):
        for m in (8, 1000, 4096, 1 << 19):
            K = lti.default_k_tile(M, m)
            assert 16 <= K <= lti.K_TILE and K & (K - 1) == 0
            assert K * m <= max(lti.TABLE_ELEMS, 16 * m)
