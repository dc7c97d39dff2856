"""Parity of the port's reference (``ops``) path with ``sdft_tpu`` in float64.

The same inputs, made with numpy from fixed seeds, go through the JAX
package (x64 on the CPU, as the conftest sets it) and through
``sdft_tpu_torch``; outputs are compared as numpy arrays.  Gate: 1e-12
relative to the output's scale — the float64 class both packages hold
against their oracles (ROADMAP, "The reference stays as it is").
"""

import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sdft_tpu as J
import sdft_tpu_torch as T
from sdft_tpu.ops import analysis as j_analysis
from sdft_tpu.ops import convolve as j_convolve
from sdft_tpu.ops import lti as j_lti
from sdft_tpu.ops import synthesis as j_synthesis
from sdft_tpu.ops import twiddle as j_twiddle
from sdft_tpu_torch.config import fp32_matmul
from sdft_tpu_torch.ops import analysis, convolve, lti, synthesis, twiddle

TOL = 1e-12
F64 = J.Precision("float64", "float64")


def _signal(n, seed=0):
    return np.random.default_rng(seed).standard_normal(n).clip(-1, 1)


def _close(got, want, tol=TOL):
    got = np.asarray(got.detach().cpu() if isinstance(got, torch.Tensor) else got)
    want = np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    scale = max(np.abs(want).max(), 1e-300)
    err = np.abs(got - want).max()
    assert err <= tol * scale, (err, scale)


def _plans(m, **kw):
    jp = J.Plan(m, precision=F64, **kw)
    return jp, T.plan_from_jax(jp)


# -- plan, precision, windows --------------------------------------------------

def test_plan_from_jax_round_trips_every_field():
    jp = J.Plan(250, window="black", latency=0.5,
                precision=J.Precision("float32", "float32", mxu="high"),
                roi=(3, 200))
    tp = T.plan_from_jax(jp)
    assert (tp.dftsize, tp.window.value, tp.latency, tp.roi) == (250, "blackman", 0.5, (3, 200))
    assert (tp.precision.td, tp.precision.fd, tp.precision.mxu) == ("float32", "float32", "high")
    assert tp.precision.allow_tf32 and not T.FAST_PRECISION.allow_tf32
    assert T.Plan(8, roi=(0, 8)).roi is None
    for bad in (dict(dftsize=0), dict(dftsize=3, window="blackman"),
                dict(dftsize=8, latency=0.0), dict(dftsize=8, roi=(4, 2))):
        with pytest.raises(ValueError):
            T.Plan(**bad)


def test_precision_matmul_flag_is_set_and_restored():
    saved = torch.backends.cuda.matmul.allow_tf32
    try:
        torch.backends.cuda.matmul.allow_tf32 = True
        with fp32_matmul(T.FAST_PRECISION):
            assert torch.backends.cuda.matmul.allow_tf32 is False
        with fp32_matmul(T.Precision("float32", "float32", mxu="split4")):
            assert torch.backends.cuda.matmul.allow_tf32 is False
        assert torch.backends.cuda.matmul.allow_tf32 is True
        with fp32_matmul(T.Precision("float32", "float32", mxu="high")):
            assert torch.backends.cuda.matmul.allow_tf32 is True
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved
    assert T.Precision().resolve() == T.Precision()
    assert T.DEFAULT_PRECISION.fdx_dtype == torch.complex128
    with pytest.raises(ValueError):
        T.Precision(mxu="fast")


@pytest.mark.parametrize("name", ["boxcar", "hann", "hamming", "blackman", "bl", "HAM", ""])
def test_window_parse_matches_jax(name):
    assert T.Window.parse(name).value == J.Window.parse(name).value


def test_window_parse_rejects_ambiguous_prefix():
    for pkg in (T, J):
        with pytest.raises(ValueError):
            pkg.Window.parse("b")


# -- twiddles -------------------------------------------------------------------

def test_mulmod_matches_jax_at_large_dftsize():
    n2 = 2 * (1 << 19)
    rng = np.random.default_rng(0)
    e = rng.integers(0, n2, 64)
    i = rng.integers(-n2, n2, 64)
    want = np.asarray(j_twiddle.mulmod(jnp.asarray(e, jnp.int32),
                                       jnp.asarray(i, jnp.int32), n2))
    got = twiddle.mulmod(torch.as_tensor(e), torch.as_tensor(i), n2)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("m,offset,M", [(130, 0, 7), (251, 377, 300)])
def test_fiddle_tables_match_jax(m, offset, M):
    jp, tp = _plans(m)
    off = torch.tensor(offset, dtype=torch.int32)
    jP, jbase = j_twiddle.fiddle_block(jp, jnp.asarray(offset, jnp.int32), M)
    P, base = twiddle.fiddle_block(tp, off, M)
    _close(P, jP)
    _close(base, jbase)
    ex = np.array([0, 1, -3, 5 * m + 1])
    _close(twiddle.fiddle_rows(tp, torch.as_tensor(ex), conj=True),
           j_twiddle.fiddle_rows(jp, jnp.asarray(ex, jnp.int32), conj=True))


@pytest.mark.parametrize("latency,roi", [(1.0, None), (0.5, None), (0.3, (4, 100))])
def test_synthesis_twiddles_match_jax(latency, roi):
    jp, tp = _plans(129, latency=latency, roi=roi)
    _close(twiddle.synthesis_twiddles(tp), j_twiddle.synthesis_twiddles(jp))


# -- convolution, analysis, synthesis -------------------------------------------

@pytest.mark.parametrize("window", ["boxcar", "hann", "hamming", "blackman"])
def test_window_convolve_matches_jax(window):
    jp, tp = _plans(131, window=window)
    rng = np.random.default_rng(1)
    aux = rng.standard_normal((5, 131)) + 1j * rng.standard_normal((5, 131))
    halo = T.windows.WINDOW_HALO[tp.window]
    _close(convolve.hermitian_pad(torch.as_tensor(aux), halo).resolve_conj(),
           j_convolve.hermitian_pad(jnp.asarray(aux), halo))
    _close(convolve.window_convolve(tp, torch.as_tensor(aux)),
           j_convolve.window_convolve(jp, jnp.asarray(aux)))


CASES = [  # (m, window, latency, roi, M): odd m, odd M, ROI, latency 0.5
    (130, "boxcar", 1.0, None, 257),
    (131, "hann", 0.5, None, 301),
    (250, "hamming", 1.0, (10, 200), 99),
    (256, "blackman", 0.5, (0, 77), 513),
    (97, "blackman", 1.0, None, 300),
]


@pytest.mark.parametrize("m,window,latency,roi,M", CASES)
def test_sdft_isdft_carried_stream_matches_jax(m, window, latency, roi, M):
    """Three chained blocks through api.sdft (f64 -> ops path), the carried
    state after each, and isdft of each block's spectra."""
    jp, tp = _plans(m, window=window, latency=latency, roi=roi)
    x = _signal(3 * M, seed=m)
    js, ts = J.init_state(jp), T.init_state(tp, device="cpu")
    for b in range(3):
        blk = x[b * M:(b + 1) * M].astype(np.float32)
        js, jd = J.sdft(jp, js, blk)
        ts, td = T.sdft(tp, ts, blk)
        _close(td, jd)
        _close(ts.accumulator, js.accumulator)
        np.testing.assert_array_equal(ts.delayline.numpy(), np.asarray(js.delayline))
        assert int(ts.offset) == int(js.offset)
        _close(T.isdft(tp, td), J.isdft(jp, jd))
    _close(T.isdft(tp, T.to_complex(td)), J.isdft(jp, jd))


@pytest.mark.parametrize("m,window,latency,roi,M", CASES[:3])
def test_planar_and_power_ops_path_match_jax(m, window, latency, roi, M):
    jp, tp = _plans(m, window=window, latency=latency, roi=roi)
    x = _signal(M, seed=5).astype(np.float32)
    _, (jre, jim) = J.sdft(jp, J.init_state(jp), x, layout="planar")
    _, (re, im) = T.sdft(tp, T.init_state(tp, device="cpu"), x, layout="planar")
    _close(re, jre)
    _close(im, jim)
    _, jpw = J.sdft_power(jp, J.init_state(jp), x)
    _, pw = T.sdft_power(tp, T.init_state(tp, device="cpu"), x)
    _close(pw, jpw)


@pytest.mark.parametrize("m,window,latency,roi,M", CASES[2:4])
def test_refresh_matches_jax(m, window, latency, roi, M):
    jp, tp = _plans(m, window=window, latency=latency, roi=roi)
    x = _signal(M, seed=7).astype(np.float32)
    js, _ = J.sdft(jp, J.init_state(jp), x)
    ts, _ = T.sdft(tp, T.init_state(tp, device="cpu"), x)
    jr = J.refresh(jp, js)
    _close(T.refresh(tp, ts).accumulator, jr.accumulator)
    _close(analysis.refresh_state(tp, ts).accumulator,
           j_analysis.refresh_state(jp, js).accumulator)
    _close(lti.refresh_state_any(tp, ts).accumulator,
           j_lti.refresh_state_any(jp, js).accumulator)
    # the refreshed accumulator equals the running one up to f64 rounding
    _close(T.refresh(tp, ts).accumulator, ts.accumulator.numpy(), 1e-11)


def test_exact_phase_row_matches_jax():
    jp, tp = _plans(251)
    ex = np.array([0, 5, 501])
    got = lti._exact_phase_row(tp, torch.as_tensor(ex), torch.float64)
    want = j_lti._exact_phase_row(jp, jnp.asarray(ex, jnp.int32), jnp.float64)
    for g, w in zip(got, want):
        _close(g, w)


@pytest.mark.parametrize("latency", [1.0, 0.5])
def test_isdft_block_matches_jax(latency):
    jp, tp = _plans(130, latency=latency)
    rng = np.random.default_rng(3)
    d = rng.standard_normal((2, 40, 130, 2))
    _close(synthesis.isdft_block(tp, torch.as_tensor(d)),
           j_synthesis.isdft_block(jp, jnp.asarray(d)))


def test_roundtrip_transform_matches_jax():
    jp, tp = _plans(131, window="hann", latency=0.5)
    x = _signal(300, seed=11).astype(np.float32)

    def jlow(z):
        return z * (jnp.arange(z.shape[-1]) < 40)

    def tlow(z):
        return z * (torch.arange(z.shape[-1]) < 40)

    js, jy = J.roundtrip(jp, J.init_state(jp), x, transform=jlow)
    ts, ty = T.roundtrip(tp, T.init_state(tp, device="cpu"), x, transform=tlow)
    _close(ty, jy)
    _close(ts.accumulator, js.accumulator)
    with pytest.raises(ValueError):
        T.roundtrip(tp, T.init_state(tp, device="cpu"), x, transform=lambda z: z[:-1])


def test_channel_batch_matches_jax():
    jp, tp = _plans(130, window="hamming")
    x = _signal(2 * 200, seed=2).reshape(2, 200).astype(np.float32)
    js, jd = J.sdft(jp, J.init_state(jp, channels=2), x)
    ts, td = T.sdft(tp, T.init_state(tp, channels=2, device="cpu"), x)
    _close(td, jd)
    _close(ts.accumulator, js.accumulator)
    _close(T.isdft(tp, td), J.isdft(jp, jd))
    _close(T.refresh(tp, ts).accumulator, J.refresh(jp, js).accumulator)
    assert T.reset_state(tp, ts).accumulator.abs().max() == 0


@pytest.mark.parametrize("dtype", ["float32", "float64", "bfloat16"])
def test_planar_to_complex_matches_jax(dtype):
    """The same planes (JAX arrays on the JAX side; torch tensors, numpy
    arrays and lists on the port's) give equal values and the same result
    dtype: complex64 for float32 and bfloat16 planes, complex128 for
    float64."""
    from sdft_tpu.cplx import planar_to_complex as j_planar_to_complex

    re, im = _signal(2 * 37, seed=40).reshape(2, 37)
    jre, jim = (jnp.asarray(a, dtype=getattr(jnp, dtype)) for a in (re, im))
    want = j_planar_to_complex(jre, jim)
    tre, tim = (torch.as_tensor(a).to(getattr(torch, dtype)) for a in (re, im))
    host = tuple(t.float().numpy() if dtype == "bfloat16" else t.numpy() for t in (tre, tim))
    for pair in ((tre, tim), host):
        got = T.planar_to_complex(*pair)
        assert isinstance(got, np.ndarray) and got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(T.planar_to_complex([1.0, 2.0], [3.0, 4.0]),
                                  [1 + 3j, 2 + 4j])


@pytest.mark.parametrize("make", ["init_state", "state_from_arrays"])
def test_state_constructors_default_to_the_card_and_raise_without_one(make, monkeypatch):
    """States are made on cuda:0 unless the caller asks for the CPU; with
    no card that raises and names device='cpu' (nothing falls back)."""
    tp = T.Plan(128, precision=T.FAST_PRECISION)
    arrays = T.state_to_arrays(T.init_state(tp, device="cpu"))
    call = {"init_state": lambda **kw: T.init_state(tp, **kw),
            "state_from_arrays": lambda **kw: T.state_from_arrays(arrays, **kw)}[make]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        call()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        call(device="cuda:0")
    assert call(device="cpu").accumulator.device.type == "cpu"


# -- checkpoints cross packages ---------------------------------------------------

def test_state_crosses_both_ways_and_continues_the_stream(tmp_path):
    jp, tp = _plans(131, window="blackman", roi=(2, 120))
    x = _signal(900, seed=4).astype(np.float32)
    # JAX streams 300, the port continues from its checkpoint for 300 ...
    js, _ = J.sdft(jp, J.init_state(jp), x[:300])
    path = tmp_path / "jax_state.npz"
    np.savez(path, **J.state_to_arrays(js))
    ts = T.state_from_arrays(np.load(path), device="cpu")
    ts, td = T.sdft(tp, ts, x[300:600])
    jref, jd = J.sdft(jp, js, x[300:600])
    _close(td, jd)
    # ... and JAX continues from the port's checkpoint for the last 300
    arrays = T.state_to_arrays(ts)
    assert set(arrays) == {"offset", "delayline", "accumulator"}
    assert arrays["offset"].dtype == np.int32
    js2, jd2 = J.sdft(jp, J.state_from_arrays(arrays), x[600:])
    _, jd_ref = J.sdft(jp, jref, x[600:])
    _close(jd2, jd_ref)


def test_import_leaves_jax_out():
    code = ("import sys, sdft_tpu_torch, sdft_tpu_torch.kernels, "
            "sdft_tpu_torch.ops.lti; "
            "bad = sorted(n for n in sys.modules "
            "if n.split('.')[0] in ('jax', 'jaxlib', 'sdft_tpu')); "
            "print(bad); sys.exit(1 if bad else 0)")
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(__import__("pathlib").Path(__file__).resolve().parents[1])]
        + [p for p in env.get("PYTHONPATH", "").split(os.pathsep) if p])
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, env=env, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
