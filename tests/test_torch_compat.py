"""The port's compat classes against ``sdft_tpu.compat`` (mirrors
tests/test_compat.py case by case).

``SDFT`` and ``STFT`` of both packages get the same seeded numpy inputs on
the CPU (JAX in x64) and are held at 1e-12 in float64.  The legs against
the reference Python package skip, as the JAX ones do, when it is not
importable (its path is tests/test_compat.py's).
"""

import sys

import numpy as np
import pytest
import torch

import sdft_tpu as J
import sdft_tpu_torch as T
from sdft_tpu.compat import SDFT as JSDFT
from sdft_tpu.compat import STFT as JSTFT
from sdft_tpu_torch.compat import SDFT, STFT
from test_compat import REF_SRC

F64 = T.Precision("float64", "float64")


@pytest.fixture(scope="module")
def ref():
    sys.path.insert(0, REF_SRC)
    try:
        import sdft as ref_mod
    except ImportError:
        pytest.skip("reference python package not importable")
    finally:
        sys.path.remove(REF_SRC)
    return ref_mod


def test_sdft_class_matches_jax():
    rng = np.random.default_rng(0)
    x = rng.standard_normal(700).clip(-1, 1)
    theirs = JSDFT(100, "hamming", 0.5, precision=J.Precision("float64", "float64"))
    ours = SDFT(100, "hamming", 0.5, precision=F64, device="cpu")
    assert ours.size == 100 and ours.window == "hamming" and ours.latency == 0.5

    d_ours = ours.sdft(x)
    assert isinstance(d_ours, np.ndarray) and d_ours.dtype == np.complex128
    np.testing.assert_allclose(d_ours, theirs.sdft(x), atol=1e-12)
    y_ours = ours.isdft(d_ours)
    assert isinstance(y_ours, np.ndarray) and y_ours.shape == (700,)
    np.testing.assert_allclose(y_ours, theirs.isdft(d_ours), atol=1e-12)

    # reset + replay reproduces the identical matrix; chained calls carry
    ours.reset()
    np.testing.assert_array_equal(ours.sdft(x), d_ours)
    np.testing.assert_allclose(ours.sdft(x[:300]), theirs.sdft(x[:300]), atol=1e-12)
    with pytest.raises(ValueError, match="1D"):
        ours.sdft(np.zeros((2, 3)))
    with pytest.raises(ValueError, match="2D"):
        ours.isdft(np.zeros((2, 3, 4)))


def test_sdft_class_matches_reference(ref):
    rng = np.random.default_rng(0)
    x = rng.standard_normal(700).clip(-1, 1)
    theirs = ref.SDFT(100, "hamming", 0.5)
    ours = SDFT(100, "hamming", 0.5, precision=F64, device="cpu")
    d_ref = theirs.sdft(x)
    d_ours = ours.sdft(x)
    np.testing.assert_allclose(d_ours, d_ref, atol=1e-7)
    np.testing.assert_allclose(ours.isdft(d_ours), theirs.isdft(d_ref), atol=1e-7)


@pytest.mark.parametrize("shift", [False, True])
@pytest.mark.parametrize("dftsize", [None, 600])
def test_stft_matches_jax(shift, dftsize):
    rng = np.random.default_rng(1)
    x = rng.standard_normal(4096).clip(-1, 1)
    theirs = JSTFT(framesize=512, hopsize=128, dftsize=dftsize, window="hann", shift=shift)
    ours = STFT(framesize=512, hopsize=128, dftsize=dftsize, window="hann", shift=shift,
                device="cpu")
    d_ref = theirs.stft(x)
    d_ours = ours.stft(x)
    assert d_ours.shape == d_ref.shape and d_ours.dtype == np.complex128
    np.testing.assert_allclose(d_ours, d_ref, atol=1e-12)
    np.testing.assert_allclose(ours.istft(d_ref), theirs.istft(d_ref), atol=1e-12)


@pytest.mark.parametrize("window", ["hamming", "blackman", "boxcar"])
def test_stft_windows_match_jax(window):
    rng = np.random.default_rng(3)
    x = rng.standard_normal(2048).clip(-1, 1)
    for dftsize in (None, 300):
        theirs = JSTFT(256, 64, dftsize, window)
        ours = STFT(256, 64, dftsize, window, device="cpu")
        np.testing.assert_allclose(ours.stft(x), theirs.stft(x), atol=1e-12)
        np.testing.assert_allclose(ours.istft(ours.stft(x)), theirs.istft(theirs.stft(x)),
                                   atol=1e-12)
    with pytest.raises(ValueError, match="framesize and dftsize"):
        STFT(512, 128, dftsize=100, device="cpu")


@pytest.mark.parametrize("shift", [False, True])
@pytest.mark.parametrize("dftsize", [None, 600])
def test_stft_matches_reference(ref, shift, dftsize):
    rng = np.random.default_rng(1)
    x = rng.standard_normal(4096).clip(-1, 1)
    theirs = ref.STFT(framesize=512, hopsize=128, dftsize=dftsize, window="hann", shift=shift)
    ours = STFT(framesize=512, hopsize=128, dftsize=dftsize, window="hann", shift=shift,
                device="cpu")
    d_ref = theirs.stft(x)
    np.testing.assert_allclose(ours.stft(x), d_ref, atol=1e-12)
    np.testing.assert_allclose(ours.istft(d_ref), theirs.istft(d_ref), atol=1e-12)


def test_stft_wola_unity_gain():
    """WOLA round trip reconstructs the interior to near-unity gain
    (python/examples/stft_window_test.py:21-32)."""
    rng = np.random.default_rng(2)
    x = rng.standard_normal(8192).clip(-1, 1)
    st = STFT(framesize=1024, hopsize=256, window="hann", device="cpu")
    y = st.istft(st.stft(x))
    core = slice(2048, 6144)
    np.testing.assert_allclose(y[core], x[core], atol=1e-10)


def test_compat_classes_need_a_card_unless_told_otherwise():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        SDFT(100)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        STFT(512, 128)
