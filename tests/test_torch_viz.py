"""``sdft_tpu_torch.viz`` against ``sdft_tpu.viz`` on the same inputs.

The dB matrices are the same numpy arithmetic in both packages, so they
must be equal exactly, for complex and packed (..., 2) spectra given as
numpy arrays or as tensors; the plotting helpers are smoke-tested behind
``importorskip("matplotlib")``.
"""

import numpy as np
import pytest
import torch

from sdft_tpu import viz as jviz
from sdft_tpu_torch import viz as tviz


def _spectra(dtype=np.complex128, shape=(40, 33)):
    rng = np.random.default_rng(0)
    z = (rng.standard_normal(shape) + 1j * rng.standard_normal(shape)).astype(dtype)
    z[0, :3] = 0  # silent bins render at the floor
    return z


@pytest.mark.parametrize("dtype", [np.complex128, np.complex64])
def test_magnitude_db_equals_jax(dtype):
    z = _spectra(dtype)
    packed = np.stack([z.real, z.imag], axis=-1)
    want = jviz.magnitude_db(z)
    for given in (z, packed, torch.as_tensor(z), torch.as_tensor(packed)):
        np.testing.assert_array_equal(tviz.magnitude_db(given), want)
    np.testing.assert_array_equal(tviz.magnitude_db(packed), jviz.magnitude_db(packed))


def test_power_db_equals_jax_and_magnitude_db():
    z = _spectra()
    p = np.abs(z) ** 2
    np.testing.assert_array_equal(tviz.power_db(p), jviz.power_db(p))
    np.testing.assert_array_equal(tviz.power_db(torch.as_tensor(p)), jviz.power_db(p))
    # bf16 power planes (sdft_power's narrow form) read as float32
    p16 = torch.as_tensor(p, dtype=torch.bfloat16)
    np.testing.assert_array_equal(tviz.power_db(p16), jviz.power_db(p16.float().numpy()))
    live = p > 0
    np.testing.assert_allclose(tviz.power_db(p)[live], tviz.magnitude_db(z)[live],
                               atol=1e-9)


def test_spectrogram_and_compare_spectrograms(tmp_path):
    pytest.importorskip("matplotlib")
    z = _spectra()
    ax = tviz.spectrogram(torch.as_tensor(z), samplerate=8000, hopsize=10, title="t")
    assert ax.get_title() == "t"
    assert ax.images[0].get_extent() == [0.0, 40 * 10 / 8000, 0.0, 4000.0]
    path = tmp_path / "cmp.png"
    tviz.compare_spectrograms([("a", z), ("b", np.stack([z.real, z.imag], -1))],
                              samplerate=8000, hopsize=10, path=str(path))
    assert path.stat().st_size > 0
