"""WOLA unity-gain check with the PyTorch port (twin of
examples/stft_window_test.py; reference: python/examples/stft_window_test.py).

The ``STFT`` comparator's weighted-overlap-add synthesis must reconstruct
the interior of a random signal at unity gain (max error < 1e-8, a float64
contract) for symmetric and asymmetric window configurations.

    python examples/stft_window_test_torch.py [--device D]
"""

import argparse
import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

import numpy as np  # noqa: E402

from sdft_tpu_torch import STFT  # noqa: E402

CONFIGS = (
    dict(framesize=1024, hopsize=256),
    dict(framesize=1024, hopsize=256, dftsize=1024),
    dict(framesize=512, hopsize=128, window="hamming"),
)


def main(device="cuda:0"):
    rng = np.random.default_rng(0)
    x = rng.standard_normal(16384).clip(-1, 1)
    core = slice(4096, 12288)
    errs = []
    for cfg in CONFIGS:
        st = STFT(**cfg, device=device)
        y = st.istft(st.stft(x))
        err = float(np.abs(y[core] - x[core]).max())
        errs.append(err)
        print(f"{'OK' if err < 1e-8 else 'FAIL'}  {cfg}: max interior error {err:.2e}")
    if max(errs) >= 1e-8:
        raise AssertionError(f"WOLA interior error {max(errs):.2e} >= 1e-8")
    return errs


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda:0")
    main(device=ap.parse_args().device)
