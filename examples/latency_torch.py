"""Latency vs SNR trade-off with the PyTorch port (twin of
examples/latency.py; reference: python/examples/latency.py).

Round trips truncated-normal noise through ``sdft``/``isdft`` at several
synthesis latency factors and reports the SNR in dB after removing the
(m-1)*latency sample algorithmic delay — lower latency costs SNR
(c/src/sdft/sdft.h:408-410).  The plan is the default precision (float64
spectra), which a card runs in float64.

    python examples/latency_torch.py [--device D]
"""

import argparse
import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

import numpy as np  # noqa: E402

from sdft_tpu_torch import Plan, init_state, isdft, roundtrip_snr_db, sdft  # noqa: E402


def main(m=1000, n=44100, device="cuda:0"):
    rng = np.random.default_rng(0)
    x = np.clip(rng.standard_normal(n), -2, 2) / 2

    snrs = {}
    for latency in (1.0, 0.75, 0.5, 0.25):
        plan = Plan(m, window="hann", latency=latency)
        _, dfts = sdft(plan, init_state(plan, device=device), x)
        y = isdft(plan, dfts)
        snrs[latency] = roundtrip_snr_db(x, y, plan)
        print(f"latency {latency:4.2f}: delay {plan.synthesis_delay:5d} samples, "
              f"SNR {snrs[latency]:6.2f} dB")
    return snrs


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda:0")
    main(device=ap.parse_args().device)
