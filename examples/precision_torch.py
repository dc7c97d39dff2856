"""Precision-tier tour with the PyTorch port (twin of examples/precision.py).

The reference exposes float/double/long-double FD tiers through template
parameters (c/src/sdft/sdft.h:21-37,101-125); the port mirrors them as
``Precision`` configurations:

  * float32 fast path       — the throughput configuration (on a card, K1)
  * float32x2 (double-word) — f64-class spectra from float32 arithmetic

Each tier's forward spectra, computed on ``device``, are held against the
port's own float64 ``ops`` path on the CPU (the JAX twin uses the native
C++ oracle, which this package does not import), so the residuals mean the
same on any device.

    python examples/precision_torch.py [--device D]
"""

import argparse
import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

import numpy as np  # noqa: E402

from sdft_tpu_torch import (Plan, Precision, df_to_float64, init_state, sdft,  # noqa: E402
                            to_complex)
from sdft_tpu_torch.cplx import to_numpy  # noqa: E402


def main(m=512, M=2048, device="cuda:0"):
    rng = np.random.default_rng(0)
    x = np.clip(rng.standard_normal(M), -2, 2).astype(np.float32) / 2

    p64 = Plan(m, window="hann", precision=Precision("float64", "float64"))
    _, d64 = sdft(p64, init_state(p64, device="cpu"), x.astype(np.float64))
    want = to_complex(d64)
    scale = np.abs(want).max()

    rows = {}
    p32 = Plan(m, window="hann", precision=Precision("float32", "float32"))
    _, d32 = sdft(p32, init_state(p32, device=device), x)
    rows["float32 fast path"] = to_complex(d32)

    px2 = Plan(m, window="hann", precision=Precision("float32", "float32x2"))
    _, dx2 = sdft(px2, init_state(px2, device=device), x)
    dx2 = to_numpy(dx2)
    rows["float32x2 double-word"] = to_complex(df_to_float64((dx2[..., 0], dx2[..., 1])))

    print(f"m={m}, {M} samples, device={device}")
    print(f"{'tier':24s} max |err| / scale  (vs float64 ops on the CPU)")
    errs = {}
    for name, got in rows.items():
        errs[name] = float(np.abs(got - want).max() / scale)
        print(f"{name:24s} {errs[name]:.3e}")
    return errs


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda:0")
    main(device=ap.parse_args().device)
