"""Tone + chirp analysis with the PyTorch port (twin of examples/analysis.py;
reference: python/examples/analysis.py, cpp/examples/analysis.cpp:44-49).

Generates a 1 kHz tone plus a 100 Hz -> 10 kHz linear chirp at 44.1 kHz
(one second by default), runs ``sdft`` with m=1000 bins in float32 — the
plan the kernels take, so on a card the spectra come from K1 — checks the
tone's peak bin and the chirp's bin analytically, and renders the dB
spectrogram to ``<out_dir>/analysis.png`` when matplotlib is there.

    python examples/analysis_torch.py [--device D] [--out DIR]
"""

import argparse
import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

import numpy as np  # noqa: E402

from sdft_tpu_torch import FAST_PRECISION, Plan, init_state, sdft, to_complex  # noqa: E402

OUT = pathlib.Path(__file__).resolve().parent / "out"


def main(m=1000, seconds=1.0, device="cuda:0", out_dir=OUT):
    sr = 44100
    n = int(sr * seconds)
    f = 1000.0

    t = np.arange(n) / sr
    tone = np.sin(2 * np.pi * f * t)
    # linear chirp 100 Hz -> 10 kHz over the signal: phase = 2π∫f(τ)dτ
    f0, f1 = 100.0, 10000.0
    chirp = 0.5 * np.sin(2 * np.pi * (f0 * t + 0.5 * (f1 - f0) * t * t / t[-1]))
    x = (tone + chirp).astype(np.float32)

    plan = Plan(m, window="hann", precision=FAST_PRECISION)
    _, dfts = sdft(plan, init_state(plan, device=device), x)
    dfts = to_complex(dfts)

    # the tone's peak bin sits at f / (sr / (2m)) = f * 2m / sr; probe
    # mid-signal where the chirp (then ~5 kHz) is far from the tone
    mid = n // 2
    hi = int(round(2000.0 * 2 * m / sr))
    mags = np.abs(dfts[mid][:hi])
    peak = int(np.argmax(mags))
    expect = int(round(f * 2 * m / sr))
    print(f"tone peak bin {peak} (expected ~{expect}), magnitude {mags[peak]:.4f}")
    if abs(peak - expect) > 1:
        raise AssertionError(f"tone peak at bin {peak}, expected {expect}")

    # the chirp's frequency as the SDFT sees it: the window spans the last
    # 2m samples, so the spectrum reflects the chirp ~m samples earlier
    f_inst = f0 + (f1 - f0) * ((mid - m) / n)
    cb = int(round(f_inst * 2 * m / sr))
    w = np.abs(dfts[mid][cb - 10:cb + 11])
    cpk = cb - 10 + int(np.argmax(w))
    print(f"chirp bin at t={mid / sr:.2f}s: {cpk} (expected ~{cb})")
    if abs(cpk - cb) > 3:
        raise AssertionError(f"chirp at bin {cpk}, expected {cb}")

    from sdft_tpu_torch.viz import spectrogram

    try:
        ax = spectrogram(dfts[::100], samplerate=sr, hopsize=100)
    except ImportError:
        print("matplotlib not available; no plot")
        return dfts
    out = pathlib.Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    ax.figure.savefig(out / "analysis.png", dpi=100)
    print(f"wrote {out / 'analysis.png'}")
    return dfts


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda:0")
    ap.add_argument("--out", default=str(OUT))
    args = ap.parse_args()
    main(device=args.device, out_dir=args.out)
