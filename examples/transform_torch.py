"""Spectral-transform streaming with the PyTorch port (twin of
examples/transform.py): a brickwall low-pass between analysis and
synthesis.

The reference's core usage is analyze -> modify the spectrum ->
resynthesize (python/src/sdft/sdft.py module docs).  The low-pass runs as a
fused transform (``Streamer.run(transform=..., fuse_transform=True)``, i.e.
``api.roundtrip(transform=...)``): the mask multiplies the complex spectra
inside the round trip, on the device.

Reads a WAV (mean-mixed to mono); without one it writes 8 s of seeded
44.1 kHz audio-like noise (a 1/f spectrum, as music has) to
``<out_dir>/source.wav`` with ``io.wav`` first.  Checks the result
physically: the energy above the cutoff must drop by >= 40 dB against the
unfiltered round trip.  Writes ``<out_dir>/transform.wav``.

    python examples/transform_torch.py [wav] [--cutoff HZ] [--device D] [--out DIR]
"""

import argparse
import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from sdft_tpu_torch import Plan, Streamer, iter_blocks  # noqa: E402
from sdft_tpu_torch.io.wav import read_wav, write_wav  # noqa: E402

OUT = pathlib.Path(__file__).resolve().parent / "out"


def source_wav(path, seconds=8.0, sr=44100, seed=0):
    """Seeded noise with a 1/f power spectrum, peak-normalized to 0.9."""
    n = int(seconds * sr)
    spec = np.fft.rfft(np.random.default_rng(seed).standard_normal(n))
    spec /= np.sqrt(np.maximum(np.fft.rfftfreq(n, 1.0 / sr), 20.0))
    x = np.fft.irfft(spec, n)
    write_wav(str(path), 0.9 * x / np.abs(x).max(), sr, bits=24)
    return str(path)


def band_energy_db(x, sr, lo_hz):
    spec = np.abs(np.fft.rfft(x)) ** 2
    freqs = np.fft.rfftfreq(x.size, 1.0 / sr)
    return 10 * np.log10(max(spec[freqs >= lo_hz].sum(), 1e-30) / spec.sum())


def main(wav=None, cutoff_hz=2000.0, m=1000, seconds=8.0, device="cuda:0", out_dir=OUT):
    out = pathlib.Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    if wav is None:
        wav = source_wav(out / "source.wav", seconds)
    plan = Plan(m, window="hann")
    x, sr = read_wav(wav)
    x = x[: (x.size // 4000) * 4000]

    # bin i covers frequencies around i * sr / (2m)
    cut_bin = int(cutoff_hz * 2 * m / sr)
    mask = (torch.arange(m, device=device) < cut_bin).to(torch.float64)

    def lowpass(z):  # complex (M, m) spectra on the device
        return z * mask

    blocks = list(iter_blocks(x, 4000))
    y_raw = np.concatenate(list(Streamer(plan, device=device).run(blocks)))
    y_lp = np.concatenate(list(Streamer(plan, device=device).run(
        blocks, transform=lowpass, fuse_transform=True)))

    above_raw = band_energy_db(y_raw, sr, cutoff_hz * 1.1)
    above_lp = band_energy_db(y_lp, sr, cutoff_hz * 1.1)
    drop = above_raw - above_lp
    print(f"cutoff {cutoff_hz:.0f} Hz (bin {cut_bin}/{m}), {x.size} samples from {wav}")
    print(f"energy above cutoff: raw {above_raw:.1f} dB -> "
          f"filtered {above_lp:.1f} dB  (drop {drop:.1f} dB)")
    write_wav(str(out / "transform.wav"), y_lp.astype(np.float64), sr)
    print(f"wrote {out / 'transform.wav'}")
    if not drop >= 40.0:
        raise AssertionError(f"stop-band drop only {drop:.1f} dB")
    print("OK")
    return drop


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("wav", nargs="?")
    ap.add_argument("--cutoff", type=float, default=2000.0)
    ap.add_argument("--device", default="cuda:0")
    ap.add_argument("--out", default=str(OUT))
    args = ap.parse_args()
    main(args.wav, args.cutoff, device=args.device, out_dir=args.out)
