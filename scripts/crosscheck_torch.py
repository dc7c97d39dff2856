"""Cross-implementation check of the PyTorch port (twin of
scripts/crosscheck.py, the analogue of the reference's test/main.sh +
test/main.py).

Runs the 7-argument driver protocol through the port's CLI
(``sdft_tpu_torch.cli.main``) and through the native C++ oracle engine
(``sdft_tpu_torch.oracle``, built from the port's own sources under
``sdft_tpu_torch/native/``), and holds the port's DFT matrix and WAV to the
oracle's; checks the oracle's two engines against each other and its
extended (fd80) tier against its double tier; holds the port's float32x2
tier to the fd80 engine at 1e-9 of scale; and correlates the port's
spectrogram with its FFT ``STFT``'s (> 0.9).

Gates: in float64 the reference contract, DFT <= 1e-7 (test/main.py:79)
and WAV <= 1e-6.  With --fd32 the f32 error model of scripts/crosscheck.py
(:69-95): with a refresh per block the spectra error is the within-block
random walk eps32 * |x|_rms * sqrt(block / (2m)), gated at 3.5x the model
(DFT floor 1e-7, WAV floor 1e-4).

The port's results are all computed before the oracle loads: the oracle's
library is built with -ffast-math, and loading it sets FTZ/DAZ for the rest
of the process, which would flush the subnormals of a float32x2 leg on the
CPU.

Usage:
    python scripts/crosscheck_torch.py [dftsize] [hopsize] [window] [latency] [wav] [plot.png]
                                       [--fd32] [--device D]
Defaults: 1000 100 hann 1, a seeded 8 s 44.1 kHz noise WAV written with
``io.wav``, device cuda:0 (--device cpu for the CPU).  A sixth argument
saves side-by-side port/oracle/STFT spectrograms there (matplotlib).
"""

import pathlib
import sys
import tempfile

import numpy as np

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

from sdft_tpu_torch import (STFT, Plan, Precision, df_to_float64, init_state,  # noqa: E402
                            sdft)
from sdft_tpu_torch.cli import main as cli_main  # noqa: E402
from sdft_tpu_torch.cplx import to_numpy  # noqa: E402
from sdft_tpu_torch.io.dump import load_complex  # noqa: E402
from sdft_tpu_torch.io.wav import read_wav, write_wav  # noqa: E402


def noise_wav(path, seconds: float = 8.0, sr: int = 44100, seed: int = 12) -> str:
    """Seeded noise, clipped at 3 sigma and scaled into [-1, 1]."""
    rng = np.random.default_rng(seed)
    write_wav(str(path), rng.standard_normal(int(seconds * sr)).clip(-3, 3) / 3, sr)
    return str(path)


def gate(name: str, err: float, tol: float) -> None:
    print(f"{name}: {err:.3e} (tolerance {tol:.3e})", flush=True)
    if not err < tol:
        raise AssertionError(f"{name}: {err:.3e} >= {tol:.3e}")


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    fd32 = "--fd32" in argv
    if fd32:
        argv.remove("--fd32")
    device = "cuda:0"
    if "--device" in argv:
        i = argv.index("--device")
        device = argv[i + 1]
        del argv[i:i + 2]
    dftsize = int(argv[0]) if len(argv) > 0 else 1000
    hopsize = int(argv[1]) if len(argv) > 1 else 100
    window = argv[2] if len(argv) > 2 else "hann"
    latency = float(argv[3]) if len(argv) > 3 else 1.0
    plot = argv[5] if len(argv) > 5 else None

    with tempfile.TemporaryDirectory() as tmp:
        tmp = pathlib.Path(tmp)
        src = argv[4] if len(argv) > 4 else noise_wav(tmp / "src.wav")
        x, sr = read_wav(src)
        size = (x.size // hopsize) * hopsize
        x = x[:size]

        block = hopsize * max(1, 4096 // hopsize)
        if fd32:
            xrms = float(np.sqrt(np.mean(x.astype(np.float64) ** 2)))
            model = float(np.finfo(np.float32).eps) * xrms * (block / (2.0 * dftsize)) ** 0.5
            dft_tol, wav_tol = max(1e-7, 3.5 * model), max(1e-4, 3.5e3 * model)
        else:
            dft_tol, wav_tol = 1e-7, 1e-6

        # -- the port: the CLI, the float32x2 tier, the STFT
        args = [str(dftsize), str(hopsize), window, str(latency), src,
                str(tmp / "port.wav"), str(tmp / "port.dft"), "--block", str(block),
                "--device", device] + (["--fd32"] if fd32 else [])
        if cli_main(args) != 0:
            raise RuntimeError(f"the port's CLI failed: {' '.join(args)}")
        dfts_port = load_complex(str(tmp / "port.dft"), dftsize)
        y_port, _ = read_wav(str(tmp / "port.wav"))

        nseg = min(size, 4 * hopsize)
        plan_x2 = Plan(dftsize, window=window, latency=latency,
                       precision=Precision("float32", "float32x2"))
        _, ddf = sdft(plan_x2, init_state(plan_x2, device=device),
                      x[:nseg].astype(np.float32))
        ddf = to_numpy(ddf)
        got_df = df_to_float64((ddf[..., 0], ddf[..., 1]))
        got_df = got_df[..., 0] + 1j * got_df[..., 1]

        # cross-algorithm sanity vs the FFT STFT (test/main.py:56-63)
        framesize = dftsize * 2
        xd = np.roll(x, framesize)
        xd[:framesize] = 0
        stftx = STFT(framesize, hopsize, window=window, device=device).stft(xd)

        # -- the oracle, loaded only now (it sets FTZ/DAZ when it loads)
        from sdft_tpu_torch.oracle import NativeSDFT, NativeSDFT2

        print("native oracle pass...", flush=True)
        eng = NativeSDFT(dftsize, window, latency, td_bits=64)
        hops = size // hopsize
        dfts_ref = np.empty((hops, dftsize), np.complex128)
        y_ref = np.empty(size)
        for h in range(hops):
            d = eng.sdft(x[h * hopsize:(h + 1) * hopsize])
            dfts_ref[h] = d[0]
            y_ref[h * hopsize:(h + 1) * hopsize] = eng.isdft(d)

        # the native<->native leg (test/main.py:78): two engines, no shared code
        print("native engine #2 pass...", flush=True)
        eng2 = NativeSDFT2(dftsize, window, latency, td_bits=64)
        nerr = 0.0
        for h in range(hops):
            d2 = eng2.sdft(x[h * hopsize:(h + 1) * hopsize])
            nerr = max(nerr, float(np.abs(d2[0] - dfts_ref[h]).max()))
        gate("native #1 vs #2 dft max abs diff", nerr, 1e-12)

        # the oracle's extended FD tier (c/src/sdft/sdft.h:21-37) against its
        # double tier, then the port's float32x2 tier against it
        eng80 = NativeSDFT(dftsize, window, latency, td_bits=64, fd_bits=80)
        xerr = 0.0
        for h in range(min(hops, 16)):
            d80 = eng80.sdft(x[h * hopsize:(h + 1) * hopsize])
            xerr = max(xerr, float(np.abs(d80[0] - dfts_ref[h]).max()))
        gate("native fd80 vs fd64 dft max abs diff", xerr, 1e-12)
        eng80.reset()
        want80 = eng80.sdft(x[:nseg].astype(np.float32).astype(np.float64))
        gate("port float32x2 tier vs native fd80 dft max rel diff",
             float(np.abs(got_df - want80).max() / np.abs(want80).max()), 1e-9)

        ref_wav = tmp / "oracle.wav"
        write_wav(str(ref_wav), y_ref, sr)
        y_ref_q, _ = read_wav(str(ref_wav))
        if dfts_port.shape != dfts_ref.shape:
            raise AssertionError(f"dft shapes {dfts_port.shape} vs {dfts_ref.shape}")
        gate(f"port ({device}, {'float32' if fd32 else 'float64'}) dft max abs diff",
             float(np.abs(dfts_port - dfts_ref).max()), dft_tol)
        gate("port wav max abs diff", float(np.abs(y_port - y_ref_q).max()), wav_tol)

        corr = _spectro_corr(dfts_port, stftx[:dfts_port.shape[0]])
        print(f"SDFT vs STFT log-spectrogram correlation: {corr:.4f} (> 0.9)")
        if not corr > 0.9:
            raise AssertionError(f"SDFT vs STFT correlation {corr:.4f} <= 0.9")

        if plot:
            from sdft_tpu_torch.viz import compare_spectrograms
            compare_spectrograms(
                [(f"sdft (port, {device})", dfts_port), ("sdft (oracle)", dfts_ref),
                 ("stft (fft)", stftx[:dfts_port.shape[0], :dftsize])],
                samplerate=sr, hopsize=hopsize, path=plot)
            print(f"spectrograms saved to {plot}")

    print("crosscheck OK")
    return 0


def _spectro_corr(a, b):
    """Correlation of dB magnitudes over the common shape."""
    n = min(a.shape[0], b.shape[0])
    k = min(a.shape[1], b.shape[1])
    da = 20 * np.log10(np.abs(a[:n, :k]) + 1e-12)
    db = 20 * np.log10(np.abs(b[:n, :k]) + 1e-12)
    da, db = da.ravel(), db.ravel()
    da -= da.mean()
    db -= db.mean()
    return float((da @ db) / np.sqrt((da @ da) * (db @ db)))


if __name__ == "__main__":
    sys.exit(main())
