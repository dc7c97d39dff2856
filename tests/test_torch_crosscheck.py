"""``scripts/crosscheck_torch.py`` on the CPU at a tiny size, and the
syntax of ``scripts/verify_torch.sh``.

The crosscheck loads the native oracle, whose -ffast-math build sets
FTZ/DAZ in the process that loads it, so it runs in a subprocess: the
oracle never enters a pytest worker.  Its gates are its own (float64: DFT
1e-7, WAV 1e-6; --fd32: the f32 error model; float32x2 vs fd80 1e-9 of
scale; SDFT vs STFT correlation > 0.9).
"""

import pathlib
import subprocess
import sys

import numpy as np
import pytest

from sdft_tpu_torch.io.wav import write_wav

REPO = pathlib.Path(__file__).resolve().parent.parent


@pytest.mark.parametrize("flags", [[], ["--fd32"]])
def test_crosscheck_torch_on_the_cpu(tmp_path, flags):
    src = tmp_path / "src.wav"
    write_wav(str(src), np.random.default_rng(4).standard_normal(6000).clip(-3, 3) / 3, 44100)
    proc = subprocess.run(
        [sys.executable, str(REPO / "scripts" / "crosscheck_torch.py"), "256", "64", "hann",
         "1", str(src), "--device", "cpu"] + flags,
        capture_output=True, text=True, timeout=300, cwd=str(tmp_path))
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-3000:]
    out = proc.stdout
    assert "crosscheck OK" in out
    assert f"port (cpu, {'float32' if flags else 'float64'}) dft max abs diff" in out


def test_verify_torch_sh_parses_and_names_what_exists():
    script = REPO / "scripts" / "verify_torch.sh"
    subprocess.run(["bash", "-n", str(script)], check=True, timeout=30)
    text = script.read_text()
    assert "scripts/crosscheck_torch.py" in text and "chip_smoke.py" in text
    for name in ("analysis", "latency", "precision", "stft_window_test", "streaming",
                 "transform"):
        assert (REPO / "examples" / f"{name}_torch.py").exists()
        assert name in text
