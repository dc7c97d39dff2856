"""Smoke coverage of ``examples/*_torch.py`` on the CPU (twin of
tests/test_examples.py): each ``main`` runs once with ``device="cpu"`` at
a small size, writing into ``tmp_path``.  Each example raises on its own
physical checks (tone and chirp bins, WOLA < 1e-8, chained hop spectra
within 1e-12 of the per-block path and SNR > 25 dB, stop band >= 40 dB);
the precision tour is held here at the tiers' classes against float64
(float32 <= 3e-6 of scale, float32x2 <= 1e-12).  None of them skips:
``transform_torch`` writes its own seeded WAV.
"""

import importlib.util
import os
import pathlib
import subprocess
import sys

import pytest

EXAMPLES = pathlib.Path(__file__).resolve().parent.parent / "examples"


def _load(name, monkeypatch):
    spec = importlib.util.spec_from_file_location(f"example_{name}", EXAMPLES / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    monkeypatch.setitem(sys.modules, spec.name, mod)
    spec.loader.exec_module(mod)
    return mod


def test_example_analysis_torch(monkeypatch, tmp_path):
    dfts = _load("analysis_torch", monkeypatch).main(
        m=256, seconds=0.25, device="cpu", out_dir=tmp_path)
    assert dfts.shape == (11025, 256)
    if importlib.util.find_spec("matplotlib"):
        assert (tmp_path / "analysis.png").stat().st_size > 0


def test_example_latency_torch(monkeypatch):
    snrs = _load("latency_torch", monkeypatch).main(m=256, n=8192, device="cpu")
    # lower latency costs SNR (c/src/sdft/sdft.h:408-410)
    assert snrs[1.0] > snrs[0.5] > snrs[0.25]


def test_example_precision_torch(monkeypatch):
    errs = _load("precision_torch", monkeypatch).main(m=128, M=512, device="cpu")
    assert errs["float32 fast path"] <= 3e-6
    assert errs["float32x2 double-word"] <= 1e-12


def test_example_stft_window_test_torch(monkeypatch):
    errs = _load("stft_window_test_torch", monkeypatch).main(device="cpu")
    assert len(errs) == 3 and max(errs) < 1e-8


def test_example_streaming_torch(monkeypatch):
    assert _load("streaming_torch", monkeypatch).main(256, 32, device="cpu") > 25.0


def test_example_transform_torch(monkeypatch, tmp_path):
    drop = _load("transform_torch", monkeypatch).main(
        m=256, seconds=1.0, device="cpu", out_dir=tmp_path)
    assert drop >= 40.0
    assert (tmp_path / "source.wav").exists() and (tmp_path / "transform.wav").exists()


def test_example_transform_torch_reads_a_given_wav(monkeypatch, tmp_path):
    mod = _load("transform_torch", monkeypatch)
    src = mod.source_wav(tmp_path / "given.wav", seconds=1.0, seed=3)
    mod.main(src, m=256, device="cpu", out_dir=tmp_path / "out")
    assert not (tmp_path / "out" / "source.wav").exists()


def test_examples_need_a_card_unless_told_cpu(monkeypatch):
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        _load("latency_torch", monkeypatch).main(m=128, n=1024)


def test_examples_import_neither_jax_nor_sdft_tpu():
    """Loading every example (and chip_smoke.py) imports only the port."""
    code = ("import importlib.util, pathlib, sys\n"
            "for f in sorted(pathlib.Path('examples').glob('*_torch.py')) + "
            "[pathlib.Path('chip_smoke.py')]:\n"
            "    spec = importlib.util.spec_from_file_location(f.stem, f)\n"
            "    spec.loader.exec_module(importlib.util.module_from_spec(spec))\n"
            "bad = sorted(n for n in sys.modules if n.split('.')[0] in "
            "('jax', 'jaxlib', 'sdft_tpu'))\n"
            "print(bad); sys.exit(1 if bad else 0)")
    env = dict(os.environ, PYTHONPATH=str(EXAMPLES.parent))
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          env=env, cwd=str(EXAMPLES.parent), timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
