"""The port's reference-protocol CLI and its WAV / dump writers against
``sdft_tpu``'s on the same files.

Gates: the ``.dft`` within 1e-12 of its scale and the WAV within one LSB of
``python -m sdft_tpu`` (both in float64 on the CPU); the writers give the
same bytes for the same arrays.
"""

import os
import runpy
import subprocess
import sys
import wave

import numpy as np
import pytest
import torch

from sdft_tpu.cli import main as j_main
from sdft_tpu.io import dump as j_dump
from sdft_tpu.io import wav as j_wav
from sdft_tpu_torch.cli import main as t_main
from sdft_tpu_torch.io import dump, wav

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _src(tmp_path, n=3000, seed=0, bits=24):
    x = np.clip(np.random.default_rng(seed).standard_normal(n), -3, 3) / 3
    path = str(tmp_path / "src.wav")
    wav.write_wav(path, x, 44100, bits=bits)
    return path


def _pcm(path):
    """The WAV's samples as integers."""
    with wave.open(path, "rb") as f:
        width = f.getsampwidth()
        raw = np.frombuffer(f.readframes(f.getnframes()), np.uint8).reshape(-1, width)
    acc = np.zeros(len(raw), np.int64)
    for b in range(width):
        acc |= raw[:, b].astype(np.int64) << (8 * b)
    sign = np.int64(1) << (8 * width - 1)
    return (acc ^ sign) - sign


def _run(main, tmp_path, tag, args, extra=()):
    out_wav, out_dft = str(tmp_path / f"{tag}.wav"), str(tmp_path / f"{tag}.dft")
    assert main([*map(str, args), out_wav, out_dft, *extra]) == 0
    return out_wav, out_dft


@pytest.mark.parametrize("m,hop,window,latency,block", [
    (100, 100, "hann", 1, None),
    (64, 4, "hamming", 0.5, None),
    (100, 100, "blackman", 1, "500"),
    (64, 4, "hann", 1, "200"),
])
def test_cli_matches_the_jax_cli(tmp_path, m, hop, window, latency, block):
    src = _src(tmp_path, seed=hop)
    extra = ["--block", block] if block else []
    jw, jd = _run(j_main, tmp_path, "jax", [m, hop, window, latency, src], extra)
    tw, td = _run(t_main, tmp_path, "port", [m, hop, window, latency, src],
                  extra + ["--device", "cpu"])
    want = j_dump.load_complex(jd, m)
    got = dump.load_complex(td, m)
    assert got.shape == want.shape == (3000 // hop, m)
    assert np.abs(got - want).max() <= 1e-12 * np.abs(want).max()
    a, b = _pcm(tw), _pcm(jw)
    assert a.shape == b.shape == (3000 // hop * hop,)
    assert np.abs(a - b).max() <= 1


def test_block_and_padding_do_not_change_the_outputs(tmp_path):
    """Blocks of 300 zero-pad the 2950-sample stream; the default block
    (16000) pads it more.  Outputs stop at size // hop spectra."""
    src = _src(tmp_path, n=2950, seed=3)
    outs = []
    for extra in ([], ["--block", "300"]):
        w, d = _run(t_main, tmp_path, f"b{len(extra)}", [64, 50, "hann", 1, src],
                    extra + ["--device", "cpu"])
        outs.append((wav.read_wav(w)[0], dump.load_complex(d, 64)))
    assert outs[0][1].shape == (59, 64) and outs[0][0].shape == (2950,)
    np.testing.assert_allclose(outs[1][0], outs[0][0], atol=1e-12)
    np.testing.assert_allclose(outs[1][1], outs[0][1], atol=1e-12)


def test_fd32_matches_the_float64_run(tmp_path):
    src = _src(tmp_path, seed=5)
    w64, d64 = _run(t_main, tmp_path, "f64", [100, 100, "hann", 1, src], ["--device", "cpu"])
    w32, d32 = _run(t_main, tmp_path, "f32", [100, 100, "hann", 1, src],
                    ["--fd32", "--device", "cpu"])
    np.testing.assert_allclose(dump.load_complex(d32, 100), dump.load_complex(d64, 100),
                               atol=2e-7)
    np.testing.assert_allclose(wav.read_wav(w32)[0], wav.read_wav(w64)[0], atol=1e-4)


@pytest.mark.parametrize("bits", [8, 16, 24, 32])
def test_writers_give_the_jax_bytes(tmp_path, bits):
    x = np.clip(np.random.default_rng(bits).standard_normal(777), -1.2, 1.2)
    x[:4] = [1.0, -1.0, 0.5, -0.5]
    wav.write_wav(str(tmp_path / "t.wav"), x, 48000, bits=bits)
    j_wav.write_wav(str(tmp_path / "j.wav"), x, 48000, bits=bits)
    assert (tmp_path / "t.wav").read_bytes() == (tmp_path / "j.wav").read_bytes()
    got, sr = wav.read_wav(str(tmp_path / "t.wav"))
    want, _ = j_wav.read_wav(str(tmp_path / "t.wav"))
    assert sr == 48000 and np.array_equal(got, want)
    z = x[:700].reshape(7, 100) * (1 - 0.5j)
    dump.dump_complex(str(tmp_path / "t.dft"), z)
    j_dump.dump_complex(str(tmp_path / "j.dft"), z)
    assert (tmp_path / "t.dft").read_bytes() == (tmp_path / "j.dft").read_bytes()


@pytest.mark.parametrize("m,hop,window,latency,block", [
    (100, 100, "hann", 1, "800"),
    (64, 4, "hamming", 0.5, "480"),
])
def test_mesh_cli_matches_the_jax_mesh_cli(tmp_path, m, hop, window, latency, block):
    """``--mesh 1x2x1 --device cpu`` on two spawned Gloo ranks against
    ``python -m sdft_tpu ... --mesh 1x2x1`` on the virtual CPU mesh: whole
    blocks through the sharded driver, the trailing partial block on the
    single-device path.  Same gates as the single-device CLI."""
    src = _src(tmp_path, seed=hop + 1)
    extra = ["--mesh", "1x2x1", "--block", block]
    jw, jd = _run(j_main, tmp_path, "jax", [m, hop, window, latency, src], extra)
    tw, td = str(tmp_path / "port.wav"), str(tmp_path / "port.dft")
    proc = subprocess.run(
        [sys.executable, os.path.join(REPO, "tests", "helpers", "torch_sharded_worker.py"),
         "1x2x1", "--cli", *map(str, [m, hop, window, latency, src]), tw, td, *extra,
         "--device", "cpu"], capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, (proc.stdout + proc.stderr)[-3000:]
    want = j_dump.load_complex(jd, m)
    got = dump.load_complex(td, m)
    assert got.shape == want.shape == (3000 // hop, m)
    assert np.abs(got - want).max() <= 1e-12 * np.abs(want).max()
    a, b = _pcm(tw), _pcm(jw)
    assert a.shape == b.shape == (3000 // hop * hop,)
    assert np.abs(a - b).max() <= 1


def test_what_the_cli_does_not_port_raises(tmp_path, capsys):
    src = _src(tmp_path, n=500)
    args = ["64", "50", "hann", "1", src, str(tmp_path / "o.wav"), str(tmp_path / "o.dft")]
    for spec, msg in (("2x1x1", "channel axis must be 1"), ("1x4", "expects CxTxB")):
        with pytest.raises(SystemExit, match=msg):
            t_main(args + ["--mesh", spec, "--device", "cpu"])
    with pytest.raises(SystemExit, match="tile\\*T"):
        t_main(args + ["--mesh", "1x4x1", "--block", "100", "--device", "cpu"])
    # the subcommands run (tests/test_torch_profiling.py); without --device
    # they take the card like the driver, and a trace needs its driver args
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="--device cpu"):
            t_main(["bench", "4096", "16384"])
    assert t_main(["trace", str(tmp_path / "tb")]) == 1
    with pytest.raises(SystemExit, match="multiple of hopsize"):
        t_main(args + ["--block", "75", "--device", "cpu"])
    assert t_main(args[:3]) == 1
    assert "7-positional" in capsys.readouterr().out


def test_cli_needs_a_card_unless_told_cpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    src = _src(tmp_path, n=500)
    with pytest.raises(RuntimeError, match="--device cpu"):
        t_main(["64", "50", "hann", "1", src, str(tmp_path / "o.wav"),
                str(tmp_path / "o.dft")])


def test_module_entry_point_runs_the_cli(tmp_path, monkeypatch):
    src = _src(tmp_path, n=400)
    out = tmp_path / "o.dft"
    monkeypatch.setattr(sys, "argv", ["sdft_tpu_torch", "64", "100", "hann", "1", src,
                                      str(tmp_path / "o.wav"), str(out), "--device", "cpu"])
    with pytest.raises(SystemExit) as exc:
        runpy.run_module("sdft_tpu_torch", run_name="__main__")
    assert exc.value.code == 0
    assert out.stat().st_size == 4 * 64 * 16


def test_new_modules_leave_jax_out():
    code = ("import sys, sdft_tpu_torch.cli, sdft_tpu_torch.io, sdft_tpu_torch.profiling, "
            "sdft_tpu_torch.kernels.kparts, sdft_tpu_torch.__main__, sdft_tpu_torch.viz, "
            "sdft_tpu_torch.parallel.scaling_worker, sdft_tpu_torch.oracle, "
            "sdft_tpu_torch.kernels.compare_bodies, sdft_tpu_torch.graphs; "
            "bad = sorted(n for n in sys.modules "
            "if n.split('.')[0] in ('jax', 'jaxlib', 'sdft_tpu')); "
            "print(bad); sys.exit(1 if bad else 0)")
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [REPO] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep) if p])
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, env=env, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
