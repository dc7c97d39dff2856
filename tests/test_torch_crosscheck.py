"""``scripts/crosscheck_torch.py`` on the CPU at a tiny size, and the
syntax of ``scripts/verify_torch.sh``.

The crosscheck loads the native oracle, whose -ffast-math build sets
FTZ/DAZ in the process that loads it, so it runs in a subprocess: the
oracle never enters a pytest worker.  Its gates are its own (float64: DFT
1e-7, WAV 1e-6; --fd32: the f32 error model; float32x2 vs fd80 1e-9 of
scale; SDFT vs STFT correlation > 0.9).

The script must run where the JAX package is absent: it is run under a
wrapper that fails when a module of ``jax``, ``jaxlib`` or ``sdft_tpu`` was
imported by the time it ends.  The port's oracle (``sdft_tpu_torch.oracle``,
its own copies of the C and C++ sources) is held against the JAX package's
in a subprocess that loads both libraries.
"""

import pathlib
import subprocess
import sys

import numpy as np
import pytest

from sdft_tpu_torch.io.wav import write_wav

REPO = pathlib.Path(__file__).resolve().parent.parent

#: runs a script as __main__, then exits 3 if the JAX package or JAX came in
WRAPPER = """
import runpy, sys
script, sys.argv = sys.argv[1], sys.argv[1:]
code = 0
try:
    runpy.run_path(script, run_name="__main__")
except SystemExit as e:
    code = e.code or 0
bad = sorted(n for n in sys.modules if n.split(".")[0] in ("jax", "jaxlib", "sdft_tpu"))
print("modules of the JAX side:", bad)
sys.exit(code if code else (3 if bad else 0))
"""


def _crosscheck(tmp_path, flags):
    src = tmp_path / "src.wav"
    write_wav(str(src), np.random.default_rng(4).standard_normal(6000).clip(-3, 3) / 3, 44100)
    return subprocess.run(
        [sys.executable, "-c", WRAPPER, str(REPO / "scripts" / "crosscheck_torch.py"), "256",
         "64", "hann", "1", str(src), "--device", "cpu"] + flags,
        capture_output=True, text=True, timeout=300, cwd=str(tmp_path))


@pytest.mark.parametrize("flags", [[], ["--fd32"]])
def test_crosscheck_torch_on_the_cpu(tmp_path, flags):
    proc = _crosscheck(tmp_path, flags)
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-3000:]
    out = proc.stdout
    assert "crosscheck OK" in out
    assert f"port (cpu, {'float32' if flags else 'float64'}) dft max abs diff" in out


def test_crosscheck_torch_leaves_the_jax_package_out(tmp_path):
    proc = _crosscheck(tmp_path, [])
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-3000:]
    assert "modules of the JAX side: []" in proc.stdout
    text = (REPO / "scripts" / "crosscheck_torch.py").read_text()
    assert "from sdft_tpu_torch.oracle import" in text and "JAX_PLATFORMS" not in text


def test_wrapper_sees_an_import_of_the_jax_package(tmp_path):
    """The check itself: a script that imports sdft_tpu.windows fails it."""
    script = tmp_path / "imports_it.py"
    script.write_text(f"import sys; sys.path.insert(0, {str(REPO)!r}); import sdft_tpu.windows\n")
    proc = subprocess.run([sys.executable, "-c", WRAPPER, str(script)], capture_output=True,
                          text=True, timeout=300, cwd=str(tmp_path))
    assert proc.returncode == 3, proc.stdout + proc.stderr
    assert "sdft_tpu" in proc.stdout


ORACLES = """
import sys
import numpy as np
sys.path.insert(0, sys.argv[1])
from sdft_tpu_torch import oracle as port
from sdft_tpu import oracle as jax_side
assert port.build.NATIVE_DIR != jax_side.build.NATIVE_DIR
x = np.random.default_rng(21).standard_normal(700).clip(-3, 3) / 3
for name in ("NativeSDFT", "NativeSDFT2"):
    for kw in (dict(td_bits=64), dict(td_bits=32)) + ((dict(td_bits=64, fd_bits=80),)
                                                      if name == "NativeSDFT" else ()):
        a = getattr(port, name)(96, "blackman", 0.5, **kw)
        b = getattr(jax_side, name)(96, "blackman", 0.5, **kw)
        da, db = a.sdft(x), b.sdft(x)
        err = float(np.abs(da - db).max())
        yerr = float(np.abs(a.isdft(da) - b.isdft(db)).max())
        print(name, kw, "dft", err, "samples", yerr)
        assert da.shape == (700, 96) and err <= 1e-12 and yerr <= 1e-12, (name, kw, err, yerr)
print("oracles agree")
"""


def test_port_oracle_matches_the_jax_package_oracle():
    """Both engines (and engine #1's fd80 tier) of the port's own build
    against ``sdft_tpu.oracle`` on one small plan: 1e-12 abs on the spectra
    and on the samples.  In a subprocess: the libraries set FTZ/DAZ."""
    proc = subprocess.run([sys.executable, "-c", ORACLES, str(REPO)], capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-3000:]
    assert "oracles agree" in proc.stdout


def test_port_oracle_builds_from_its_own_sources_into_an_ignored_directory():
    from sdft_tpu_torch.oracle import build

    native = REPO / "sdft_tpu_torch" / "native"
    assert build.NATIVE_DIR == native
    for name in ("sdft_native.cpp", "sdft_native2.c", "Makefile"):
        assert (native / name).is_file()
    assert "sdft_tpu_torch/native/_build/" in (REPO / ".gitignore").read_text().split()
    assert '"sdft_tpu_torch.native"' in (REPO / "pyproject.toml").read_text()


def _port_scripts():
    return ([REPO / "chip_smoke.py"] + sorted((REPO / "examples").glob("*_torch.py"))
            + sorted((REPO / "scripts").glob("*_torch.py"))
            + sorted((REPO / "sdft_tpu_torch").rglob("*.py")))


def test_no_script_or_module_of_the_port_imports_the_jax_side():
    """Every import statement of chip_smoke.py, the port's examples and
    scripts and its package, by its syntax tree."""
    import ast

    files = _port_scripts()
    assert len(files) > 40
    for path in files:
        for node in ast.walk(ast.parse(path.read_text())):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            for name in names:
                assert name.split(".")[0] not in ("jax", "jaxlib", "sdft_tpu"), (path, name)


def test_verify_torch_sh_parses_and_names_what_exists():
    script = REPO / "scripts" / "verify_torch.sh"
    subprocess.run(["bash", "-n", str(script)], check=True, timeout=30)
    text = script.read_text()
    assert "scripts/crosscheck_torch.py" in text and "chip_smoke.py" in text
    for name in ("analysis", "latency", "precision", "stft_window_test", "streaming",
                 "transform"):
        assert (REPO / "examples" / f"{name}_torch.py").exists()
        assert name in text
