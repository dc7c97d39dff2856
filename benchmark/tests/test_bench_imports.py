"""Nothing the benchmark runs imports JAX or the JAX package, compared by
whole top-level module names (``sdft_tpu_torch`` is the port, not
``sdft_tpu``); the reference imports nothing of the port."""

import ast
import subprocess
import sys

from benchmark import spec

FORBIDDEN = {"jax", "jaxlib", "flax", "sdft_tpu"}


def _imported(path) -> set:
    tree = ast.parse(path.read_text())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
    return names


def test_no_source_of_the_benchmark_imports_jax():
    files = [p for p in (spec.ROOT / "benchmark").rglob("*.py") if "__pycache__" not in p.parts]
    assert len(files) > 10
    for p in files:
        assert not _imported(p) & FORBIDDEN, p


def test_the_reference_imports_nothing_of_the_program():
    for name in ("reference.py", "cost.py"):
        assert _imported(spec.ROOT / "benchmark" / name) <= {"torch", "math", "dataclasses",
                                                             "__future__"}


def _loaded_after(code: str) -> set:
    out = subprocess.run([sys.executable, "-c", code + "\nimport sys\nprint(' '.join(sorted("
                          "{m.split('.')[0] for m in sys.modules})))"],
                         cwd=spec.ROOT, capture_output=True, text=True, timeout=120, check=True)
    return set(out.stdout.split())


def test_a_run_loads_no_jax():
    mods = _loaded_after(
        "from benchmark import run, harness, control, faults\n"
        "from benchmark.tests import tiny\n"
        "tiny.run('m1000-c8.spectra', 0.2, True)\n"
        "tiny.run('m1000-c8-hop100.driver', 0.2)\n"
        "import benchmark.entries.spectra, benchmark.entries.streamer_run\n"
        "import benchmark.entries.streamer_run_hopped\n"
        "from benchmark import spec\n"
        "for m in spec.benchmark_json()['per_layer']:\n"
        "    spec.reader(m['name'])")
    assert "sdft_tpu_torch" in mods
    assert not mods & FORBIDDEN


def test_the_reference_loads_no_program():
    mods = _loaded_after("import benchmark.reference, benchmark.cost")
    assert "sdft_tpu_torch" not in mods and not mods & FORBIDDEN
