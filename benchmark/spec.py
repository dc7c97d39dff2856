"""Finding a cell's files by name.

``BENCHMARK.json`` names each cell's configuration and traffic; the
harness reads them from files of their own, so a later cell or metric is
added by adding files and entries, never by editing one:

  * ``configs/<config>.json``  the deployment (plan, channels, mesh);
  * ``traffic/<traffic>.json`` the stream of blocks and the entry it is
    fed through (``entries/<entry>.py``);
  * ``limits/<workload>.json`` the limits of the numbers ``checks``
    compares in that cell;
  * ``metrics/<name>.py``      the reader of one per-layer metric (a
    quantity split by cells, ``<name>.<cells>``, may share its reader).
"""

from __future__ import annotations

import dataclasses
import importlib
import json
import pathlib
import re

HERE = pathlib.Path(__file__).resolve().parent
ROOT = HERE.parent
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")


@dataclasses.dataclass
class Cell:
    """One entry of ``workloads`` with everything it names."""

    name: str
    chips: int
    config: dict
    traffic: dict
    end_to_end: list      # BENCHMARK.json metric entries this cell reports
    per_layer: list
    limits: dict

    @property
    def mesh(self) -> tuple:
        return tuple(self.config.get("mesh", (1, 1, 1)))

    @property
    def world(self) -> int:
        c, t, b = self.mesh
        return c * t * b


def load_json(path: pathlib.Path) -> dict:
    return json.loads(path.read_text())


def benchmark_json(root: pathlib.Path = ROOT) -> dict:
    return load_json(root / "BENCHMARK.json")


def _reports(metric: dict, workload: str) -> bool:
    return "workloads" not in metric or workload in metric["workloads"]


def cell(workload: str, root: pathlib.Path = ROOT) -> Cell:
    """The cell ``workload`` of ``root/BENCHMARK.json``, its files read."""
    bench = benchmark_json(root)
    entries = {w["name"]: w for w in bench["workloads"]}
    if workload not in entries:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json; "
                       f"have {sorted(entries)}")
    w = entries[workload]
    cfg = next(c for c in bench["configs"] if c["name"] == w["config"])
    config = load_json(root / cfg["file"])
    traffic = load_json(HERE / "traffic" / f"{w['traffic']}.json")
    limits = load_json(HERE / "limits" / f"{workload}.json")["limits"]
    return Cell(workload, int(w["chips"]), config, traffic,
                [m for m in bench["end_to_end"] if _reports(m, workload)],
                [m for m in bench["per_layer"] if _reports(m, workload)], limits)


def entry(name: str):
    """The module that feeds a traffic's blocks to the program."""
    if not NAME.match(name):
        raise ValueError(f"bad entry name {name!r}")
    return importlib.import_module(f"benchmark.entries.{name}")


def reader(name: str):
    """The ``read(run)`` function of per-layer metric ``name``: from
    ``metrics/<name>.py`` (dots as underscores), or, for a quantity split
    by the end-to-end metric it moves (``<quantity>.<cells>``) with no file
    of its own, from ``metrics/<quantity>.py``."""
    if not NAME.match(name):
        raise ValueError(f"bad metric name {name!r}")
    for mod in dict.fromkeys((name.replace(".", "_"), name.split(".")[0])):
        if (HERE / "metrics" / f"{mod}.py").is_file():
            return importlib.import_module(f"benchmark.metrics.{mod}").read
    raise ModuleNotFoundError(f"no reader of {name!r} under benchmark/metrics")
