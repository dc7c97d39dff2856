"""The benchmark's cells cut to a size the CPU runs in a second: the same
entries, traffic and checks, with the port's plain versions."""

from __future__ import annotations

import copy

from benchmark import harness, spec

CELLS = ("m1000-c8.spectra", "m1000-c8.collapsed", "m1000-c8-hop100.driver",
         "m1000-c8-time4.spectra")
SEED = 3000000019


def cell(workload: str) -> spec.Cell:
    """``workload`` at m = 128, 2 channels, blocks of 512 samples per card
    (hop 16, chains of 4), a pool of 4 blocks, its own limits."""
    c = copy.deepcopy(spec.cell(workload))
    c.config.update(dftsize=128, channels=2)
    if "hop" in c.config:
        c.config["hop"] = 16
    c.traffic.update(samples_per_card=512, pool_blocks=4)
    if "chain" in c.traffic:
        c.traffic["chain"] = 4
    return c


def run(workload: str, seconds: float | None = None, trace: bool = False, fault=None,
        seed: int = SEED) -> dict:
    """One run on the CPU: 1 s windows, 3 s on a mesh (four Gloo ranks
    take about half a second a block)."""
    c = cell(workload)
    seconds = seconds or (3.0 if c.world > 1 else 1.0)
    return harness.run(workload, seed, seconds, trace, device_type="cpu", cell=c, fault=fault)
