"""The control of each cell (``reference.Control``: the reference in the
program's place in TF32 products) fails the cell's limits; the float64
reference put in the program's place passes them.  At a tiny size on the
CPU; the readings at each cell's own size on the card are in PERF.md."""

import pytest
import torch

from benchmark import checks, control, harness
from benchmark.reference import tf32

from . import tiny


@pytest.mark.parametrize("workload", tiny.CELLS)
def test_control_fails_the_limits(workload):
    c = tiny.cell(workload)
    nums = control.readings(c, tiny.SEED, 400, torch.device("cpu"))
    ok, rows = checks.verdict(nums, c.limits)
    assert not ok, rows
    assert nums["delayline_err"] == 0.0 and nums["offset_err"] == 0.0


def test_tf32_rounding():
    x = torch.tensor([1.0, 1.0 + 2**-11, 1.0 + 2**-10 + 2**-11, -3.0 - 2**-12, 2**-130])
    y = tf32(x)
    assert y.tolist() == [1.0, 1.0, 1.0 + 2**-9, -3.0, y[4].item()]
    bits = y.view(torch.int32) & 0x1FFF
    assert (bits == 0).all()


def test_control_stream_matches_the_reference_in_float64_terms():
    """The control's carried state differs from the exact one only by its
    rounding: far below the spectra's scale, so what fails is precision."""
    c = tiny.cell("m1000-c8.spectra")
    nums = control.readings(c, tiny.SEED, 3, torch.device("cpu"))
    assert nums["spectra_err"] < 0.05 and nums["acc_err"] < 0.05
    assert harness.block_length(c) == 512


def test_mesh_control_rebuilds_each_shards_carry():
    """On the mesh the control rebuilds every time shard's carry from the
    samples before it, as the program does: its error does not grow with
    the blocks streamed, where a carried TF32 accumulator's would."""
    c = tiny.cell("m1000-c8-time4.spectra")
    early = control.readings(c, tiny.SEED, 3, torch.device("cpu"))
    late = control.readings(c, tiny.SEED, 400, torch.device("cpu"))
    assert late["acc_err"] < 3 * early["acc_err"]
    assert late["spectra_err"] < 3 * early["spectra_err"]


@pytest.mark.parametrize("workload", tiny.CELLS)
def test_control_serves_the_entrys_outputs(workload):
    from benchmark import spec

    c = tiny.cell(workload)
    outputs = spec.entry(c.traffic["entry"]).OUTPUTS
    ctl_numbers = control.readings(c, tiny.SEED, 2, torch.device("cpu"))
    want = {"spectra": "spectra_err", "samples": "samples_err", "hop_spectra": "hop_spectra_err"}
    assert {want[o] for o in outputs} | {"acc_err", "delayline_err", "offset_err"} == set(
        ctl_numbers) == set(c.limits)
