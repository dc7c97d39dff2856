"""The harness with the timed path broken underneath (``benchmark.faults``)
sees ``correct`` come out false: a step that returns its state unchanged,
half the channels left out, an output altered where it is produced, and
on the mesh cell the exchange between cards left out."""

import pytest

from . import tiny


@pytest.mark.parametrize("fault", ["state_unchanged", "half_batch", "altered"])
@pytest.mark.parametrize("workload", tiny.CELLS[:3])
def test_fault_is_caught(workload, fault):
    res = tiny.run(workload, fault=fault)
    assert not res["correct"], res["checks"]


@pytest.mark.parametrize("fault", ["no_exchange", "state_unchanged", "altered"])
def test_fault_is_caught_on_the_mesh(fault):
    res = tiny.run("m1000-c8-time4.spectra", fault=fault)
    assert not res["correct"], res["checks"]
