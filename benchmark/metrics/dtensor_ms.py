"""Host time a block in a sharded program's DTensor steps, in ms, on rank
0: taking this rank's shards of the inputs (``sdft.parallel.in``) and
assembling the outputs (``sdft.parallel.out``)."""

from ..spans import ms_per_block


def read(run):
    return ms_per_block(run, "sdft.parallel.in", "sdft.parallel.out")
