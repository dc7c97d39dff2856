"""Host time a block that the ``Streamer`` waits for a block's outputs to
be numpy on the host, in ms (``sdft.stream.wait``)."""

from ..spans import ms_per_block


def read(run):
    return ms_per_block(run, "sdft.stream.wait")
