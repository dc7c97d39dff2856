"""Host time a block inside the graphs' spans, in ms: each replay with its
key, lookup and copy-in, each capture, and the clones of the static
outputs (``sdft.graphs.*``), nested spans counted once.  None where no
graph ran (the CPU, or a program without the spans)."""

from ..spans import ms_per_block


def read(run):
    return ms_per_block(run, "sdft.graphs.")
