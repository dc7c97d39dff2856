"""Host time a block inside the synthesis, in ms: ``ops.synthesis.isdft_block``
(``sdft.ops.synthesis.isdft``: the twiddles, the real plane, the product
and the weight enqueued).  None on a program without the span."""

from ..spans import ms_per_block


def read(run):
    return ms_per_block(run, "sdft.ops.synthesis.isdft")
