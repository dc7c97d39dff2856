"""Host time a block inside the driver chain's loop, in ms: each block of
``ops.lti.roundtrip_hopped_chain`` (``sdft.ops.lti.chain_block``): its
graph's replay, then K2's wrapper at hop = 1 or the copy into the stacked
outputs at other hops, and a refresh due after it.  None on a program
without the span."""

from ..spans import ms_per_block


def read(run):
    return ms_per_block(run, "sdft.ops.lti.chain_block")
