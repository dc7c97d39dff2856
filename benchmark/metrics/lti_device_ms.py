"""The device time per block of every kernel in the traced window, in ms,
with no copy counted: in the collapsed round trip and the hop > 1 driver
body, ``ops.lti``'s GEMMs and the torch ops around them (and the refresh
the driver runs each block).  Blocks are those the entry took in the
window."""


def read(run):
    ks = run.trace.kernels()
    if not ks or not run.trace.blocks:
        return None
    return sum(d for _, d in ks) / run.trace.blocks / 1e3
