"""Device-to-host copy time per block, in ms: the ``Streamer``'s copies of
each block's outputs back to the host, summed in the traced window over
the blocks the entry took in it."""


def read(run):
    if not run.trace.blocks:
        return None
    cp = run.trace.copies(lambda n: "DtoH" in n)
    if not cp:
        return None
    return sum(d for _, d in cp) / run.trace.blocks / 1e3
