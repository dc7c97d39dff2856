"""Host time a block in the ``Streamer``'s copies, in ms: putting the block
on the card (``sdft.stream.upload``) and issuing the copy back
(``sdft.stream.download``)."""

from ..spans import ms_per_block


def read(run):
    return ms_per_block(run, "sdft.stream.upload", "sdft.stream.download")
