"""``roundtrip(plan, state, x, transform=f)`` on every block, the samples
left on the card: bench.cpp's sdft-then-isdft with the spectra of every
sample materialized and handed to a transform between the two.  The
traffic's ``transform`` names ``f`` in ``TRANSFORMS``: plain functions of
the complex (C, M, m) spectra, which the program calls as it would any
caller's.  ``roundtrip`` is looked up on ``sdft_tpu_torch`` at each call,
so a test may put another in its place.

The closed loop is ``entries/spectra.py``'s: the entry takes block b (the
call), the harness records an event after it, then waits for block b-1's
event; a block's output is the caller's when that wait returns.
"""

from __future__ import annotations

from .. import checks
from .spectra import Spectra
from .streamer import state_readers


def identity(z):
    """The spectra as they are: bench.cpp's isdft of its sdft's output."""
    return z


#: the transforms a traffic may name
TRANSFORMS = {"identity": identity}

#: the outputs the runner's ``window`` returns, by ``checks.compare``'s names
OUTPUTS = ("samples",)


class Roundtrip(Spectra):
    def __init__(self, ctx):
        import sdft_tpu_torch as T

        self.ctx = ctx
        plan, f = ctx.plan, TRANSFORMS[ctx.cell.traffic["transform"]]
        self.state = T.init_state(plan, channels=int(ctx.cell.config["channels"]),
                                  device=ctx.device)
        self.call = lambda st, x: T.roundtrip(plan, st, x, transform=f)
        self.next = 0

    def _final(self, index: int, y) -> dict:
        return {"index": index, "samples": checks.rows(y),
                "state": state_readers(self.state)}


def make(ctx):
    return Roundtrip(ctx)
