"""``Streamer(plan, channels=C).run(blocks)``: each block's samples round
trip (the collapsed LTI path when no transform is given) and come back to
the host as numpy.  The entry takes a block when the generator pulls it
from the feed, and its output is the caller's when it is yielded; the
generator queues block b before it waits for block b-1."""

from __future__ import annotations

import torch

from .. import checks
from .streamer import Feed, drain, state_readers

WARM_BLOCKS = 3


#: the outputs the runner's ``window`` returns, by ``checks.compare``'s names
OUTPUTS = ("samples",)

class Run:
    multiple = 1

    def __init__(self, ctx):
        from sdft_tpu_torch import Streamer

        self.ctx = ctx
        cfg = ctx.cell.config
        self.streamer = Streamer(ctx.plan, channels=int(cfg["channels"]),
                                 refresh_every=cfg.get("refresh_every"), device=ctx.device)
        self.next = 0

    def warm(self) -> None:
        for _ in self.streamer.run(self.ctx.host_block(b) for b in range(WARM_BLOCKS)):
            pass
        self.next = WARM_BLOCKS

    def window(self, win, rec) -> dict:
        feed = Feed(self.ctx, win, rec, self.next)
        y = drain(self.ctx, self.streamer.run(feed), rec)
        return {"index": self.next + feed.pulled - 1,
                "samples": checks.rows(torch.as_tensor(y, device=self.ctx.device)),
                "state": state_readers(self.streamer.state)}

    def free(self) -> None:
        self.streamer = None
        if self.ctx.device.type == "cuda":
            torch.cuda.empty_cache()


def make(ctx):
    return Run(ctx)
