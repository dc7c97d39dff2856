"""``Streamer(plan, channels=C, refresh_every=N).run_hopped(blocks, hop,
chain)``: the reference driver's protocol.  Groups of ``chain`` blocks run
as one ``api.roundtrip_hopped`` call; each block's first-of-hop spectra
and synthesized samples come back to the host as numpy.  The configuration
gives ``hop`` and ``refresh_every``, the traffic ``chain``.  A block is
taken when the generator pulls it, and is the caller's when its outputs
are yielded; the window ends on a whole chain."""

from __future__ import annotations

import torch

from .. import checks
from .streamer import Feed, drain, state_readers


#: the outputs the runner's ``window`` returns, by ``checks.compare``'s names
OUTPUTS = ("hop_spectra", "samples")

class RunHopped:
    def __init__(self, ctx):
        from sdft_tpu_torch import Streamer

        self.ctx = ctx
        cfg = ctx.cell.config
        self.hop, self.multiple = int(cfg["hop"]), int(ctx.cell.traffic["chain"])
        self.streamer = Streamer(ctx.plan, channels=int(cfg["channels"]),
                                 refresh_every=cfg.get("refresh_every"), device=ctx.device)
        self.next = 0

    def _run(self, blocks):
        return self.streamer.run_hopped(blocks, hop=self.hop, chain=self.multiple)

    def warm(self) -> None:
        for _ in self._run(self.ctx.host_block(b) for b in range(2 * self.multiple)):
            pass
        self.next = 2 * self.multiple

    def window(self, win, rec) -> dict:
        feed = Feed(self.ctx, win, rec, self.next)
        hd, y = drain(self.ctx, self._run(feed), rec)
        dev = self.ctx.device
        return {"index": self.next + feed.pulled - 1,
                "hop_spectra": checks.packed(torch.as_tensor(hd, device=dev)), "hop": self.hop,
                "samples": checks.rows(torch.as_tensor(y, device=dev)),
                "state": state_readers(self.streamer.state)}

    def free(self) -> None:
        self.streamer = None
        if self.ctx.device.type == "cuda":
            torch.cuda.empty_cache()


def make(ctx):
    return RunHopped(ctx)
