"""``roundtrip_hopped(plan, state, xs, hop, refresh_every=N)`` on chains of
blocks stacked on the card, the outputs left there: the reference
driver's protocol for a consumer that reads every hop's spectrum and the
synthesized samples on the card.  The configuration gives ``hop`` and
``refresh_every``, the traffic ``chain``.  The function is looked up on
``sdft_tpu_torch`` at each call, so a test may put another in its place.

The closed loop: the entry stacks ``chain`` blocks and takes them in one
call, the harness records an event after it, then waits for the previous
call's event.  Each block of a chain is taken at the call and is the
caller's when its chain's wait returns; the window ends on a whole chain.
"""

from __future__ import annotations

import time

import torch

from .. import checks
from .streamer import state_readers

WARM_CHAINS = 2


#: the outputs the runner's ``window`` returns, by ``checks.compare``'s names
OUTPUTS = ("hop_spectra", "samples")

class Chain:
    def __init__(self, ctx):
        import sdft_tpu_torch as T

        self.ctx = ctx
        cfg = ctx.cell.config
        self.hop, self.refresh_every = int(cfg["hop"]), cfg.get("refresh_every")
        self.multiple = int(ctx.cell.traffic["chain"])
        self.state = T.init_state(ctx.plan, channels=int(cfg["channels"]), device=ctx.device)
        self.next = 0

    def _stack(self, first: int) -> torch.Tensor:
        return torch.stack([self.ctx.block(first + k) for k in range(self.multiple)])

    def _call(self, xs: torch.Tensor) -> tuple:
        import sdft_tpu_torch as T

        self.state, hd, y = T.roundtrip_hopped(self.ctx.plan, self.state, xs, self.hop,
                                               refresh_every=self.refresh_every)
        return hd, y

    def warm(self) -> None:
        for _ in range(WARM_CHAINS):
            self._call(self._stack(self.next))
            self.next += self.multiple

    def window(self, win, rec) -> dict:
        ctx, pending, i = self.ctx, None, 0
        while win.go(i):
            xs = self._stack(self.next + i)
            with ctx.span("call"):
                t = time.perf_counter()
                ks = [rec.new(t) for _ in range(self.multiple)]
                out = self._call(xs)
                ev = ctx.event()
                ev.record()
                t = time.perf_counter()
                for k in ks:
                    rec.ret[k] = t
            if pending is not None:
                with ctx.span("wait"):
                    pending[0].synchronize()
                    t = time.perf_counter()
                    for k in pending[1]:
                        rec.done[k] = t
            pending = (ev, ks, out)
            i += self.multiple
        pending[0].synchronize()
        t = time.perf_counter()
        for k in pending[1]:
            rec.done[k] = t
        hd, y = pending[2]
        return {"index": self.next + i - 1, "hop_spectra": checks.packed(hd[-1]),
                "hop": self.hop, "samples": checks.rows(y[-1]),
                "state": state_readers(self.state)}

    def free(self) -> None:
        if self.ctx.device.type == "cuda":
            torch.cuda.empty_cache()


def make(ctx):
    return Chain(ctx)
