"""``sdft`` on every block, the spectra left on the card: ``api.sdft`` on
one card, ``parallel.sharded_sdft_pallas`` over a mesh (each rank holds its
time shard of every block's spectra).  The traffic's ``layout`` names the
spectra's form ("planar" or "packed").

The closed loop: the entry takes block b (the call), the harness records
an event after it, then waits for block b-1's event; a block's output is
the caller's when that wait returns.
"""

from __future__ import annotations

import time

import torch

from .. import checks

WARM_BLOCKS = 3


def _local(t):
    """A rank's shard of a DTensor output (a plain tensor as it is)."""
    return t.to_local() if hasattr(t, "to_local") else t


#: the outputs the runner's ``window`` returns, by ``checks.compare``'s names
OUTPUTS = ("spectra",)

class Spectra:
    multiple = 1

    def __init__(self, ctx):
        import sdft_tpu_torch as T

        self.ctx = ctx
        plan, layout = ctx.plan, ctx.cell.traffic["layout"]
        self.layout = layout
        self.state = T.init_state(plan, channels=int(ctx.cell.config["channels"]),
                                  device=ctx.device)
        if ctx.mesh is None:
            self.call = lambda st, x: T.sdft(plan, st, x, layout=layout)
        else:
            from sdft_tpu_torch import parallel

            mesh = ctx.mesh
            self.call = lambda st, x: parallel.sharded_sdft_pallas(plan, mesh, st, x,
                                                                   layout=layout)
        self.next = 0

    def warm(self) -> None:
        for _ in range(WARM_BLOCKS):
            self.state, _ = self.call(self.state, self.ctx.block(self.next))
            self.next += 1

    def window(self, win, rec) -> dict:
        ctx, pending, i = self.ctx, None, 0
        while win.go(i):
            x = ctx.block(self.next + i)
            with ctx.span("call"):
                k = rec.new(time.perf_counter())
                self.state, out = self.call(self.state, x)
                ev = ctx.event()
                ev.record()
                rec.ret[k] = time.perf_counter()
            if pending is not None:
                with ctx.span("wait"):
                    pending[0].synchronize()
                    rec.done[k - 1] = time.perf_counter()
            pending = (ev, out)
            i += 1
        pending[0].synchronize()
        rec.done[i - 1] = time.perf_counter()
        return self._final(self.next + i - 1, pending[1])

    def _final(self, index: int, out) -> dict:
        st = self.state
        if self.ctx.mesh is not None:
            out = tuple(map(_local, out)) if self.layout == "planar" else _local(out)
            st = type(st)(*map(_local, st))
        spectra = checks.planar(*out) if self.layout == "planar" else checks.packed(out)
        acc = torch.view_as_complex(st.accumulator.float().contiguous())
        return {"index": index, "spectra": spectra,
                "state": (st.offset, st.delayline, acc)}

    def free(self) -> None:
        self.call = None
        if self.ctx.device.type == "cuda":
            torch.cuda.empty_cache()


def make(ctx):
    return Spectra(ctx)
