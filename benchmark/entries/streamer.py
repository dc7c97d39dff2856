"""Shared parts of the ``Streamer`` entries: a feed that hands the pool's
blocks (host numpy arrays) to the Streamer's generator, stamping the host
clock when the generator pulls each one, and stops when the window ends."""

from __future__ import annotations

import time

import torch


class Feed:
    """Iterator of host blocks ``start``, ``start + 1``, ... while the
    window goes on; ``pulled`` counts what it handed out."""

    def __init__(self, ctx, win, rec, start: int):
        self.ctx, self.win, self.rec, self.start = ctx, win, rec, start
        self.pulled = 0

    def __iter__(self):
        while self.win.go(self.pulled):
            self.rec.new(time.perf_counter())
            block = self.ctx.host_block(self.start + self.pulled)
            self.pulled += 1
            yield block


def state_readers(st) -> tuple:
    return st.offset, st.delayline, torch.view_as_complex(st.accumulator.float().contiguous())


def drain(ctx, gen, rec) -> object:
    """Consume the Streamer's generator: stamp each output as delivered
    when it is yielded; return the last one."""
    last, k = None, 0
    while True:
        with ctx.span("streamer"):
            try:
                last = next(gen)
            except StopIteration:
                return last
        rec.done[k] = time.perf_counter()
        k += 1
