"""Host time a block inside the program's own spans (``sdft_tpu_torch``'s
``sdft.*`` record functions, which its ``tracing`` module opens only while
a profiler records): the union of the intervals of the traced window's
host events whose names start with one of the prefixes, clipped to the
window, over the blocks the entry took in it.  A program without such
spans (one older than them, or a run on which no step reached them) reads
None."""

from __future__ import annotations

from .tracing import _union


def ms_per_block(run, *prefixes: str) -> float | None:
    tr = run.trace
    spans = [(max(ts, tr.t0), min(ts + dur, tr.t1)) for ts, dur, name in tr._host
             if name.startswith(prefixes)]
    spans = [(a, b) for a, b in spans if b > a]
    if not spans or not tr.blocks:
        return None
    return sum(b - a for a, b in _union(spans)) / tr.blocks / 1e3
