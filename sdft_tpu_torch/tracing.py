"""Host spans and counters of the port, on the profiler's clock.

``span(name)`` marks one step of the port in a ``torch.profiler`` trace,
beside the kernels and copies the step enqueues (the profiler records
host and device events on one clock).  Spans are on exactly while a
profiler records on this thread: inside ``profiling.trace``, ``python -m
sdft_tpu_torch trace`` and any ``torch.profiler.profile`` of a caller's.
There is no other switch.  Off, a span costs one check of the profiler's
state and enters nothing; on, it enters ``torch``'s cheapest record
function (``_RecordFunctionFast``, a ``cpu_op`` event of the exported
trace; ``record_function``, a ``user_annotation``, where a torch lacks it).

The spans, by layer (every name starts ``sdft.``; none is open across a
generator's ``yield``):

  * ``sdft.api.<entry>``: ``api.sdft``, ``sdft_power``, ``roundtrip``,
    ``roundtrip_hopped``, ``refresh``, the whole call; inside
    ``roundtrip``, ``sdft.api.roundtrip.transform``: the caller's transform;
  * ``sdft.graphs.replay.<graph>``: a graph's key and lookup, copy-in,
    replay and launch bookkeeping (a ``Streamer.run`` block: its carried
    graph's replay alone); ``sdft.graphs.capture.<graph>``: its
    warm-up and capture; ``sdft.graphs.clone``: the clones of a replay's
    static outputs (``graphs``);
  * ``sdft.ops.lti.chain_block``: one block of ``roundtrip_hopped_chain``
    (``api.roundtrip_hopped``): its graph's replay, then K2's wrapper
    (hop = 1) or the copy into the stacked outputs, and a refresh due
    after it;
  * ``sdft.ops.synthesis.isdft``: one block's synthesis from its spectra
    (``ops.synthesis.isdft_block``: the twiddles, the planes, the product
    and the weight);
  * ``sdft.kernels.spectra``, ``sdft.kernels.scan``: K1's and K2's launch
    wrappers (checks, output allocation, the launch);
  * ``sdft.stream.upload``, ``.download``, ``.wait``: the ``Streamer``'s
    host work to put a block on the card, to enqueue its copy back, and the
    time the host blocks until a block's outputs are numpy;
  * ``sdft.parallel.<program>``: a sharded program's call; inside it
    ``sdft.parallel.in`` and ``sdft.parallel.out``, the DTensor steps
    that take this rank's shards and assemble the outputs.

``counters()`` reads the port's counters: the graphs captured and evicted
(``graphs.CAPTURES``, ``graphs.EVICTIONS``), the K1, K2, ``split_mm``
and carry launches (each kernel module's ``LAUNCHES``; K1's paced ones,
``kernels.spectra.PACED_LAUNCHES``, apart), the chains
``Streamer.run_hopped`` copied home without blocking and of them those
still in flight once the next chain was queued (``stream.streamer``'s
``PINNED_COPIES``, ``OVERLAPPED_COPIES``), and the blocks
``roundtrip_hopped_chain`` ran through K2 and through the driver body
(``ops.lti``'s ``K2_BLOCKS``, ``BODY_BLOCKS``), the blocks synthesized
from their spectra (``ops.synthesis.BLOCKS``), and ``api.roundtrip``'s
calls by route, collapsed or with the spectra materialized for a transform
(``api``'s ``ROUNDTRIP_COLLAPSED``, ``ROUNDTRIP_MATERIALIZED``).
"""

from __future__ import annotations

import contextlib
import functools

import torch

_recording = torch._C._autograd._profiler_enabled
_Record = getattr(torch._C._profiler, "_RecordFunctionFast", None) or torch.profiler.record_function
_OFF = contextlib.nullcontext()


def span(name: str):
    """A context manager marking ``name`` in the profiler's trace while a
    profiler records, else a shared no-op."""
    if not _recording():
        return _OFF
    return _Record(name)


def spanned(name: str):
    """Decorator: each call of the function inside ``span(name)``."""
    def wrap(fn):
        @functools.wraps(fn)
        def call(*args, **kwargs):
            with span(name):
                return fn(*args, **kwargs)
        return call
    return wrap


def counters() -> dict:
    """The port's counters since the process started (or a caller reset
    them): graphs captured and evicted, kernel launches, the Streamer's
    pinned and overlapped copies home, the driver chain's blocks by route,
    the blocks synthesized, ``roundtrip``'s calls by route."""
    from . import api, graphs
    from .kernels import carry, scan, spectra, split_mm
    from .ops import lti, synthesis
    from .stream import streamer

    return {"graphs.captures": graphs.CAPTURES, "graphs.evictions": graphs.EVICTIONS,
            "kernels.spectra.launches": spectra.LAUNCHES,
            "kernels.spectra.paced_launches": spectra.PACED_LAUNCHES,
            "kernels.scan.launches": scan.LAUNCHES,
            "kernels.split_mm.launches": split_mm.LAUNCHES,
            "kernels.carry.launches": carry.LAUNCHES,
            "stream.pinned_copies": streamer.PINNED_COPIES,
            "stream.overlapped_copies": streamer.OVERLAPPED_COPIES,
            "ops.lti.k2_blocks": lti.K2_BLOCKS, "ops.lti.body_blocks": lti.BODY_BLOCKS,
            "ops.synthesis.blocks": synthesis.BLOCKS,
            "api.roundtrip.collapsed": api.ROUNDTRIP_COLLAPSED,
            "api.roundtrip.materialized": api.ROUNDTRIP_MATERIALIZED}
