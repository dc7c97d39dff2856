"""A stand-in capture backend for ``sdft_tpu_torch.graphs`` on the CPU.

``StubBackend`` "captures" by running the function once and "replays" by
running it again into the same static outputs, so the port's graph
plumbing (static inputs, a chain's state fed back, stacked outputs, the
collectives of a sharded rank's body) runs on CPU tensors.  Put it in
``graphs.BACKEND`` (``installed()``, or a test's monkeypatch); with the real
backend CPU tensors never reach the cache.  A replay runs no kernel
wrapper on the card, so it leaves the launch counters as they were.
"""

from __future__ import annotations

import contextlib

from sdft_tpu_torch import graphs
from sdft_tpu_torch.kernels import scan, spectra


class _StubGraph:
    def __init__(self, fn, args, out):
        self.fn, self.args, self.out = fn, args, out

    def replay(self):
        saved = spectra.LAUNCHES, spectra.PACED_LAUNCHES, scan.LAUNCHES
        new = self.fn(*self.args)
        # a replay runs no Python
        spectra.LAUNCHES, spectra.PACED_LAUNCHES, scan.LAUNCHES = saved
        for s, t in zip(graphs.leaves(self.out), graphs.leaves(new)):
            s.copy_(t)


class StubBackend:
    """Captures on the CPU: one eager call fixes the static outputs, each
    replay recomputes them in place.  ``captures`` counts the captures and
    ``modes`` records each one's capture error mode."""

    device_type = "cpu"

    def __init__(self):
        self.captures = 0
        self.modes = []

    def warmup(self, fn, args, device):
        for _ in range(graphs.WARMUP_CALLS):
            fn(*args)

    def capture(self, fn, args, device, mode="global"):
        self.captures += 1
        self.modes.append(mode)
        out = fn(*args)
        return _StubGraph(fn, args, out), out

    def reserved(self, device):
        return 0

    def clear(self):
        pass


@contextlib.contextmanager
def installed():
    """A fresh ``StubBackend`` in ``graphs.BACKEND`` over an empty cache for
    the block; the backend that was there before, and an empty cache,
    after it."""
    backend, saved = StubBackend(), graphs.BACKEND
    graphs.BACKEND = backend
    graphs.clear()
    try:
        yield backend
    finally:
        graphs.clear()
        graphs.BACKEND = saved
