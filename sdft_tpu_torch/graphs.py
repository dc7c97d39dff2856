"""Captured CUDA graphs for the chained paths: the port's counterpart of
``jax.jit`` and its cache.

The JAX package runs each hot entry point as one compiled program
(``_roundtrip_jit``, ``_fused_driver_jit``, ``_hopped_jit``, the
``lax.scan`` driver chains, ``_refresh_1d/2d``).  Here the same paths are
tens of small torch ops and kernel launches per block, which the host
issues more slowly than the card runs them.  ``run`` captures such a
function once per key into a ``torch.cuda.CUDAGraph`` and replays it:

    out = graphs.run(name, static, fn, *args)

  * the key is (``name``, ``static``, each input's shape, dtype and
    device); ``static`` holds what else the captured work depends on (the
    plan, which carries the precision, and the hop, tile and refresh
    arguments).  An unhashable ``static`` or an input off the backend's
    device raises;
  * the first call for a key copies the inputs into static buffers, runs
    ``fn`` twice on a side stream (which builds every cached table and
    loads the kernel library: a host-to-device copy is illegal inside a
    capture), then captures one call on them;
  * every call copies the caller's inputs into the static buffers on the
    current stream, replays there, and returns fresh clones of the static
    outputs: what a caller holds is never overwritten by a later call, and
    its inputs are never written.  A caller that reads the returned
    tensors on another stream orders that stream after the current one
    itself;
  * a failed warm-up, capture or replay raises with the path's name and
    key.  Nothing retries eagerly: CPU tensors never get here (callers
    test ``active`` and run their eager code on the CPU).

``Carried`` is a graph of one stream's round trip that keeps the state
in its static inputs from block to block (``Streamer.run``).

``get`` returns the graph itself, whose call returns the static outputs,
and ``replay`` replays it once and returns them.  A caller of either reads
the static outputs on the current stream before the next replay of any
graph is enqueued, in one of two ways:

  * it copies them out (the driver chains at hop > 1, single-device and
    sharded, copy each block's outputs into their stacks; a state fed to
    the next replay is copied into the static inputs);
  * a hand-written kernel reads them straight after the replay: K1 after
    the prologue graph of ``sdft``/``sdft_power`` (``kernels.spectra.
    prologue``), K2 after the hop=1 chain's prologue graph, K1 or K2 after
    the sharded kernel programs' graph, each writing into memory the
    caller owns.  The kernel is enqueued on the replay's
    stream before anything else is, so a later replay (of this graph, or
    of another one that captured its scratch into the same memory) runs
    after the kernel has read.

At most ``MAX_GRAPHS`` graphs are kept, least recently used evicted
first.  They all capture into one memory pool per device, which is safe
by the rule above, and because graphs never replay concurrently on two
streams.  An eviction follows the capture of a new graph, which
synchronizes the device first (``CudaBackend.reserved``), so the kernels
enqueued after an evicted graph's last replay have read its outputs by
then; a caller's own references to static outputs keep their memory in
any case.  Device tables that a captured function reads from a cache
(``cached``) are held by the graph, so a cache eviction never frees memory
a graph reads.
``clear`` drops every graph (``jax.clear_caches``); inside ``disabled()``
every path runs eagerly on the card (``jax.disable_jit``), the yardstick
the graphs are held against.

A replay launches the kernels it captured without running their Python
wrappers, so each graph adds its captured K1, K2, ``split_mm`` and carry
launches to the counters each kernel module lists in ``COUNTERS``
(``kernels.spectra.LAUNCHES`` and, of them, ``PACED_LAUNCHES``,
``kernels.scan.LAUNCHES``, ``kernels.split_mm.LAUNCHES`` and
``kernels.carry.LAUNCHES``) per replay.
``CAPTURES`` counts the graphs captured and ``EVICTIONS`` those the bound evicted: a stream whose
shapes vary captures and evicts on every call (``tracing.counters``).
Under a profiler (``tracing``) each replay, with its key, lookup and
copy-in, lies in a span ``sdft.graphs.replay.<name>``, each warm-up and
capture in ``sdft.graphs.capture.<name>`` (inside the first replay's span
when ``replay`` or ``run`` captured it), and ``clone`` in
``sdft.graphs.clone``.
"""

from __future__ import annotations

import collections
import contextlib
import functools
import time
from typing import NamedTuple

import torch

from .tracing import span

#: graphs kept at once (as the port's ``lru_cache(maxsize=16)`` tables)
MAX_GRAPHS = 16
#: eager runs of a function before its capture
WARMUP_CALLS = 2


class CudaBackend:
    """Warm-up and capture on the card (``torch.cuda.CUDAGraph``)."""

    device_type = "cuda"

    def __init__(self):
        self._pools = {}

    def warmup(self, fn, args, device: torch.device) -> None:
        with torch.cuda.device(device):
            side = torch.cuda.Stream()
            side.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(side):
                for _ in range(WARMUP_CALLS):
                    fn(*args)
            torch.cuda.current_stream().wait_stream(side)

    def capture(self, fn, args, device: torch.device, mode: str = "global"):
        """(graph, outputs): ``fn`` captured on a side stream into the
        device's pool, in the capture error mode ``mode``."""
        with torch.cuda.device(device):
            if device not in self._pools:
                self._pools[device] = torch.cuda.graph_pool_handle()
            pool = self._pools[device]
            graph = torch.cuda.CUDAGraph()
            try:
                with torch.cuda.graph(graph, pool=pool, capture_error_mode=mode):
                    out = fn(*args)
            except Exception:
                # a failed capture leaves the allocator recording into the
                # pool, which refuses every later capture into it: end the
                # recording and capture into a fresh pool from now on
                del self._pools[device]
                with contextlib.suppress(RuntimeError):   # "not currently recording"
                    for _ in range(8):
                        torch._C._cuda_endAllocateToPool(device.index, pool)
                raise
        return graph, out

    def reserved(self, device: torch.device) -> int:
        """The device's reserved bytes once its unused cache is released
        (as a capture's start releases it)."""
        torch.cuda.synchronize(device)
        torch.cuda.empty_cache()
        return torch.cuda.memory_reserved(device)

    def clear(self) -> None:
        self._pools.clear()


#: the capture backend; tests put a stand-in here that runs on the CPU
BACKEND = CudaBackend()

_GRAPHS: collections.OrderedDict = collections.OrderedDict()
_DISABLED = 0
#: graphs captured, and graphs evicted by ``MAX_GRAPHS``, since the start
CAPTURES = 0
EVICTIONS = 0
#: device tables read from a cache by the capture in progress (None outside)
_HELD: list | None = None


def cached(maxsize: int):
    """``functools.lru_cache`` for device tables, whose results a capture in
    progress holds for the life of its graph."""
    def wrap(fn):
        inner = functools.lru_cache(maxsize=maxsize)(fn)

        @functools.wraps(fn)
        def call(*args, **kwargs):
            out = inner(*args, **kwargs)
            if _HELD is not None:
                _HELD.append(out)
            return out

        call.cache_clear, call.cache_info = inner.cache_clear, inner.cache_info
        return call
    return wrap


def leaves(tree) -> list:
    """The tensors of a nest of tuples, lists and NamedTuples, in order."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, (tuple, list)):
        return [t for sub in tree for t in leaves(sub)]
    return []


def _rebuild(tree, tensors):
    """``tree`` with its tensors replaced by the next of ``tensors``."""
    if isinstance(tree, torch.Tensor):
        return next(tensors)
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_rebuild(t, tensors) for t in tree))
    if isinstance(tree, (tuple, list)):
        return type(tree)(_rebuild(t, tensors) for t in tree)
    return tree


def _launch_counters():
    """The kernels' launch counters as (name, module, attribute), from each
    kernel module's ``COUNTERS``."""
    from .kernels import carry, scan, spectra, split_mm

    return tuple((name, mod, attr) for mod in (spectra, scan, split_mm, carry)
                 for name, attr in mod.COUNTERS.items())


class Graph:
    """One captured function with its static inputs and outputs."""

    def __init__(self, name: str, key: tuple, fn, args, mode: str = "global"):
        self.name, self.key = name, key
        self._span = "sdft.graphs.replay." + name
        with span("sdft.graphs.capture." + name):
            self._capture(fn, args, mode)

    def _capture(self, fn, args, mode: str) -> None:
        global _HELD, CAPTURES
        name, key = self.name, self.key
        inputs = leaves(args)
        device = inputs[0].device
        self._fn = fn                 # its closure holds the tables it read
        self._inputs = [t.clone(memory_format=torch.contiguous_format) for t in inputs]
        static = _rebuild(args, iter(self._inputs))
        t0 = time.perf_counter()
        try:
            BACKEND.warmup(fn, static, device)
            counters = _launch_counters()
            before = [getattr(mod, attr) for _, mod, attr in counters]
            reserved = BACKEND.reserved(device)
            _HELD = []
            try:
                self._graph, self.outputs = BACKEND.capture(fn, static, device, mode)
            finally:
                self._held, _HELD = _HELD, None
                captured = [getattr(mod, attr) - n
                            for (_, mod, attr), n in zip(counters, before)]
                for (_, mod, attr), n in zip(counters, before):
                    setattr(mod, attr, n)     # the capture launched nothing
        except Exception as e:
            raise RuntimeError(f"graph capture of {name} failed (key {key}): {e}") from e
        self.pool_bytes = BACKEND.reserved(device) - reserved
        self.capture_s = time.perf_counter() - t0
        self._launches = [(c, n) for c, n in zip(counters, captured) if n]
        CAPTURES += 1

    def __call__(self, *args):
        """Copy ``args`` into the static inputs, replay, and return the
        static outputs (overwritten by the next replay of any graph)."""
        with span(self._span):
            return self._replay(args)

    def _replay(self, args):
        for s, t in zip(self._inputs, leaves(args)):
            if t is not s:
                s.copy_(t)
        try:
            self._graph.replay()
        except Exception as e:
            raise RuntimeError(f"graph replay of {self.name} failed (key {self.key}): "
                               f"{e}") from e
        for (_, mod, attr), n in self._launches:
            setattr(mod, attr, getattr(mod, attr) + n)
        return self.outputs


def active(x: torch.Tensor) -> bool:
    """Whether a call on ``x`` runs as a graph: ``x`` on the backend's
    device type, outside ``disabled()``."""
    return _DISABLED == 0 and x.device.type == BACKEND.device_type


@contextlib.contextmanager
def disabled():
    """Run every path eagerly inside the block (nests)."""
    global _DISABLED
    _DISABLED += 1
    try:
        yield
    finally:
        _DISABLED -= 1


def _key(name: str, static: tuple, inputs: list) -> tuple:
    for t in inputs:
        if t.device.type != BACKEND.device_type or t.device != inputs[0].device:
            raise ValueError(f"graph {name}: inputs must all lie on one "
                             f"{BACKEND.device_type} device, got {t.device}")
    key = (name, static, tuple((tuple(t.shape), t.dtype, t.device) for t in inputs))
    try:
        hash(key)
    except TypeError as e:
        raise TypeError(f"graph {name}: static arguments {static!r} are not hashable") from e
    return key


def get(name: str, static: tuple, fn, *args, mode: str = "global") -> Graph:
    """The graph of ``fn`` for this key, captured on its first request in
    the capture error mode ``mode`` (``torch.cuda.graph``'s
    ``capture_error_mode``: "thread_local" lets other threads, such as
    NCCL's watchdog, make calls a global capture forbids)."""
    global EVICTIONS
    key = _key(name, static, leaves(args))
    graph = _GRAPHS.get(key)
    if graph is None:
        graph = _GRAPHS[key] = Graph(name, key, fn, args, mode)
        while len(_GRAPHS) > MAX_GRAPHS:
            _GRAPHS.popitem(last=False)
            EVICTIONS += 1
    else:
        _GRAPHS.move_to_end(key)
    return graph


def clone(tree):
    """``tree`` with every tensor cloned."""
    with span("sdft.graphs.clone"):
        return _rebuild(tree, (t.clone() for t in leaves(tree)))


def replay(name: str, static: tuple, fn, *args, mode: str = "global"):
    """The static outputs of ``fn``'s graph replayed on ``args``
    (overwritten by the next replay, see above)."""
    with span("sdft.graphs.replay." + name):
        return get(name, static, fn, *args, mode=mode)._replay(args)


def run(name: str, static: tuple, fn, *args, mode: str = "global"):
    """``fn(*args)`` by replaying its graph; fresh outputs."""
    return clone(replay(name, static, fn, *args, mode=mode))


class Carried:
    """``fn(state, x) -> (state, y)`` as one graph for a caller that feeds
    one stream's blocks in order (``Streamer.run``).  The graph writes the
    new state back into its own static state inputs, so a replay copies
    nothing in but the block's samples, which the caller writes into ``x``
    itself, and clones nothing: a call returns the static ``y``, which the
    caller copies out before it enqueues the next replay of any graph.
    ``state`` is the carried state between replays; ``load`` puts a
    caller's there.  The graph lies outside the cache (``get``), so only
    its owner replays it; its span is the cached graph's,
    ``sdft.graphs.replay.<name>``."""

    def __init__(self, name: str, static: tuple, fn, state, x: torch.Tensor):
        def carried(st, xs):
            new, y = fn(st, xs)
            for s, t in zip(leaves(st), leaves(new)):
                s.copy_(t)
            return y

        args = (state, x)
        self.graph = Graph(name, _key(name, static, leaves(args)), carried, args)
        *held, self.x = self.graph._inputs
        self.state = _rebuild(state, iter(held))
        self.load(state)        # the warm-up calls moved the static state on

    def load(self, state) -> None:
        """Make ``state`` the carried one (copied in on the current stream)."""
        for s, t in zip(leaves(self.state), leaves(state)):
            s.copy_(t)

    def __call__(self) -> torch.Tensor:
        """One block from ``x`` and the carried state: its static ``y``."""
        return self.graph(self.state, self.x)


class Entry(NamedTuple):
    """What ``entries`` reports of one cached graph."""

    name: str
    key: tuple
    capture_s: float      # warm-up and capture, host clock
    pool_bytes: int       # the device's reserved bytes the capture added
    launches: dict        # kernel launches per replay, by counter


def entries() -> list:
    """The cached graphs, least recently used first."""
    return [Entry(g.name, g.key, g.capture_s, g.pool_bytes,
                  {name: n for (name, _, _), n in g._launches})
            for g in _GRAPHS.values()]


def clear() -> None:
    """Drop every cached graph (their pool memory goes back to the card's
    cache once no graph holds it)."""
    _GRAPHS.clear()
    BACKEND.clear()
