"""Endless bounded-memory streaming driver (counterpart of
``sdft_tpu.stream.streamer``).

Generalizes the reference's hop-chunked streaming protocol (test/test.c:
69-83: process hopsize samples per call, state persists in the plan) into a
block pipeline.  ``Streamer.run`` is one loop on every device, as in the
JAX package: it queues block k (upload, round trip, copy back) and only
then waits for block k-1's copy back and yields it, so on a card block k
computes while the host hands out block k-1.  ``Streamer.run_hopped``
does the same a chain of blocks at a time: chain k's outputs are copied
home on a copy stream of the Streamer's own, into pinned memory, while
chain k+1 uploads and computes, and chain k's blocks are yielded once
chain k+1 is queued.  Every copy back lands in a fresh pinned tensor from
torch's caching host allocator, so a yielded array is never overwritten
under the caller.  Memory is O(block), independent of stream length.

On a card ``run``'s collapsed round trip (no transform, the default ops)
keeps the state in a graph of the Streamer's own, one per block shape
(``graphs.Carried``): a block's samples go straight into the graph's
input, one replay computes the block and leaves the new state in place,
and the samples come home from the graph's output.  Nothing else is copied
or allocated on the card a block.  Reading ``state`` copies it out.

Checkpoint/resume: the resumable state is (offset, delayline, accumulator)
plus the stream position; ``checkpoint``/``restore`` use the JAX package's
``.npz`` keys, so a checkpoint written by either package's Streamer
continues the stream in the other.  Taken between two yields of ``run``
or ``run_hopped``, a checkpoint holds the state after the block or chain
already queued, not after the one just yielded.

Under a profiler (``tracing``) the host's steps of a block lie in spans:
``sdft.stream.upload`` (the block to a tensor on the device; a
``run_hopped`` group stacked and put there), ``sdft.stream.download``
(the copy back enqueued and its event recorded) and ``sdft.stream.wait``
(the host blocked until a block's or a chain's outputs are numpy),
beside the entry's own ``sdft.api.*`` span.  No span is open across a
``yield``.  ``PINNED_COPIES`` counts the chains ``run_hopped`` copied home
without blocking, ``OVERLAPPED_COPIES`` those whose copy was still in
flight once the next chain was queued (``tracing.counters``).
"""

from __future__ import annotations

import collections
import pathlib
from typing import Callable, Iterable, Iterator

import numpy as np
import torch

from ..api import isdft as _isdft
from ..api import refresh as _refresh
from ..api import roundtrip as _roundtrip
from ..api import roundtrip_hopped as _roundtrip_hopped
from ..api import sdft as _sdft
from .. import graphs
from ..cplx import to_numpy
from ..ops.lti import roundtrip_lti_parts
from ..plan import Plan
from ..state import (State, init_state, require_device, state_from_arrays,
                     state_to_arrays)
from ..tracing import span

PINNED_COPIES = 0
OVERLAPPED_COPIES = 0


def _wait(y, done):
    """The host tensor ``y``, or each of a tuple of them, as numpy, once the
    copy that fills it (recorded by the CUDA event ``done``; None on the
    CPU) has landed."""
    with span("sdft.stream.wait"):
        if done is not None:
            done.synchronize()
        return tuple(map(to_numpy, y)) if isinstance(y, tuple) else to_numpy(y)


def _groups(blocks: Iterable, chain: int) -> Iterator[list]:
    """``blocks`` in lists of ``chain``, the last one shorter if need be."""
    group: list = []
    for block in blocks:
        group.append(block)
        if len(group) == chain:
            yield group
            group = []
    if group:
        yield group


def _hopped_blocks(host: tuple, done) -> Iterator[tuple[np.ndarray, np.ndarray]]:
    """A queued group's (hop_dfts, samples) per block, once its copy home
    has landed."""
    hd, ys = _wait(host, done)
    for b in range(hd.shape[0]):
        yield hd[b], ys[b]


class Streamer:
    """Stateful block-stream processor for one or many channels."""

    def __init__(self, plan: Plan, channels: int | None = None,
                 forward: Callable | None = None,
                 inverse: Callable | None = None,
                 refresh_every: int | None = None,
                 device: torch.device | str = "cuda:0"):
        """Args:
          plan: the plan.
          channels: None for a mono (M,) stream, else channel count C.
          forward/inverse: optional overrides for the block ops; default to
            ``api.sdft``/``api.isdft``.
          refresh_every: if set, exactly rebuild the accumulator from the
            delayline every N blocks (``api.refresh``), which resets the
            rounding drift of endless streams.  None disables.
          device: where the stream runs (default cuda:0).  A CUDA device
            with no card raises; nothing falls back to the CPU.
        """
        self.device = require_device(device)
        self.plan = plan
        self.channels = channels
        self.refresh_every = refresh_every
        self._blocks_since_refresh = 0
        # With default ops and no spectral transform, round trips take the
        # collapsed LTI path (ops.lti): spectra never exist.
        self._fused_roundtrip = forward is None and inverse is None
        self._forward = forward or (lambda st, x: _sdft(plan, st, x))
        self._inverse = inverse or (
            lambda d: _isdft(plan, torch.as_tensor(d, device=self.device)))
        # run's collapsed round trips on the card, by block shape and dtype
        self._carried: collections.OrderedDict = collections.OrderedDict()
        self._live = None       # the one of them that holds the state
        self.state = init_state(plan, channels, device=self.device)
        self.samples_processed = 0
        # run_hopped's copies home, beside the stream that computes
        self._copier = (torch.cuda.Stream(self.device) if self.device.type == "cuda"
                        else None)

    @property
    def state(self) -> State:
        """The carried state after the blocks queued so far.  ``run``'s
        collapsed round trips keep it in their graph on the card; reading
        it there copies it out into tensors no later block writes."""
        if self._live is not None:
            self._state = graphs.clone(self._live.state)
            self._live = None
        return self._state

    @state.setter
    def state(self, st: State) -> None:
        self._state, self._live = st, None

    def _carry(self, x: torch.Tensor):
        """The graph that runs ``run``'s collapsed round trip of blocks
        shaped as the host tensor ``x`` with the state in it (``graphs.
        Carried``), or None where the round trip runs otherwise: on the
        CPU, a transform, or forward/inverse ops of the caller's."""
        if not (self._fused_roundtrip and graphs.active(self._state.offset)):
            return None
        key = (tuple(x.shape), x.dtype)
        g = self._carried.get(key)
        if g is None:
            if len(self._carried) >= graphs.MAX_GRAPHS:
                if self._live is self._carried.popitem(last=False)[1]:
                    self.state      # copied out of the graph it leaves
            xs = torch.zeros(x.shape, dtype=x.dtype, device=self.device)
            g = self._carried[key] = graphs.Carried(
                *roundtrip_lti_parts(self.plan, xs), self.state, xs)
            self._live = g
        else:
            self._carried.move_to_end(key)
            if self._live is not g:
                g.load(self.state)
                self._live = g
        return g

    def _maybe_refresh(self) -> None:
        if self.refresh_every is None:
            return
        self._blocks_since_refresh += 1
        if self._blocks_since_refresh >= self.refresh_every:
            self.state = _refresh(self.plan, self.state)
            self._blocks_since_refresh = 0

    def process(self, block) -> torch.Tensor:
        """Analyze one block; returns its spectra (a tensor on the device)."""
        self.state, dfts = self._forward(self.state, block)
        self.samples_processed += np.shape(block)[-1]
        self._maybe_refresh()
        return dfts

    def synthesize(self, dfts) -> torch.Tensor:
        """Inverse-transform one block of spectra."""
        return self._inverse(dfts)

    def roundtrip(self, block, transform: Callable | None = None) -> torch.Tensor:
        """Analyze + synthesize one block.

        Without ``transform`` the spectra are never materialized (collapsed
        LTI path).  With ``transform`` (complex spectra -> same shape) it
        runs inside ``api.roundtrip``.
        """
        self.state, y = _roundtrip(self.plan, self.state, block, transform)
        self.samples_processed += np.shape(block)[-1]
        self._maybe_refresh()
        return y

    def _step(self, x: torch.Tensor, transform, fuse_transform: bool) -> torch.Tensor:
        if self._fused_roundtrip and (transform is None or fuse_transform):
            return self.roundtrip(x, transform)
        dfts = self.process(x)
        if transform is not None:
            dfts = transform(dfts)
        return self.synthesize(dfts)

    def run(self, blocks: Iterable, transform: Callable | None = None,
            fuse_transform: bool = False) -> Iterator[np.ndarray]:
        """Round-trip a stream of blocks.

        Args:
          blocks: iterable of (M,) / (C, M) sample blocks.
          transform: optional spectral-domain callback applied between
            analysis and synthesis.  By default it receives the *packed*
            (..., m, 2) spectra tensor of each block.  With
            ``fuse_transform`` it must instead map *complex* (..., M, m)
            spectra to the same shape, inside ``api.roundtrip``.
          fuse_transform: run the transform inside ``api.roundtrip``.
            Requires the default forward/inverse ops.

        Yields:
          synthesized sample blocks as numpy arrays, one per input block,
          each once the next block is queued (module docstring).
        """
        if fuse_transform and (transform is None or not self._fused_roundtrip):
            raise ValueError("fuse_transform needs a transform and the "
                             "default forward/inverse ops")
        pending = None      # the previous block's host copy and its copy's event
        for block in blocks:
            # neither copy syncs the stream: a pageable upload is staged at
            # once, and the copy back lands in a fresh pinned tensor
            with span("sdft.stream.upload"):
                host = torch.as_tensor(to_numpy(block))
                g = self._carry(host) if transform is None else None
                if g is None:
                    x = host.to(self.device, non_blocking=True)
                else:
                    g.x.copy_(host, non_blocking=True)
            if g is None:
                copy = self._download(self._step(x, transform, fuse_transform))
            else:
                # y is the graph's static output: home before any other replay
                copy = self._download(g())
                self.samples_processed += host.shape[-1]
                self._maybe_refresh()
            if pending is not None:
                yield _wait(*pending)           # sync the *previous* block only
            pending = copy
        if pending is not None:
            yield _wait(*pending)

    def _download(self, y: torch.Tensor) -> tuple:
        """Enqueue ``y``'s copy home: a new host tensor (``y`` may be a
        graph's static output) and the copy's event (None on the CPU)."""
        with span("sdft.stream.download"):
            y = y.to("cpu", non_blocking=True, copy=True)
            done = None
            if self.device.type == "cuda":
                done = torch.cuda.Event()
                done.record(torch.cuda.current_stream(self.device))
        return y, done

    def run_hopped(self, blocks: Iterable, hop: int, chain: int = 16
                   ) -> Iterator[tuple[np.ndarray, np.ndarray]]:
        """Chained driver-protocol streaming: groups ``chain`` equal-length
        blocks into one ``api.roundtrip_hopped`` call and fetches each
        group's outputs once.

        Args:
          blocks: iterable of equal-length (M,) / (C, M) sample blocks, M a
            multiple of ``hop`` (a shorter final group is fine).
          hop: spectra emission stride in samples.
          chain: blocks per group.

        Yields:
          (hop_dfts, samples) per input block: the packed (M//hop, m, 2)
          first-of-hop spectra and the (M,) synthesized samples, as numpy
          arrays.  A group's blocks are yielded once the next group is
          queued (the last group once the input ends), as ``run`` yields a
          block; on a card its outputs come home in pinned memory on the
          Streamer's copy stream meanwhile (module docstring).

        The accumulator refresh cadence (``refresh_every``) applies within
        each group, restarting at group boundaries.
        """
        global OVERLAPPED_COPIES
        pending = None      # the previous group's host copies and their copy's event
        for group in _groups(blocks, chain):
            queued = self._queue_hopped(group, hop)
            if pending is not None:
                if pending[1] is not None and not pending[1].query():
                    OVERLAPPED_COPIES += 1
                yield from _hopped_blocks(*pending)
            pending = queued
        if pending is not None:
            yield from _hopped_blocks(*pending)

    def _queue_hopped(self, group: list, hop: int) -> tuple:
        """Upload a group, run its chain and enqueue its copy home: the
        (hop_dfts, samples) host tensors and the copy's event (None on the
        CPU, where the outputs are host tensors already)."""
        global PINNED_COPIES
        with span("sdft.stream.upload"):
            xs = torch.as_tensor(np.stack([to_numpy(b) for b in group]), device=self.device)
        self.state, hd, ys = _roundtrip_hopped(
            self.plan, self.state, xs, hop, refresh_every=self.refresh_every)
        self.samples_processed += xs.shape[0] * xs.shape[-1]
        with span("sdft.stream.download"):
            if self._copier is None:
                return (hd, ys), None
            self._copier.wait_stream(torch.cuda.current_stream(self.device))
            with torch.cuda.stream(self._copier):
                host = hd.to("cpu", non_blocking=True), ys.to("cpu", non_blocking=True)
                done = torch.cuda.Event()
                done.record(self._copier)
            # the caching allocator keeps their memory from the next chain
            # until the copy is done
            hd.record_stream(self._copier)
            ys.record_stream(self._copier)
            PINNED_COPIES += 1
            return host, done

    # -- checkpoint / resume --------------------------------------------------

    def checkpoint(self, path: str | pathlib.Path) -> None:
        """Snapshot carry state + stream position to an .npz file."""
        np.savez(path, samples_processed=self.samples_processed,
                 **state_to_arrays(self.state))

    def restore(self, path: str | pathlib.Path) -> None:
        with np.load(path) as data:
            self.samples_processed = int(data["samples_processed"])
            self.state = state_from_arrays(
                {k: data[k] for k in ("offset", "delayline", "accumulator")},
                device=self.device)
        # the refresh cadence restarts at the checkpoint boundary
        self._blocks_since_refresh = 0

    def reset(self) -> None:
        self.state = init_state(self.plan, self.channels, device=self.device)
        self.samples_processed = 0
        self._blocks_since_refresh = 0


def iter_blocks(samples: np.ndarray, block: int, pad: bool = False
                ) -> Iterator[np.ndarray]:
    """Split (..., n) samples into (..., block) chunks (the last one padded
    with zeros when ``pad``, else truncated, like the drivers' whole-hop
    truncation, test/test.c:61)."""
    n = samples.shape[-1]
    stop = n if pad else (n // block) * block
    for i in range(0, stop, block):
        chunk = samples[..., i:i + block]
        if chunk.shape[-1] < block:
            width = [(0, 0)] * (chunk.ndim - 1) + [(0, block - chunk.shape[-1])]
            chunk = np.pad(chunk, width)
        yield chunk
