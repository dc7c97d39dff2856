"""The traced run's device record: ``torch.profiler`` over part of the window.

The profiler starts as the window opens, in a warm-up step of about
``WARM_S`` seconds (events right after the tracer starts have been misread
on an H100, ``sdft_tpu_torch.profiling.device_time``), then records one
active step of about ``ACTIVE_S`` seconds, both ending at blocks the
window's clock sets (``harness.Window``); the rest of the window runs
untraced.  The
active step's host span (``ProfilerStep#1``) is the traced window.  Its
Chrome trace is read back into plain lists, and the file deleted.

``Trace`` gives the per-layer readers what they need: the kernels, copies
and sets that ran on the card inside the traced window, the host's spans
and ops, and the union of device activity.
"""

from __future__ import annotations

import bisect
import collections
import contextlib
import json
import os
import tempfile
import time

import torch

#: seconds of the profiler's warm-up step, and of its active (recorded) step
WARM_S, ACTIVE_S = 0.25, 2.0
#: host span names the harness records around its calls (``span``)
SPAN_PREFIX = "bench."
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver", "python_function")


class Tracer:
    """Runs the profiler's two steps as the window's clock passes them."""

    def __init__(self, device_type: str):
        from torch.profiler import ProfilerActivity, profile, schedule

        acts = [ProfilerActivity.CPU]
        if device_type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        self._dir = tempfile.mkdtemp(prefix="bench_trace_")
        self.path = os.path.join(self._dir, "trace.json")
        self.prof = profile(activities=acts, schedule=schedule(wait=0, warmup=1, active=1,
                                                               repeat=1),
                            on_trace_ready=lambda p: p.export_chrome_trace(self.path))
        self.phase = 0          # 0 not started, 1 warm-up, 2 active, 3 done
        self.t = [0.0, 0.0]     # host clock at the active step's start and end
        self.blocks = [0, 0]    # blocks issued before the active step's start and end

    def start(self) -> None:
        """Start the warm-up step (just before the window opens: starting
        the tracer takes a while)."""
        self.prof.start()
        self.phase = 1

    def at(self, issued: int, start: int, end: int) -> None:
        """Called before each block is issued (``issued`` so far): open the
        active step at block ``start``, close it at ``end`` (-1: not yet
        known)."""
        if self.phase == 1 and 0 <= start <= issued:
            self.prof.step()
            self.phase, self.t[0], self.blocks[0] = 2, time.perf_counter(), issued
        elif self.phase == 2 and 0 <= end <= issued:
            self._end(issued)

    def _end(self, issued: int) -> None:
        self.t[1], self.blocks[1] = time.perf_counter(), issued
        self.prof.step()
        self.prof.stop()
        self.phase = 3

    def finish(self, issued: int) -> "Trace":
        """Close the active step if the window ended inside it (a short
        ``--seconds``), and read the trace."""
        if self.phase == 1:
            self.prof.step()
            self.phase, self.t[0], self.blocks[0] = 2, time.perf_counter(), issued
        if self.phase == 2:
            self._end(issued)
        try:
            with open(self.path) as f:
                doc = json.load(f)
        finally:
            with contextlib.suppress(OSError):
                os.remove(self.path)
                os.rmdir(self._dir)
        return Trace(doc, tuple(self.t), self.blocks[1] - self.blocks[0])


def span(tracing: bool, name: str):
    """A host span the trace shows (``bench.<name>``), or nothing."""
    if not tracing:
        return contextlib.nullcontext()
    return torch.profiler.record_function(SPAN_PREFIX + name)


def _union(intervals) -> list:
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


class Trace:
    """The traced window of one rank, in microseconds of the trace's clock."""

    def __init__(self, doc: dict, host_window: tuple, blocks: int):
        events = [e for e in doc.get("traceEvents", []) if e.get("ph") == "X"]
        step = [e for e in events if e.get("name", "").startswith("ProfilerStep#")]
        if not step:
            raise RuntimeError("the trace has no ProfilerStep span: no active step recorded")
        s = max(step, key=lambda e: float(e["dur"]))
        self.t0, self.t1 = float(s["ts"]), float(s["ts"]) + float(s["dur"])
        self.host_window = host_window
        self.blocks = blocks

        def inside(e):
            return float(e["ts"]) >= self.t0 and float(e["ts"]) + float(e["dur"]) <= self.t1

        def overlaps(e):
            return float(e["ts"]) < self.t1 and float(e["ts"]) + float(e["dur"]) > self.t0

        dev = [e for e in events if e.get("cat") in DEVICE_CATS]
        #: device events wholly inside the window: (cat, name, ts, dur)
        self.device = [(e["cat"], e["name"], float(e["ts"]), float(e["dur"]))
                       for e in dev if inside(e)]
        self._busy = _union((max(float(e["ts"]), self.t0),
                             min(float(e["ts"]) + float(e["dur"]), self.t1))
                            for e in dev if overlaps(e))
        host = sorted(((float(e["ts"]), float(e["dur"]), e["name"]) for e in events
                       if e.get("cat") in HOST_CATS and not e["name"].startswith("ProfilerStep")
                       and overlaps(e)))
        self._host = host
        self._host_ts = [h[0] for h in host]

    @property
    def window_s(self) -> float:
        return (self.t1 - self.t0) / 1e6

    @property
    def busy_s(self) -> float:
        return sum(b - a for a, b in self._busy) / 1e6

    def kernels(self, pred=lambda name: True) -> list:
        """(name, dur_us) of the kernels wholly inside the window."""
        return [(n, d) for c, n, _, d in self.device if c == "kernel" and pred(n)]

    def copies(self, pred=lambda name: True) -> list:
        return [(n, d) for c, n, _, d in self.device if c == "gpu_memcpy" and pred(n)]

    def _host_at(self, t: float) -> str:
        """What the host was doing at ``t``: the innermost host event
        around it, under the harness's span when there is one."""
        i = bisect.bisect_right(self._host_ts, t)
        inner, outer = None, None
        for ts, dur, name in reversed(self._host[max(0, i - 2000):i]):
            if ts + dur >= t:
                if inner is None or dur < inner[0]:
                    inner = (dur, name)
                if name.startswith(SPAN_PREFIX) and outer is None:
                    outer = name
        if inner is None:
            return "host: no event"
        return inner[1] if outer in (None, inner[1]) else f"{outer} > {inner[1]}"

    def breakdown(self, n: int = 10) -> dict:
        """The device operations that took most time, and the idle time of
        the device by what the host was doing, each as [name, seconds]."""
        ops = collections.Counter()
        for _, name, _, dur in self.device:
            ops[name[:160]] += dur / 1e6
        idle = collections.Counter()
        edges = [self.t0] + [x for ab in self._busy for x in ab] + [self.t1]
        for a, b in zip(edges[::2], edges[1::2]):
            if b > a:
                idle[self._host_at((a + b) / 2)[:160]] += (b - a) / 1e6
        return {"device_ops": [[k, v] for k, v in ops.most_common(n)],
                "idle_gaps": [[k, v] for k, v in idle.most_common(n)]}
