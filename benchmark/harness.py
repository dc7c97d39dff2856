"""One run of one cell: set-up, the measured window, the check, the result.

A run makes a pool of distinct input blocks from the seed (24-bit noise in
[-1, 1), on the card in one call), streams them in turn, each with a sign
drawn from the seed (``Stream``), builds the cell's entry
(``entries/<entry>.py``), warms up its shapes, then feeds the pool's
blocks to the entry in a closed loop for ``--seconds``: the entry takes
block b, then the harness waits for block b-1's output, so at most two
blocks are in flight (a Streamer chain: its own group).  The state carries
across the whole window.  After the window it waits for the last block,
reads the peak memory, and compares that block's outputs and the state
after it with the plain reference (``checks``).

On a mesh of more than one card the run spawns one process per card
(NCCL, a ``file://`` rendezvous under ``TMPDIR``); every rank feeds the
same blocks, rank 0 ends the window for all of them at a block count they
share, and each block's latency runs from the first rank's take to the
last rank's delivery (the host clock is the machine's monotonic clock,
shared by the processes).
"""

from __future__ import annotations

import dataclasses
import math
import os
import sys
import tempfile
import time

import numpy as np
import torch

from . import checks, reference, spec as spec_
from .tracing import ACTIVE_S, WARM_S, Tracer, span

#: blocks by which rank 0 sets a shared mark of the window ahead of its
#: own count (a rank runs at most two blocks ahead of another)
RANK_MARGIN = 4
#: the only top-level modules a run may not have loaded
FORBIDDEN = ("jax", "jaxlib", "flax", "sdft_tpu")


class Window:
    """The measured window's clock.  ``go(i)`` before block i of the window
    says whether to issue it, and moves the tracer's steps.

    Its marks, the block at which the window ends and those at which the
    traced step opens and closes, are set by the leader (rank 0) from its
    clock and shared by every rank (``shared``: three int64, -1 unset),
    so that all ranks issue the same blocks and trace the same ones: a
    rank that closes its trace stalls, and a rank still tracing would
    record the wait for it in its collectives."""

    def __init__(self, seconds: float, multiple: int = 1, shared=None, leader: bool = True,
                 tracer: Tracer | None = None):
        self.seconds, self.multiple = seconds, multiple
        self.marks = shared if shared is not None else [-1, -1, -1]
        self.margin = RANK_MARGIN if shared is not None else 0
        self.leader, self.tracer = leader, tracer
        self.t0 = self.t_end = math.nan

    def begin(self) -> None:
        self.t0 = time.perf_counter()
        self.t_end = self.t0 + self.seconds

    def _mark(self, k: int, i: int, now: float, at: float, multiple: int = 1) -> int:
        if self.marks[k] < 0 and self.leader and now >= at:
            self.marks[k] = -(-(i + self.margin) // multiple) * multiple
        return self.marks[k]

    def go(self, i: int) -> bool:
        now = time.perf_counter()
        if self.tracer is not None and self.tracer.phase < 3:
            a = self._mark(1, i, now, self.t0 + WARM_S)
            b = self._mark(2, i, now, self.t0 + WARM_S + ACTIVE_S) if a >= 0 else -1
            self.tracer.at(i, a, b)
        stop = self._mark(0, i, now, self.t_end, self.multiple)
        return stop < 0 or i < stop


@dataclasses.dataclass
class Records:
    """Host clock per block of the window: when the entry took it, when
    the entry call returned, and when its output was the caller's."""

    take: list = dataclasses.field(default_factory=list)
    ret: list = dataclasses.field(default_factory=list)
    done: list = dataclasses.field(default_factory=list)

    def new(self, t_take: float) -> int:
        self.take.append(t_take)
        self.ret.append(math.nan)
        self.done.append(math.nan)
        return len(self.take) - 1


class _NoEvent:
    def record(self, *a):
        pass

    def synchronize(self):
        pass


@dataclasses.dataclass
class Ctx:
    """What an entry is given: the cell, the plan, and the stream."""

    cell: spec_.Cell
    plan: object
    device: torch.device
    stream: "Stream"
    mesh: object = None
    tracing: bool = False

    def block(self, k: int) -> torch.Tensor:
        return self.stream.block(k)

    def host_block(self, k: int) -> np.ndarray:
        return self.stream.host_block(k)

    def event(self):
        return torch.cuda.Event() if self.device.type == "cuda" else _NoEvent()

    def span(self, name: str):
        return span(self.tracing, name)


def make_pool(seed: int, blocks: int, channels: int, length: int, device) -> torch.Tensor:
    """(blocks, channels, length) float32 samples k / 2^23, k uniform in
    [-2^23, 2^23): 24-bit audio, drawn from ``seed`` on ``device`` in one
    call (every rank of a mesh draws the same)."""
    g = torch.Generator(device=device)
    g.manual_seed(seed % (1 << 64))
    k = torch.randint(-(1 << 23), 1 << 23, (blocks, channels, length), generator=g,
                      device=device, dtype=torch.int32)
    return k.to(torch.float32) / float(1 << 23)


def _sign_bit(seed: int, k: int) -> int:
    """A bit drawn from (seed, k) by splitmix64's finalizer."""
    z = (seed + (k + 1) * 0x9E3779B97F4A7C15) & 0xFFFFFFFFFFFFFFFF
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & 0xFFFFFFFFFFFFFFFF
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & 0xFFFFFFFFFFFFFFFF
    return (z ^ (z >> 31)) & 1


class Stream:
    """The input stream: block k is ``pool[k % P]``, negated where a bit
    drawn from (seed, k) says so.  The signs keep a cycled pool from adding
    the same rounding errors to the carried state on every cycle (a
    periodic input makes a float32 running sum drift linearly with the
    blocks streamed, a real stream as a random walk); both signs are kept,
    so taking a block costs nothing."""

    def __init__(self, seed: int, pool: torch.Tensor):
        self.seed = seed % (1 << 64)
        self.P = pool.shape[0]
        self.signed = torch.cat([pool, -pool])
        self._host = None

    def index(self, k: int) -> int:
        return k % self.P + self.P * _sign_bit(self.seed, k)

    def block(self, k: int) -> torch.Tensor:
        return self.signed[self.index(k)]

    def host_block(self, k: int) -> np.ndarray:
        if self._host is None:
            self._host = list(self.signed.cpu().numpy())
        return self._host[self.index(k)]

    def history(self, k: int, n: int) -> torch.Tensor:
        """The ``n`` samples right before block ``k`` (zeros before the
        stream's start): (C, n)."""
        parts, need, j = [], n, k - 1
        while need > 0 and j >= 0:
            blk = self.block(j)
            take = blk[:, max(0, blk.shape[1] - need):]
            parts.insert(0, take)
            need -= take.shape[1]
            j -= 1
        if need > 0:
            parts.insert(0, self.signed.new_zeros(self.signed.shape[1], need))
        return torch.cat(parts, dim=1)


def make_plan(config: dict):
    import sdft_tpu_torch as T

    p = config["precision"]
    return T.Plan(int(config["dftsize"]), window=config["window"],
                  latency=float(config["latency"]),
                  precision=T.Precision(td=p["td"], fd=p["fd"], mxu=p["mxu"]),
                  roi=tuple(config["roi"]) if config.get("roi") else None)


def ref_spec(config: dict) -> reference.Spec:
    return reference.Spec(int(config["dftsize"]), config["window"], float(config["latency"]),
                          tuple(config["roi"]) if config.get("roi") else None)


def block_length(cell: spec_.Cell) -> int:
    """Samples of each channel in one block: the traffic's per card times
    the mesh's time shards."""
    return int(cell.traffic["samples_per_card"]) * cell.mesh[1]


def run_rank(cell: spec_.Cell, seed: int, seconds: float, trace: bool, device: torch.device,
             rank: int = 0, mesh=None, shared=None, fault: str | None = None) -> dict:
    """Set-up, window and check of one rank.  Returns its part of the
    result: the block records, the compared numbers, the peak memory, and
    on a traced run the trace's busy and window seconds, rank 0's
    per-layer metrics and breakdown."""
    from .faults import planted

    with planted(fault):
        return _run_rank(cell, seed, seconds, trace, device, rank, mesh, shared)


def _run_rank(cell, seed, seconds, trace, device, rank, mesh, shared) -> dict:
    C, L = int(cell.config["channels"]), block_length(cell)
    stream = Stream(seed, make_pool(seed, int(cell.traffic["pool_blocks"]), C, L, device))
    ctx = Ctx(cell, make_plan(cell.config), device, stream, mesh, trace)
    runner = spec_.entry(cell.traffic["entry"]).make(ctx)
    runner.warm()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    if mesh is not None:
        torch.distributed.barrier()
    tracer = Tracer(device.type) if trace else None
    win = Window(seconds, runner.multiple, shared, leader=rank == 0, tracer=tracer)
    rec = Records()
    if tracer is not None:
        tracer.start()      # its warm-up step opens with the window
    host = HostLoad()
    win.begin()
    final = runner.window(win, rec)          # the last block's outputs, after the window
    out = {"t_start_window": win.t0, "t_end": win.t_end, "take": rec.take, "ret": rec.ret,
           "done": rec.done, "host": host.read()}
    if tracer is not None:
        tr = tracer.finish(len(rec.take))
        out["busy_s"], out["window_s"] = tr.busy_s, tr.window_s
        run = TracedRun(cell, tr, rec)
        out["metrics"] = {}
        for m in cell.per_layer if rank == 0 else ():
            v = spec_.reader(m["name"])(run)
            if v is not None:
                out["metrics"][m["name"]] = {"value": float(v), "unit": m["unit"]}
        out["breakdown"] = tr.breakdown()
    cuda = device.type == "cuda"
    out["memory_peak_bytes"] = torch.cuda.max_memory_allocated(device) if cuda else 0
    out["kind"] = torch.cuda.get_device_name(device) if cuda else "cpu"
    # the reference runs once the window's outputs are in and the peak is read
    b = final.pop("index")
    runner.free()
    spec = ref_spec(cell.config)
    n2 = spec.n2
    xext = torch.cat([stream.history(b, n2), stream.block(b)], dim=1).double()
    Lr = L // cell.mesh[1]
    d = mesh.get_local_rank("time") if mesh is not None else 0
    xr = xext[:, d * Lr:d * Lr + n2 + Lr]
    out["numbers"] = checks.compare(spec, xr, final, ((b + 1) * L) % n2, tail=xext[:, -n2:])
    out["block_index"] = b
    return out


class HostLoad:
    """The share of one core this process used while the window ran (its
    CPU time over the window's wall time).  Near 1 in a host-bound cell: a
    slow run at 1 had a slower core, one well under 1 lost its core to
    other work.  (The machine's ``/proc/stat`` and load average read the
    same at every moment, so they tell nothing.)"""

    def __init__(self):
        self.t, self.cpu = time.perf_counter(), time.process_time()

    def read(self) -> dict:
        return {"own_cores": (time.process_time() - self.cpu) / (time.perf_counter() - self.t)}


@dataclasses.dataclass
class TracedRun:
    """What a per-layer metric's reader is given."""

    cell: spec_.Cell
    trace: object           # tracing.Trace
    records: Records

    def calls_in_trace(self) -> list:
        """Host seconds of each entry call taken inside the traced window."""
        a, b = self.trace.host_window
        return [r - t for t, r in zip(self.records.take, self.records.ret)
                if a <= t <= b and math.isfinite(r)]


def summarize(cell: spec_.Cell, parts: list, seconds: float, t_process: float,
              trace: bool) -> dict:
    """The result line from every rank's part (rank 0 first)."""
    lead = parts[0]
    t_end = lead["t_end"]
    n = min(len(p["take"]) for p in parts)
    take = np.min([p["take"][:n] for p in parts], axis=0)
    done = np.max([p["done"][:n] for p in parts], axis=0)
    ok = np.isfinite(done) & (done <= t_end)
    lat_ms = (done[ok] - take[ok]) * 1e3
    L = block_length(cell)
    C = int(cell.config["channels"])
    numbers = {}
    for p in parts:
        for k, v in p["numbers"].items():
            numbers[k] = max(numbers.get(k, -math.inf), v)
    correct, rows = checks.verdict(numbers, cell.limits)
    result = {"correct": correct, "attempted": int(np.sum(take < t_end)),
              "failed": int(np.sum(~np.isfinite(done)))}
    if trace:
        metrics = dict(lead.get("metrics", {}))
    else:
        have = {"samples_per_s": int(ok.sum()) * C * L / seconds,
                "block_ms_p95": float(np.percentile(lat_ms, 95)) if lat_ms.size else math.nan,
                "setup_s": lead["t_start_window"] - t_process}
        # a metric named <quantity>.<cells> reports <quantity>
        metrics = {m["name"]: {"value": have[m["name"].split(".")[0]], "unit": m["unit"]}
                   for m in cell.end_to_end}
    result["metrics"] = metrics
    dev = {"platform": "gpu", "kind": lead["kind"], "count": cell.chips,
           "memory_peak_bytes": int(max(p["memory_peak_bytes"] for p in parts))}
    if trace:
        dev["busy_s"] = float(np.mean([p["busy_s"] for p in parts]))
        dev["window_s"] = float(np.mean([p["window_s"] for p in parts]))
        result["breakdown"] = lead["breakdown"]
    result["device"] = dev
    result["blocks_delivered"] = int(ok.sum())
    result["checked_block"] = lead["block_index"]
    result["host"] = lead["host"]
    result["checks"] = {k: {"value": v, "limit": lim} for k, v, lim in rows}
    return result


def forbidden_modules() -> list:
    """Top-level names of loaded modules a run may not have loaded."""
    return sorted({name.split(".")[0] for name in list(sys.modules)} & set(FORBIDDEN))


def _rank_main(rank: int, cell: spec_.Cell, seed: int, seconds: float, trace: bool, init: str,
               shared, queue, device_type: str, fault):
    """One rank of a multi-card run (``torch.multiprocessing.spawn``)."""
    import datetime

    import torch.distributed as dist

    from sdft_tpu_torch import parallel as par

    if device_type == "cuda":
        torch.cuda.set_device(rank)
        device = torch.device("cuda", rank)
    else:
        device = torch.device("cpu")
    dist.init_process_group("nccl" if device_type == "cuda" else "gloo", init_method=init,
                            world_size=cell.world, rank=rank,
                            timeout=datetime.timedelta(seconds=240))
    try:
        mesh = par.make_mesh(*cell.mesh, device_type=device_type)
        part = run_rank(cell, seed, seconds, trace, device, rank, mesh, shared, fault)
        part["forbidden"] = forbidden_modules()
        queue.put((rank, part))
    finally:
        par.multihost.shutdown()


def run_mesh(cell: spec_.Cell, seed: int, seconds: float, trace: bool,
             device_type: str = "cuda", fault: str | None = None) -> list:
    """Spawn the cell's ranks; return their parts, rank 0 first."""
    import queue as queue_mod

    import torch.multiprocessing as mp

    ctx = mp.get_context("spawn")
    shared = ctx.Array("q", [-1, -1, -1])
    queue = ctx.Queue()
    with tempfile.TemporaryDirectory(prefix="bench_rdv_") as tmp:
        procs = [ctx.Process(target=_rank_main,
                             args=(r, cell, seed, seconds, trace, f"file://{tmp}/group",
                                   shared, queue, device_type, fault))
                 for r in range(cell.world)]
        for p in procs:
            p.start()
        parts = {}
        try:
            while len(parts) < cell.world:
                if any(p.exitcode for p in procs) or (
                        not any(p.is_alive() for p in procs) and queue.empty()):
                    break               # a rank failed: the others would wait for it
                try:
                    r, part = queue.get(timeout=1.0)
                    parts[r] = part
                except queue_mod.Empty:
                    continue
        finally:
            for p in procs:
                p.join(timeout=120 if len(parts) == cell.world else 5)
            for p in procs:
                if p.is_alive():
                    p.kill()
                    p.join()
    if len(parts) < cell.world or any(p.exitcode for p in procs):
        raise RuntimeError(f"ranks ended without a result: exit codes "
                           f"{[p.exitcode for p in procs]}")
    return [parts[r] for r in range(cell.world)]


def run(workload: str, seed: int, seconds: float, trace: bool, root=spec_.ROOT,
        device_type: str = "cuda", t_process: float | None = None,
        fault: str | None = None, cell: spec_.Cell | None = None) -> dict:
    """One run of a cell; returns the result dict (the line's keys, with
    ``checks`` last).  ``device_type="cpu"`` (tests only) skips the look
    for a card and runs the port's plain versions."""
    t_process = time.perf_counter() if t_process is None else t_process
    cell = cell or spec_.cell(workload, root)
    if cell.world > 1:
        parts = run_mesh(cell, seed, seconds, trace, device_type, fault)
    else:
        device = torch.device("cuda", 0) if device_type == "cuda" else torch.device("cpu")
        if device.type == "cuda":
            torch.cuda.set_device(0)
        part = run_rank(cell, seed, seconds, trace, device, fault=fault)
        part["forbidden"] = forbidden_modules()
        parts = [part]
    bad = sorted({f for p in parts for f in p["forbidden"]} | set(forbidden_modules()))
    if bad:
        raise RuntimeError(f"loaded in a run: {bad}")
    res = summarize(cell, parts, seconds, t_process, trace)
    if device_type != "cuda":
        res["device"]["platform"] = "cpu"
    return res


def cache_dirs(root) -> None:
    """Point every kernel cache a library could use at fixed directories
    inside the checkout (the port builds its own kernels into
    ``sdft_tpu_torch/kernels/_build``)."""
    base = os.path.join(str(root), ".bench_cache")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(base, "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(base, "triton")
    os.environ["TORCHINDUCTOR_CACHE_DIR"] = os.path.join(base, "inductor")
    os.environ["USE_FLAX"] = "0"
