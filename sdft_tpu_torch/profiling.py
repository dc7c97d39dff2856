"""Profiling, tracing and roofline accounting (counterpart of
``sdft_tpu.profiling``).

  * :func:`trace` — context manager around ``torch.profiler.profile``
    writing a Chrome trace of everything run in the block;
  * :class:`OpCost`, :func:`analysis_cost`, :func:`synthesis_cost`,
    :func:`roundtrip_cost` — analytic flops and device-memory bytes of the
    blockwise SDFT ops, the inputs of a roofline;
  * :func:`device_peaks`, :func:`bound` — the card's published peaks and
    the least time a piece of work could take on it;
  * :func:`wall_time`, :func:`device_time` — a call's time between CUDA
    events and its time on the card by the profiler;
  * :func:`benchmark`, :func:`benchmark_marginal` — wall-clock timing with
    device synchronization (and device time on a card), reporting achieved
    flop/s and bytes/s against the card's peaks where known;
  * :func:`scaling_projection`, :func:`measure_scaling_proxy` — the sharded
    round trip's scaling model, and its two-process CPU proxy;
  * :func:`bench_cli`, :func:`bench_mesh_cli` — ``python -m sdft_tpu_torch
    bench [m] [block] [runs] [--device D] [--mesh CxTxB]``;
  * :func:`kernel_parts` — drives the probes of K1's parts
    (``kernels.kparts``) on the card and times each;
    :func:`kernel_part_bounds` — the least time each could take;
  * :data:`SPLIT_MM_SHAPES`, :func:`split_mm_bound`, :func:`cublas_split_mm`
    — the split products' shapes on the main path, the least time each
    could take, and cuBLAS's bf16 GEMMs summed the same way (the yardstick
    the kernel is timed against, never called by the port).
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import pathlib
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from .config import FAST_PRECISION
from .kernels import kparts as _kparts
from .plan import Plan
from .state import init_state, require_device
from .windows import WINDOW_HALO

__all__ = ["trace", "OpCost", "analysis_cost", "synthesis_cost",
           "roundtrip_cost", "benchmark", "benchmark_marginal",
           "device_peaks", "device_time", "wall_time", "bound",
           "scaling_projection", "measure_scaling_proxy", "bench_cli",
           "bench_mesh_cli", "kernel_parts", "kernel_part_bounds", "SPLIT_MM_SHAPES",
           "split_mm_bound", "cublas_split_mm"]


@contextlib.contextmanager
def trace(logdir: str):
    """Profile everything run in the block (host ops, and the card's
    kernels and copies when there is a card) and write it to ``logdir`` as
    a Chrome trace (``<host>_<pid>.<ms>.pt.trace.json``; open it in
    Perfetto, chrome://tracing or TensorBoard's profiler), the port's
    ``sdft.*`` spans among the host's events (``tracing``).  Yields the
    ``torch.profiler.profile``."""
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities,
                 on_trace_ready=tensorboard_trace_handler(str(logdir))) as prof:
        yield prof


@dataclasses.dataclass(frozen=True)
class OpCost:
    """Analytic cost of one op invocation (per channel)."""

    flops: int          # real flops (adds + muls)
    hbm_bytes: int      # unavoidable device-memory traffic (inputs + outputs + state)

    @property
    def intensity(self) -> float:
        """Arithmetic intensity in flop/byte — the roofline x-axis."""
        return self.flops / max(self.hbm_bytes, 1)


def analysis_cost(plan: Plan, n_samples: int, emit_dfts: bool = True) -> OpCost:
    """Flops/bytes of the forward blockwise analysis.

    Per (sample, bin): rotate delta into the bin frame (2 mul), prefix-sum
    (2 add), carry add (2), demodulate (6: complex multiply), and the
    window convolution — ``2*(1 + 2*halo)`` multiplies plus ``2*2*halo``
    adds plus the normalization.
    """
    m, halo = plan.dftsize, WINDOW_HALO[plan.window]
    per_bin = 2 + 2 + 2 + 6 + 2 * (1 + 2 * halo) + 4 * halo + 2
    flops = n_samples * m * per_bin
    fd = plan.precision.fd_dtype.itemsize
    td = plan.precision.td_dtype.itemsize
    state_bytes = (2 * m * td) + (m * 2 * fd)       # delayline + accumulator
    bytes_ = n_samples * td + 2 * state_bytes
    if emit_dfts:
        bytes_ += n_samples * m * 2 * fd
    return OpCost(flops=flops, hbm_bytes=bytes_)


def synthesis_cost(plan: Plan, n_samples: int, read_dfts: bool = True) -> OpCost:
    """Flops/bytes of the inverse bin-sum (c/src/sdft/sdft.h:635-657)."""
    m = plan.dftsize
    per_bin = 2 if plan.latency == 1.0 else 4
    flops = n_samples * m * per_bin
    fd = plan.precision.fd_dtype.itemsize
    td = plan.precision.td_dtype.itemsize
    bytes_ = n_samples * td + (n_samples * m * 2 * fd if read_dfts else 0)
    return OpCost(flops=flops, hbm_bytes=bytes_)


def roundtrip_cost(plan: Plan, n_samples: int) -> OpCost:
    """Fused analysis + synthesis: the spectra never touch device memory."""
    a = analysis_cost(plan, n_samples, emit_dfts=False)
    s = synthesis_cost(plan, n_samples, read_dfts=False)
    return OpCost(flops=a.flops + s.flops, hbm_bytes=a.hbm_bytes + s.hbm_bytes)


# -- the card's peaks and bounds ---------------------------------------------------

#: published H100 SXM peaks (NVIDIA data sheet, dense): HBM bytes/s, FP32
#: flop/s outside the tensor cores, bf16 tensor-core flop/s
PEAK_BYTES, PEAK_F32, PEAK_BF16_TC = 3.35e12, 67e12, 989e12
#: (bf16 tensor-core flop/s, device-memory bytes/s) by the words of the
#: card's name (``torch.cuda.get_device_name``): the H100 SXM, whose name
#: says HBM3, and the H200 (the same tensor cores, 4.8 TB/s of HBM3e)
_PEAKS = ((("H100", "HBM3"), (PEAK_BF16_TC, PEAK_BYTES)),
          (("H200",), (PEAK_BF16_TC, 4.8e12)))
#: f32 flops per output bin of the tile body (running sum 4, phasor product
#: 6, demodulation 6, Hann stencil 8, power 3: about 25), and of K2, which
#: adds y (4 more)
K1_FLOPS_PER_BIN, K2_FLOPS_PER_BIN = 25, 29


def device_peaks(device=None):
    """(bf16 tensor-core flop/s, device-memory bytes/s) of the card
    (``device``, default cuda:0 when there is one), or (None, None) for
    the CPU and for cards whose peaks this module does not know."""
    if device is None:
        device = "cuda" if torch.cuda.is_available() else "cpu"
    device = torch.device(device)
    if device.type != "cuda":
        return None, None
    name = torch.cuda.get_device_name(device)
    for words, peaks in _PEAKS:
        if all(w in name for w in words):
            return peaks
    return None, None


def bound(nbytes: float, f32_flops: float = 0.0, tc_flops: float = 0.0) -> tuple:
    """The least time an H100 SXM could take (ms) and what bounds it: bytes
    over HBM's rate, or operations over their peak rates."""
    t_bytes = nbytes / PEAK_BYTES * 1e3
    t_ops = (f32_flops / PEAK_F32 + tc_flops / PEAK_BF16_TC) * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


#: (rows, K, N) of each split product on the main path, by where it runs:
#: the collapsed round trip at m = 4096, k_tile 1024, on 1 x 65536 (64
#: tile rows) and 8 x 32768 (256); the driver at m = 1000, hop = 100, on a
#: block of 16000 (160 hop tiles; ``sdft_hopped`` on 64000 samples takes
#: 640 rows of the totals), and at hop = 4 on 4000 (500 tiles of two hops)
SPLIT_MM_SHAPES = {
    "totals 1x65536": (64, 1024, 8192), "GLT 1x65536": (64, 1024, 1024),
    "PQ 1x65536": (64, 8192, 1024),
    "totals 8x32768": (256, 1024, 8192), "GLT 8x32768": (256, 1024, 1024),
    "PQ 8x32768": (256, 8192, 1024),
    "totals hop=100": (160, 100, 2000), "GLT hop=100": (160, 100, 100),
    "PQ hop=100": (160, 2000, 100), "totals sdft_hopped": (640, 100, 2000),
    "totals hop=4": (500, 8, 2000), "stepped hop=4": (500, 8, 4000),
    "GLT hop=4": (500, 8, 8), "PQ hop=4": (500, 2000, 8),
}


def split_mm_bound(rows: int, K: int, N: int, passes: int, accumulate: bool = False) -> tuple:
    """``bound`` of one ``kernels.split_mm`` launch: the float32 activation
    and the two bf16 halves of the table read once, the float32 output
    written once (and read once with ``accumulate``), against
    2*rows*K*N*passes bf16 tensor-core operations."""
    nbytes = 4 * rows * K + 4 * K * N + 4 * rows * N * (2 if accumulate else 1)
    return bound(nbytes, tc_flops=2.0 * rows * K * N * passes)


def cublas_split_mm(a: torch.Tensor, b, passes: int) -> torch.Tensor:
    """The split class by cuBLAS: ``a`` split by torch ops, one bf16 GEMM
    with float32 output per product (``aten::mm.dtype``), summed in the
    kernel's order.  The route the split classes took before the kernel,
    kept as its yardstick; the port never calls it."""
    from .config import bf16_products
    from .kernels.split_mm import split_mask

    x = split_mask(a)
    with bf16_products():
        def d(u, v):
            return torch.mm(u, v, out_dtype=torch.float32)

        hh, hl, lh = d(x.hi, b.hi), d(x.hi, b.lo), d(x.lo, b.hi)
        return (hh + hl) + (lh + d(x.lo, b.lo)) if passes == 4 else (hh + hl) + lh


# -- timing ------------------------------------------------------------------------

def wall_time(fn, reps: int, warmup: int = 2) -> float:
    """Wall time per call in ms between CUDA events, back to back: what a
    caller sees, host overhead included.  Needs a card."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / reps


def device_time(fn, reps: int, warmup: int = 2, attempts: int = 4) -> float:
    """Device time per call in ms: the summed durations of the kernels and
    copies the calls ran on the card (torch.profiler), so the host's gaps
    between launches do not count.  The warm-up calls run inside the
    profiler, as its own warm-up step, with the card idle for 20 ms on
    either side of the step boundary: with the tracer started only around
    the timed calls, a run of 10 K1 launches has read 0.8 of the kernel's
    time (its form at 110 % of the HBM bound), and kernels next to the
    boundary have been counted on the wrong side of it.  Only recorded time
    is reported: a measurement in which some kernel's count is not a
    multiple of ``reps`` (an event lost or misplaced), or that recorded
    no device time at all (once in a full chip_smoke.py run on an H100),
    is taken again, and after ``attempts`` such measurements this
    raises.  The kernels a CUDA graph's replay launches are recorded like
    any others (``graphs``: a graphed call reads 0.96-1.08 of its eager
    run's device time on an H100, the excess being the graph's input and
    output copies, by chip_smoke.py).  Needs a card."""
    from torch.profiler import ProfilerActivity, profile, schedule

    for _ in range(attempts):
        with profile(activities=[ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=1, repeat=1)) as prof:
            for calls in (max(1, warmup), reps):
                for _ in range(calls):
                    fn()
                torch.cuda.synchronize()
                time.sleep(0.02)
                prof.step()
                time.sleep(0.02)
        events = [e for e in prof.key_averages()
                  if e.count > 0 and e.self_device_time_total > 0]
        odd = [f"{e.key[:40]} x{e.count}" for e in events if e.count % reps]
        if events and not odd:
            return sum(e.self_device_time_total for e in events) / reps / 1e3
        print(f"  (profiler lost events, measuring again: "
              f"{'; '.join(odd) or 'no device time recorded'})", flush=True)
    raise RuntimeError(f"the profiler lost or misplaced events in {attempts} measurements")


def _device_of(tree) -> torch.device:
    """The device of the first CUDA tensor in a nest of tuples and lists
    (else the CPU): the device a benchmark synchronizes."""
    if isinstance(tree, torch.Tensor):
        return tree.device
    if isinstance(tree, (tuple, list)):
        for t in tree:
            dev = _device_of(t)
            if dev.type != "cpu":
                return dev
    return torch.device("cpu")


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def benchmark(fn, args, *, iters: int = 5, warmup: int = 2,
              cost: OpCost | None = None):
    """Time ``fn(*args)`` with the device synchronized around each call;
    returns a result dict: ``seconds`` (best), ``median_seconds``, and on a
    card ``device_seconds`` (the card's busy time per call,
    :func:`device_time`), which the host's gaps between launches do not
    count.  The device is that of the tensors in ``args``.

    When ``cost`` is given, achieved flop/s, device-memory GB/s and the
    roofline fractions against the card's peaks are included.
    """
    device = _device_of(args)
    for _ in range(max(warmup, 1)):
        fn(*args)
    _sync(device)
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        fn(*args)
        _sync(device)
        times.append(time.perf_counter() - t0)
    best = min(times)
    out = {"seconds": best, "median_seconds": float(np.median(times))}
    if device.type == "cuda":
        out["device_seconds"] = device_time(lambda: fn(*args), iters, warmup) / 1e3
    if cost is not None:
        _add_roofline(out, cost, best, device)
    return out


def _add_roofline(out, cost, seconds, device):
    out["flops_per_s"] = cost.flops / seconds
    out["hbm_gb_per_s"] = cost.hbm_bytes / seconds / 1e9
    out["intensity_flop_per_byte"] = cost.intensity
    peak_flops, peak_bw = device_peaks(device)
    if peak_bw:
        out["hbm_roofline_fraction"] = (cost.hbm_bytes / seconds) / peak_bw
    if peak_flops:
        # the bf16 tensor-core share, under the JAX package's key so that
        # the two packages' rows line up
        out["mxu_roofline_fraction"] = (cost.flops / seconds) / peak_flops


def benchmark_marginal(step, state, xs, *, k_lo: int = 4, k_hi: int = 12,
                       repeats: int = 3, cost: OpCost | None = None):
    """Marginal per-step cost of a state-threading step function.

    Runs chains of ``k_lo`` and ``k_hi`` sequential steps (state threaded,
    each step's output reduced on the device to one scalar ``sum(y*y)``,
    and the chain's sum fetched to the host once: the barrier), and
    reports ``(t(k_hi) - t(k_lo)) / (k_hi - k_lo)``: fixed launch and
    fetch latency cancels out.  ``step(state, x) -> (state, y)``; ``xs``
    has a leading axis of at least ``k_hi``.
    """
    def chain(k):
        st, total = state, None
        for i in range(k):
            st, y = step(st, xs[i])
            s = (y * y).sum()
            total = s if total is None else total + s
        return float(total)

    def timed(k):
        chain(k)  # warm
        best = float("inf")
        for _ in range(repeats):
            t0 = time.perf_counter()
            chain(k)
            best = min(best, time.perf_counter() - t0)
        return best

    t_lo, t_hi = timed(k_lo), timed(k_hi)
    per_step = (t_hi - t_lo) / (k_hi - k_lo)
    out = {"chain_lo_seconds": t_lo, "chain_hi_seconds": t_hi}
    if per_step <= 0:
        # Noise swamped the marginal (tiny problems on a loaded host can
        # time the long chain faster than the short one).  Fall back to the
        # amortized per-step cost of the long chain — a valid upper bound
        # that keeps derived throughputs finite and positive.
        per_step = t_hi / k_hi
        out["marginal_noise_floor"] = True
    out["seconds"] = per_step
    if cost is not None:
        _add_roofline(out, cost, per_step, _device_of((state, xs)))
    return out


# -- scaling -----------------------------------------------------------------------

def scaling_projection(m: int, t_fixed_us: float, ns_per_sample: float,
                       block: int = 262144, *, link_gb_per_s: float,
                       coll_latency_us: float) -> dict:
    """Analytic model of the sharded round trip's scaling efficiency over
    T devices joined by links of ``link_gb_per_s`` with a per-collective
    latency of ``coll_latency_us`` (both required: they are the
    interconnect's, e.g. NVLink's or a network's).

    Per time-shard block the sharded LTI round trip runs three collectives
    (parallel/sharded.py): the comb-tail send (2m * 4 B), the delayline
    all_gather ((T-1) * 2m * 4 B received per device) and the totals
    all_gather ((T-1) * m * 2 * 4 B) — per-device bytes ~ 8m * (2T - 1);
    the bins=1 all_reduce is degenerate.  Single-device compute is the
    affine model t(B) = t_fixed + c*B.

    Returns {"strong": {T: eff}, "weak": {T: eff}, ...} — strong splits
    ``block`` across T devices; weak gives every device ``block`` samples.
    """
    def t_us(b):
        return t_fixed_us + ns_per_sample * b / 1e3

    def t_coll_us(T):
        recv = 8 * m * (2 * T - 1)
        return recv / (link_gb_per_s * 1e3) + 3 * coll_latency_us

    strong = {}
    weak = {}
    for T in (2, 4, 8):
        strong[T] = round(t_us(block) / (T * (t_us(block // T) + t_coll_us(T))), 4)
        weak[T] = round(t_us(block) / (t_us(block) + t_coll_us(T)), 4)
    return {"m": m, "block": block, "strong": strong, "weak": weak,
            "model": {"t_fixed_us": t_fixed_us,
                      "ns_per_sample": ns_per_sample,
                      "link_gb_per_s": link_gb_per_s,
                      "coll_latency_us": coll_latency_us}}


def _core_sets() -> tuple:
    """Two disjoint core sets of equal size from this process's cores."""
    cores = sorted(os.sched_getaffinity(0))
    half = max(1, len(cores) // 2)
    second = cores[half:2 * half] or cores[:half]
    return ",".join(map(str, cores[:half])), ",".join(map(str, second))


def measure_scaling_proxy(m: int = 1000, block: int = 65536,
                          timeout_s: float = 300.0) -> dict:
    """CPU two-process strong-scaling proxy: two Gloo ranks, one process
    each on disjoint cores, time the chained ``parallel.sharded_roundtrip``
    over a (1, 2, 1) mesh on the same global block that one process, on as
    many cores as each rank, times through ``ops.lti.roundtrip_block_lti``;
    returns the strong-scaling efficiency t1 / (2 * t2).

    The processes are ``python -m sdft_tpu_torch.parallel.scaling_worker``
    on the CPU, so this is safe to call beside a process that holds the
    card.  A worker that fails, or outlasts ``timeout_s``, raises with its
    output.
    """
    pin0, pin1 = _core_sets()
    root = pathlib.Path(__file__).resolve().parent.parent
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(root)] + [p for p in os.environ.get("PYTHONPATH", "").split(os.pathsep) if p]))
    worker = [sys.executable, "-m", "sdft_tpu_torch.parallel.scaling_worker"]
    with tempfile.TemporaryDirectory() as td:
        single = pathlib.Path(td) / "single.json"
        pair = pathlib.Path(td) / "pair.json"
        runs = [[worker + ["single", pin0, str(single), str(m), str(block)]],
                [worker + ["pair", pin, str(rank), f"file://{td}/group", str(pair),
                           str(m), str(block)] for rank, pin in enumerate((pin0, pin1))]]
        for cmds in runs:
            procs = [subprocess.Popen(c, env=env, stdout=subprocess.PIPE,
                                      stderr=subprocess.STDOUT, text=True) for c in cmds]
            try:
                outs = [p.communicate(timeout=timeout_s)[0] for p in procs]
            finally:
                for p in procs:
                    if p.poll() is None:
                        p.kill()
                        p.wait()
            for p, out in zip(procs, outs):
                if p.returncode != 0:
                    raise RuntimeError(f"scaling worker {' '.join(p.args[3:])} exited "
                                       f"{p.returncode}:\n{out[-3000:]}")
        t1 = json.loads(single.read_text())["seconds"]
        t2 = json.loads(pair.read_text())["seconds"]
    return {"m": m, "block": block, "t1_ms": round(t1 * 1e3, 3),
            "t2_ms": round(t2 * 1e3, 3), "efficiency": round(t1 / (2 * t2), 4)}


# -- the bench subcommand ----------------------------------------------------------

def _pop_value(argv: list, flag: str, default: str) -> str:
    """Remove ``flag value`` from argv and return the value (or default)."""
    if flag not in argv:
        return default
    i = argv.index(flag)
    if i + 1 >= len(argv):
        raise SystemExit(f"{flag} needs a value")
    value = argv[i + 1]
    del argv[i:i + 2]
    return value


def _device_name(device: torch.device) -> str:
    return torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"


def _blocks(n: int, C: int | None, block: int, device) -> torch.Tensor:
    """(n, [C,] block) float32 seeded noise on ``device``."""
    shape = (n, block) if C is None else (n, C, block)
    x = np.random.default_rng(0).standard_normal(shape).astype(np.float32)
    return torch.as_tensor(x, device=device)


def bench_mesh_cli(argv, mesh_spec: str) -> int:
    """``python -m sdft_tpu_torch bench --mesh CxTxB [m] [block] [runs]
    [--device D]`` — sharded round-trip throughput and strong-scaling
    efficiency against one device.  One rank per card under ``torchrun``
    (NCCL; Gloo with --device cpu); a plain ``python -m`` run makes a
    one-rank group of its own, for --mesh 1x1x1 (the CLI's rank model).
    Rank 0 prints; the last line is one JSON object."""
    import torch.distributed as dist

    from .ops.lti import roundtrip_block_lti
    from .parallel import make_mesh, multihost, sharded_roundtrip

    argv = list(argv)
    device = require_device(_pop_value(argv, "--device", "cuda:0"))
    try:
        nc, nt, nb = (int(p) for p in mesh_spec.lower().split("x"))
    except ValueError:
        raise SystemExit(f"--mesh expects CxTxB (e.g. 1x4x2), got {mesh_spec!r}")

    m = int(argv[0]) if len(argv) > 0 else 4096
    # default block: big enough that every time shard holds >= 2m samples
    # (one-neighbour comb exchange) and the marginal dominates launches
    block = int(argv[1]) if len(argv) > 1 else max(16384, 2 * 2 * m * nt)
    runs = int(argv[2]) if len(argv) > 2 else 3

    created = not (dist.is_available() and dist.is_initialized())
    multihost.initialize(device_type=device.type)
    try:
        ndev = nc * nt * nb
        mesh = make_mesh(nc, nt, nb, device_type=device.type)
        dev = multihost.mesh_device(mesh)
        say = print if dist.get_rank() == 0 else (lambda *a, **k: None)
        plan = Plan(m, window="hann", precision=FAST_PRECISION)
        C = max(nc, 1)
        state = init_state(plan, channels=C, device=dev)
        xs = _blocks(12, C, block, dev)
        say(f"device: {_device_name(dev)} ({dev}) x {dist.get_world_size()} ranks "
            f"({dist.get_backend()}); mesh channel={nc} time={nt} bins={nb}")

        def sharded(st, x):
            st, y = sharded_roundtrip(plan, mesh, st, x)
            return st, y.to_local()

        t_mesh = benchmark_marginal(sharded, state, xs, repeats=runs)["seconds"]
        rate = C * block / t_mesh
        say(f"sharded roundtrip m={m} block={block} C={C}: "
            f"{t_mesh * 1e3:.3f} ms/block marginal -> {rate:,.0f} samples/s "
            f"({rate / ndev:,.0f} per device)")

        # strong-scaling baseline: the same global block on ONE device
        t_one = benchmark_marginal(lambda st, x: roundtrip_block_lti(plan, st, x),
                                   state, xs, repeats=runs)["seconds"]
        speedup = t_one / t_mesh
        eff = speedup / ndev
        say(f"single-device: {t_one * 1e3:.3f} ms/block -> "
            f"speedup {speedup:.2f}x on {ndev} devices, "
            f"scaling efficiency {eff:.1%}")
        say(json.dumps({
            "metric": f"sharded_roundtrip_samples_per_s_m{m}",
            "value": round(rate, 1),
            "unit": "samples/s",
            "mesh": {"channel": nc, "time": nt, "bins": nb},
            "per_device_samples_per_s": round(rate / ndev, 1),
            "scaling_efficiency_vs_1dev": round(eff, 4),
        }))
    finally:
        if created:
            multihost.shutdown()
    return 0


def bench_cli(argv) -> int:
    """``python -m sdft_tpu_torch bench [m] [block] [runs] [--device D]`` —
    round-trip bench with roofline accounting (m=4096 default), on cuda:0
    unless --device says otherwise.  With ``--mesh CxTxB`` runs the sharded
    scaling bench instead."""
    from .kernels import kernel_supported, roundtrip_block_fused
    from .ops.analysis import sdft_block
    from .ops.lti import roundtrip_block_lti
    from .ops.synthesis import isdft_block

    argv = list(argv)
    if "--mesh" in argv:
        mesh_spec = _pop_value(argv, "--mesh", "")
        return bench_mesh_cli(argv, mesh_spec)
    device = require_device(_pop_value(argv, "--device", "cuda:0"))

    m = int(argv[0]) if len(argv) > 0 else 4096
    block = int(argv[1]) if len(argv) > 1 else 16384
    runs = int(argv[2]) if len(argv) > 2 else 3

    plan = Plan(m, window="hann", precision=FAST_PRECISION)
    state = init_state(plan, device=device)
    xs = _blocks(12, None, block, device)
    use_kernels = kernel_supported(plan, block)
    print(f"device: {_device_name(device)} ({device}), kernels: "
          f"{'on' if use_kernels and device.type == 'cuda' else 'off'}")

    # collapsed LTI round trip (the production no-transform path)
    res = benchmark_marginal(lambda st, x: roundtrip_block_lti(plan, st, x),
                             state, xs, repeats=runs)
    print(f"roundtrip LTI    m={m} block={block}: "
          f"{res['seconds'] * 1e3:.3f} ms/block marginal "
          f"-> {block / res['seconds']:,.0f} samples/s")

    # scan-form round trip with roofline accounting (per-sample spectra
    # cost): K2 (its plain version on the CPU) where the plan takes the
    # kernels, else the ops path
    def step(state, x):
        if use_kernels:
            return roundtrip_block_fused(plan, state, x)
        st, d = sdft_block(plan, state, x)
        return st, isdft_block(plan, d)

    cost = roundtrip_cost(plan, block)
    res = benchmark_marginal(step, state, xs, repeats=runs, cost=cost)
    route = "K2 roundtrip_block_fused" if use_kernels else "ops sdft_block + isdft_block"
    print(f"roundtrip scan   m={m} block={block}: "
          f"{res['seconds'] * 1e3:.3f} ms/block marginal "
          f"-> {block / res['seconds']:,.0f} samples/s ({route})")
    print(f"achieved: {res['flops_per_s'] / 1e12:.3f} TFLOP/s (f32), "
          f"{res['hbm_gb_per_s']:.1f} GB/s HBM "
          f"(intensity {res['intensity_flop_per_byte']:.1f} FLOP/B)")
    if "hbm_roofline_fraction" in res:
        print(f"HBM roofline fraction: {res['hbm_roofline_fraction']:.1%}")
    if "mxu_roofline_fraction" in res:
        print(f"bf16 tensor-core roofline fraction: {res['mxu_roofline_fraction']:.1%}")
    if use_kernels and device.type == "cuda":
        # the step's least time on an H100 SXM: its state and samples in
        # and out once, K2's f32 operations on every (sample, bin)
        b_ms, b_by = bound(cost.hbm_bytes, K2_FLOPS_PER_BIN * block * m)
        print(f"bound: {b_ms:.4f} ms ({b_by}; H100 SXM peaks), "
              f"{b_ms / (res['seconds'] * 1e3):.1%} of bound")
    return 0


# -- the probes of K1's parts ------------------------------------------------------

def kernel_part_bounds(nt: int = 512, m: int = 4096, K: int = 128, pad: int = 64) -> dict:
    """(ms, "bytes" or "operations") of each probe's bound on an H100: the
    rows of c0 read (vpu, full, tables), the thi/tlo tiles (dots, full,
    tables), the table inputs of "tables", and two (K, m) f32 planes per
    tile stored; six bf16 products of (K, K) by (K, m) per tile on the
    tensor cores; about 8 f32 flops per stored value in the rotation and
    the convolution."""
    W = m + 2 * pad
    out = 2 * nt * K * m * 4
    c0, tiles = nt * 2 * W * 4, 2 * nt * K * K * 2
    tc, f32 = 12 * nt * K * K * m, 8 * 2 * nt * K * m
    return {"store": bound(out),
            "dots": bound(tiles + out, 0, tc),
            "vpu": bound(c0 + out, f32),
            "full": bound(c0 + tiles + out, f32, tc),
            "tables": bound(c0 + tiles + out + 2 * K * W * (4 + 2), f32, tc)}


def kernel_parts(nt: int = 512, m: int = 4096, K: int = 128, pad: int = 64,
                 variants=_kparts.VARIANTS, seed: int = 0, reps: int = 3,
                 device=None) -> dict:
    """Run each probe of K1's parts on the card at (nt tiles of K samples,
    m bins, PAD = pad) — the script's shapes by default; nt = 512 stores
    2 GiB per call — and time it between CUDA events after one warm-up.

    Returns {variant: {"ms": per call, "us_per_tile": ms*1e3/nt,
    "stored_gbs": output bytes per second / 1e9, "finite": whether both
    planes are finite}}.  Needs a CUDA device: the probes measure the card.
    """
    device = torch.device(device if device is not None else "cuda")
    if device.type != "cuda":
        raise RuntimeError(f"kernel_parts times the card's kernels; got {device}")
    p = _kparts.probe_inputs(nt, m, K, pad, seed, device)
    stored = 2 * nt * K * m * 4
    out = {}
    for v in variants:
        o1, o2 = _kparts.kparts(v, p)
        finite = bool(torch.isfinite(o1).all() and torch.isfinite(o2).all())
        del o1, o2
        ms = wall_time(lambda: _kparts.kparts(v, p), reps, warmup=0)
        out[v] = {"ms": ms, "us_per_tile": ms * 1e3 / nt,
                  "stored_gbs": stored / ms / 1e6, "finite": finite}
    return out
