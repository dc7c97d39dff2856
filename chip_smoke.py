#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path once on one GPU and check it.

    python3 chip_smoke.py          # from the repository root, one CUDA card
    python3 chip_smoke.py --cards 4   # the sharded programs over 4 cards

The second form runs only the sharded programs, one NCCL rank per card,
on the meshes of ``CARD_MESHES`` against float64 and the unsharded call,
and graphed (each rank's body with its NCCL collectives in its graphs)
against eager, bit for bit on every rank; times the flagship spectra on 4
cards, graphed and eager, beside one; and runs the CLI's ``--mesh 1x4x1``
under torchrun against the one-card CLI.  The first form:

Phases, each of which raises on failure (the script then exits non-zero):

  1. device    require CUDA; print the card's name and power limit, the
               torch version and both TF32 flags;
  2. build     build the kernels from sdft_tpu_torch/kernels/csrc;
  3. main path, in six parts, each with the launch counts set to 0 just
               before it and read just after:
     a. spectra ``sdft``/``sdft_power`` at the flagship size (m = 4096,
               Hann, float32, two chained 16384-sample blocks) and at
               m = 1000 for all four windows with latency 0.5 and a ROI;
               ``isdft`` and ``roundtrip`` with a low-pass transform;
               a ragged (3, 8229) channel batch at m = 4096, channels at
               different offsets, through ``sdft`` (packed, planar bf16),
               ``sdft_power`` and ``roundtrip(transform)``, each cached
               call one K1 launch and one carry launch (its prologue's
               graph replayed), against
               float64 and the per-channel calls;
               ``roundtrip_hopped(hop=1)`` at m = 1000 over 4 blocks of
               8000 samples, and over 2 blocks of 2 channels x 4000 (one
               K2 and one carry launch per block); K1 at m = 1000 on a
               ragged 2-channel batch in every store form, each call one
               launch, paced (``kernels.spectra.PACED_LAUNCHES``) in the
               paced forms, held to the plain version and, paced, bit for
               bit to the unpaced launch.
               K1, K2 and the carry kernel must have been launched;
     b. driver ``roundtrip`` without a transform (the collapsed LTI form)
               at the flagship size; with ``mxu="split4"`` at m = 4096 on
               1 x 65536 and 8 x 32768 (within 5e-4 of float64, unequal
               to the exact FP32 y, each split product of its trace a
               split_mm launch in an SGEMM's place), ``split_mm`` on the
               card against its plain version on the 8 x 32768 block's
               totals product, and the split4 driver at m = 1000, hop = 100
               (hop spectra and state bit for bit the exact plan's, its
               split synthesis two split_mm launches beside the exact
               totals); with ``mxu="high"`` (the three-pass class): bit
               for bit the exact plan where the JAX package pins HIGHEST
               (``sdft`` packed and planar, ``sdft_power``, the hop=1
               chain, ``refresh``, ``isdft``, none launching split_mm),
               the collapsed round trip at m = 4096 on 1 x 65536 and 8 x
               32768 (within 1e-4 of float64), the driver at m = 1000, hop
               = 100 over 4 blocks of 16000 (hop spectra within 2e-6,
               samples 1e-4) and ``sdft_hopped`` (2e-6), each unequal to
               the exact plan and each split product a split_mm launch
               (three per block, one for ``sdft_hopped``), no TF32 kernel;
               ``roundtrip_hopped`` at m = 1000 with
               hop = 100 over 4 blocks of 16000 and hop = 4 over 4 blocks
               of 4000; ``sdft_hopped`` at hop = 100; the CLI in-process on
               an 8 s, 44100 Hz WAV (m = 1000, hop = 100, hann, latency 1),
               in float64 and with --fd32; ``profiling.kernel_parts``, the
               five probes of K1's parts at m = 4096, K = 128, PAD = 64 and
               512 tiles.  The probe kernel must have been launched, for
               both TPU functions it ports, and split_mm;
     c. stream ``Streamer.run`` over 16 blocks of 65536 at m = 4096 (the
               collapsed path) against a chain of ``roundtrip``, and
               checkpoint after block 8 + ``restore``; ``run`` over 4
               blocks of 8192 with a mask on packed spectra (K1) beside
               the same mask fused; ``run_hopped`` at m = 1000, hop = 100
               (blocks of 16000, chain 8) and hop = 1 (blocks of 8000, K2)
               against ``roundtrip_hopped``; the float32x2 tier at m =
               4096 on two chained blocks of 8192; ``SDFT`` on the card
               against the CPU; ``STFT`` against numpy framing and
               ``np.fft.rfft``, and its WOLA interior.  K1 and K2 must
               have been launched, and the carry kernel;
     d. sharded the seven programs of ``sdft_tpu_torch.parallel`` on a
               one-rank NCCL mesh (1x1x1) of a process group of their own:
               ``sharded_sdft_pallas`` (one K1 launch per time shard) at
               m = 4096 on 1 x 65536 planar f32 and on 8 x 32768 (peak
               memory gated);
               ``sharded_sdft``, dispatching to K1 and forced onto the
               scan form (1 x 16384); ``sharded_roundtrip`` (collapsed)
               and ``sharded_isdft``; ``sharded_roundtrip_hopped`` and
               ``sharded_sdft_hopped`` at m = 1000, hop = 100 (8 blocks of
               16000); ``sharded_roundtrip_pallas`` (one K2 launch per
               time shard) over 4 chained blocks of 8000, run twice and
               held bit for bit, and on 2 channels x 8000;
               the CLI with ``--mesh 1x1x1 --fd32``.  Each is held against
               its unsharded counterpart and float64.  Then every program
               graphed (each rank's body a graph replay, K1/K2 launched
               after it) against its eager run under ``graphs.disabled()``,
               bit for bit, with one K1 or K2 launch per time shard per
               cached call; the sharded driver chain's profiler trace (one
               copy of a block's spectra per block, into the stack); a warm
               graphed ``sharded_sdft_pallas`` and one warm
               ``sharded_roundtrip_hopped`` block under
               ``set_sync_debug_mode("error")``.  K1 must have been
               launched by ``sharded_sdft_pallas`` and K2 by
               ``sharded_roundtrip_pallas``, and the carry kernel;
     e. tools  ``bench --mesh 1x1x1`` inside part d's group (its JSON line,
               value > 0); ``bench 4096 16384 3`` (both rows positive, the
               scan-form row through K2, every roofline share <= 1.05);
               ``trace`` over the CLI at m = 1000, hop = 1, --fd32 on part
               b's WAV (the trace parses and holds K2, the outputs equal an
               untraced run's bit for bit); each ``examples/*_torch.py`` on
               the card (``analysis_torch`` through K1); and
               ``scripts/crosscheck_torch.py`` at m = 1000, hop = 100,
               --fd32 against the native oracle, in a subprocess.  K1, K2
               and the carry kernel must have been launched;
     f. graphs every graphed path (``sdft_tpu_torch.graphs``: ``sdft``
               in every K1 store form at m = 4096 (planar f32 and bf16 on
               65536, the 8 x 32768 batch, packed f32 and both power forms
               on 16384) and ``roundtrip(low-pass)`` on 8 x 4096, each a
               replay of the prologue's graph and one K1 launch; the
               collapsed round trip at 1 x 65536 and 8 x 32768, exact,
               "high" and split4, the driver chain at hop = 100 (exact,
               "high" and split4), 4 (exact and "high") and 1 (a prologue
               graph per block and
               one K2 launch into the stacked outputs), mono and channel
               batches of 2 and 8, K2's fused round trip, ``sdft_hopped``
               (exact and "high"), ``roundtrip_hopped_block`` and
               ``refresh``) against its eager run under
               ``graphs.disabled()``, bit for bit; three calls on one graph
               leave the first call's outputs as they were; each cached
               call adds its K1, K2 and split_mm launches to the counts; peak memory graphed and eager, each graph's capture
               time and pool bytes; the profiler trace of each hop=1 chain
               (one K2 kernel per block, no device-to-device copy as large
               as a block's spectra); a warm graphed ``sdft`` and chain
               block under ``set_sync_debug_mode("error")``, and the
               synchronising calls of an eager ``sdft`` ("warn").  K1, K2,
               split_mm and the carry kernel must have been launched.  (Parts a-e run the
               graphs too: they are the default on the card.)
     Every result is held against the float64 ``ops`` path on the card;
  4. kernels   each kernel against its plain PyTorch version on the same
               inputs, at the main path's shapes; K1 and K2 also on part
               a's ragged C = 3 batch (one launch each), each channel of
               the launch bit for bit a C = 1 launch on its slice of the
               same prologue; the five probes also at a
               ragged shape (37 tiles, m = 1000) that the persistent grid
               does not divide; split_mm at every shape of the main path
               (``profiling.SPLIT_MM_SHAPES``) with three and four
               products, within 2e-6 of scale, ``out`` accumulated bit for
               bit, its own split bit for bit ``split_mask``'s; the carry
               kernel (``kernels.carry.launch_carry``) against
               ``ops.carry.carry`` at 8 x 44100, m = 1000, at 1 x 65536,
               m = 4096 and on part a's ragged C = 3 batch at m = 4096 and
               1000, channels at different offsets, one launch each: deltas,
               delayline and offset bit for bit, c0 and the end
               accumulator within 4 * eps32 * samples;
  5. timings   device times (torch.profiler) of each kernel and its plain
               version at m = 4096 on 65536-sample blocks (K1, all five
               store forms, each beside the bytes it moves, its bound and
               its share of the bound), m = 1000 on 8000-sample blocks (K2)
               and the five probes at 512 tiles (CUDA events), each beside
               its bound and its share of it; torch.stft at hop 1 beside K1
               (its library yardstick, held against K1's spectra); ``sdft``
               on 8 channels of 32768 (one launch; device, wall, peak
               memory), its prologue and K1 beside the bound, the plain
               version and torch.stft on the same batch; K1 planar f32 on
               the spectra cell's 8 x 44100 at m = 1000, paced (one paced
               launch, held to the plain version and bit for bit to the
               unpaced launch), beside its bound, the unpaced launch and
               the plain version (``k1_spectra_cell`` in the kernels line);
               K2 on 8 channels of 8000 and 8 x 44100 at m = 1000 beside
               its bound; the
               collapsed round trip for k_tile in {128, 256, 512, 1024} at
               m = 4096 on 65536-sample blocks and on 8 channels of 32768,
               exact FP32, "high" and split4, each with its error against
               float64, and one block of each by kind (split_mm, cuBLAS
               GEMMs, the rest) with its wall time; split_mm at every
               shape of the main path beside its bound, its plain version,
               cuBLAS's bf16 GEMMs summed the same way and torch.mm in
               FP32; the hop = 100 driver on 4000- and
               16000-sample blocks with its device idle share; wall
               times (CUDA events) of the public calls; ``Streamer.run``
               against a sequential loop, on the collapsed round trip
               (host-bound) and on 8 x 16384 through K1 with a packed
               transform (device-bound), and ``run_hopped`` against its
               per-block loop (host clock, in turns, median and range);
               the float32x2 tier's two legs beside float64 ``ops``, with
               their peak device memory; each sharded program of part d,
               graphed and eager, beside its unsharded call (wall, device,
               idle share, host enqueue time, peak memory, in turns), the
               flagship K1 program's device time by kernel, and the host
               time of the DTensor steps around the graphs; part f's
               cells eager against graphed in turns (wall, device, idle
               and host enqueue time per block; the flagship
               ``sdft`` planar f32 and bf16, the 8 x 32768 batch and the
               hop=1 chain on 8 blocks of 8 channels x 8000 among them),
               ``Streamer.run`` and ``run_hopped``
               eager against graphed, and the ``bench 4096 16384 3`` rows
               eager against graphed; the carry kernel at 8 x 44100,
               m = 1000 and at 1 x 65536, m = 4096 beside its bound (the
               totals' FP32 flops over 67 TFLOP/s, or its bytes once),
               its plain version and the graphed prologue.

The line before the last is a JSON summary of the kernels; the last line is
{"ok": true, "device": {...}}.  Inputs are made from a fixed seed.
"""

from __future__ import annotations

import contextlib
import json
import pathlib
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from sdft_tpu_torch.profiling import (K1_FLOPS_PER_BIN, K2_FLOPS_PER_BIN, bound,
                                      device_time, wall_time)

SEED = 0
ROOT = pathlib.Path(__file__).resolve().parent


def require_cuda() -> str:
    if not torch.cuda.is_available():
        raise RuntimeError("chip_smoke.py needs a CUDA device "
                           "(torch.cuda.is_available() is False)")
    if not (ROOT / "sdft_tpu_torch" / "kernels" / "csrc").is_dir():
        raise RuntimeError(f"sdft_tpu_torch not found beside {__file__}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    return smi.splitlines()[0]


def host_signal(n: int, seed: int, scale: float = 1.0) -> np.ndarray:
    x = (np.random.default_rng(seed).standard_normal(n) * scale).clip(-1, 1)
    return x.astype(np.float32)


def signal(n: int, seed: int, device) -> torch.Tensor:
    return torch.as_tensor(host_signal(n, seed), device=device)


def maxerr(a, b) -> float:
    def wide(t):
        return t.to(torch.complex128) if t.is_complex() else t.double()
    return (wide(a) - wide(b)).abs().max().item()


def gate(name: str, err: float, limit: float) -> None:
    print(f"  {name}: {err:.3e} (limit {limit:.3e})", flush=True)
    if not err <= limit:
        raise AssertionError(f"{name}: error {err:.3e} exceeds {limit:.3e}")


def planar_complex(re, im):
    return torch.complex(re.double(), im.double())


def f64(plan):
    from sdft_tpu_torch import Precision

    return plan.with_(precision=Precision("float64", "float64"))


def lowpass(z):
    """The round trips' transform: keep the lowest quarter of the bins."""
    keep = (torch.arange(z.shape[-1], device=z.device) < z.shape[-1] // 4)
    return z * keep.to(z.real.dtype)


def main_path(T, dev) -> dict:
    """Phase 3: the port's public entry points, held against float64."""
    errs = {}
    eps32 = float(np.finfo(np.float32).eps)

    # -- K1 at the flagship size: two chained blocks, every output form
    m, M = 4096, 16384
    plan = T.Plan(m, window="hann", precision=T.FAST_PRECISION)
    p64 = f64(plan)
    x = signal(2 * M, SEED, dev)
    st, st64 = T.init_state(plan, device=dev), T.init_state(p64, device=dev)
    for b in range(2):
        blk = x[b * M:(b + 1) * M]
        st_in = st
        st, packed = T.sdft(plan, st_in, blk)
        _, (re, im) = T.sdft(plan, st_in, blk, layout="planar")
        _, (re16, im16) = T.sdft(plan, st_in, blk, "planar", "bfloat16")
        _, pw16 = T.sdft_power(plan, st_in, blk, "bfloat16")
        _, pw = T.sdft_power(plan, st_in, blk)
        st64, ref = T.sdft(p64, st64, blk)
        want = torch.complex(ref[..., 0], ref[..., 1])
        scale = want.abs().max().item()
        got = torch.complex(packed[..., 0].double(), packed[..., 1].double())
        print(f"K1 m={m} block {b}: spectrum scale {scale:.4e}", flush=True)
        # f32 propagation class of the JAX package's on-chip gate
        # (tests/test_tpu.py:315-316), bf16 rounding class (:324-325)
        gate("sdft packed f32 vs f64 / scale", maxerr(got, want) / scale, 3e-6)
        gate("sdft planar f32 vs f64 / scale",
             (planar_complex(re, im) - want).abs().max().item() / scale, 3e-6)
        gate("sdft planar bf16 vs f64 / scale",
             (planar_complex(re16, im16) - want).abs().max().item() / scale, 8e-3)
        p_want = want.abs() ** 2
        # |d|^2 doubles the relative error of d
        gate("sdft_power f32 vs f64 / scale^2", maxerr(pw, p_want) / scale**2, 6e-6)
        gate("sdft_power bf16 vs f64 / scale^2",
             maxerr(pw16.float(), p_want) / scale**2, 1.6e-2)
        errs.setdefault("k1_rel", 0.0)
        errs["k1_rel"] = max(errs["k1_rel"], maxerr(got, want) / scale)
    # carried accumulator: any summation order of the 2M unit-bounded terms
    # (tests/test_pallas_kernels.py:54-58)
    gate("carried accumulator vs f64", maxerr(st.accumulator, st64.accumulator),
         4 * eps32 * 2 * M)
    if int(st.offset) != int(st64.offset):
        raise AssertionError("offset mismatch")

    # -- round trip: isdft of the kernel's spectra, roundtrip(transform)
    y = T.isdft(plan, packed)
    y64 = T.isdft(p64, ref)
    gate("isdft of K1 spectra vs f64 (abs)", maxerr(y, y64), 1e-4)

    blk = x[:M]
    _, yt = T.roundtrip(plan, T.init_state(plan, device=dev), blk, lowpass)
    _, yt64 = T.roundtrip(p64, T.init_state(p64, device=dev), blk, lowpass)
    gate("roundtrip(low-pass) vs f64 (abs)", maxerr(yt, yt64), 1e-4)
    errs["roundtrip_abs"] = maxerr(yt, yt64)

    # -- K1 at m = 1000, every window, latency 0.5 and a ROI
    m, M = 1000, 8000
    for window in ("boxcar", "hann", "hamming", "blackman"):
        plan = T.Plan(m, window=window, latency=0.5, roi=(7, 901),
                      precision=T.FAST_PRECISION)
        p64 = f64(plan)
        xs = signal(M + 1234, SEED + 1, dev)
        st, _ = T.sdft(plan, T.init_state(plan, device=dev), xs[:1234])
        st64, _ = T.sdft(p64, T.init_state(p64, device=dev), xs[:1234])
        _, got = T.sdft(plan, st, xs[1234:])
        _, ref = T.sdft(p64, st64, xs[1234:])
        scale = ref.abs().max().item()
        gate(f"sdft m={m} {window} latency 0.5 roi vs f64 / scale",
             maxerr(got, ref) / scale, 3e-6)

    errs["k1_paced"] = paced_path(T, dev)
    errs.update(batch_path(T, dev))

    # -- K2: the hop=1 driver chain
    m, B, nb = 1000, 8000, 4
    plan = T.Plan(m, window="hann", precision=T.FAST_PRECISION)
    p64 = f64(plan)
    xs = signal(nb * B, SEED + 2, dev).reshape(nb, B)
    st, hd, ys = T.roundtrip_hopped(plan, T.init_state(plan, device=dev), xs, 1,
                                    refresh_every=1)
    st64, hd64, ys64 = T.roundtrip_hopped(p64, T.init_state(p64, device=dev),
                                          xs, 1, refresh_every=1)
    if tuple(hd.shape) != (nb, B, m, 2) or tuple(ys.shape) != (nb, B):
        raise AssertionError(f"hop=1 shapes {tuple(hd.shape)} {tuple(ys.shape)}")
    scale = hd64.abs().max().item()
    # the JAX hop=1 route's class (tests/test_tpu.py:411-417)
    gate("roundtrip_hopped(hop=1) spectra vs f64 / scale",
         maxerr(hd, hd64) / scale, 1.5e-5)
    gate("roundtrip_hopped(hop=1) samples vs f64 (abs)", maxerr(ys, ys64), 1e-4)
    errs["hop1_rel"] = maxerr(hd, hd64) / scale
    errs["hop1_y_abs"] = maxerr(ys, ys64)
    for name, t in (("spectra", hd), ("samples", ys), ("accumulator", st.accumulator)):
        if not torch.isfinite(t).all():
            raise AssertionError(f"hop=1 {name} not finite")
    return errs


def paced_path(T, dev) -> float:
    """Part a, K1 at m = 1000, where every store form's rows split 256-byte
    units: each cached ``sdft``/``sdft_power`` call on a ragged 2-channel
    batch is one K1 launch, paced (``PACED_LAUNCHES``) exactly in the paced
    forms (``kernels.spectra.paced``); every form on that batch's prologue
    held to the plain version (``hold_k1``), and each paced form equal bit
    for bit to its unpaced launch.  Returns the f32 forms' largest
    error."""
    from sdft_tpu_torch.kernels import spectra as S

    plan = T.Plan(1000, window="hann", precision=T.FAST_PRECISION)
    C, M = 2, 4000 + 37
    x = signal(C * M, SEED + 47, dev).reshape(C, M)
    st = T.init_state(plan, channels=C, device=dev)
    calls = {("packed", "float32"): lambda: T.sdft(plan, st, x),
             ("planar", "float32"): lambda: T.sdft(plan, st, x, "planar"),
             ("planar", "bfloat16"): lambda: T.sdft(plan, st, x, "planar", "bfloat16"),
             ("power", "float32"): lambda: T.sdft_power(plan, st, x),
             ("power", "bfloat16"): lambda: T.sdft_power(plan, st, x, "bfloat16")}
    paced = [f for f in calls if S.paced(1000, *f)]
    if not paced:
        raise AssertionError("no store form is paced at m = 1000")
    for f, call in calls.items():
        call()    # the first call captures the prologue's graph
        n, p = S.LAUNCHES, S.PACED_LAUNCHES
        call()
        if (S.LAUNCHES - n, S.PACED_LAUNCHES - p) != (1, int(f in paced)):
            raise AssertionError(f"{' '.join(f)} m=1000 {C}x{M}: {S.LAUNCHES - n} K1 launches, "
                                 f"{S.PACED_LAUNCHES - p} paced; expected 1 and {int(f in paced)}")
    pro = S.spectra_prologue(plan, st, x)
    p = S.PACED_LAUNCHES
    err = hold_k1(S, plan, pro, f" m=1000 {C}x{M}")
    if S.PACED_LAUNCHES - p != len(paced) * (C + 1):
        raise AssertionError(f"K1 m=1000: {S.PACED_LAUNCHES - p} paced launches in hold_k1, "
                             f"expected {len(paced) * (C + 1)}")
    with pacing(S, False):
        unpaced = {f: S.launch_spectra(plan, pro, *f) for f in paced}
    for f, want in unpaced.items():
        got = S.launch_spectra(plan, pro, *f)
        if not all(torch.equal(a, b) for a, b in zip(
                got if isinstance(got, tuple) else (got,),
                want if isinstance(want, tuple) else (want,))):
            raise AssertionError(f"K1 {' '.join(f)} m=1000: paced differs from unpaced")
    print(f"  K1 m=1000 {C}x{M}: paced in {', '.join(' '.join(f) for f in paced)}, each bit "
          f"for bit its unpaced launch (kernels.spectra.paced_launches {S.PACED_LAUNCHES} of "
          f"{S.LAUNCHES} launches)", flush=True)
    return err


@contextlib.contextmanager
def pacing(S, on: bool):
    """``kernels.spectra.paced`` forced to ``on`` inside the block."""
    rule, S.paced = S.paced, lambda *args: on
    try:
        yield
    finally:
        S.paced = rule


def desynchronized(T, plan, C: int, dev):
    """A batched state whose channels sit at different offsets (channel c
    has run 300 + 700*c samples of one seeded lead-in), and its channels."""
    from sdft_tpu_torch.state import stack_states

    lead = signal(300 + 700 * C, SEED + 41, dev)
    sts = [T.sdft(plan, T.init_state(plan, device=dev), lead[:300 + 700 * c])[0]
           for c in range(C)]
    return stack_states(sts), sts


#: part a's channel batch: ragged (no multiple of the 128-sample tile)
BATCH_C, BATCH_M = 3, 8192 + 37


def batch_path(T, dev) -> dict:
    """Part a, the channel axis: ``sdft`` (packed f32, planar bf16),
    ``sdft_power`` and ``roundtrip(low-pass)`` on a (3, 8229) batch at
    m = 4096 whose channels sit at different offsets, each cached call
    exactly one K1 and one carry launch; held against float64 at the gates above and against the
    per-channel calls at the f32 class (2e-6 of scale, |d|^2 4e-6 of
    scale^2, samples 1e-5); then the hop=1 chain on 2 blocks of 2 channels
    x 4000 at m = 1000, one K2 launch per block of a cached call, against
    float64."""
    from sdft_tpu_torch.kernels import carry as F, scan as Q, spectra as S

    errs = {}
    eps32 = float(np.finfo(np.float32).eps)
    m, C, M = 4096, BATCH_C, BATCH_M
    plan = T.Plan(m, window="hann", precision=T.FAST_PRECISION)
    p64 = f64(plan)
    stb, sts = desynchronized(T, plan, C, dev)
    stb64, _ = desynchronized(T, p64, C, dev)
    xb = signal(C * M, SEED + 42, dev).reshape(C, M)

    calls = {"sdft packed f32": lambda p, st, x: T.sdft(p, st, x),
             "sdft planar bf16": lambda p, st, x: T.sdft(p, st, x, "planar", "bfloat16"),
             "sdft_power f32": lambda p, st, x: T.sdft_power(p, st, x),
             "roundtrip(low-pass)": lambda p, st, x: T.roundtrip(p, st, x, lowpass)}
    st64, ref = T.sdft(p64, stb64, xb)
    want = torch.complex(ref[..., 0], ref[..., 1])
    scale = want.abs().max().item()
    del ref
    for name, call in calls.items():
        call(plan, stb, xb)    # the first call captures the prologue's graph
        k1, f = S.LAUNCHES, F.LAUNCHES
        st, out = call(plan, stb, xb)
        torch.cuda.synchronize()
        if (S.LAUNCHES - k1, F.LAUNCHES - f) != (1, 1):
            raise AssertionError(f"{name} on a {C} x {M} batch: {S.LAUNCHES - k1} K1 and "
                                 f"{F.LAUNCHES - f} carry launches, expected one each (a "
                                 "cached call)")
        if name == "sdft packed f32":
            e = maxerr(torch.complex(out[..., 0].double(), out[..., 1].double()), want) / scale
            gate(f"{name} {C}x{M} m={m} (one launch) vs f64 / scale", e, 3e-6)
            errs["batch_k1_rel"] = e
            gate(f"{name} batch accumulator vs f64", maxerr(st.accumulator, st64.accumulator),
                 4 * eps32 * (M + 300 + 700 * C))
        elif name == "sdft planar bf16":
            gate(f"{name} {C}x{M} vs f64 / scale",
                 (planar_complex(*out) - want).abs().max().item() / scale, 8e-3)
        elif name == "sdft_power f32":
            gate(f"{name} {C}x{M} vs f64 / scale^2", maxerr(out, want.abs() ** 2) / scale**2,
                 6e-6)
        else:
            _, y64 = T.roundtrip(p64, stb64, xb, lowpass)
            gate(f"{name} {C}x{M} vs f64 (abs)", maxerr(out, y64), 1e-4)
        for c in range(C):
            sc, oc = call(plan, sts[c], xb[c])
            if name == "sdft packed f32":
                gate(f"{name} channel {c} (offset {int(sts[c].offset)}) vs its own call / scale",
                     maxerr(out[c], oc) / scale, 2e-6)
                gate(f"{name} channel {c} accumulator vs its own call",
                     maxerr(st.accumulator[c], sc.accumulator), 4 * eps32 * (M + 300 + 700 * C))
            elif name == "sdft_power f32":
                gate(f"{name} channel {c} vs its own call / scale^2",
                     maxerr(out[c], oc) / scale**2, 4e-6)
            elif name == "roundtrip(low-pass)":
                gate(f"{name} channel {c} vs its own call (abs)", maxerr(out[c], oc), 1e-5)
        del out
    del want

    # the hop=1 chain on a channel batch: one K2 launch per block
    m, C2, B, nb = 1000, 2, 4000, 2
    plan = T.Plan(m, window="hann", precision=T.FAST_PRECISION)
    p64 = f64(plan)
    xs = signal(nb * C2 * B, SEED + 43, dev).reshape(nb, C2, B)
    st0 = T.init_state(plan, channels=C2, device=dev)
    T.roundtrip_hopped(plan, st0, xs, 1)
    q, f = Q.LAUNCHES, F.LAUNCHES
    _, hd, ys = T.roundtrip_hopped(plan, st0, xs, 1)
    torch.cuda.synchronize()
    if (Q.LAUNCHES - q, F.LAUNCHES - f) != (nb, nb):
        raise AssertionError(f"hop=1 chain {nb}x{C2}x{B}: {Q.LAUNCHES - q} K2 and "
                             f"{F.LAUNCHES - f} carry launches, expected {nb} each (one per "
                             "block)")
    _, hd64, ys64 = T.roundtrip_hopped(p64, T.init_state(p64, channels=C2, device=dev), xs, 1)
    scale = hd64.abs().max().item()
    gate(f"roundtrip_hopped(hop=1) {nb}x{C2}x{B} (one K2 launch per block) spectra vs f64 "
         "/ scale", maxerr(hd, hd64) / scale, 1.5e-5)
    gate(f"roundtrip_hopped(hop=1) {nb}x{C2}x{B} samples vs f64 (abs)", maxerr(ys, ys64), 1e-4)
    errs["batch_hop1_rel"] = maxerr(hd, hd64) / scale
    return errs


def driver_path(T, dev) -> dict:
    """Phase 3b: the collapsed round trip, the driver protocol at hop > 1,
    the hopped analysis, the CLI and the probes of K1's parts.  The CLI's
    outputs come back under "cli" ({tag: (wav samples, .dft)})."""
    from sdft_tpu_torch import cli, profiling
    from sdft_tpu_torch.io.dump import load_complex
    from sdft_tpu_torch.io.wav import read_wav

    errs = {}
    # -- roundtrip without a transform at the flagship size: two chained
    # blocks against sdft + isdft in float64 (tests/test_tpu.py:340); the
    # state must be the one sdft leaves (offset exact, accumulator within
    # the f32 random-walk class of tests/test_tpu.py:113)
    m, M = 4096, 16384
    plan = T.Plan(m, window="hann", precision=T.FAST_PRECISION)
    p64 = f64(plan)
    x = signal(2 * M, SEED + 10, dev)
    st, st_k1, st64 = (T.init_state(plan, device=dev), T.init_state(plan, device=dev),
                       T.init_state(p64, device=dev))
    for b in range(2):
        blk = x[b * M:(b + 1) * M]
        st, y = T.roundtrip(plan, st, blk)
        st_k1, _ = T.sdft(plan, st_k1, blk)
        st64, d64 = T.sdft(p64, st64, blk)
        err = maxerr(y, T.isdft(p64, d64))
        gate(f"roundtrip (collapsed) m={m} block {b} vs f64 sdft+isdft (abs)", err, 2e-5)
        errs["lti_abs"] = max(errs.get("lti_abs", 0.0), err)
    if int(st.offset) != int(st_k1.offset):
        raise AssertionError("roundtrip offset differs from sdft's")
    gate("roundtrip state vs sdft state, accumulator (abs)",
         maxerr(st.accumulator, st_k1.accumulator), 1e-3)
    del d64
    errs.update(split4_path(T, dev))
    errs.update(high_path(T, dev))

    # -- the driver protocol at hop > 1 (tests/test_tpu.py:274-275) and the
    # hopped analysis (:149), against the full-rate f64 spectra
    m = 1000
    plan = T.Plan(m, window="hann", precision=T.FAST_PRECISION)
    p64 = f64(plan)
    for hop, B in ((100, 16000), (4, 4000)):
        xs = signal(4 * B, SEED + 11 + hop, dev).reshape(4, B)
        st, hd, ys = T.roundtrip_hopped(plan, T.init_state(plan, device=dev), xs, hop)
        _, d64 = T.sdft(p64, T.init_state(p64, device=dev), xs.reshape(-1))
        if tuple(hd.shape) != (4, B // hop, m, 2) or tuple(ys.shape) != (4, B):
            raise AssertionError(f"hop={hop} shapes {tuple(hd.shape)} {tuple(ys.shape)}")
        for name, t in (("spectra", hd), ("samples", ys), ("accumulator", st.accumulator)):
            if not torch.isfinite(t).all():
                raise AssertionError(f"hop={hop} {name} not finite")
        e_d = maxerr(hd.reshape(-1, m, 2), d64[::hop])
        e_y = maxerr(ys.reshape(-1), T.isdft(p64, d64))
        gate(f"roundtrip_hopped(hop={hop}) m={m} B={B} spectra vs f64 (abs)", e_d, 2e-7)
        gate(f"roundtrip_hopped(hop={hop}) m={m} B={B} samples vs f64 (abs)", e_y, 1e-4)
        errs[f"hop{hop}_abs"] = (e_d, e_y)
        if hop == 100:
            _, hs = T.sdft_hopped(plan, T.init_state(plan, device=dev), xs.reshape(-1), hop)
            gate(f"sdft_hopped(hop={hop}) m={m} vs f64 (abs)", maxerr(hs, d64[::hop]), 1e-7)
        del d64

    # -- the CLI, in-process on the card: float64, then --fd32 held against
    # it at the driver's gates
    with tempfile.TemporaryDirectory() as tmp:
        src = cli_wav(tmp)
        outs = {}
        for tag, extra in (("f64", []), ("fd32", ["--fd32"])):
            args = ["1000", "100", "hann", "1", src, f"{tmp}/{tag}.wav", f"{tmp}/{tag}.dft"]
            if cli.main(args + extra) != 0:
                raise AssertionError(f"cli {tag} failed")
            outs[tag] = (read_wav(f"{tmp}/{tag}.wav")[0], load_complex(f"{tmp}/{tag}.dft", 1000))
    (y64, d64), (y32, d32) = outs["f64"], outs["fd32"]
    if d64.shape != (8 * 44100 // 100, 1000) or y64.shape != (8 * 44100,):
        raise AssertionError(f"cli output shapes {d64.shape} {y64.shape}")
    gate("cli --fd32 vs float64 .dft (abs)", float(np.abs(d32 - d64).max()), 2e-7)
    gate("cli --fd32 vs float64 wav (abs)", float(np.abs(y32 - y64).max()), 1e-4)
    errs["cli"] = outs

    # -- the probes of K1's parts at the script's shapes, 512 tiles (2 GiB
    # stored per call, as K1's flagship block)
    parts = profiling.kernel_parts(nt=512, reps=2)
    for v, r in parts.items():
        print(f"  kernel_parts {v}: {r['ms']:.4f} ms ({r['us_per_tile']:.3f} us/tile, "
              f"{r['stored_gbs']:.1f} GB/s stored)", flush=True)
        if not r["finite"]:
            raise AssertionError(f"kernel_parts {v}: output not finite")
    return errs


SPLIT4 = dict(td="float32", fd="float32", mxu="split4")


def y64_of(T, plan, x) -> torch.Tensor:
    """The float64 sdft + isdft of (M,) or (C, M) samples from time zero,
    channel by channel (a float64 8 x 32768 batch would hold 17 GiB)."""
    p64 = f64(plan)
    rows = x[None] if x.ndim == 1 else x
    ys = []
    for row in rows:
        _, d64 = T.sdft(p64, T.init_state(p64, device=row.device), row)
        ys.append(T.isdft(p64, d64))
        del d64
    return ys[0] if x.ndim == 1 else torch.stack(ys)


def kernel_table(fn) -> dict:
    """{kernel name: (launches, device ms)} of one warm call of ``fn``
    (torch.profiler)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return {e.key: (e.count, e.self_device_time_total / 1e3) for e in prof.key_averages()
            if e.self_device_time_total > 0}


def is_gemm(name: str) -> bool:
    """A cuBLAS GEMM kernel (its split-K reduction left out)."""
    low = name.lower()
    return "splitkreduce" not in low and any(w in low for w in ("gemm", "nvjet", "xmma",
                                                                "cutlass"))


def is_split_mm(name: str) -> bool:
    """A kernel of ``kernels.split_mm`` (the products or their split-K sum)."""
    return "split_mm" in name


def matmul_ops(fn) -> int:
    """The float32 matmuls (aten mm, addmm, bmm, mv, dot) that one eager
    call of ``fn`` dispatches (torch.profiler, host side)."""
    from torch.profiler import ProfilerActivity, profile

    from sdft_tpu_torch import graphs

    names = {"aten::mm", "aten::addmm", "aten::bmm", "aten::mv", "aten::dot"}
    with graphs.disabled():
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            fn()
            torch.cuda.synchronize()
    return sum(e.count for e in prof.key_averages() if e.key in names)


def split_sites(label: str, fn, exact_fn, sites: int) -> None:
    """One warm (graphed) call's kernels: ``sites`` launches of the
    split_mm product kernel and no TF32 kernel; and, eagerly, ``sites``
    float32 matmuls fewer than the exact plan dispatches: each split
    product stands in one matmul's place, so none runs as an SGEMM or in
    TF32."""
    got, ref = kernel_table(fn), kernel_table(exact_fn)
    n = sum(c for k, (c, _) in got.items() if "split_mm_kernel" in k)
    g, ge = (sum(c for k, (c, _) in t.items() if is_gemm(k)) for t in (got, ref))
    ops, ops_e = matmul_ops(fn), matmul_ops(exact_fn)
    tf32 = [k for k in got if "tf32" in k.lower()]
    print(f"  {label}: split_mm launches {n} (expected {sites}); matmuls dispatched {ops} "
          f"against the exact plan's {ops_e}; cuBLAS GEMM kernels {g} against {ge}; "
          f"kernels: " + "; ".join(f"{k[:56]} x{c} {ms:.4f} ms" for k, (c, ms) in got.items()
                                   if is_gemm(k) or is_split_mm(k)), flush=True)
    if n != sites or ops_e - ops != sites or tf32:
        raise AssertionError(f"{label}: {n} split_mm launches, {ops_e - ops} matmuls fewer "
                             f"than the exact plan (both {sites} expected), TF32 kernels "
                             f"{tf32}")


def split4_path(T, dev) -> dict:
    """Part b, ``mxu="split4"``: the collapsed round trip at m = 4096 on
    1 x 65536 and 8 x 32768 against float64 (5e-4, the gate of PERF.md
    section 2) and unequal to the exact FP32 y; its trace (every split
    product a split_mm launch, with four products, none a float32 SGEMM);
    ``split_mm`` on the card against its plain version on the 8 x 32768
    block's totals product (2e-6 of scale); the driver at m = 1000, hop =
    100: hop spectra and state bit for bit the exact plan's, samples at the
    driver's 1e-4, its synthesis two split_mm launches."""
    from sdft_tpu_torch.kernels.split_mm import split_mm
    from sdft_tpu_torch.ops import lti

    errs = {}
    m = 4096
    p4 = T.Plan(m, window="hann", precision=T.Precision(**SPLIT4))
    pe = p4.with_(precision=T.FAST_PRECISION)
    x = signal(8 * 32768, SEED + 70, dev)
    for C, M in ((1, 65536), (8, 32768)):
        xx = x[:M] if C == 1 else x.reshape(C, M)
        ch = None if C == 1 else C
        y64 = y64_of(T, p4, xx)
        st4, y4 = T.roundtrip(p4, T.init_state(p4, channels=ch, device=dev), xx)
        ste, ye = T.roundtrip(pe, T.init_state(pe, channels=ch, device=dev), xx)
        err = maxerr(y4, y64)
        gate(f"split4 roundtrip (collapsed) m={m} {C}x{M} vs f64 sdft+isdft (abs)", err, 5e-4)
        diff = maxerr(y4, ye)
        acc = maxerr(st4.accumulator, ste.accumulator)
        print(f"  split4 against exact FP32 y: largest difference {diff:.3e} (exact FP32 vs "
              f"f64 {maxerr(ye, y64):.3e}); accumulators {acc:.3e}", flush=True)
        if diff == 0.0:
            raise AssertionError(f"split4 y equals the exact FP32 y at {C}x{M}: a no-op")
        errs[f"split4_C{C}_abs"] = err
        st = T.init_state(p4, channels=ch, device=dev)
        split_sites(f"split4 roundtrip {C}x{M}", lambda: T.roundtrip(p4, st, xx),
                    lambda: T.roundtrip(pe, st, xx), 3)
        del y64

    # split_mm on the card against its plain version: the totals product of
    # the 8 x 32768 block, (256 x 1024) comb deltas @ the (1024 x 8192) fine
    # table
    fine = lti._lti_consts_split_device(p4, 1024, dev)[0]
    xb = x.reshape(8, 32768)
    delta = xb.clone()
    delta[:, 2 * m:] -= xb[:, :-2 * m]
    a = delta.reshape(256, 1024)
    got = split_mm(a, fine, 4)
    want = split_mm(a.cpu(), fine.map(torch.Tensor.cpu), 4)
    gate("split4 split_mm (256x1024)@(1024x8192) card vs plain (of scale)",
         maxerr(got.cpu(), want) / want.abs().max().item(), 2e-6)

    # the driver: the synthesis split, the totals, carry and hop spectra exact
    m, hop, B = 1000, 100, 16000
    p4 = T.Plan(m, window="hann", precision=T.Precision(**SPLIT4))
    pe = p4.with_(precision=T.FAST_PRECISION)
    xs = signal(4 * B, SEED + 71, dev).reshape(4, B)
    s4, hd4, ys4 = T.roundtrip_hopped(p4, T.init_state(p4, device=dev), xs, hop)
    se, hde, yse = T.roundtrip_hopped(pe, T.init_state(pe, device=dev), xs, hop)
    same_carry = torch.equal(hd4, hde) and all(torch.equal(u, v) for u, v in zip(s4, se))
    print(f"  split4 roundtrip_hopped(hop={hop}) m={m}: hop spectra and state bit for bit "
          f"the exact plan's {same_carry}; samples differ {not torch.equal(ys4, yse)}",
          flush=True)
    if not same_carry:
        raise AssertionError("split4 driver: hop spectra or state differ from the exact plan's")
    if torch.equal(ys4, yse):
        raise AssertionError("split4 driver: samples equal the exact plan's: a no-op")
    err = maxerr(ys4.reshape(-1), y64_of(T, p4, xs.reshape(-1)))
    gate(f"split4 roundtrip_hopped(hop={hop}) m={m} B={B} samples vs f64 (abs)", err, 1e-4)
    errs["split4_hop100_abs"] = err
    st = T.init_state(p4, device=dev)
    split_sites(f"split4 roundtrip_hopped(hop={hop}) block",
                lambda: T.roundtrip_hopped(p4, st, xs[:1], hop),
                lambda: T.roundtrip_hopped(pe, st, xs[:1], hop), 2)
    return errs


HIGH = dict(td="float32", fd="float32", mxu="high")
#: shapes of the "high" checks (module constants, so a rehearsal on the CPU
#: can shrink them): the collapsed round trip's m and its two blocks, the
#: exact sites' block, the driver's m, hop and blocks
HIGH_M, HIGH_BLOCKS, HIGH_EXACT_BLOCK = 4096, ((1, 65536), (8, 32768)), 16384
HIGH_DRV_M, HIGH_HOP, HIGH_DRV_BLOCK, HIGH_K2_BLOCK = 1000, 100, 16000, 8000


def high_path(T, dev) -> dict:
    """Part b, ``mxu="high"`` (the three-pass split class).  Where the JAX
    package pins HIGHEST, a "high" plan is bit for bit the "highest" one's,
    and launches no split_mm: ``sdft`` packed and planar f32 and
    ``sdft_power`` at m = 4096 (K1's prologue), the hop=1 chain at m = 1000
    (K2), ``refresh`` and ``isdft``.  Where it reads ``mxu_precision``,
    against float64 and unequal to the exact plan: the collapsed round trip
    at m = 4096 on 1 x 65536 and 8 x 32768 (y <= 1e-4 abs), the driver at
    m = 1000, hop = 100 over 4 blocks of 16000 (hop spectra <= 2e-6 abs,
    samples <= 1e-4) and ``sdft_hopped`` on the same samples (<= 2e-6);
    each block's kernels (``split_sites``)."""
    from sdft_tpu_torch.kernels import split_mm as M

    errs = {}
    big = T.Plan(HIGH_M, window="hann", precision=T.Precision(**HIGH))
    drv = big.with_(dftsize=HIGH_DRV_M)
    bige, drve = (p.with_(precision=T.FAST_PRECISION) for p in (big, drv))
    x = signal(max(C * M_ for C, M_ in HIGH_BLOCKS), SEED + 80, dev)
    E, K2B = HIGH_EXACT_BLOCK, HIGH_K2_BLOCK
    d_exact = T.sdft(bige, T.init_state(bige, device=dev), x[:E])[1]

    def init(p, C=None):
        return T.init_state(p, channels=C, device=dev)

    exact_sites = {
        f"sdft packed f32 m={HIGH_M} {E}": (big, lambda p: T.sdft(p, init(p), x[:E])),
        f"sdft planar f32 m={HIGH_M} {E}": (big, lambda p: T.sdft(p, init(p), x[:E],
                                                                  "planar")),
        f"sdft_power f32 m={HIGH_M} {E}": (big, lambda p: T.sdft_power(p, init(p), x[:E])),
        f"roundtrip_hopped hop=1 (K2) m={HIGH_DRV_M} 2x{K2B}": (
            drv, lambda p: T.roundtrip_hopped(p, init(p), x[:2 * K2B].reshape(2, K2B), 1)),
        f"refresh m={HIGH_M}": (big, lambda p: T.refresh(p, T.sdft(p, init(p), x[:E])[0])),
        f"isdft m={HIGH_M} {E}": (big, lambda p: T.isdft(p, d_exact)),
    }
    for label, (p, call) in exact_sites.items():
        n0 = M.LAUNCHES
        got = call(p)
        launched = M.LAUNCHES - n0
        want = call(p.with_(precision=T.FAST_PRECISION))
        torch.cuda.synchronize()
        equal = same(got, want)
        print(f"  high {label}: bit for bit the highest plan's {equal}; split_mm launches "
              f"{launched} (expected 0)", flush=True)
        if not equal or launched:
            raise AssertionError(f"high {label}: differs from the exact plan or launched "
                                 f"split_mm where the JAX package is exact")
    del d_exact

    for C, M_ in HIGH_BLOCKS:
        xx = x[:M_] if C == 1 else x[:C * M_].reshape(C, M_)
        ch = None if C == 1 else C
        y64 = y64_of(T, big, xx)
        _, yh = T.roundtrip(big, init(big, ch), xx)
        _, ye = T.roundtrip(bige, init(bige, ch), xx)
        err = maxerr(yh, y64)
        gate(f"high roundtrip (collapsed) m={HIGH_M} {C}x{M_} vs f64 sdft+isdft (abs)", err,
             1e-4)
        print(f"  high against exact FP32 y: largest difference {maxerr(yh, ye):.3e} (exact "
              f"FP32 vs f64 {maxerr(ye, y64):.3e})", flush=True)
        if torch.equal(yh, ye):
            raise AssertionError(f"high y equals the exact FP32 y at {C}x{M_}: a no-op")
        errs[f"high_C{C}_abs"] = err
        st = init(big, ch)
        split_sites(f"high roundtrip {C}x{M_}", lambda: T.roundtrip(big, st, xx),
                    lambda: T.roundtrip(bige, st, xx), 3)
        del y64

    m, hop, B = HIGH_DRV_M, HIGH_HOP, HIGH_DRV_BLOCK
    p64 = f64(drv)
    xs = signal(4 * B, SEED + 81, dev).reshape(4, B)
    _, hdh, ysh = T.roundtrip_hopped(drv, init(drv), xs, hop)
    _, hde, yse = T.roundtrip_hopped(drve, init(drve), xs, hop)
    _, hs = T.sdft_hopped(drv, init(drv), xs.reshape(-1), hop)
    _, hse = T.sdft_hopped(drve, init(drve), xs.reshape(-1), hop)
    _, d64 = T.sdft(p64, init(p64), xs.reshape(-1))
    e_d = maxerr(hdh.reshape(-1, m, 2), d64[::hop])
    e_y = maxerr(ysh.reshape(-1), T.isdft(p64, d64))
    e_h = maxerr(hs, d64[::hop])
    gate(f"high roundtrip_hopped(hop={hop}) m={m} B={B} spectra vs f64 (abs)", e_d, 2e-6)
    gate(f"high roundtrip_hopped(hop={hop}) m={m} B={B} samples vs f64 (abs)", e_y, 1e-4)
    gate(f"high sdft_hopped(hop={hop}) m={m} vs f64 (abs)", e_h, 2e-6)
    if torch.equal(hdh, hde) or torch.equal(ysh, yse) or torch.equal(hs, hse):
        raise AssertionError("high driver or sdft_hopped equals the exact plan's: a no-op")
    errs["high_hop100_abs"] = (e_d, e_y, e_h)
    del d64
    st = init(drv)
    split_sites(f"high roundtrip_hopped(hop={hop}) block",
                lambda: T.roundtrip_hopped(drv, st, xs[:1], hop),
                lambda: T.roundtrip_hopped(drve, st, xs[:1], hop), 3)
    split_sites(f"high sdft_hopped(hop={hop}) {B}", lambda: T.sdft_hopped(drv, st, xs[0], hop),
                lambda: T.sdft_hopped(drve, st, xs[0], hop), 1)
    return errs


def cli_wav(tmp: str) -> str:
    """The CLI's input: 8 s of seeded noise at 44100 Hz, 24-bit."""
    from sdft_tpu_torch.io.wav import write_wav

    src = f"{tmp}/src.wav"
    rng = np.random.default_rng(SEED + 12)
    write_wav(src, (rng.standard_normal(8 * 44100).clip(-3, 3) / 3), 44100)
    return src


#: a probe shape the persistent grid does not divide: 37 tiles over 8 (store,
#: vpu: 16) blocks per span, and m = 1000 = 15 spans of 64 columns and one of 40
RAGGED_PROBE = dict(nt=37, m=1000, K=128, pad=64)


def probes_vs_plain(P, dev) -> dict:
    """Phase 4, the probes: each variant against its plain version on the
    same seeded inputs at 512 tiles, and at a ragged shape (RAGGED_PROBE).
    store and vpu 2e-6 abs; the products' f32 sums run in another order on
    the tensor cores, so dots, full and tables are held at 1e-5 of the
    products' size (the convolution cancels most of it in the output).
    Returns the errors at 512 tiles."""
    out = {}
    for tag, p in (("", P.probe_inputs(512, seed=SEED + 13, device=dev)),
                   (" ragged", P.probe_inputs(**RAGGED_PROBE, seed=SEED + 18, device=dev))):
        for v in P.VARIANTS:
            got = P.launch_kparts(v, p)
            want = P.kparts_reference(v, p)
            limit = 2e-6 if v in ("store", "vpu") else 1e-5 * P.product_scale(v, p)
            err = max(maxerr(g, w) for g, w in zip(got, want))
            gate(f"kparts {v}{tag} (nt={p.nt}, m={p.m}) vs plain (abs)", err, limit)
            if not tag:
                out[v] = err
            del got, want
    return out


def hold_k1(S, plan, pro, tag: str) -> float:
    """Every K1 store form on one prologue (a block or a batch: one launch)
    against the plain version; bf16 outputs against the plain version's
    float32 values: the kernel's plane must be that value rounded once to
    bf16 (at most 2^-8 relative), within the f32 gate.  With a batch, each
    channel of the launch must equal a C = 1 launch on that channel's slice
    of the same prologue bit for bit.  Returns the f32 forms' largest
    error."""
    k1 = 0.0
    channels = pro.lead[0] if len(pro.lead) == 2 else 0
    for form, dtype in S.STORES:
        before = S.LAUNCHES
        got = S.launch_spectra(plan, pro, form, dtype)
        if S.LAUNCHES - before != 1:
            raise AssertionError(f"K1 {form} {dtype}{tag}: {S.LAUNCHES - before} launches")
        want = S.spectra_reference(plan, pro, form, "float32")
        got = got if isinstance(got, tuple) else (got,)
        want = want if isinstance(want, tuple) else (want,)
        for g, w in zip(got, want):
            if dtype == "bfloat16":
                err = ((g.double() - w.double()).abs()
                       - 2.0**-8 * w.double().abs()).max().item()
                gate(f"K1 {form} {dtype}{tag} vs plain f32 (abs beyond bf16 rounding)",
                     max(err, 0.0), 2e-6)
            else:
                err = maxerr(g, w)
                gate(f"K1 {form} {dtype}{tag} vs plain (abs)", err, 2e-6)
                k1 = max(k1, err)
        del want
        for c in range(channels):
            one = S.launch_spectra(plan, pro.channel(c), form, dtype)
            one = one if isinstance(one, tuple) else (one,)
            if not all(torch.equal(g[c], o) for g, o in zip(got, one)):
                raise AssertionError(f"K1 {form} {dtype}{tag}: channel {c} of the batched "
                                     "launch differs from its own launch")
        if channels:
            print(f"  K1 {form} {dtype}{tag}: each channel equals its C = 1 launch on the "
                  "same prologue bit for bit", flush=True)
    return k1


def hold_k2(Q, plan, pro, tag: str) -> float:
    """K2 (packed, planar, y only) on one prologue (one launch) against the
    plain version: spectra 2e-6, y 1e-5 (the chunks' partial rows are added
    in another order than the plain version's matmul); planar equals
    packed, and y is the same in every form; two launches on the same
    inputs, bit for bit; with a batch, each channel equals a C = 1 launch
    on its slice of the same prologue bit for bit.  Returns the spectra's
    error."""
    synth = Q.synthesis_row(plan, pro.c0.device)
    channels = pro.lead[0] if len(pro.lead) == 2 else 0
    runs = {}
    for layout in ("packed", "planar", None):
        before = Q.LAUNCHES
        runs[layout] = Q.launch_scan(plan, pro, synth, layout)
        if Q.LAUNCHES - before != 1:
            raise AssertionError(f"K2 {layout}{tag}: {Q.LAUNCHES - before} launches")
        for c in range(channels):
            d1, y1 = Q.launch_scan(plan, pro.channel(c), synth, layout)
            dk, yk = runs[layout]
            same = torch.equal(yk[c], y1) and (
                layout is None or all(torch.equal(a[c], b) for a, b in zip(
                    dk if layout == "planar" else (dk,), d1 if layout == "planar" else (d1,))))
            if not same:
                raise AssertionError(f"K2 {layout}{tag}: channel {c} of the batched launch "
                                     "differs from its own launch")
    dk, yk = runs["packed"]
    dr, yr = Q.forward_and_y_reference(plan, pro, synth, "packed")
    gate(f"K2 spectra{tag} vs plain (abs)", maxerr(dk, dr), 2e-6)
    gate(f"K2 y{tag} vs plain (abs)", maxerr(yk, yr), 1e-5)
    (re, im), _ = runs["planar"]
    if not (torch.equal(re, dk[..., 0]) and torch.equal(im, dk[..., 1])
            and torch.equal(runs["planar"][1], yk) and torch.equal(runs[None][1], yk)):
        raise AssertionError(f"K2{tag}: the store forms disagree")
    again = Q.launch_scan(plan, pro, synth, "packed")
    same = torch.equal(again[0], dk) and torch.equal(again[1], yk)
    print(f"  K2{tag}: planar, packed and y-only agree; two launches on the same inputs "
          f"bit-identical: {same}"
          + (f"; each channel equals its C = 1 launch bit for bit" if channels else ""),
          flush=True)
    if not same:
        raise AssertionError("K2 is not deterministic")
    return maxerr(dk, dr)


#: (C, B) of the hop=1 chain blocks phase 4 holds K2 on at m = 1000: an
#: 8000-sample batch and the hop-1 chain cell's block
HOP1_SHAPES = [(8, 8000), (8, 44100)]


def hold_hop1_chain(T, S, Q, dev, C: int, B: int) -> float:
    """The hop=1 chain on two blocks of C x B at m = 1000, Hann: a cached
    call launches one carry kernel and one K2 a block; the first block's
    spectra and samples equal a K2 launch on that block's prologue bit for
    bit, and that launch is held to the plain version (``hold_k2``).
    Returns the spectra's error."""
    from sdft_tpu_torch.kernels import carry as F

    plan = T.Plan(1000, window="hann", precision=T.FAST_PRECISION)
    xs = signal(2 * C * B, SEED + 46, dev).reshape(2, C, B)
    st0 = T.init_state(plan, channels=C, device=dev)
    T.roundtrip_hopped(plan, st0, xs, 1)    # the first call captures the chain's graph
    q, f = Q.LAUNCHES, F.LAUNCHES
    _, hd, ys = T.roundtrip_hopped(plan, st0, xs, 1)
    torch.cuda.synchronize()
    if (Q.LAUNCHES - q, F.LAUNCHES - f) != (2, 2):
        raise AssertionError(f"hop=1 chain 2x{C}x{B}: {Q.LAUNCHES - q} K2 and "
                             f"{F.LAUNCHES - f} carry launches, expected 2 each (one a block)")
    pro = S.spectra_prologue(plan, st0, xs[0])
    d, y = Q.launch_scan(plan, pro, Q.synthesis_row(plan, dev), "packed")
    same = torch.equal(hd[0], d) and torch.equal(ys[0], y)
    print(f"  hop=1 chain 2x{C}x{B} m={plan.dftsize}: one K2 and one carry launch a block; the "
          f"first block equals K2 on its prologue bit for bit: {same}", flush=True)
    if not same:
        raise AssertionError(f"hop=1 chain 2x{C}x{B}: the first block differs from K2 on its "
                             "prologue")
    del hd, ys, d, y
    return hold_k2(Q, plan, pro, f" hop=1 chain block {C}x{B}")


def kernels_vs_plain(T, S, Q, dev) -> dict:
    """Phase 4: each kernel against its plain version on the same inputs:
    K1 at m = 4096 on a 16384-sample block, K2 at m = 1000 on 8000; then
    both on part a's ragged C = 3 batch at m = 4096 and m = 1000 (Blackman,
    latency 0.5), channels at different offsets; then K2 on the first block
    of a hop=1 chain at each of HOP1_SHAPES (``hold_hop1_chain``)."""
    out = {}
    plan = T.Plan(4096, window="hann", precision=T.FAST_PRECISION)
    st, _ = T.sdft(plan, T.init_state(plan, device=dev), signal(777, SEED + 3, dev))
    pro = S.spectra_prologue(plan, st, signal(16384, SEED + 4, dev))
    out["spectra"] = hold_k1(S, plan, pro, "")

    plan = T.Plan(1000, window="hann", precision=T.FAST_PRECISION)
    st, _ = T.sdft(plan, T.init_state(plan, device=dev), signal(555, SEED + 5, dev))
    pro = S.spectra_prologue(plan, st, signal(8000, SEED + 6, dev))
    out["scan"] = hold_k2(Q, plan, pro, "")

    C, M = BATCH_C, BATCH_M
    for m in (4096, 1000):
        plan = T.Plan(m, window="blackman", latency=0.5, precision=T.FAST_PRECISION)
        st, _ = desynchronized(T, plan, C, dev)
        pro = S.spectra_prologue(plan, st, signal(C * M, SEED + 44, dev).reshape(C, M))
        tag = f" batch {C}x{M} m={m}"
        out["spectra"] = max(out["spectra"], hold_k1(S, plan, pro, tag))
        out["scan"] = max(out["scan"], hold_k2(Q, plan, pro, tag))
        del pro
    for C, B in HOP1_SHAPES:
        out["scan"] = max(out["scan"], hold_hop1_chain(T, S, Q, dev, C, B))
        torch.cuda.empty_cache()
    return out


#: (m, C, M) of the carry kernel's timed shapes: the spectra and hop-1
#: cells' block, and one channel at m = 4096
CARRY_SHAPES = [(1000, 8, 44100), (4096, 1, 65536)]


def carry_inputs(T, plan, C: int, M: int, seed: int, dev):
    """A batched state 333 samples into ``plan`` (by the plain front) with
    channel c moved to offset 333 + 611 c, (C, M) samples and the kernels'
    fine table: the carry kernel's inputs."""
    from sdft_tpu_torch.kernels import spectra as S
    from sdft_tpu_torch.ops import carry as plain
    from sdft_tpu_torch.state import State

    fine, _ = S._spectra_tables(plan, S.TILE_K, dev)
    xs = signal(C * (333 + M), seed, dev).reshape(C, 333 + M)
    _, _, st = plain.carry(plan, T.init_state(plan, channels=C, device=dev), xs[:, :333], fine)
    m = plan.dftsize
    offsets = torch.tensor([(333 + 611 * c) % (2 * m) for c in range(C)], dtype=torch.int32,
                           device=dev)
    return State(offsets, st.delayline.contiguous(), st.accumulator), \
        xs[:, 333:].contiguous(), fine


def carry_vs_plain(T, dev) -> float:
    """Phase 4, the carry kernel against ``ops.carry.carry`` on the same
    inputs, one launch each (the counter read): at the spectra cell's 8 x
    44100, m = 1000, at 1 x 65536, m = 4096 (Hann), and on part a's ragged
    C = 3 batch at m = 4096 and 1000 (Blackman, latency 0.5, channels at
    different offsets).  The deltas, the next delayline and offset bit for
    bit; c0 and the end accumulator within 4 * eps32 * (samples so far +
    M).  Returns the largest difference of c0 and the accumulator."""
    from sdft_tpu_torch.kernels import carry as F, spectra as S
    from sdft_tpu_torch.ops import carry as plain

    eps32 = float(np.finfo(np.float32).eps)
    cases = []
    for i, (m, C, M) in enumerate(CARRY_SHAPES):
        plan = T.Plan(m, window="hann", precision=T.FAST_PRECISION)
        cases.append((plan, *carry_inputs(T, plan, C, M, SEED + 90 + i, dev), 333))
    for m in (4096, 1000):
        plan = T.Plan(m, window="blackman", latency=0.5, precision=T.FAST_PRECISION)
        stb, _ = desynchronized(T, plan, BATCH_C, dev)
        fine, _ = S._spectra_tables(plan, S.TILE_K, dev)
        x = signal(BATCH_C * BATCH_M, SEED + 44, dev).reshape(BATCH_C, BATCH_M)
        cases.append((plan, stb, x, fine, 300 + 700 * BATCH_C))
    worst = 0.0
    for plan, st, x, fine, lead in cases:
        (C, M), m = x.shape, plan.dftsize
        tag = f"carry {C}x{M} m={m} {plan.window.name.lower()}"
        dt, c0, want = plain.carry(plan, st, x, fine)
        F.LAUNCHES = 0
        delta, c0k, got = F.launch_carry(plan, st, x, fine)
        torch.cuda.synchronize()
        if F.LAUNCHES != 1:
            raise AssertionError(f"{tag}: {F.LAUNCHES} launches, expected one")
        same = (torch.equal(delta, dt.reshape(C, -1)) and torch.equal(got.delayline, want.delayline)
                and torch.equal(got.offset, want.offset))
        print(f"  {tag}: deltas, delayline and offset bit for bit the plain version's {same}",
              flush=True)
        if not same:
            raise AssertionError(f"{tag}: deltas, delayline or offset differ from ops.carry.carry")
        limit = 4 * eps32 * (lead + M)
        err_c0 = maxerr(c0k, torch.view_as_real(c0))
        err_acc = maxerr(got.accumulator, want.accumulator)
        gate(f"{tag} c0 vs ops.carry.carry (abs)", err_c0, limit)
        gate(f"{tag} end accumulator vs ops.carry.carry (abs)", err_acc, limit)
        worst = max(worst, err_c0, err_acc)
        del dt, c0, delta, c0k
    return worst


def carry_cost(m: int, C: int, M: int) -> tuple:
    """(FP32 flops, bytes) of the carry front of a (C, M) block: the totals
    product; the samples, history, accumulator and offsets read, the
    deltas, delayline, c0 and end accumulator written, once each."""
    K = 128
    nt = -(-M // K)
    flops = 2.0 * C * nt * K * 2 * m
    nbytes = 4 * (C * M + 2 * C * 2 * m + 2 * C * m + C) + 4 * C * nt * K \
        + 8 * C * nt * m + 8 * C * m
    return flops, nbytes


def carry_timings(T, dev, card: str) -> dict:
    """Phase 5, the carry kernel at ``CARRY_SHAPES``: its device time
    (profiler) beside its bound, the plain version (``ops.carry.carry``,
    eager) and the graphed prologue (``kernels.spectra.prologue``: the
    kernel and the next offset, as the cells run it).  No single PyTorch
    call computes it (library: none)."""
    from sdft_tpu_torch.kernels import carry as F, spectra as S
    from sdft_tpu_torch.ops import carry as plain

    res = {}
    for i, (m, C, M) in enumerate(CARRY_SHAPES):
        plan = T.Plan(m, window="hann", precision=T.FAST_PRECISION)
        st, x, fine = carry_inputs(T, plan, C, M, SEED + 95 + i, dev)
        flops, nbytes = carry_cost(m, C, M)
        b_ms, b_by = bound(nbytes, flops)
        k = device_time(lambda: F.launch_carry(plan, st, x, fine), 50)
        p = device_time(lambda: plain.carry(plan, st, x, fine), 20)
        g = device_time(lambda: S.prologue(plan, st, x), 50)
        print(f"timing: carry {C}x{M} m={m}: kernel device {k:.4f} ms, bound {b_ms:.4f} ms "
              f"({b_by}: {flops / 1e9:.3f} GFLOP, {nbytes / 1e6:.1f} MB), {b_ms / k:.1%} of "
              f"bound; plain device {p:.4f} ms; graphed prologue {g:.4f} ms [{card}]",
              flush=True)
        res[f"{C}x{M} m={m}"] = (k, p, b_ms, b_by, g)
    return res


#: bytes per output bin of each K1 store form
FORM_BYTES = {("packed", "float32"): 8, ("planar", "float32"): 8,
              ("planar", "bfloat16"): 4, ("power", "float32"): 4, ("power", "bfloat16"): 2}


def tile_input_bytes(pro) -> int:
    """Bytes the kernels read once: the carries, the deltas, the table."""
    return sum(t.numel() * t.element_size() for t in (pro.c0, pro.delta, pro.phase))


def timings(T, S, Q, dev, card: str) -> dict:
    """Phase 5: kernel and plain-version times at the main path's shapes,
    every K1 store form beside its bound, and K1 beside torch.stft.
    "device" is the card's busy time per call (profiler), "wall" the time
    per call back to back (CUDA events)."""
    res = {}
    from sdft_tpu_torch.kernels._build import library

    lib = library()
    print(f"timing: resident blocks per SM at K={S.TILE_K} (hann): spectra "
          f"{lib.sdft_spectra_occupancy(S.TILE_K)}, scan "
          f"{lib.sdft_scan_occupancy(S.TILE_K)}", flush=True)
    m, M = 4096, 65536
    plan = T.Plan(m, window="hann", precision=T.FAST_PRECISION)
    st = T.init_state(plan, device=dev)
    x = signal(M, SEED + 7, dev)
    pro = S.spectra_prologue(plan, st, x)
    t_pro = device_time(lambda: S.spectra_prologue(plan, st, x), 10)
    w_pro = wall_time(lambda: S.spectra_prologue(plan, st, x), 10)
    print(f"timing: K1 prologue m={m} M={M}: device {t_pro:.4f} ms, wall "
          f"{w_pro:.4f} ms [{card}]", flush=True)
    for form, dtype in S.STORES:
        k = device_time(lambda: S.launch_spectra(plan, pro, form, dtype), 10)
        p = device_time(lambda: S.spectra_reference(plan, pro, form, dtype), 3, 1)
        nbytes = M * m * FORM_BYTES[form, dtype] + tile_input_bytes(pro)
        b_ms, b_by = bound(nbytes, K1_FLOPS_PER_BIN * M * m)
        print(f"timing: K1 {form} {dtype} m={m} M={M}: kernel device {k:.4f} ms "
              f"({M / k * 1e3:.4e} samples/s, {nbytes / k / 1e6:.1f} GB/s), {nbytes / 1e9:.4f} GB "
              f"moved, bound {b_ms:.4f} ms ({b_by}), {b_ms / k:.1%} of bound; plain device "
              f"{p:.4f} ms; {S.store_bytes(m, form, dtype)}-byte stores [{card}]", flush=True)
        res[f"k1_{form}_{dtype}"] = (k, p, b_ms, b_by)
    for dtype in (None, "bfloat16"):
        e2e = wall_time(lambda: T.sdft(plan, st, x, "planar", dtype), 10)
        dev_t = device_time(lambda: T.sdft(plan, st, x, "planar", dtype), 10)
        print(f"timing: sdft planar {dtype or 'float32'} m={m} M={M}: wall "
              f"{e2e:.4f} ms ({M / e2e * 1e3:.4e} samples/s), device "
              f"{dev_t:.4f} ms [{card}]", flush=True)
    del pro
    res["k1_library"] = stft_beside_k1(T, plan, x, card)

    m, B = 1000, 8000
    plan = T.Plan(m, window="hann", precision=T.FAST_PRECISION)
    st = T.init_state(plan, device=dev)
    x = signal(B, SEED + 8, dev)
    pro = S.spectra_prologue(plan, st, x)
    synth = Q.synthesis_row(plan, dev)
    k = device_time(lambda: Q.launch_scan(plan, pro, synth, "packed"), 20)
    p = device_time(lambda: Q.forward_and_y_reference(plan, pro, synth, "packed"), 5, 1)
    nbytes = B * m * 8 + B * 4 + tile_input_bytes(pro) + synth.numel() * 4
    b_ms, b_by = bound(nbytes, K2_FLOPS_PER_BIN * B * m)
    print(f"timing: K2 packed m={m} B={B}: kernel device {k:.4f} ms "
          f"({B / k * 1e3:.4e} samples/s, {nbytes / k / 1e6:.1f} GB/s), bound {b_ms:.4f} ms "
          f"({b_by}), {b_ms / k:.1%} of bound; plain device {p:.4f} ms; no single "
          f"PyTorch call computes it (library: none) [{card}]", flush=True)
    xs = signal(8 * B, SEED + 9, dev).reshape(8, B)
    chain = wall_time(lambda: T.roundtrip_hopped(plan, st, xs, 1), 3, 1) / 8
    chain_dev = device_time(lambda: T.roundtrip_hopped(plan, st, xs, 1), 3, 1) / 8
    print(f"timing: roundtrip_hopped(hop=1) m={m} B={B} refresh_every=1: wall "
          f"{chain:.4f} ms per block ({B / chain * 1e3:.4e} samples/s), device "
          f"{chain_dev:.4f} ms per block [{card}]", flush=True)
    res["k2_packed"] = (k, p, b_ms, b_by)
    res["batch"] = batch_timings(T, S, Q, dev, card)
    return res


def stft_beside_k1(T, plan, x, card: str) -> float:
    """torch.stft at hop 1 as K1's library yardstick (the port never calls
    it), on one block (M,) or a channel batch (C, M): its device time, and
    its frames against K1's spectra.  Frame f of the periodic-Hann STFT of
    2m points, scaled by 1/(2m), is K1's row f + 2m - 1 (the demodulation
    leaves no per-bin phase); the top `halo` bins differ, since the
    reference mirrors around bin m-1 there."""
    m = plan.dftsize
    n = 2 * m
    win = torch.hann_window(n, periodic=True, device=x.device)

    def stft():
        return torch.stft(x, n_fft=n, hop_length=1, window=win, center=False,
                          return_complex=True)

    lib_ms = device_time(stft, 3, 1)
    lib_wall = wall_time(stft, 3, 1)
    xb = x.reshape(-1, x.shape[-1])
    z = stft().reshape(xb.shape[0], m + 1, -1)
    _, d = T.sdft(plan, T.init_state(plan, channels=xb.shape[0], device=x.device), xb)
    err = scale = 0.0
    top = 0.0
    for f0 in range(0, z.shape[-1], 8192):
        ref = z[..., f0:f0 + 8192].transpose(1, 2) / n
        got = torch.view_as_complex(d[:, f0 + n - 1:f0 + n - 1 + ref.shape[1]])
        diff = (got - ref[..., :m]).abs()
        err = max(err, diff[..., :m - 1].max().item())
        top = max(top, diff[..., m - 1].max().item())
        scale = max(scale, ref.abs().max().item())
        del ref, got, diff
    agree = err <= 3e-6 * scale
    print(f"timing: torch.stft(n_fft={n}, hop_length=1, hann periodic, center=False) on "
          f"{' x '.join(map(str, x.shape))} samples: device {lib_ms:.4f} ms, wall "
          f"{lib_wall:.4f} ms; frames / (2m) vs K1 rows 2m-1.. bins 0..m-2: {err:.3e} "
          f"({err / scale:.3e} of scale, {'agree' if agree else 'DO NOT agree'} at 3e-6), bin "
          f"m-1 {top:.3e} (the reference's mirror around m-1) [{card}]", flush=True)
    if not agree:
        raise AssertionError("torch.stft and K1 do not agree")
    del z, d
    return lib_ms


def batch_timings(T, S, Q, dev, card: str, m: int = 4096, C: int = 8, M: int = 32768) -> dict:
    """The channel axis.  ``sdft`` on an 8 x 32768 batch, planar f32: one
    prologue and one K1 launch that writes the batch's outputs, so the peak
    device memory above the inputs is the 8 GiB of spectra, not twice
    that; its device and wall time, the prologue's and K1's device times,
    K1's bound, its plain version and torch.stft on the same batch.  Then
    K1 on the spectra cell's block (``k1_cell_timing``), and K2 on 8
    channels x 8000 and on the hop-1 chain cell's 8 x 44100 at m = 1000
    beside its bound."""
    res = {}
    plan = T.Plan(m, window="hann", precision=T.FAST_PRECISION)
    st = T.init_state(plan, channels=C, device=dev)
    xs = signal(C * M, SEED + 40, dev).reshape(C, M)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    k1 = S.LAUNCHES
    out = T.sdft(plan, st, xs, "planar")
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    launched = S.LAUNCHES - k1
    del out
    d = device_time(lambda: T.sdft(plan, st, xs, "planar"), 3, 1)
    w = wall_time(lambda: T.sdft(plan, st, xs, "planar"), 3, 1)
    spectra = 2 * C * M * m * 4
    print(f"timing: sdft C={C} M={M} m={m} planar f32: {launched} K1 launch(es); device "
          f"{d:.4f} ms, wall {w:.4f} ms ({C * M / w * 1e3:.4e} samples/s), idle "
          f"{max(0.0, 1 - d / w):.1%}, peak {peak / 2**30:.3f} GiB above the inputs for "
          f"{spectra / 2**30:.1f} GiB of spectra [{card}]", flush=True)
    if launched != 1:
        raise AssertionError(f"sdft on {C} x {M}: {launched} K1 launches, expected one")
    if peak > 1.25 * spectra:
        raise AssertionError(f"channel batch peak {peak / 2**30:.2f} GiB: spectra copied")
    res["sdft"] = (d, w, peak)

    pro = S.spectra_prologue(plan, st, xs)
    t_pro = device_time(lambda: S.spectra_prologue(plan, st, xs), 10)
    w_pro = wall_time(lambda: S.spectra_prologue(plan, st, xs), 10)
    k = device_time(lambda: S.launch_spectra(plan, pro, "planar", "float32"), 10)
    nbytes = C * M * m * FORM_BYTES["planar", "float32"] + tile_input_bytes(pro)
    b_ms, b_by = bound(nbytes, K1_FLOPS_PER_BIN * C * M * m)
    torch.cuda.empty_cache()
    try:
        plain = device_time(lambda: S.spectra_reference(plan, pro, "planar", "float32"), 2, 1)
    except torch.cuda.OutOfMemoryError:
        plain = None
    del pro
    torch.cuda.empty_cache()
    print(f"timing: K1 planar f32 batch C={C} M={M} m={m}: prologue device {t_pro:.4f} ms "
          f"(wall {w_pro:.4f}), kernel device {k:.4f} ms ({nbytes / k / 1e6:.1f} GB/s), "
          f"{nbytes / 1e9:.4f} GB moved, bound {b_ms:.4f} ms ({b_by}), {b_ms / k:.1%} of "
          f"bound; plain device "
          f"{'not measured (out of memory)' if plain is None else f'{plain:.4f} ms'} [{card}]",
          flush=True)
    lib = stft_beside_k1(T, plan, xs, card)
    res["k1"] = (k, plain, b_ms, b_by, lib, t_pro)
    res["k1_spectra_cell"] = k1_cell_timing(T, S, dev, card, C)

    m = 1000
    plan = T.Plan(m, window="hann", precision=T.FAST_PRECISION)
    st = T.init_state(plan, channels=C, device=dev)
    synth = Q.synthesis_row(plan, dev)
    for B, key in ((8000, "k2"), (44100, "k2_hop1_cell")):
        x = signal(C * B, SEED + 45, dev).reshape(C, B)
        pro = S.spectra_prologue(plan, st, x)
        k = device_time(lambda: Q.launch_scan(plan, pro, synth, "packed"), 20)
        p = device_time(lambda: Q.forward_and_y_reference(plan, pro, synth, "packed"),
                        5 if B == 8000 else 2, 1)
        nbytes = C * B * m * 8 + C * B * 4 + tile_input_bytes(pro) + synth.numel() * 4
        b_ms, b_by = bound(nbytes, K2_FLOPS_PER_BIN * C * B * m)
        print(f"timing: K2 packed batch C={C} m={m} B={B}: kernel "
              f"device {k:.4f} ms ({C * B / k * 1e3:.4e} samples/s, {nbytes / k / 1e6:.1f} "
              f"GB/s), bound {b_ms:.4f} ms ({b_by}), {b_ms / k:.1%} of bound; plain device "
              f"{p:.4f} ms; library: none [{card}]", flush=True)
        res[key] = (k, p, b_ms, b_by)
        del pro
        torch.cuda.empty_cache()
    return res


def k1_cell_timing(T, S, dev, card: str, C: int = 8, M: int = 44100) -> tuple:
    """K1 planar f32 on the spectra cell's C x M block at m = 1000, the
    shape and form the main path runs paced: with ``PACED_LAUNCHES`` zeroed,
    one launch is one paced launch, held to the plain version at 2e-6 and
    bit for bit to the unpaced launch (``pacing``), which counts none; the
    device times of the paced launch, the unpaced one and the plain version
    beside K1's bound.  Returns (ms, plain ms, bound ms, bound by, unpaced
    ms)."""
    m, form = 1000, ("planar", "float32")
    if not S.paced(m, *form):
        raise AssertionError(f"K1 {' '.join(form)} m={m} is not paced")
    plan = T.Plan(m, window="hann", precision=T.FAST_PRECISION)
    st = T.init_state(plan, channels=C, device=dev)
    pro = S.spectra_prologue(plan, st, signal(C * M, SEED + 48, dev).reshape(C, M))
    tag = f"K1 {' '.join(form)} spectra cell {C}x{M} m={m}"
    S.PACED_LAUNCHES, n = 0, S.LAUNCHES
    got = S.launch_spectra(plan, pro, *form)
    with pacing(S, False):
        unpaced = S.launch_spectra(plan, pro, *form)
    if (S.LAUNCHES - n, S.PACED_LAUNCHES) != (2, 1):
        raise AssertionError(f"{tag}: {S.LAUNCHES - n} launches, {S.PACED_LAUNCHES} paced; "
                             "expected 2 and 1")
    same = all(torch.equal(a, b) for a, b in zip(got, unpaced))
    print(f"  {tag}: one paced launch (kernels.spectra.paced_launches {S.PACED_LAUNCHES}); "
          f"bit for bit the unpaced launch: {same}", flush=True)
    if not same:
        raise AssertionError(f"{tag}: the paced launch differs from the unpaced one")
    del unpaced
    want = S.spectra_reference(plan, pro, *form)
    gate(f"{tag} vs plain (abs)", max(maxerr(g, w) for g, w in zip(got, want)), 2e-6)
    del got, want
    torch.cuda.empty_cache()
    k = device_time(lambda: S.launch_spectra(plan, pro, *form), 10)
    paced = S.PACED_LAUNCHES
    with pacing(S, False):
        ku = device_time(lambda: S.launch_spectra(plan, pro, *form), 10)
    if S.PACED_LAUNCHES != paced or paced < 11:
        raise AssertionError(f"{tag}: {S.PACED_LAUNCHES} paced launches after the timing, "
                             f"{paced} before the unpaced one")
    try:
        plain = device_time(lambda: S.spectra_reference(plan, pro, *form), 2, 1)
    except torch.cuda.OutOfMemoryError:
        plain = None
    nbytes = C * M * m * FORM_BYTES[form] + tile_input_bytes(pro)
    b_ms, b_by = bound(nbytes, K1_FLOPS_PER_BIN * C * M * m)
    del pro
    torch.cuda.empty_cache()
    print(f"timing: {tag} paced: kernel device {k:.4f} ms ({nbytes / k / 1e6:.1f} GB/s), "
          f"{nbytes / 1e9:.4f} GB moved, bound {b_ms:.4f} ms ({b_by}), {b_ms / k:.1%} of "
          f"bound; unpaced {ku:.4f} ms ({b_ms / ku:.1%}); plain device "
          f"{'not measured (out of memory)' if plain is None else f'{plain:.4f} ms'} [{card}]",
          flush=True)
    return k, plain, b_ms, b_by, ku


#: bit patterns at the edges of the masked split: ties, a carry into the
#: exponent, the largest finite values, subnormals, zeros
SPLIT_EDGES = (0x3F808000, 0x3F807FFF, 0x3F808001, 0x3FFF8000, 0x3FFFFFFF, 0xBF808000,
               0xBF807FFF, 0x7F7FFFFF, 0x7F7F8000, 0x7F7F7FFF, 0xFF7FFFFF, 0x00000001,
               0x00007FFF, 0x00008000, 0x0000FFFF, 0x007FFFFF, 0x007F8000, 0x80008000,
               0x807FFFFF, 0x00800000, 0x00000000, 0x80000000)


def split_operands(rows: int, K: int, N: int, dev, seed: int):
    """A float32 (rows, K) activation and a split (K, N) table on the card."""
    from sdft_tpu_torch.kernels import split_mm as M

    rng = np.random.default_rng(seed)
    a = torch.as_tensor((rng.standard_normal((rows, K)) * 4).astype(np.float32), device=dev)
    b = M.split_mask(torch.as_tensor(rng.standard_normal((K, N)), dtype=torch.float32))
    return a, b.map(lambda h: h.to(dev))


#: shapes off the main path for the kernel's ragged edges and split-K
SPLIT_MM_RAGGED = {"ragged 37x33x7": (37, 33, 7), "ragged 1x8x4000": (1, 8, 4000),
                   "ragged 129x1000x129": (129, 1000, 129)}


def split_mm_vs_plain(dev) -> tuple:
    """Phase 4, ``split_mm``: the kernel's own split bit for bit
    ``split_mask``'s (the edge patterns and 4093 random values); at every
    shape of the main path (``profiling.SPLIT_MM_SHAPES``) and the ragged
    ones, with three and four products, the kernel within 2e-6 of scale of
    its plain version on the same inputs (each one's distance from the
    float64 sum of the same products printed beside), and ``out``
    accumulated bit for bit as out + product.  Returns the largest
    difference, absolute and of scale."""
    from sdft_tpu_torch import profiling
    from sdft_tpu_torch.kernels import split_mm as M

    vals = np.concatenate([np.asarray(SPLIT_EDGES, np.uint32).view(np.float32),
                           (np.random.default_rng(SEED + 85).standard_normal(4093) * 100)
                           .astype(np.float32)])
    a = torch.as_tensor(vals, device=dev)
    got, want = M.launch_split_mask(a), M.split_mask(a)
    halves = all(torch.equal(g.view(torch.int16), w.view(torch.int16))
                 for g, w in zip(got, want))
    print(f"  split_mm: the kernel's split bit for bit split_mask's {halves}", flush=True)
    if not halves:
        raise AssertionError("split_mm: the kernel's halves differ from split_mask's")
    worst = worst_abs = 0.0
    shapes = {**profiling.SPLIT_MM_SHAPES, **SPLIT_MM_RAGGED}
    for i, (label, (rows, K, N)) in enumerate(shapes.items()):
        a, b = split_operands(rows, K, N, dev, SEED + 86 + i)
        base = signal(rows * N, SEED + 87, dev).reshape(rows, N)
        x = M.split_mask(a)
        products = [u.double() @ v.double() for u, v in
                    ((x.hi, b.hi), (x.hi, b.lo), (x.lo, b.hi), (x.lo, b.lo))]
        for passes in (3, 4):
            got = M.launch_split_mm(a, b, passes)
            acc = M.launch_split_mm(a, b, passes, out=base.clone())
            want = M.split_mm_reference(a, b, passes)
            err_abs = maxerr(got, want)
            scale = want.abs().max().item()
            err = err_abs / scale
            exact = sum(products[:passes])
            print(f"  split_mm {label} passes={passes}: from the float64 sum of the same "
                  f"products, kernel {maxerr(got, exact) / scale:.3e}, plain "
                  f"{maxerr(want, exact) / scale:.3e} of scale", flush=True)
            gate(f"split_mm {label} ({rows}x{K})@({K}x{N}) passes={passes} vs plain "
                 f"(of scale)", err, 2e-6)
            if not torch.equal(acc, base + got):
                raise AssertionError(f"split_mm {label}: out + product not bit for bit")
            worst, worst_abs = max(worst, err), max(worst_abs, err_abs)
    return worst_abs, worst


def split_mm_timings(dev, card: str) -> dict:
    """Phase 5, ``split_mm`` at every shape of the main path, three and four
    products: the kernel's device time (profiler) beside its bound
    (``profiling.split_mm_bound``), its plain version, cuBLAS's bf16 GEMMs
    summed the same way (``profiling.cublas_split_mm``: the route split4
    took before the kernel) and one torch.mm in FP32 on the summed table
    (the library call for the product)."""
    from sdft_tpu_torch import profiling
    from sdft_tpu_torch.kernels import split_mm as M

    res = {}
    for i, (label, (rows, K, N)) in enumerate(profiling.SPLIT_MM_SHAPES.items()):
        a, b = split_operands(rows, K, N, dev, SEED + 88 + i)
        bf = b.hi.float() + b.lo.float()
        fp32 = device_time(lambda: a @ bf, 10)
        for passes in (3, 4):
            kern = device_time(lambda: M.launch_split_mm(a, b, passes), 10)
            plain = device_time(lambda: M.split_mm_reference(a, b, passes), 10)
            cub = device_time(lambda: profiling.cublas_split_mm(a, b, passes), 10)
            b_ms, by = profiling.split_mm_bound(rows, K, N, passes)
            print(f"timing: split_mm {label} ({rows}x{K})@({K}x{N}) passes={passes}: "
                  f"{kern:.4f} ms, bound {b_ms:.4f} ms ({by}), {b_ms / kern:.1%} of the bound; "
                  f"plain {plain:.4f}, cuBLAS bf16 x{passes} {cub:.4f}, torch.mm FP32 "
                  f"{fp32:.4f} ms [{card}]", flush=True)
            res[label, passes] = (kern, plain, b_ms, by, fp32, cub)
    return res


def class_blocks(T, dev, card: str) -> dict:
    """Phase 5, one block of the collapsed round trip (m = 4096, k_tile
    1024, graphed) at 1 x 65536 and 8 x 32768 by matmul class (highest,
    high, split4): device ms by kind (split_mm, cuBLAS GEMMs, the rest,
    profiler) and wall ms (CUDA events), in one run."""
    res = {}
    plan = T.Plan(4096, window="hann", precision=T.FAST_PRECISION)
    x = signal(8 * 32768, SEED + 73, dev)
    for C, M_ in ((1, 65536), (8, 32768)):
        xx = x[:M_] if C == 1 else x.reshape(C, M_)
        for mxu in ("highest", "high", "split4"):
            pl = plan.with_(precision=T.Precision("float32", "float32", mxu=mxu))
            st = T.init_state(pl, channels=None if C == 1 else C, device=dev)

            def call():
                return T.roundtrip(pl, st, xx)

            kt = kernel_table(call)
            s_ms = sum(ms for k, (_, ms) in kt.items() if is_split_mm(k))
            g_ms = sum(ms for k, (_, ms) in kt.items() if is_gemm(k))
            total = device_time(call, 10)
            wall = wall_time(call, 10)
            print(f"timing: roundtrip mxu={mxu} {C}x{M_} one block: device {total:.4f} ms "
                  f"(split_mm {s_ms:.4f}, cuBLAS GEMMs {g_ms:.4f}, the rest "
                  f"{total - s_ms - g_ms:.4f}), wall {wall:.4f} ms; {top_kernels(call, 6)} "
                  f"[{card}]", flush=True)
            res[f"block_{mxu}_C{C}"] = (total, s_ms, g_ms, wall)
    return res


def driver_timings(T, P, dev, card: str, k1_ms: float) -> dict:
    """Phase 5, this slice's calls: the collapsed round trip per k_tile and
    matmul class (exact FP32, "high", split4), one block by kind, the hop =
    100 driver, and the probes beside K1."""
    from sdft_tpu_torch import profiling
    from sdft_tpu_torch.ops import lti

    res = {}
    m = 4096
    sweep = (128, 256, 512, 1024)
    for C, M in ((1, 65536), (8, 32768)):
        x = signal(C * M, SEED + 14, dev)
        x = x if C == 1 else x.reshape(C, M)
        for mxu in ("highest", "high", "split4"):
            plan = T.Plan(m, window="hann",
                          precision=T.Precision("float32", "float32", mxu=mxu))
            st = T.init_state(plan, channels=None if C == 1 else C, device=dev)
            y64 = y64_of(T, plan, x) if mxu == "highest" else y64
            cost = profiling.roundtrip_cost(plan, C * M)
            for K in sweep:
                err = maxerr(lti.roundtrip_block_lti(plan, st, x, K)[1], y64)
                d = device_time(lambda: lti.roundtrip_block_lti(plan, st, x, K), 10)
                w = wall_time(lambda: lti.roundtrip_block_lti(plan, st, x, K), 10)
                print(f"timing: roundtrip (collapsed) mxu={mxu} m={m} C={C} M={M} "
                      f"k_tile={K}: error vs f64 {err:.3e}, device {d:.4f} ms, wall "
                      f"{w:.4f} ms ({C * M / w * 1e3:.4e} samples/s, "
                      f"{cost.hbm_bytes / d / 1e6:.3f} GB/s of roundtrip_cost bytes) [{card}]",
                      flush=True)
                res[f"lti_{mxu}_C{C}_K{K}"] = (err, d, w)
            best = min(sweep, key=lambda K: res[f"lti_{mxu}_C{C}_K{K}"][1])
            print(f"timing: fastest k_tile by device time, mxu={mxu} C={C} M={M}: {best}; "
                  f"default_k_tile({M}, {m}) = {lti.default_k_tile(M, m)}", flush=True)
        del y64
        K = lti.default_k_tile(M, m)
        hi = res[f"lti_highest_C{C}_K{K}"]
        for mxu, limit in (("high", 1e-4), ("split4", 5e-4)):
            r = res[f"lti_{mxu}_C{C}_K{K}"]
            print(f"timing: {mxu} at C={C} M={M} k_tile={K}: within its {limit:g} gate "
                  f"{r[0] <= limit}, device {r[1]:.4f} against exact FP32 {hi[1]:.4f} ms "
                  f"({r[1] / hi[1]:.3f}x) [{card}]", flush=True)
    res.update(class_blocks(T, dev, card))

    # the driver protocol at hop = 100, 8 chained blocks
    m, hop = 1000, 100
    plan = T.Plan(m, window="hann", precision=T.FAST_PRECISION)
    st = T.init_state(plan, device=dev)
    for B in (4000, 16000):
        xs = signal(8 * B, SEED + 16, dev).reshape(8, B)
        w = wall_time(lambda: T.roundtrip_hopped(plan, st, xs, hop), 3, 1) / 8
        d = device_time(lambda: T.roundtrip_hopped(plan, st, xs, hop), 3, 1) / 8
        print(f"timing: roundtrip_hopped(hop={hop}) m={m} B={B} refresh_every=1: wall "
              f"{w:.4f} ms per block ({B / w * 1e3:.4e} samples/s), device {d:.4f} ms "
              f"per block, device idle {max(0.0, 1 - d / w):.1%} [{card}]", flush=True)
        res[f"hop100_B{B}"] = (d, w)

    # the probes at 512 tiles beside K1's tiles (128 samples x 4096 bins).
    # CUDA events: each call is one launch of ~1 ms or more (the profiler
    # has summed one launch of five for the store probe)
    p = P.probe_inputs(512, seed=SEED + 17, device=dev)
    bounds = profiling.kernel_part_bounds(512)
    for v in P.VARIANTS:
        k = wall_time(lambda: P.launch_kparts(v, p), 5, 1)
        pl = wall_time(lambda: P.kparts_reference(v, p), 2, 1)
        b_ms, b_by = bounds[v]
        print(f"timing: kparts {v} nt=512: kernel {k:.4f} ms ({k * 1e3 / 512:.3f} "
              f"us/tile, {2 * 512 * 128 * 4096 * 4 / k / 1e6:.1f} GB/s stored), bound "
              f"{b_ms:.4f} ms ({b_by}), {b_ms / k:.1%} of the bound, plain {pl:.4f} ms "
              f"(CUDA events) [{card}]", flush=True)
        res[f"kparts_{v}"] = (k, pl, b_ms, b_by)
    print(f"timing: K1 planar f32 per tile {k1_ms * 1e3 / 512:.3f} us against the store "
          f"probe's {res['kparts_store'][0] * 1e3 / 512:.3f} us [{card}]", flush=True)
    return res


#: shapes of part c (module constants, so a rehearsal on the CPU can shrink them)
STREAM_M, STREAM_BLOCK, STREAM_BLOCKS = 4096, 65536, 16
TRANSFORM_BLOCK, TRANSFORM_BLOCKS = 8192, 4
HOP_M, HOP100_BLOCK, HOP1_BLOCK = 1000, 16000, 8000
TIER_M, TIER_BLOCK = 4096, 8192
COMPAT_M, STFT_SAMPLES = 1000, 16384


def host_err(got, want) -> float:
    return float(np.abs(np.asarray(got, np.float64) - np.asarray(want, np.float64)).max())


def stream_path(T, dev) -> dict:
    """Phase 3c: the Streamer (``run`` on the collapsed path, with a packed
    host transform through K1 and with a fused one, ``run_hopped`` at
    hop = 100 and at hop = 1 through K2, checkpoint and restore), the
    float32x2 tier and the compat classes.  Each is held against the direct
    calls it stands for and the float64 ``ops`` path on the card."""
    errs = {}
    m, M, nb = STREAM_M, STREAM_BLOCK, STREAM_BLOCKS
    plan = T.Plan(m, window="hann", precision=T.FAST_PRECISION)
    blocks = list(host_signal(nb * M, SEED + 20).reshape(nb, M))
    s = T.Streamer(plan, device=dev)
    got = list(s.run(blocks))
    st = T.init_state(plan, device=dev)
    want = []
    for b in blocks:
        st, y = T.roundtrip(plan, st, torch.as_tensor(b, device=dev))
        want.append(y.cpu().numpy())
    if s.samples_processed != nb * M or len(got) != nb:
        raise AssertionError(f"Streamer.run: {len(got)} blocks, {s.samples_processed} samples")
    errs["stream_run_abs"] = max(host_err(g, w) for g, w in zip(got, want))
    gate(f"Streamer.run (collapsed) {nb} x {M} vs a chain of roundtrip (abs)",
         errs["stream_run_abs"], 1e-6)
    with tempfile.TemporaryDirectory() as tmp:
        first = T.Streamer(plan, device=dev)
        list(first.run(blocks[:nb // 2]))
        first.checkpoint(f"{tmp}/ckpt.npz")
        second = T.Streamer(plan, device=dev)
        second.restore(f"{tmp}/ckpt.npz")
        rest = list(second.run(blocks[nb // 2:]))
    errs["stream_restore_abs"] = max(host_err(g, w) for g, w in zip(rest, got[nb // 2:]))
    gate(f"Streamer checkpoint after block {nb // 2} + restore, the rest vs uninterrupted "
         "(abs)", errs["stream_restore_abs"], 1e-6)

    # a transform on packed spectra (process -> K1 -> mask -> isdft) beside
    # the same mask fused into api.roundtrip on complex spectra; inputs at
    # the scale of tests/test_stream.py:87
    M = TRANSFORM_BLOCK
    xb = list(host_signal(TRANSFORM_BLOCKS * M, SEED + 21, 0.25).reshape(-1, M))
    mask = (torch.arange(m, device=dev) < m // 4).float()
    host = list(T.Streamer(plan, device=dev).run(xb, transform=lambda d: d * mask[:, None]))
    fused = list(T.Streamer(plan, device=dev).run(xb, transform=lambda z: z * mask,
                                                  fuse_transform=True))
    ref = list(T.Streamer(f64(plan), device=dev).run(
        xb, transform=lambda z: z * mask.double(), fuse_transform=True))
    gate(f"Streamer.run packed transform (K1) vs fuse_transform, {len(xb)} x {M} (abs)",
         max(host_err(a, b) for a, b in zip(host, fused)), 1e-6)
    errs["stream_k1_transform_abs"] = max(host_err(a, b) for a, b in zip(host, ref))
    gate("Streamer.run packed transform (K1) vs f64 (abs)",
         errs["stream_k1_transform_abs"], 1e-4)
    gate("Streamer.run fuse_transform vs f64 (abs)",
         max(host_err(a, b) for a, b in zip(fused, ref)), 1e-4)

    # run_hopped against one direct roundtrip_hopped call on the same blocks
    hplan = T.Plan(HOP_M, window="hann", precision=T.FAST_PRECISION)
    for hop, B, nb, chain in ((100, HOP100_BLOCK, 8, 8), (1, HOP1_BLOCK, 4, 4)):
        xs = host_signal(nb * B, SEED + 22 + hop).reshape(nb, B)
        got = list(T.Streamer(hplan, refresh_every=1, device=dev).run_hopped(
            list(xs), hop, chain=chain))
        _, hd, ys = T.roundtrip_hopped(hplan, T.init_state(hplan, device=dev),
                                       torch.as_tensor(xs, device=dev), hop, refresh_every=1)
        hd, ys = hd.cpu().numpy(), ys.cpu().numpy()
        e_d = max(host_err(g[0], w) for g, w in zip(got, hd))
        e_y = max(host_err(g[1], w) for g, w in zip(got, ys))
        # hop = 1 runs K2, which adds y in a fixed order: the same gates
        gate(f"Streamer.run_hopped(hop={hop}) m={HOP_M} {nb} x {B} spectra vs "
             "roundtrip_hopped (abs)", e_d, 1e-7)
        gate(f"Streamer.run_hopped(hop={hop}) samples vs roundtrip_hopped (abs)", e_y, 1e-6)
        errs[f"stream_hop{hop}_abs"] = (e_d, e_y)

    # the float32x2 tier: two chained blocks against float64 (the hard gate
    # of tests/test_tpu.py:448, samples :456)
    m, M = TIER_M, TIER_BLOCK
    ext = T.Plan(m, window="hann", precision=T.Precision("float32", "float32x2"))
    p64 = f64(ext)
    x = signal(2 * M, SEED + 24, dev)
    st, st64 = T.init_state(ext, device=dev), T.init_state(p64, device=dev)
    for b in range(2):
        blk = x[b * M:(b + 1) * M]
        st, d = T.sdft(ext, st, blk)
        st64, d64 = T.sdft(p64, st64, blk)
        if tuple(d.shape) != (M, m, 2, 2) or not torch.isfinite(d).all():
            raise AssertionError(f"float32x2 spectra {tuple(d.shape)} or not finite")
        got = d[..., 0].double() + d[..., 1].double()
        scale = d64.abs().max().item()
        head = T.df_to_float64((d[:8, :, :, 0], d[:8, :, :, 1]))
        if not np.array_equal(head, got[:8].cpu().numpy()):
            raise AssertionError("df_to_float64 disagrees with hi + lo in float64")
        err = maxerr(got, d64) / scale
        gate(f"float32x2 sdft m={m} block {b} (df_to_float64) vs f64 / scale", err, 1e-9)
        errs["tier_rel"] = max(errs.get("tier_rel", 0.0), err)
        y = T.isdft(ext, d)
        y64 = T.isdft(p64, d64)
        err = maxerr(y, y64) / y64.abs().max().item()
        gate(f"float32x2 isdft block {b} vs f64 (relative)", err, 1e-7)
        errs["tier_isdft_rel"] = max(errs.get("tier_isdft_rel", 0.0), err)
        del d, d64, got

    # the compat classes: SDFT on the card against the same class on the CPU
    # (float64 FD; isdft returns float32 samples, so it may differ by the
    # rounding of the last of them: 2 ulps of float32, 2.4e-7 of scale)
    x = host_signal(4 * COMPAT_M, SEED + 25).astype(np.float64)
    gpu = T.SDFT(COMPAT_M, "hamming", 0.5, device=dev)
    cpu = T.SDFT(COMPAT_M, "hamming", 0.5, device="cpu")
    dg, dc = gpu.sdft(x), cpu.sdft(x)
    errs["sdft_class_rel"] = host_err(dg.view(np.float64), dc.view(np.float64)) / np.abs(dc).max()
    gate(f"SDFT({COMPAT_M}, hamming, 0.5) card vs CPU / scale", errs["sdft_class_rel"], 1e-9)
    yg, yc = gpu.isdft(dg), cpu.isdft(dc)
    gate("SDFT.isdft card vs CPU / scale", host_err(yg, yc) / np.abs(yc).max(), 2.4e-7)
    # STFT against numpy framing and np.fft.rfft in float64
    x = np.random.default_rng(SEED + 26).standard_normal(STFT_SAMPLES).clip(-1, 1)
    for dftsize in (None, 600):
        for shift in (False, True):
            stft = T.STFT(512, 128, dftsize, "hann", shift, device=dev)
            n, w = stft.analysis_window_size, stft._analysis_window()
            frames = np.stack([x[i:i + n] for i in range(0, x.size - n + 1, 128)]) * w
            if shift:
                frames = np.fft.fftshift(frames, axes=-1)
            gate(f"STFT(512, 128, dftsize={dftsize}, shift={shift}) vs numpy (abs)",
                 host_err(stft.stft(x).view(np.float64),
                          (np.fft.rfft(frames, axis=-1) / n).view(np.float64)), 1e-12)
    stft = T.STFT(1024, 256, device=dev)
    y = stft.istft(stft.stft(x))
    gate("STFT(1024, 256) WOLA interior vs input (abs)",
         host_err(y[2048:x.size - 2048], x[2048:x.size - 2048]), 1e-10)
    return errs


def interleaved(fns: dict, reps: int) -> dict:
    """Host-clock seconds of each function, called in turns ``reps`` times
    after one warm-up each; every call ends on the host with its results."""
    for fn in fns.values():
        fn()
    out = {k: [] for k in fns}
    for _ in range(reps):
        for k, fn in fns.items():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            out[k].append(time.perf_counter() - t0)
    return out


def spread(ts) -> str:
    ms = sorted(t * 1e3 for t in ts)
    return f"median {float(np.median(ms)):.4f} ms (range {ms[0]:.4f}-{ms[-1]:.4f}, n={len(ms)})"


def stream_timings(T, dev, card: str, k1_ms: float) -> dict:
    """Phase 5, this slice's calls: the Streamer's overlap against a
    sequential loop, run_hopped against its per-block loop, and the price of
    the float32x2 tier beside float64 ``ops`` and K1 float32."""
    res = {}
    m = STREAM_M
    plan = T.Plan(m, window="hann", precision=T.FAST_PRECISION)
    mask = (torch.arange(m, device=dev) < m // 4).float()
    s = T.Streamer(plan, device=dev)
    # the collapsed round trip is host-bound (device ~0.15 of ~1 ms per
    # block); the packed transform through K1 keeps the device busy longer
    # than the host takes to queue it
    for cell, M, nb, transform in (
            ("collapsed", STREAM_BLOCK, STREAM_BLOCKS, None),
            ("packed K1 transform", STREAM_BLOCK // 4, 8, lambda d: d * mask[:, None])):
        blocks = list(host_signal(nb * M, SEED + 30).reshape(nb, M))

        def run_streamer(blocks=blocks, transform=transform):
            s.reset()
            for _ in s.run(blocks, transform=transform):
                pass

        def run_loop(blocks=blocks, transform=transform):
            st = T.init_state(plan, device=dev)
            for b in blocks:
                x = torch.as_tensor(b, device=dev)
                if transform is None:
                    st, y = T.roundtrip(plan, st, x)
                else:
                    st, d = T.sdft(plan, st, x)
                    y = T.isdft(plan, transform(d))
                y.cpu().numpy()

        t = interleaved({"run": run_streamer, "loop": run_loop}, 7)
        t_run, t_seq = float(np.median(t["run"])), float(np.median(t["loop"]))
        print(f"timing: Streamer.run {nb} x {M} m={m} ({cell}): {spread(t['run'])}, "
              f"{nb * M / t_run:.4e} samples/s [{card}]", flush=True)
        print(f"timing: sequential loop (numpy in, the same calls, .cpu() out) same blocks: "
              f"{spread(t['loop'])}, {nb * M / t_seq:.4e} samples/s [{card}]", flush=True)
        print(f"timing: Streamer overlap ({cell}) = 1 - T_run/T_seq = "
              f"{1 - t_run / t_seq:.4f} (medians) [{card}]", flush=True)
        res[f"overlap {cell}"] = (t_run, t_seq)

    hplan = T.Plan(HOP_M, window="hann", precision=T.FAST_PRECISION)
    B, nb = HOP100_BLOCK, 16
    xs = list(host_signal(nb * B, SEED + 31).reshape(nb, B))
    hs = T.Streamer(hplan, refresh_every=1, device=dev)

    def hopped_streamer():
        hs.reset()
        for _ in hs.run_hopped(xs, 100, chain=16):
            pass

    def hopped_loop():
        st = T.init_state(hplan, device=dev)
        for b in xs:
            st, hd, y = T.roundtrip_hopped(hplan, st, torch.as_tensor(b[None], device=dev),
                                           100, refresh_every=1)
            hd.cpu().numpy(), y.cpu().numpy()

    t = interleaved({"run_hopped": hopped_streamer, "loop": hopped_loop}, 5)
    for k in t:
        print(f"timing: {k} hop=100 m={HOP_M} {nb} x {B}: {spread(t[k])}, "
              f"{nb * B / float(np.median(t[k])):.4e} samples/s [{card}]", flush=True)
    res["run_hopped"] = tuple(float(np.median(t[k])) for k in ("run_hopped", "loop"))

    # the float32x2 tier's two legs against float64 ops and K1 float32
    m, M = TIER_M, TIER_BLOCK
    ext = T.Plan(m, window="hann", precision=T.Precision("float32", "float32x2"))
    p64 = f64(ext)
    x = signal(M, SEED + 32, dev)
    st, st64 = T.init_state(ext, device=dev), T.init_state(p64, device=dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    _, d = T.sdft(ext, st, x)
    torch.cuda.synchronize()
    peak_a = torch.cuda.max_memory_allocated() - base
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    T.isdft(ext, d)
    torch.cuda.synchronize()
    peak_s = torch.cuda.max_memory_allocated() - base
    _, d64 = T.sdft(p64, st64, x)
    legs = {"float32x2 sdft": lambda: T.sdft(ext, st, x),
            "float32x2 isdft": lambda: T.isdft(ext, d),
            "float64 ops sdft": lambda: T.sdft(p64, st64, x),
            "float64 ops isdft": lambda: T.isdft(p64, d64)}
    for name, fn in legs.items():
        dv = device_time(fn, 2, 1)
        w = wall_time(fn, 2, 1)
        print(f"timing: {name} m={m} M={M}: device {dv:.4f} ms ({M / dv * 1e3:.4e} "
              f"samples/s), wall {w:.4f} ms ({M / w * 1e3:.4e} samples/s) [{card}]",
              flush=True)
        res[name] = (dv, w)
    print(f"timing: K1 planar f32 m={m} M=65536 device {k1_ms:.4f} ms "
          f"({65536 / k1_ms * 1e3:.4e} samples/s) [{card}]", flush=True)
    print(f"timing: float32x2 peak device memory above its inputs: sdft "
          f"{peak_a / 2**20:.1f} MiB, isdft {peak_s / 2**20:.1f} MiB "
          f"(torch.cuda.max_memory_allocated) [{card}]", flush=True)
    return res


def same(a, b) -> bool:
    """Whether two nests of tensors are equal bit for bit."""
    from sdft_tpu_torch import graphs

    la, lb = graphs.leaves(a), graphs.leaves(b)
    return len(la) == len(lb) and all(torch.equal(x, y) for x, y in zip(la, lb))


def graph_cells(T, Q, dev) -> dict:
    """The graphed paths on the cells of PERF.md section 5, on carried
    (non-zero) states: {label: (call, blocks per call, K2 launches per
    call, K1 launches per call, split_mm launches per call)}.  ``sdft``, ``sdft_power`` and
    ``roundtrip(transform)`` replay the prologue's graph and launch K1
    after it, in every K1 store form; the hop=1 chains replay the
    prologue's graph per block and launch K2 after it."""
    from sdft_tpu_torch.ops import lti

    f32 = T.FAST_PRECISION
    big = T.Plan(4096, window="hann", precision=f32)
    drv = T.Plan(1000, window="hann", precision=f32)
    big4 = big.with_(precision=T.Precision(**SPLIT4))
    drv4 = drv.with_(precision=T.Precision(**SPLIT4))
    bigh = big.with_(precision=T.Precision(**HIGH))
    drvh = drv.with_(precision=T.Precision(**HIGH))
    x = signal(8 * 32768, SEED + 60, dev)
    lead = signal(3000, SEED + 61, dev)
    st1 = T.sdft(big, T.init_state(big, device=dev), lead)[0]
    st8 = T.sdft(big, T.init_state(big, channels=8, device=dev), lead[:1000].repeat(8, 1))[0]
    sd = T.sdft(drv, T.init_state(drv, device=dev), lead)[0]
    sd2 = T.sdft(drv, T.init_state(drv, channels=2, device=dev), lead[:1000].repeat(2, 1))[0]
    sd8 = T.sdft(drv, T.init_state(drv, channels=8, device=dev), lead[:1000].repeat(8, 1))[0]
    x8 = signal(8 * 8 * 8000, SEED + 64, dev).reshape(8, 8, 8000)
    low = torch.arange(4096, device=dev) < 400
    return {
        "sdft planar f32 m=4096 65536": (lambda: T.sdft(big, st1, x[:65536], "planar"),
                                         1, 0, 1, 0),
        "sdft planar bf16 m=4096 65536": (
            lambda: T.sdft(big, st1, x[:65536], "planar", "bfloat16"), 1, 0, 1, 0),
        "sdft planar f32 m=4096 8x32768": (
            lambda: T.sdft(big, st8, x.reshape(8, 32768), "planar"), 1, 0, 1, 0),
        "sdft packed f32 m=4096 16384": (lambda: T.sdft(big, st1, x[:16384]), 1, 0, 1, 0),
        "sdft_power f32 m=4096 16384": (lambda: T.sdft_power(big, st1, x[:16384]), 1, 0, 1, 0),
        "sdft_power bf16 m=4096 16384": (
            lambda: T.sdft_power(big, st1, x[:16384], "bfloat16"), 1, 0, 1, 0),
        "roundtrip(low-pass) m=4096 8x4096": (
            lambda: T.roundtrip(big, st8, x[:32768].reshape(8, 4096), lambda z: z * low),
            1, 0, 1, 0),
        "roundtrip 1x65536 m=4096": (lambda: T.roundtrip(big, st1, x[:65536]), 1, 0, 0, 0),
        "roundtrip 8x32768 m=4096": (lambda: T.roundtrip(big, st8, x.reshape(8, 32768)),
                                     1, 0, 0, 0),
        "roundtrip split4 1x65536 m=4096": (lambda: T.roundtrip(big4, st1, x[:65536]),
                                            1, 0, 0, 3),
        "roundtrip split4 8x32768 m=4096": (
            lambda: T.roundtrip(big4, st8, x.reshape(8, 32768)), 1, 0, 0, 3),
        "roundtrip_hopped split4 hop=100 m=1000 8x16000": (
            lambda: T.roundtrip_hopped(drv4, sd, x[:128000].reshape(8, 16000), 100), 8, 0, 0,
            16),
        "roundtrip high 1x65536 m=4096": (lambda: T.roundtrip(bigh, st1, x[:65536]),
                                          1, 0, 0, 3),
        "roundtrip high 8x32768 m=4096": (
            lambda: T.roundtrip(bigh, st8, x.reshape(8, 32768)), 1, 0, 0, 3),
        "roundtrip_hopped high hop=100 m=1000 8x16000": (
            lambda: T.roundtrip_hopped(drvh, sd, x[:128000].reshape(8, 16000), 100), 8, 0, 0,
            24),
        "roundtrip_hopped high hop=4 m=1000 4x4000": (
            lambda: T.roundtrip_hopped(drvh, sd, x[:16000].reshape(4, 4000), 4), 4, 0, 0, 16),
        "sdft_hopped high hop=100 m=1000 16000": (
            lambda: T.sdft_hopped(drvh, sd, x[:16000], 100), 1, 0, 0, 1),
        "roundtrip_hopped hop=100 m=1000 8x4000": (
            lambda: T.roundtrip_hopped(drv, sd, x[:32000].reshape(8, 4000), 100), 8, 0, 0, 0),
        "roundtrip_hopped hop=100 m=1000 8x16000": (
            lambda: T.roundtrip_hopped(drv, sd, x[:128000].reshape(8, 16000), 100), 8, 0, 0, 0),
        "roundtrip_hopped hop=4 refresh_every=2 m=1000 4x4000": (
            lambda: T.roundtrip_hopped(drv, sd, x[:16000].reshape(4, 4000), 4,
                                       refresh_every=2), 4, 0, 0, 0),
        "roundtrip_hopped hop=1 (K2) m=1000 8x8000": (
            lambda: T.roundtrip_hopped(drv, sd, x[:64000].reshape(8, 8000), 1), 8, 8, 0, 0),
        "roundtrip_hopped hop=1 (K2) m=1000 4x2x2000 refresh_every=2": (
            lambda: T.roundtrip_hopped(drv, sd2, x[:16000].reshape(4, 2, 2000), 1,
                                       refresh_every=2), 4, 4, 0, 0),
        "roundtrip_hopped hop=1 (K2) m=1000 8x8x8000": (
            lambda: T.roundtrip_hopped(drv, sd8, x8, 1), 8, 8, 0, 0),
        "roundtrip_block_fused (K2) m=4096 16384": (
            lambda: Q.roundtrip_block_fused(big, st1, x[:16384]), 1, 1, 0, 0),
        "sdft_hopped hop=100 m=1000 16000": (
            lambda: T.sdft_hopped(drv, sd, x[:16000], 100), 1, 0, 0, 0),
        "roundtrip_hopped_block hop=100 refresh m=1000 16000": (
            lambda: lti.roundtrip_hopped_block(drv, sd, x[:16000], 100, True), 1, 0, 0, 0),
        "refresh m=1000": (lambda: T.refresh(drv, sd), 1, 0, 0, 0),
    }


def graph_path(T, S, Q, M, dev, card: str, cells: dict) -> dict:
    """Part f: every graphed path of ``graph_cells`` against its eager run
    under ``graphs.disabled()`` on the same inputs, bit for bit (parts a-c
    already hold the graphed results against float64, since the graphs are
    the default).  Three calls on one graph: the first call's outputs must
    be unchanged after the next two, which get the same inputs and must
    return the same outputs.  A cached call must launch its K1, K2 and
    split_mm kernels as many times as expected (one K1 launch per ``sdft``
    call, one K2 launch per chain block, one split_mm launch per split
    product), replays included.  Prints each path's peak
    memory graphed and eager, and each graph's capture time and pool bytes.
    Then the hop=1 chains' profiler traces (no device-to-device copy of a
    block's spectra) and the host synchronisations (``sync_checks``)."""
    from sdft_tpu_torch import graphs

    out = {}
    for label, (call, _, k2, k1, ks) in cells.items():
        first = call()
        held = graphs.clone(first)
        q, s1, n = Q.LAUNCHES, S.LAUNCHES, M.LAUNCHES
        second = call()
        launched, launched1, split = Q.LAUNCHES - q, S.LAUNCHES - s1, M.LAUNCHES - n
        third = call()
        with graphs.disabled():
            eager = call()
        torch.cuda.synchronize()
        diff = max(maxerr(a, b) for a, b in zip(graphs.leaves(first), graphs.leaves(eager)))
        print(f"  graphs {label}: graphed vs eager bit for bit {same(first, eager)} "
              f"(largest difference {diff:.3e}); first call's outputs unchanged after two "
              f"more {same(first, held)}; the same inputs again equal "
              f"{same(second, first) and same(third, first)}; K1, K2, split_mm launches per "
              f"cached call {launched1}, {launched}, {split} (expected {k1}, {k2}, {ks})",
              flush=True)
        if not same(first, eager):
            raise AssertionError(f"graphs {label}: the graphed result differs from eager")
        if not (same(first, held) and same(second, first) and same(third, first)):
            raise AssertionError(f"graphs {label}: a later call changed a held output")
        if (launched1, launched, split) != (k1, k2, ks):
            raise AssertionError(f"graphs {label}: {launched1} K1, {launched} K2 and {split} "
                                 f"split_mm launches counted, expected {k1}, {k2} and {ks}")
        del first, held, second, third, eager
        peaks = {"graphed": peak_gib(call)}
        with graphs.disabled():
            peaks["eager"] = peak_gib(call)
        print(f"  graphs {label}: peak memory above the inputs graphed "
              f"{peaks['graphed'] * 1024:.2f} MiB, eager {peaks['eager'] * 1024:.2f} MiB "
              f"[{card}]", flush=True)
        out[label] = peaks
    entries = graphs.entries()
    for e in entries:
        shapes = " ".join("x".join(map(str, s[0])) or "()" for s in e.key[2])
        print(f"  graph {e.name} [{shapes}]: capture {e.capture_s * 1e3:.1f} ms (warm-up "
              f"included), pool +{e.pool_bytes / 2**20:.1f} MiB, launches per replay "
              f"{e.launches or '{}'}", flush=True)
    print(f"  graphs cached: {len(entries)} of at most {graphs.MAX_GRAPHS}, pool "
          f"{sum(e.pool_bytes for e in entries) / 2**20:.1f} MiB in all [{card}]", flush=True)
    if len(entries) > graphs.MAX_GRAPHS:
        raise AssertionError(f"{len(entries)} graphs cached")
    for label in HOP1_CHAINS:
        chain_copies(cells[label][0], cells[label][1], label)
    sync_checks(T, dev)
    return out


#: the hop=1 chains whose traces must hold no copy of a block's spectra
HOP1_CHAINS = ("roundtrip_hopped hop=1 (K2) m=1000 8x8000",
               "roundtrip_hopped hop=1 (K2) m=1000 8x8x8000")


def chain_copies(call, nb: int, label: str, k2: bool = True, stack_copies: int = 0) -> None:
    """One graphed chain call of ``nb`` blocks under the profiler: its trace
    must hold one K2 tile kernel per block (``k2``) and at most
    ``stack_copies`` device-to-device copies as large as one block's
    spectra: none in a hop=1 chain (K2 writes them into the stacked
    outputs; before, each block's were copied there), one per block in the
    sharded driver chain (each replay's outputs copied into the stack).  A
    trace that lost K2 events is taken again, at most three times."""
    import os

    from torch.profiler import ProfilerActivity, profile

    out = call()
    hd = out[1].to_local() if hasattr(out[1], "to_local") else out[1]
    block_bytes = hd[0].numel() * hd.element_size()
    del out, hd
    torch.cuda.synchronize()
    for _ in range(3):
        with tempfile.TemporaryDirectory() as tmp:
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                call()
                torch.cuda.synchronize()
            path = os.path.join(tmp, "chain.json")
            prof.export_chrome_trace(path)
            with open(path) as f:
                events = json.load(f)["traceEvents"]
        n_k2 = sum(1 for e in events if e.get("cat") == "kernel"
                   and "scan_kernel" in e["name"] and "scan_kernel_rows" not in e["name"])
        memcpy = [e for e in events if e.get("cat") == "gpu_memcpy"]
        if any("bytes" not in e.get("args", {}) for e in memcpy):
            raise AssertionError(f"graphs {label}: the trace's copies carry no byte counts")
        copies = [int(e["args"]["bytes"]) for e in memcpy]
        if n_k2 == (nb if k2 else 0):
            break
    big = [b for b in copies if b >= block_bytes]
    print(f"  graphs {label}: trace of one graphed call: {n_k2} K2 tile kernels, "
          f"{len(copies)} device copies, largest {max(copies, default=0)} bytes, "
          f"{len(big)} of at least a block's spectra ({block_bytes} bytes; at most "
          f"{stack_copies} allowed)", flush=True)
    if n_k2 != (nb if k2 else 0):
        raise AssertionError(f"graphs {label}: the trace shows {n_k2} K2 launches, "
                             f"expected {nb if k2 else 0}")
    if len(big) > stack_copies:
        raise AssertionError(f"graphs {label}: {len(big)} copies of a block's spectra")


def sync_checks(T, dev) -> None:
    """A warm graphed ``sdft`` (flagship block, planar f32) and one warm
    hop=1 chain block must enqueue without a host synchronisation
    (``torch.cuda.set_sync_debug_mode("error")``).  The eager ``sdft`` on the
    same inputs runs under "warn": each synchronising call it makes is
    printed (none is the finding that its wall over device time is host
    enqueue time)."""
    import warnings

    from sdft_tpu_torch import graphs

    big = T.Plan(4096, window="hann", precision=T.FAST_PRECISION)
    drv = T.Plan(1000, window="hann", precision=T.FAST_PRECISION)
    st, sd = T.init_state(big, device=dev), T.init_state(drv, device=dev)
    x = signal(65536, SEED + 65, dev)
    block = signal(8000, SEED + 66, dev).reshape(1, 8000)
    for _ in range(2):
        T.sdft(big, st, x, "planar")
        T.roundtrip_hopped(drv, sd, block, 1)
        with graphs.disabled():
            T.sdft(big, st, x, "planar")
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            with graphs.disabled():
                T.sdft(big, st, x, "planar")
        finally:
            torch.cuda.set_sync_debug_mode("default")
    # torch warns "called a synchronizing CUDA operation"; the mode's own
    # notice ("a prototype feature") is not a synchronisation
    syncs = [f"{w.filename}:{w.lineno}: {str(w.message).splitlines()[0]}" for w in caught
             if "synchronizing" in str(w.message) and "prototype" not in str(w.message)]
    print(f"  sync: eager sdft planar f32 m=4096 65536 (warm, inputs on the card): "
          f"{len(syncs)} synchronising call(s){': ' if syncs else ''}{'; '.join(syncs)}",
          flush=True)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        T.sdft(big, st, x, "planar")
        T.roundtrip_hopped(drv, sd, block, 1)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    print("  sync: a warm graphed sdft and one hop=1 chain block raised nothing under "
          "set_sync_debug_mode('error')", flush=True)


def enqueue_ms(call, n: int = 5) -> float:
    """Host time to enqueue one call, the device left to catch up."""
    call()
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(n):
        call()
    t = time.perf_counter() - t
    torch.cuda.synchronize()
    return t * 1e3 / n


#: the cells of ``graph_cells`` timed eager against graphed (PERF.md section 5)
GRAPH_TIMED = ("sdft planar f32 m=4096 65536", "sdft planar bf16 m=4096 65536",
               "sdft planar f32 m=4096 8x32768",
               "roundtrip 1x65536 m=4096", "roundtrip 8x32768 m=4096",
               "roundtrip split4 1x65536 m=4096", "roundtrip split4 8x32768 m=4096",
               "roundtrip high 1x65536 m=4096", "roundtrip high 8x32768 m=4096",
               "roundtrip_hopped hop=100 m=1000 8x4000",
               "roundtrip_hopped hop=100 m=1000 8x16000",
               "roundtrip_hopped split4 hop=100 m=1000 8x16000",
               "roundtrip_hopped high hop=100 m=1000 8x16000",
               "roundtrip_hopped hop=1 (K2) m=1000 8x8000",
               "roundtrip_hopped hop=1 (K2) m=1000 8x8x8000",
               "roundtrip_block_fused (K2) m=4096 16384")


def graph_timings(T, dev, card: str, cells: dict) -> dict:
    """Phase 5, this slice: eager (``graphs.disabled()``) against graphed.
    Wall ms per block between CUDA events in turns (eager, graphed,
    graphed, eager), device ms per block (profiler) and the device's idle
    share; then ``Streamer.run`` (16 x 65536, m = 4096) and ``run_hopped``
    (hop = 100, 16 x 16000) on the host clock in turns, and the ``bench
    4096 16384 3`` rows in turns."""
    import contextlib
    import io
    import re

    from sdft_tpu_torch import cli, graphs

    def mode(name):
        return graphs.disabled() if name == "eager" else contextlib.nullcontext()

    res = {}
    for label in GRAPH_TIMED:
        call, nb = cells[label][:2]
        walls = {"eager": [], "graphed": []}
        for m in ("eager", "graphed", "graphed", "eager"):
            with mode(m):
                walls[m].append(wall_time(call, 5, 1) / nb)
        devs, enqueue = {}, {}
        for m in ("eager", "graphed"):
            with mode(m):
                devs[m] = device_time(call, 3, 1) / nb
                enqueue[m] = enqueue_ms(call) / nb
        for m in ("eager", "graphed"):
            w = min(walls[m])
            print(f"timing: graphs {label} {m}: wall {'/'.join(f'{v:.4f}' for v in walls[m])} "
                  f"ms per block, device {devs[m]:.4f} ms per block, idle "
                  f"{max(0.0, 1 - devs[m] / w):.1%}, host enqueue {enqueue[m]:.4f} ms per block "
                  f"[{card}]", flush=True)
        print(f"timing: graphs {label}: graphed/eager wall {min(walls['graphed']) / min(walls['eager']):.3f}, "
              f"device {devs['graphed'] / devs['eager']:.3f} [{card}]", flush=True)
        res[label] = {m: (min(walls[m]), devs[m]) for m in walls}

    m = STREAM_M
    plan = T.Plan(m, window="hann", precision=T.FAST_PRECISION)
    hplan = T.Plan(HOP_M, window="hann", precision=T.FAST_PRECISION)
    blocks = list(host_signal(STREAM_BLOCKS * STREAM_BLOCK, SEED + 62).reshape(-1, STREAM_BLOCK))
    hblocks = list(host_signal(16 * HOP100_BLOCK, SEED + 63).reshape(16, HOP100_BLOCK))

    def streamer(name):
        def go():
            with mode(name):
                for _ in T.Streamer(plan, device=dev).run(blocks):
                    pass
        return go

    def hopped(name):
        def go():
            with mode(name):
                for _ in T.Streamer(hplan, refresh_every=1, device=dev).run_hopped(
                        hblocks, 100, chain=16):
                    pass
        return go

    for cell, fns, n in (
            (f"Streamer.run {STREAM_BLOCKS} x {STREAM_BLOCK} m={m}",
             {"eager": streamer("eager"), "graphed": streamer("graphed")}, STREAM_BLOCKS),
            (f"Streamer.run_hopped hop=100 m={HOP_M} 16 x {HOP100_BLOCK}",
             {"eager": hopped("eager"), "graphed": hopped("graphed")}, 16)):
        t = interleaved(fns, 5)
        for k in t:
            med = float(np.median(t[k]))
            print(f"timing: graphs {cell} {k}: {spread(t[k])}, {med * 1e3 / n:.4f} ms per "
                  f"block [{card}]", flush=True)
        res[cell] = {k: float(np.median(t[k])) for k in t}

    rows = {"eager": [], "graphed": []}
    for name in ("eager", "graphed", "graphed", "eager"):
        buf = io.StringIO()
        with mode(name), contextlib.redirect_stdout(buf):
            if cli.main(["bench", "4096", "16384", "3"]) != 0:
                raise AssertionError("bench failed")
        rows[name].append([float(v) for v in re.findall(r"([\d.]+) ms/block marginal",
                                                       buf.getvalue())])
    for name, runs in rows.items():
        print(f"timing: graphs bench 4096 16384 3 {name}: ms per block (collapsed, scan "
              f"K2) {runs} [{card}]", flush=True)
    res["bench"] = rows
    return res


#: shapes of part d, the sharded programs on a one-rank mesh
SHARD_M, SHARD_BLOCK, SHARD_BATCH = 4096, 65536, (8, 32768)
SHARD_SCAN_BLOCK, SHARD_F64_CHUNK = 16384, 16384
SHARD_HOP_M, SHARD_HOP, SHARD_HOP_BLOCK, SHARD_HOP_BLOCKS = 1000, 100, 16000, 8
SHARD_Y_BLOCK, SHARD_Y_BLOCKS = 8000, 4


class Launches:
    """K1 and K2 launches made inside each sharded program's calls."""

    def __init__(self, S, Q):
        self.S, self.Q, self.by = S, Q, {}

    def __call__(self, program: str, fn):
        k1, k2 = self.S.LAUNCHES, self.Q.LAUNCHES
        out = fn()
        n = self.by.setdefault(program, [0, 0])
        n[0] += self.S.LAUNCHES - k1
        n[1] += self.Q.LAUNCHES - k2
        return out


def f64_chunks(T, plan, x, chunk: int):
    """The float64 ``ops`` spectra of a (M,) block, chunk by chunk on one
    carried state (chunking invariance): yields (start, packed f64 spectra,
    isdft of them)."""
    p64 = f64(plan)
    st = T.init_state(p64, device=x.device)
    for i in range(0, x.numel(), chunk):
        st, d = T.sdft(p64, st, x[i:i + chunk])
        yield i, d, T.isdft(p64, d)
        del d


def timed_pair(name: str, sharded, unsharded, reps: int, card: str) -> dict:
    """Wall (CUDA events), device (profiler), the device's idle share, the
    host enqueue time and the peak memory above the inputs of a sharded
    program graphed (the default) and eager (``graphs.disabled()``), beside
    its unsharded counterpart (graphed), in turns: unsharded, graphed,
    eager, eager, graphed, unsharded."""
    import contextlib

    from sdft_tpu_torch import graphs

    fns = {"unsharded": unsharded, "sharded graphed": sharded, "sharded eager": sharded}

    def mode(who):
        return graphs.disabled() if who == "sharded eager" else contextlib.nullcontext()

    res = {}
    for who in ("unsharded", "sharded graphed", "sharded eager", "sharded eager",
                "sharded graphed", "unsharded"):
        with mode(who):
            res.setdefault(who, []).append((wall_time(fns[who], reps, 1),
                                            device_time(fns[who], reps, 1)))
    out = {}
    for who, vals in res.items():
        w = min(v[0] for v in vals)
        d = min(v[1] for v in vals)
        with mode(who):
            peak, enqueue = peak_gib(fns[who]), enqueue_ms(fns[who])
        out[who] = (w, d, peak, enqueue)
        print(f"timing: {name} {who}: wall {'/'.join(f'{v[0]:.4f}' for v in vals)} ms, "
              f"device {'/'.join(f'{v[1]:.4f}' for v in vals)} ms, idle "
              f"{max(0.0, 1 - d / w):.1%} (best of turns), host enqueue {enqueue:.4f} ms, "
              f"peak {peak:.3f} GiB above the inputs [{card}]", flush=True)
    return out


def top_kernels(fn, n: int = 8) -> str:
    """The n kernels and copies of one call that took the most device time
    (torch.profiler)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    ev = sorted(prof.key_averages(), key=lambda e: -e.self_device_time_total)
    total = sum(e.self_device_time_total for e in ev)
    return f"total {total / 1e3:.4f} ms: " + "; ".join(
        f"{e.key[:48]} {e.self_device_time_total / 1e3:.4f} ms x{e.count}" for e in ev[:n])


def peak_gib(fn) -> float:
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    out = fn()
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    del out
    return peak / 2**30


def sharded_path(T, S, Q, dev, card: str, cli_ref: dict, mesh) -> tuple:
    """Part d: the seven sharded programs and the CLI's --mesh on a one-rank
    NCCL mesh (the card's only rank: NCCL puts no two ranks on one card),
    each gated against its unsharded counterpart or float64 ``ops`` at the
    gates of PERF.md section 2.  Returns (errors, timing jobs for
    ``sharded_timings``: {key: (name, sharded call, unsharded call,
    repetitions)}, launches of K1 and K2 by program)."""
    from sdft_tpu_torch import cli
    from sdft_tpu_torch import parallel as par
    from sdft_tpu_torch.io.dump import load_complex
    from sdft_tpu_torch.io.wav import read_wav
    from sdft_tpu_torch.ops.analysis import sdft_block

    errs, jobs = {}, {}
    count = Launches(S, Q)
    eps32 = float(np.finfo(np.float32).eps)

    # -- K1 per time shard, the flagship block: sharded_sdft_pallas
    # against float64 ops chunk by chunk, and against sdft
    m, M = SHARD_M, SHARD_BLOCK
    plan = T.Plan(m, window="hann", precision=T.FAST_PRECISION)
    x = signal(M, SEED + 50, dev)
    st0 = T.init_state(plan, channels=1, device=dev)
    st, (re, im) = count("sharded_sdft_pallas", lambda: par.sharded_sdft_pallas(
        plan, mesh, st0, x[None], layout="planar"))
    re, im = re.to_local()[0], im.to_local()[0]
    _, (ure, uim) = T.sdft(plan, T.init_state(plan, device=dev), x, "planar")
    e = scale = eu = 0.0
    for i, d64, _ in f64_chunks(T, plan, x, SHARD_F64_CHUNK):
        n = d64.shape[0]
        want = torch.complex(d64[..., 0], d64[..., 1])
        scale = max(scale, want.abs().max().item())
        e = max(e, (planar_complex(re[i:i + n], im[i:i + n]) - want).abs().max().item())
        eu = max(eu, (planar_complex(re[i:i + n], im[i:i + n])
                      - planar_complex(ure[i:i + n], uim[i:i + n])).abs().max().item())
        del want
    gate(f"sharded_sdft_pallas 1x{M} m={m} planar f32 vs f64 / scale", e / scale, 3e-6)
    gate("sharded_sdft_pallas vs sdft (unsharded K1) / scale", eu / scale, 3e-6)
    errs["shard_k1_rel"] = e / scale
    st64, _ = T.sdft(f64(plan), T.init_state(f64(plan), device=dev), x)
    acc = st.accumulator.to_local()[0]
    gate("sharded_sdft_pallas end accumulator (refresh identity) vs f64",
         maxerr(acc, st64.accumulator), 4 * eps32 * M)
    if int(st.offset.to_local()[0]) != int(st64.offset):
        raise AssertionError("sharded_sdft_pallas offset mismatch")
    del re, im, ure, uim, st64
    jobs["shard_k1"] = (
        f"sharded_sdft_pallas planar f32 m={m} 1x{M} vs sdft",
        lambda plan=plan, x=x: par.sharded_sdft_pallas(plan, mesh, st0, x[None],
                                                       layout="planar"),
        lambda plan=plan, x=x: T.sdft(plan, T.init_state(plan, device=dev), x, "planar"), 5)

    # -- the 8 x 32768 batch: one K1 launch for the time shard's channels
    C, Mb = SHARD_BATCH
    xb = signal(C * Mb, SEED + 51, dev).reshape(C, Mb)
    stb = T.init_state(plan, channels=C, device=dev)
    k1 = S.LAUNCHES
    peak = peak_gib(lambda: count("sharded_sdft_pallas", lambda: par.sharded_sdft_pallas(
        plan, mesh, stb, xb, layout="planar")))
    if S.LAUNCHES - k1 != mesh.shape[1]:
        raise AssertionError(f"sharded_sdft_pallas {C}x{Mb}: {S.LAUNCHES - k1} K1 launches, "
                             f"expected one per time shard ({mesh.shape[1]})")
    _, (re, im) = par.sharded_sdft_pallas(plan, mesh, stb, xb, layout="planar")
    re, im = re.to_local(), im.to_local()
    _, (ure, uim) = T.sdft(plan, stb, xb, "planar")
    eu = scale = 0.0
    for c in range(C):
        u = planar_complex(ure[c], uim[c])
        scale = max(scale, u.abs().max().item())
        eu = max(eu, (planar_complex(re[c], im[c]) - u).abs().max().item())
        del u
    gate(f"sharded_sdft_pallas {C}x{Mb} vs sdft (unsharded K1) / scale", eu / scale, 3e-6)
    spectra = 2 * C * Mb * m * 4 / 2**30
    print(f"  sharded_sdft_pallas {C}x{Mb} peak {peak:.3f} GiB above the inputs for "
          f"{spectra:.1f} GiB of spectra [{card}]", flush=True)
    if peak > 1.25 * spectra:
        raise AssertionError(f"sharded batch peak {peak:.2f} GiB: spectra copied")
    del re, im, ure, uim
    jobs["shard_k1_batch"] = (
        f"sharded_sdft_pallas planar f32 m={m} {C}x{Mb} vs sdft",
        lambda plan=plan: par.sharded_sdft_pallas(plan, mesh, stb, xb, layout="planar"),
        lambda plan=plan: T.sdft(plan, stb, xb, "planar"), 3)
    errs["shard_k1_batch_peak_gib"] = peak

    # -- sharded_sdft: the default dispatches to K1 on the card; the
    # scan form forced off the kernel against float64
    xs = x[:SHARD_SCAN_BLOCK]
    k1_before = S.LAUNCHES
    _, auto = count("sharded_sdft", lambda: par.sharded_sdft(plan, mesh, st0, xs[None]))
    if S.LAUNCHES == k1_before:
        raise AssertionError("sharded_sdft did not dispatch to K1 on the card")
    _, scan = par.sharded_sdft(plan, mesh, st0, xs[None], use_pallas=False)
    _, ops32 = sdft_block(plan, T.init_state(plan, device=dev), xs)
    _, d64, _ = next(f64_chunks(T, plan, xs, SHARD_SCAN_BLOCK))
    scale = d64.abs().max().item()
    # the scan form's unsharded counterpart is the float32 ops path: both
    # run a complex64 running sum over the whole block, with no exact
    # per-tile carry, so the form is held to ops float32's own error on
    # the same input, not to K1's 3e-6 (both read 3.3-3.4e-6 here)
    e_ops = maxerr(ops32, d64) / scale
    e_scan = maxerr(scan.to_local()[0], d64) / scale
    print(f"  ops float32 (unsharded) vs f64 / scale {e_ops:.3e}", flush=True)
    gate(f"sharded_sdft scan form m={m} 1x{xs.numel()} vs ops float32 (unsharded) / scale",
         maxerr(scan.to_local()[0], ops32) / scale, 2e-6)
    gate("sharded_sdft scan form vs f64 / scale, limit 1.5 x ops float32's", e_scan,
         1.5 * e_ops)
    gate("sharded_sdft (K1 dispatch) vs f64 / scale",
         maxerr(auto.to_local()[0], d64) / scale, 3e-6)
    errs["shard_scan_rel"], errs["ops32_rel"] = e_scan, e_ops
    del auto, scan, d64, ops32
    jobs["shard_scan"] = (
        f"sharded_sdft scan form m={m} 1x{xs.numel()} vs ops float32",
        lambda plan=plan, xs=xs: par.sharded_sdft(plan, mesh, st0, xs[None], use_pallas=False),
        lambda plan=plan, xs=xs: sdft_block(plan, T.init_state(plan, device=dev), xs), 3)

    # -- sharded_roundtrip (collapsed) and sharded_isdft against
    # float64 sdft + isdft
    st, y = par.sharded_roundtrip(plan, mesh, st0, x[None])
    y = y.to_local()[0]
    _, yu = T.roundtrip(plan, T.init_state(plan, device=dev), x)
    e = 0.0
    for i, d64, y64 in f64_chunks(T, plan, x, SHARD_F64_CHUNK):
        e = max(e, maxerr(y[i:i + y64.numel()], y64))
        if i == 0:
            yi = par.sharded_isdft(plan, mesh, d64[None].float()).to_local()[0]
            gate("sharded_isdft of f64 spectra (as f32) vs f64 isdft (abs)",
                 maxerr(yi, y64), 1e-4)
    gate(f"sharded_roundtrip (collapsed) m={m} 1x{M} vs f64 sdft+isdft (abs)", e, 2e-5)
    gate("sharded_roundtrip vs roundtrip (unsharded) (abs)", maxerr(y, yu), 2e-5)
    errs["shard_lti_abs"] = e
    stk, _ = T.sdft(plan, T.init_state(plan, device=dev), x)
    gate("sharded_roundtrip state vs sdft state, accumulator (abs)",
         maxerr(st.accumulator.to_local()[0], stk.accumulator), 1e-3)
    jobs["shard_lti"] = (
        f"sharded_roundtrip (collapsed) m={m} 1x{M} vs roundtrip",
        lambda plan=plan, x=x: par.sharded_roundtrip(plan, mesh, st0, x[None]),
        lambda plan=plan, x=x: T.roundtrip(plan, T.init_state(plan, device=dev), x), 10)

    # -- the driver protocol at hop = 100: sharded_roundtrip_hopped,
    # and sharded_sdft_hopped, against float64 and the unsharded call
    m, hop, B, nb = SHARD_HOP_M, SHARD_HOP, SHARD_HOP_BLOCK, SHARD_HOP_BLOCKS
    plan = T.Plan(m, window="hann", precision=T.FAST_PRECISION)
    p64 = f64(plan)
    xs = signal(nb * B, SEED + 52, dev).reshape(nb, 1, B)
    sth = T.init_state(plan, channels=1, device=dev)
    _, hd, ys = par.sharded_roundtrip_hopped(plan, mesh, sth, xs, hop)
    hd, ys = hd.to_local(), ys.to_local()
    _, hdu, ysu = T.roundtrip_hopped(plan, sth, xs, hop)
    _, d64 = T.sdft(p64, T.init_state(p64, device=dev), xs.reshape(-1))
    e_d = maxerr(hd.reshape(-1, m, 2), d64[::hop])
    e_y = maxerr(ys.reshape(-1), T.isdft(p64, d64))
    gate(f"sharded_roundtrip_hopped(hop={hop}) m={m} {nb}x{B} spectra vs f64 (abs)",
         e_d, 2e-7)
    gate(f"sharded_roundtrip_hopped(hop={hop}) samples vs f64 (abs)", e_y, 1e-4)
    gate("sharded_roundtrip_hopped vs roundtrip_hopped, spectra (abs)",
         maxerr(hd, hdu), 1e-7)
    gate("sharded_roundtrip_hopped vs roundtrip_hopped, samples (abs)",
         maxerr(ys, ysu), 1e-6)
    errs["shard_hop100_abs"] = (e_d, e_y)
    _, hs = par.sharded_sdft_hopped(plan, mesh, sth, xs.reshape(1, -1), hop)
    gate(f"sharded_sdft_hopped(hop={hop}) vs f64 (abs)",
         maxerr(hs.to_local()[0], d64[::hop]), 1e-7)
    del d64
    jobs["shard_hop100"] = (
        f"sharded_roundtrip_hopped(hop={hop}) m={m} {nb}x{B} vs roundtrip_hopped",
        lambda plan=plan, xs=xs: par.sharded_roundtrip_hopped(plan, mesh, sth, xs, hop),
        lambda plan=plan, xs=xs: T.roundtrip_hopped(plan, sth, xs, hop), 3)

    # -- K2 per time shard: sharded_roundtrip_pallas over chained
    # blocks, against roundtrip_hopped(hop=1) and float64; run twice,
    # bit for bit
    B, nb = SHARD_Y_BLOCK, SHARD_Y_BLOCKS
    xs = signal(nb * B, SEED + 53, dev).reshape(nb, 1, B)

    def chain():
        st, ds, ys = sth, [], []
        for b in range(nb):
            st, d, y = par.sharded_roundtrip_pallas(plan, mesh, st, xs[b])
            ds.append(d.to_local())
            ys.append(y.to_local())
        return st, torch.stack(ds), torch.stack(ys)

    k2 = Q.LAUNCHES
    st1, d1, y1 = count("sharded_roundtrip_pallas", chain)
    if Q.LAUNCHES - k2 != nb * mesh.shape[1]:
        raise AssertionError(f"sharded_roundtrip_pallas over {nb} blocks: {Q.LAUNCHES - k2} "
                             "K2 launches, expected one per block and time shard")
    _, d2, y2 = count("sharded_roundtrip_pallas", chain)
    same = torch.equal(d1, d2) and torch.equal(y1, y2)
    print(f"  sharded_roundtrip_pallas run twice bit-identical: {same}", flush=True)
    if not same:
        raise AssertionError("sharded_roundtrip_pallas does not repeat itself")
    _, hdu, ysu = T.roundtrip_hopped(plan, sth, xs, 1, refresh_every=1)
    _, hd64, ys64 = T.roundtrip_hopped(p64, T.init_state(p64, channels=1, device=dev),
                                       xs, 1, refresh_every=1)
    scale = hd64.abs().max().item()
    gate(f"sharded_roundtrip_pallas m={m} {nb}x{B} spectra vs f64 / scale",
         maxerr(d1, hd64) / scale, 1.5e-5)
    gate("sharded_roundtrip_pallas samples vs f64 (abs)", maxerr(y1, ys64), 1e-4)
    gate("sharded_roundtrip_pallas vs roundtrip_hopped(hop=1), spectra (abs)",
         maxerr(d1, hdu), 1e-7)
    gate("sharded_roundtrip_pallas vs roundtrip_hopped(hop=1), samples (abs)",
         maxerr(y1, ysu), 1e-6)
    print(f"  sharded_roundtrip_pallas equals roundtrip_hopped(hop=1) bit for bit: "
          f"{torch.equal(d1, hdu) and torch.equal(y1, ysu)}", flush=True)
    errs["shard_hop1_rel"] = maxerr(d1, hd64) / scale
    del d1, d2, hdu, hd64
    # two channels: still one K2 launch per time shard
    x2 = signal(2 * B, SEED + 54, dev).reshape(2, B)
    st2 = T.init_state(plan, channels=2, device=dev)
    k2 = Q.LAUNCHES
    _, d2, y2 = count("sharded_roundtrip_pallas", lambda: par.sharded_roundtrip_pallas(
        plan, mesh, st2, x2))
    if Q.LAUNCHES - k2 != mesh.shape[1]:
        raise AssertionError(f"sharded_roundtrip_pallas 2x{B}: {Q.LAUNCHES - k2} K2 launches, "
                             "expected one per time shard")
    _, hdu, ysu = T.roundtrip_hopped(plan, st2, x2[None], 1, refresh_every=1)
    gate(f"sharded_roundtrip_pallas 2x{B} (one launch) vs roundtrip_hopped(hop=1), spectra "
         "(abs)", maxerr(d2.to_local(), hdu[0]), 1e-7)
    gate(f"sharded_roundtrip_pallas 2x{B} vs roundtrip_hopped(hop=1), samples (abs)",
         maxerr(y2.to_local(), ysu[0]), 1e-6)
    del d2, hdu
    jobs["shard_k2"] = (
        f"sharded_roundtrip_pallas m={m} {nb}x{B} vs roundtrip_hopped(hop=1)",
        chain, lambda plan=plan, xs=xs: T.roundtrip_hopped(plan, sth, xs, 1, refresh_every=1),
        3)

    # -- the CLI's --mesh 1x1x1 --fd32 against the float64 CLI of
    # part b on the same WAV
    with tempfile.TemporaryDirectory() as tmp2:
        src = cli_wav(tmp2)
        args = ["1000", "100", "hann", "1", src, f"{tmp2}/m.wav", f"{tmp2}/m.dft",
                "--fd32", "--mesh", "1x1x1"]
        t0 = time.perf_counter()
        if cli.main(args) != 0:
            raise AssertionError("cli --mesh 1x1x1 failed")
        t_cli = time.perf_counter() - t0
        ym, dm = read_wav(f"{tmp2}/m.wav")[0], load_complex(f"{tmp2}/m.dft", 1000)
    (y64, dd64), (y32, d32) = cli_ref["f64"], cli_ref["fd32"]
    if dm.shape != dd64.shape or ym.shape != y64.shape:
        raise AssertionError(f"cli --mesh shapes {dm.shape} {ym.shape}")
    gate("cli --mesh 1x1x1 --fd32 vs float64 .dft (abs)", float(np.abs(dm - dd64).max()),
         2e-7)
    gate("cli --mesh 1x1x1 --fd32 vs float64 wav (abs)", float(np.abs(ym - y64).max()),
         1e-4)
    print(f"  cli --mesh 1x1x1 --fd32 vs the single-device --fd32: .dft "
          f"{np.abs(dm - d32).max():.3e}, wav {np.abs(ym - y32).max():.3e}; "
          f"{t_cli:.2f} s host clock [{card}]", flush=True)
    errs["shard_cli_s"] = t_cli
    sharded_graph_path(T, S, Q, dev, card, mesh)
    return errs, jobs, count.by


def local_leaves(out) -> list:
    """The local tensors of a sharded program's output (DTensors, a State
    of DTensors, tuples of them), in order."""
    if isinstance(out, (tuple, list)):
        return [t for v in out for t in local_leaves(v)]
    return [out.to_local() if hasattr(out, "to_local") else out]


def sharded_cells(T, dev, mesh) -> dict:
    """Every sharded program at part d's shapes, on carried (non-zero)
    states: {label: (call, K1 launches, K2 launches per call and time
    shard)}."""
    from sdft_tpu_torch import parallel as par

    f32 = T.FAST_PRECISION
    big = T.Plan(SHARD_M, window="hann", precision=f32)
    drv = T.Plan(SHARD_HOP_M, window="hann", precision=f32)
    lead = signal(3000, SEED + 56, dev)
    st1 = T.sdft(big, T.init_state(big, channels=1, device=dev), lead[None])[0]
    C = SHARD_BATCH[0]
    st8 = T.sdft(big, T.init_state(big, channels=C, device=dev), lead[:1000].repeat(C, 1))[0]
    sd = T.sdft(drv, T.init_state(drv, channels=1, device=dev), lead[None])[0]
    sd2 = T.sdft(drv, T.init_state(drv, channels=2, device=dev), lead[:1000].repeat(2, 1))[0]
    x = signal(SHARD_BLOCK, SEED + 55, dev)[None]
    xb = signal(SHARD_BATCH[0] * SHARD_BATCH[1], SEED + 57, dev).reshape(SHARD_BATCH)
    xs = x[:, :SHARD_SCAN_BLOCK]
    d16 = T.sdft(big, st1, xs)[1]
    hop, B, nb = SHARD_HOP, SHARD_HOP_BLOCK, SHARD_HOP_BLOCKS
    xh = signal(nb * B, SEED + 58, dev).reshape(nb, 1, B)
    xy = signal(2 * SHARD_Y_BLOCK, SEED + 59, dev).reshape(2, SHARD_Y_BLOCK)
    low = lambda z, bins: z * (bins < 400)  # noqa: E731
    return {
        f"sharded_sdft_pallas planar f32 m={SHARD_M} 1x{SHARD_BLOCK}": (
            lambda: par.sharded_sdft_pallas(big, mesh, st1, x, layout="planar"), 1, 0),
        f"sharded_sdft_pallas planar bf16 m={SHARD_M} 1x{SHARD_BLOCK}": (
            lambda: par.sharded_sdft_pallas(big, mesh, st1, x, layout="planar",
                                            spectra_dtype="bfloat16"), 1, 0),
        f"sharded_sdft_pallas planar f32 m={SHARD_M} {SHARD_BATCH[0]}x{SHARD_BATCH[1]}": (
            lambda: par.sharded_sdft_pallas(big, mesh, st8, xb, layout="planar"), 1, 0),
        f"sharded_sdft (K1) m={SHARD_M} 1x{SHARD_SCAN_BLOCK}": (
            lambda: par.sharded_sdft(big, mesh, st1, xs), 1, 0),
        f"sharded_sdft scan form m={SHARD_M} 1x{SHARD_SCAN_BLOCK}": (
            lambda: par.sharded_sdft(big, mesh, st1, xs, use_pallas=False), 0, 0),
        f"sharded_isdft m={SHARD_M} 1x{SHARD_SCAN_BLOCK}": (
            lambda: par.sharded_isdft(big, mesh, d16), 0, 0),
        f"sharded_roundtrip (collapsed) m={SHARD_M} 1x{SHARD_BLOCK}": (
            lambda: par.sharded_roundtrip(big, mesh, st1, x), 0, 0),
        f"sharded_roundtrip scan form m={SHARD_M} 1x{SHARD_SCAN_BLOCK}": (
            lambda: par.sharded_roundtrip(big, mesh, st1, xs, collapsed=False), 0, 0),
        f"sharded_roundtrip(low-pass) m={SHARD_M} 1x{SHARD_SCAN_BLOCK}": (
            lambda: par.sharded_roundtrip(big, mesh, st1, xs, transform=low), 0, 0),
        f"sharded_sdft_hopped hop={hop} m={SHARD_HOP_M} 1x{nb * B}": (
            lambda: par.sharded_sdft_hopped(drv, mesh, sd, xh.reshape(1, -1), hop), 0, 0),
        SHARD_CHAIN: (lambda: par.sharded_roundtrip_hopped(drv, mesh, sd, xh, hop), 0, 0),
        f"sharded_roundtrip_pallas (K2) m={SHARD_HOP_M} 1x{SHARD_Y_BLOCK}": (
            lambda: par.sharded_roundtrip_pallas(drv, mesh, sd, xy[:1]), 0, 1),
        f"sharded_roundtrip_pallas (K2) m={SHARD_HOP_M} 2x{SHARD_Y_BLOCK}": (
            lambda: par.sharded_roundtrip_pallas(drv, mesh, sd2, xy), 0, 1),
    }


#: the sharded driver chain of ``sharded_cells``
SHARD_CHAIN = (f"sharded_roundtrip_hopped hop={SHARD_HOP} m={SHARD_HOP_M} "
               f"{SHARD_HOP_BLOCKS}x{SHARD_HOP_BLOCK}")


def sharded_graph_path(T, S, Q, dev, card: str, mesh) -> None:
    """Part d, the graphs: every sharded program of ``sharded_cells`` on the
    one-rank mesh, graphed (the default) against its eager run under
    ``graphs.disabled()``, bit for bit; a cached call replays the program's
    own graphs and launches K1 and K2 once per time shard; each sharded
    graph's capture time and pool bytes; the sharded driver chain's
    profiler trace (one copy of a block's spectra per block, into the
    stack); a warm graphed ``sharded_sdft_pallas`` and one warm
    ``sharded_roundtrip_hopped`` block under ``set_sync_debug_mode("error")``."""
    from sdft_tpu_torch import graphs

    cells = sharded_cells(T, dev, mesh)
    nt = mesh.shape[1]
    for label, (call, k1, k2) in cells.items():
        first = local_leaves(call())
        q, s1 = Q.LAUNCHES, S.LAUNCHES
        second = local_leaves(call())
        launched = (S.LAUNCHES - s1, Q.LAUNCHES - q)
        last = graphs.entries()[-1].name     # the graph the cached call replayed last
        again = same(first, second)
        del second
        with graphs.disabled():
            eager = local_leaves(call())
        torch.cuda.synchronize()
        diff = max(maxerr(a, b) for a, b in zip(first, eager))
        print(f"  sharded graphs {label}: graphed vs eager bit for bit {same(first, eager)} "
              f"(largest difference {diff:.3e}); the same inputs again equal {again}; K1, K2 "
              f"launches per cached call {launched} (expected {k1 * nt}, {k2 * nt}); last graph "
              f"replayed {last}", flush=True)
        if not same(first, eager):
            raise AssertionError(f"sharded graphs {label}: the graphed result differs from eager")
        if not again:
            raise AssertionError(f"sharded graphs {label}: a second call differs")
        if launched != (k1 * nt, k2 * nt):
            raise AssertionError(f"sharded graphs {label}: {launched} K1, K2 launches, expected "
                                 f"one per time shard")
        if not last.startswith("sharded_"):
            raise AssertionError(f"sharded graphs {label}: no sharded graph replayed")
        del first, eager
    for e in graphs.entries():
        if e.name.startswith("sharded_"):
            shapes = " ".join("x".join(map(str, s[0])) or "()" for s in e.key[2])
            print(f"  graph {e.name} [{shapes}]: capture {e.capture_s * 1e3:.1f} ms (warm-up "
                  f"included), pool +{e.pool_bytes / 2**20:.1f} MiB [{card}]", flush=True)
    chain_copies(cells[SHARD_CHAIN][0], SHARD_HOP_BLOCKS, SHARD_CHAIN, k2=False,
                 stack_copies=SHARD_HOP_BLOCKS)
    warm = (cells[f"sharded_sdft_pallas planar f32 m={SHARD_M} 1x{SHARD_BLOCK}"][0],
            cells[SHARD_CHAIN][0])
    one_block = sharded_one_block(T, dev, mesh)
    for call in (*warm, one_block):
        call()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        warm[0]()
        one_block()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    print("  sync: a warm graphed sharded_sdft_pallas and one sharded_roundtrip_hopped block "
          "raised nothing under set_sync_debug_mode('error')", flush=True)


def sharded_one_block(T, dev, mesh):
    """One block of the sharded driver chain at part d's shapes."""
    from sdft_tpu_torch import parallel as par

    drv = T.Plan(SHARD_HOP_M, window="hann", precision=T.FAST_PRECISION)
    st = T.init_state(drv, channels=1, device=dev)
    x = signal(SHARD_HOP_BLOCK, SEED + 69, dev).reshape(1, 1, SHARD_HOP_BLOCK)
    return lambda: par.sharded_roundtrip_hopped(drv, mesh, st, x, SHARD_HOP)


#: the port's examples, driven on the card by part e
EXAMPLES = ("analysis", "latency", "precision", "stft_window_test", "streaming", "transform")


def captured(fn, *args) -> str:
    """Run ``fn(*args)`` with its standard output captured, which is then
    printed indented and returned; a non-zero return raises."""
    import contextlib
    import io

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = fn(*args)
    out = buf.getvalue()
    print("".join(f"    | {line}\n" for line in out.splitlines()), end="", flush=True)
    if rc != 0:
        raise AssertionError(f"{fn.__name__}{args} returned {rc}")
    return out


def bench_mesh(card: str) -> dict:
    """Part e, inside part d's one-rank group: ``bench --mesh 1x1x1``."""
    from sdft_tpu_torch import cli

    out = captured(cli.main, ["bench", "--mesh", "1x1x1"])
    row = json.loads(out.strip().splitlines()[-1])
    print(f"  bench --mesh 1x1x1: {row['value']:.4e} samples/s, scaling efficiency "
          f"{row['scaling_efficiency_vs_1dev']} [{card}]", flush=True)
    if not row["value"] > 0:
        raise AssertionError(f"bench --mesh 1x1x1 value {row['value']}")
    return row


def tools_path(T, S, Q, card: str) -> dict:
    """Part e: the tools a user runs.  ``bench 4096 16384 3`` (both rows
    positive, the scan-form row through K2, every roofline share <= 1.05);
    ``trace`` over the CLI at m = 1000, hop = 1, --fd32 on part b's 8 s WAV
    (the trace parses and holds K2's kernel, the outputs equal an untraced
    run's bit for bit); each ``examples/*_torch.py`` on cuda:0
    (``analysis_torch`` through K1); ``scripts/crosscheck_torch.py`` at
    m = 1000, hop = 100, --fd32 in a subprocess, so that the native
    oracle's FTZ/DAZ never reaches this process."""
    import filecmp
    import importlib.util
    import re

    from sdft_tpu_torch import cli

    res = {}
    k2 = Q.LAUNCHES
    out = captured(cli.main, ["bench", "4096", "16384", "3"])
    rates = [float(r.replace(",", "")) for r in re.findall(r"-> ([\d,]+) samples/s", out)]
    shares = [float(s) / 100 for s in re.findall(r"([\d.]+)% of bound", out)
              + re.findall(r"roofline fraction: ([\d.]+)%", out)]
    print(f"  bench rows (samples/s): {rates}; K2 launches {Q.LAUNCHES - k2}; shares of "
          f"bound and roofline fractions {shares} [{card}]", flush=True)
    if len(rates) != 2 or min(rates) <= 0:
        raise AssertionError(f"bench rows {rates}")
    if Q.LAUNCHES == k2:
        raise AssertionError("bench's scan-form row did not launch K2")
    if len(shares) != 3 or max(shares) > 1.05:
        raise AssertionError(f"bench shares {shares}: a count or the clock is wrong")
    res["bench_samples_per_s"] = rates

    with tempfile.TemporaryDirectory() as tmp:
        src = cli_wav(tmp)
        args = ["1000", "1", "hann", "1", src]
        t0 = time.perf_counter()
        captured(cli.main, ["trace", f"{tmp}/tb"] + args + [f"{tmp}/t.wav", f"{tmp}/t.dft",
                                                           "--fd32"])
        t_traced = time.perf_counter() - t0
        t0 = time.perf_counter()
        captured(cli.main, args + [f"{tmp}/u.wav", f"{tmp}/u.dft", "--fd32"])
        t_plain = time.perf_counter() - t0
        traces = list(pathlib.Path(tmp, "tb").glob("*.pt.trace.json"))
        if len(traces) != 1:
            raise AssertionError(f"trace wrote {traces}")
        events = json.loads(traces[0].read_text())["traceEvents"]
        kernels = {e["name"] for e in events if e.get("cat") == "kernel"}
        k2_names = sorted(n for n in kernels if "scan_kernel" in n)
        same = all(filecmp.cmp(f"{tmp}/t.{x}", f"{tmp}/u.{x}", shallow=False)
                   for x in ("dft", "wav"))
        print(f"  trace: {traces[0].stat().st_size / 2**20:.1f} MiB, {len(events)} events, "
              f"{len(kernels)} kernel names, K2's: {k2_names[:2]}; traced CLI "
              f"{t_traced:.2f} s, untraced {t_plain:.2f} s host clock; .dft "
              f"{pathlib.Path(tmp, 'u.dft').stat().st_size / 2**30:.2f} GiB; outputs "
              f"bit-identical: {same} [{card}]", flush=True)
        if not k2_names:
            raise AssertionError("the trace holds no K2 kernel")
        if not same:
            raise AssertionError("the traced CLI's outputs differ from the untraced run's")
        res["trace_s"] = (t_traced, t_plain)

        for name in EXAMPLES:
            spec = importlib.util.spec_from_file_location(
                f"{name}_torch", ROOT / "examples" / f"{name}_torch.py")
            mod = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(mod)
            k1 = S.LAUNCHES
            t0 = time.perf_counter()
            kw = {"out_dir": f"{tmp}/ex"} if name in ("analysis", "transform") else {}
            mod.main(device="cuda:0", **kw)
            print(f"  example {name}_torch: {time.perf_counter() - t0:.2f} s host clock, "
                  f"K1 launches {S.LAUNCHES - k1} [{card}]", flush=True)
            if name == "analysis" and S.LAUNCHES == k1:
                raise AssertionError("analysis_torch did not launch K1")

        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, str(ROOT / "scripts" / "crosscheck_torch.py"), "1000", "100",
             "hann", "1", src, "--fd32"], capture_output=True, text=True, timeout=600,
            cwd=str(ROOT))
        print("".join(f"    | {line}\n" for line in proc.stdout.splitlines()[-12:]), end="")
        print(f"  crosscheck_torch --fd32: exit {proc.returncode}, "
              f"{time.perf_counter() - t0:.2f} s host clock [{card}]", flush=True)
        if proc.returncode != 0:
            raise AssertionError(f"crosscheck_torch failed:\n{proc.stderr[-3000:]}")
    return res


def sharded_timings(T, jobs: dict, card: str, dev, mesh) -> dict:
    """Phase 5, the sharded programs: each graphed and eager beside its
    unsharded call, in turns; the flagship K1 program's device time by
    kernel; the host time of the DTensor steps around the graphs."""
    out = {key: timed_pair(name, a, b, reps, card) for key, (name, a, b, reps) in jobs.items()}
    _, a, b, _ = jobs["shard_k1"]
    for who, fn in (("sharded_sdft_pallas", a), ("sdft", b)):
        print(f"timing: device time by kernel, {who} 1x{SHARD_BLOCK}: {top_kernels(fn)} "
              f"[{card}]", flush=True)
    out["dtensor_ms"] = dtensor_steps(T, dev, card, mesh)
    return out


def dtensor_steps(T, dev, card: str, mesh) -> dict:
    """Host ms per call of the DTensor steps that stay outside the graphs
    (``parallel.sharded``: taking this rank's shard of the inputs,
    assembling the outputs), median of 20 calls after 3, at the shapes of
    the flagship ``sharded_sdft_pallas`` and of the hop=100 driver chain."""
    from torch.distributed.tensor import Replicate, Shard

    from sdft_tpu_torch.parallel import sharded as sh

    plan = T.Plan(SHARD_M, window="hann", precision=T.FAST_PRECISION)
    drv = T.Plan(SHARD_HOP_M, window="hann", precision=T.FAST_PRECISION)
    st, sd = (T.init_state(p, channels=1, device=dev) for p in (plan, drv))
    x = signal(SHARD_BLOCK, SEED + 67, dev)[None]
    xh = signal(SHARD_HOP_BLOCKS * SHARD_HOP_BLOCK, SEED + 68, dev).reshape(
        SHARD_HOP_BLOCKS, 1, SHARD_HOP_BLOCK)
    planes = [torch.empty(1, SHARD_BLOCK, SHARD_M, device=dev) for _ in range(2)]
    hd = torch.empty(SHARD_HOP_BLOCKS, 1, SHARD_HOP_BLOCK // SHARD_HOP, SHARD_HOP_M, 2,
                     device=dev)
    steps = {
        "sharded_sdft_pallas inputs (state, 1x65536)": lambda: (
            sh._local_state(mesh, st), sh._local(mesh, x, sh.SAMPLE_SPEC)),
        "sharded_sdft_pallas outputs (state, planar pair)": lambda: (
            sh._global_state(mesh, st),
            [sh.host_local_to_global(mesh, sh.SAMPLE_SPEC, p) for p in planes]),
        "sharded_roundtrip_hopped inputs (state, 8x1x16000)": lambda: (
            sh._local_state(mesh, sd), sh._local(mesh, xh, (Shard(1), Shard(2), Replicate()))),
        "sharded_roundtrip_hopped outputs (state, hop spectra, samples)": lambda: (
            sh._global_state(mesh, sd),
            sh.host_local_to_global(mesh, (Shard(1), Shard(2), Shard(3)), hd),
            sh.host_local_to_global(mesh, (Shard(1), Shard(2), Replicate()), xh)),
    }
    out = {}
    for label, fn in steps.items():
        ts = []
        for i in range(23):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            if i >= 3:
                ts.append((time.perf_counter() - t0) * 1e3)
        out[label] = float(np.median(ts))
        print(f"timing: DTensor steps, {label}: {out[label]:.4f} ms host per call (median of "
              f"20; range {min(ts):.4f}-{max(ts):.4f}) [{card}]", flush=True)
    return out


#: the multi-card check (``--cards 4``): its meshes, and its shapes
CARD_MESHES = ((1, 4, 1), (1, 2, 2), (1, 1, 4))
CARD_M, CARD_BLOCK, CARD_HOP, CARD_Y_BLOCK = 1000, 64000, 100, 32000
CARD_FLAGSHIP_M, CARD_FLAGSHIP_BLOCK = 4096, 65536
#: seconds after which a rank of the multi-card check prints its stacks
CARD_STACKS_S = 120


def _card_rank(rank: int, n: int, init: str):
    """One rank of the multi-card check: every program on each mesh of
    CARD_MESHES, gathered whole and held on every rank against the
    unsharded call on its own card and against float64 (the gates of part
    d); rank 0 prints."""
    import datetime
    import faulthandler

    import torch.distributed as dist

    import sdft_tpu_torch as T
    from sdft_tpu_torch import graphs
    from sdft_tpu_torch import parallel as par
    from sdft_tpu_torch.kernels import scan as Q, spectra as S
    from sdft_tpu_torch.ops.analysis import sdft_block

    torch.cuda.set_device(rank)
    dist.init_process_group("nccl", init_method=init, world_size=n, rank=rank,
                            timeout=datetime.timedelta(seconds=180))
    dev = torch.device("cuda", rank)
    say = print if rank == 0 else (lambda *a, **k: None)
    # a rank still running after CARD_STACKS_S prints every thread's stack
    # once (where a collective that never completes waits)
    faulthandler.dump_traceback_later(CARD_STACKS_S)
    t_start = time.perf_counter()

    def check(name: str, err: float, limit: float) -> None:
        if rank == 0:
            gate(name, err, limit)
        elif not err <= limit:
            raise AssertionError(f"rank {rank}: {name}: error {err:.3e} exceeds {limit:.3e}")

    m, M, hop = CARD_M, CARD_BLOCK, CARD_HOP
    plan = T.Plan(m, window="hann", precision=T.FAST_PRECISION)
    p64 = f64(plan)
    x = signal(M, SEED + 70, dev)
    st64, d64 = T.sdft(p64, T.init_state(p64, device=dev), x)
    y64 = T.isdft(p64, d64)
    scale = d64.abs().max().item()
    # the scan form (bins > 1) is held to 1.5 x the error of the unsharded
    # float32 ops path on the same input, as in part d
    e_ops = maxerr(sdft_block(plan, T.init_state(plan, device=dev), x)[1], d64) / scale
    say(f"cards: ops float32 (unsharded) vs f64 / scale {e_ops:.3e}", flush=True)
    st1 = T.init_state(plan, channels=1, device=dev)
    keep = torch.arange(m, device=dev) < m // 4
    _, yt64 = T.roundtrip(p64, T.init_state(p64, device=dev), x[:M // 4],
                          transform=lambda z: z * keep)
    short = x[:4 * (m // 2)]
    _, yshu = T.roundtrip(plan, T.init_state(plan, device=dev), short)
    xy = x[:2 * CARD_Y_BLOCK].reshape(2, 1, CARD_Y_BLOCK)
    _, _, yh64 = T.roundtrip_hopped(p64, T.init_state(p64, device=dev), xy[:, 0], 1,
                                    refresh_every=1)

    def programs(mesh, axes) -> dict:
        """Every program on the mesh: {name: output}."""
        out = {}
        out["sdft"] = par.sharded_sdft(plan, mesh, st1, x[None])
        out["roundtrip"] = par.sharded_roundtrip(plan, mesh, st1, x[None])
        out["isdft"] = par.sharded_isdft(plan, mesh, d64[None, :M // 4].float())
        out["roundtrip_hopped"] = par.sharded_roundtrip_hopped(
            plan, mesh, st1, x.reshape(4, 1, M // 4), hop)
        out["sdft_hopped"] = par.sharded_sdft_hopped(plan, mesh, st1, x[None], hop)
        # local blocks shorter than 2m: the comb history is all_gathered
        out["roundtrip short"] = par.sharded_roundtrip(plan, mesh, st1, short[None])
        out["roundtrip(transform)"] = par.sharded_roundtrip(
            plan, mesh, st1, x[None, :M // 4], transform=lambda z, bins: z * (bins < m // 4))
        if axes[2] == 1:
            for r in range(2):
                st, outs = st1, []
                for b in range(2):
                    st, dd, yy = par.sharded_roundtrip_pallas(plan, mesh, st, xy[b])
                    outs += [dd, yy]
                out[f"roundtrip_pallas run {r}"] = (st, *outs)
        return out

    for axes in CARD_MESHES:
        mesh = par.make_mesh(*axes)
        tag = "x".join(map(str, axes))
        say(f"cards: mesh {tag} over {n} ranks, backend {dist.get_backend()}, "
            f"{time.perf_counter() - t_start:.1f} s after the ranks began", flush=True)
        graphs.clear()
        k1, k2 = S.LAUNCHES, Q.LAUNCHES
        t0 = time.perf_counter()
        got = programs(mesh, axes)
        torch.cuda.synchronize()
        t_graphed = time.perf_counter() - t0
        launched = (S.LAUNCHES - k1, Q.LAUNCHES - k2)
        st, d = got["sdft"]
        klass = 3e-6 if axes[2] == 1 else 1.5 * e_ops  # K1, or the scan form
        check(f"[{tag}] sharded_sdft vs f64 / scale",
              maxerr(d.full_tensor()[0], d64) / scale, klass)
        check(f"[{tag}] sharded_sdft accumulator vs f64",
              maxerr(st.accumulator.full_tensor()[0], st64.accumulator), 4e-3)
        check(f"[{tag}] sharded_roundtrip (collapsed) vs f64 sdft+isdft (abs)",
              maxerr(got["roundtrip"][1].full_tensor()[0], y64), 2e-5)
        check(f"[{tag}] sharded_isdft vs f64 (abs)",
              maxerr(got["isdft"].full_tensor()[0], y64[:M // 4]), 1e-4)
        _, hd, ys = got["roundtrip_hopped"]
        check(f"[{tag}] sharded_roundtrip_hopped(hop={hop}) spectra vs f64 (abs)",
              maxerr(hd.full_tensor().reshape(-1, m, 2), d64[::hop]), 2e-7)
        check(f"[{tag}] sharded_roundtrip_hopped samples vs f64 (abs)",
              maxerr(ys.full_tensor().reshape(-1), y64), 1e-4)
        check(f"[{tag}] sharded_sdft_hopped(hop={hop}) vs f64 (abs)",
              maxerr(got["sdft_hopped"][1].full_tensor()[0], d64[::hop]), 1e-7)
        check(f"[{tag}] sharded_roundtrip, local blocks < 2m, vs roundtrip (abs)",
              maxerr(got["roundtrip short"][1].full_tensor()[0], yshu), 2e-5)
        check(f"[{tag}] sharded_roundtrip(transform) vs f64 (abs)",
              maxerr(got["roundtrip(transform)"][1].full_tensor()[0], yt64), 1e-4)
        if axes[2] == 1:
            runs = [got[f"roundtrip_pallas run {r}"] for r in range(2)]
            if not all(torch.equal(a, b) for a, b in zip(*map(local_leaves, runs))):
                raise AssertionError(f"[{tag}] sharded_roundtrip_pallas does not repeat itself")
            dk = torch.cat([runs[0][1].full_tensor(), runs[0][3].full_tensor()], dim=1)[0]
            yk = torch.cat([runs[0][2].full_tensor(), runs[0][4].full_tensor()], dim=1)[0]
            check(f"[{tag}] sharded_roundtrip_pallas spectra vs f64 / scale",
                  maxerr(dk, d64[:2 * CARD_Y_BLOCK]) / scale, 1.5e-5)
            check(f"[{tag}] sharded_roundtrip_pallas samples vs f64 (abs)",
                  maxerr(yk, yh64.reshape(-1)), 1e-4)
            say(f"  [{tag}] sharded_roundtrip_pallas run twice bit-identical: True", flush=True)
            del runs, dk
        say(f"  [{tag}] rank 0 launches (K1, K2): {launched}", flush=True)
        if axes[2] == 1 and min(launched) <= 0:
            raise AssertionError(f"[{tag}] K1 or K2 not launched on a bins=1 mesh")
        # graphed (the default, each rank's body with its NCCL collectives
        # in its graphs) against eager, bit for bit on every rank
        names = sorted({e.name for e in graphs.entries() if e.name.startswith("sharded_")})
        t0 = time.perf_counter()
        with graphs.disabled():
            eager = programs(mesh, axes)
        torch.cuda.synchronize()
        t_eager = time.perf_counter() - t0
        differ = [k for k in got if not same(local_leaves(got[k]), local_leaves(eager[k]))]
        flag = torch.tensor([float(bool(differ))], device=dev)
        dist.all_reduce(flag, op=dist.ReduceOp.MAX)
        say(f"  [{tag}] graphed vs eager, every program, bit for bit on every rank: "
            f"{flag.item() == 0} (rank 0 differs in {differ}); graphs {names}; first calls "
            f"{t_graphed:.2f} s graphed (captures included), {t_eager:.2f} s eager, host "
            f"clock", flush=True)
        if flag.item() != 0:
            raise AssertionError(f"[{tag}] a graphed program differs from its eager run")
        del got, eager, d, hd, ys
    del d64, y64

    # the flagship spectra over the four cards: sharded_sdft_pallas on 1x4x1
    # beside sdft on one card, for the same 4 x 65536 samples
    mesh = par.make_mesh(1, n, 1)
    fplan = T.Plan(CARD_FLAGSHIP_M, window="hann", precision=T.FAST_PRECISION)
    xf = signal(n * CARD_FLAGSHIP_BLOCK, SEED + 71, dev)
    stf = T.init_state(fplan, channels=1, device=dev)
    _, (re, im) = par.sharded_sdft_pallas(fplan, mesh, stf, xf[None], layout="planar")
    local = planar_complex(re.to_local()[0], im.to_local()[0])
    lo = rank * CARD_FLAGSHIP_BLOCK
    _, (ure, uim) = T.sdft(fplan, T.init_state(fplan, device=dev), xf, "planar")
    u = planar_complex(ure[lo:lo + CARD_FLAGSHIP_BLOCK], uim[lo:lo + CARD_FLAGSHIP_BLOCK])
    err = torch.tensor([(local - u).abs().max().item() / u.abs().max().item()], device=dev)
    dist.all_reduce(err, op=dist.ReduceOp.MAX)
    check(f"[1x{n}x1] sharded_sdft_pallas m={CARD_FLAGSHIP_M} {n}x{CARD_FLAGSHIP_BLOCK} "
          f"planar f32 vs sdft on one card / scale (worst rank)", err.item(), 3e-6)
    del re, im, local, ure, uim, u

    def sharded():
        par.sharded_sdft_pallas(fplan, mesh, stf, xf[None], layout="planar")
        torch.cuda.synchronize()
        dist.barrier()

    def sharded_eager():
        with graphs.disabled():
            sharded()

    def single():
        T.sdft(fplan, T.init_state(fplan, device=dev), xf, "planar")
        torch.cuda.synchronize()

    t = {}
    for who, fn in (("one card", single), (f"{n} cards graphed", sharded),
                    (f"{n} cards eager", sharded_eager), (f"{n} cards eager", sharded_eager),
                    (f"{n} cards graphed", sharded), ("one card", single)):
        fn()
        dist.barrier()
        t0 = time.perf_counter()
        for _ in range(3):
            fn()
        t.setdefault(who, []).append((time.perf_counter() - t0) / 3 * 1e3)
    for who, ms in t.items():
        say(f"timing: {n * CARD_FLAGSHIP_BLOCK} samples at m={CARD_FLAGSHIP_M}, planar f32, "
            f"{who}: {'/'.join(f'{v:.4f}' for v in ms)} ms per call (host clock, to the last "
            f"card's end), {n * CARD_FLAGSHIP_BLOCK / min(ms) * 1e3:.4e} samples/s", flush=True)
    for who in (f"{n} cards graphed", f"{n} cards eager"):
        say(f"timing: {who} against one card: {min(t['one card']) / min(t[who]):.3f}x one "
            f"card's speed (best of turns) [{torch.cuda.get_device_name(dev)}]", flush=True)
    say(f"cards: the ranks took {time.perf_counter() - t_start:.1f} s", flush=True)
    par.multihost.shutdown()
    faulthandler.cancel_dump_traceback_later()


def cards_main(n: int) -> int:
    """``python3 chip_smoke.py --cards N``: the sharded programs over N
    cards (one NCCL rank each), then the CLI under torchrun against the
    single-card CLI.  Needs N cards."""
    import torch.multiprocessing as mp

    card = require_cuda()
    if torch.cuda.device_count() < n:
        raise RuntimeError(f"--cards {n} needs {n} CUDA devices, found "
                           f"{torch.cuda.device_count()}")
    print(card, flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda}; {n} x "
          f"{torch.cuda.get_device_name(0)}", flush=True)
    from sdft_tpu_torch.kernels import _build

    _build.build()
    with tempfile.TemporaryDirectory() as tmp:
        mp.spawn(_card_rank, args=(n, f"file://{tmp}/group"), nprocs=n)
        src = cli_wav(tmp)
        args = ["1000", "100", "hann", "1", src]
        outs = {}
        for tag, cmd in (
                ("one card", [sys.executable, "-m", "sdft_tpu_torch"]),
                (f"torchrun {n} ranks", [sys.executable, "-m", "torch.distributed.run",
                                         "--standalone", f"--nproc-per-node={n}",
                                         "-m", "sdft_tpu_torch"])):
            extra = ["--fd32"] + (["--mesh", f"1x{n}x1"] if "torchrun" in tag else [])
            t0 = time.perf_counter()
            proc = subprocess.run(cmd + args + [f"{tmp}/{len(outs)}.wav", f"{tmp}/{len(outs)}.dft",
                                                *extra], capture_output=True, text=True,
                                  timeout=300, cwd=str(ROOT))
            if proc.returncode != 0:
                raise RuntimeError(f"cli {tag} failed:\n{(proc.stdout + proc.stderr)[-3000:]}")
            from sdft_tpu_torch.io.dump import load_complex
            from sdft_tpu_torch.io.wav import read_wav

            outs[tag] = (read_wav(f"{tmp}/{len(outs)}.wav")[0],
                         load_complex(f"{tmp}/{len(outs)}.dft", 1000))
            print(f"cli {tag}: {time.perf_counter() - t0:.2f} s host clock, process start "
                  f"included; {proc.stdout.strip().splitlines()[-1]}", flush=True)
        (y1, d1), (yn, dn) = outs.values()
        gate(f"cli --mesh 1x{n}x1 --fd32 under torchrun vs one card --fd32, .dft (abs)",
             float(np.abs(dn - d1).max()), 2e-7)
        gate(f"cli --mesh 1x{n}x1 --fd32 under torchrun vs one card --fd32, wav (abs)",
             float(np.abs(yn - y1).max()), 1e-4)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


def print_ptxas(log: pathlib.Path) -> None:
    """ptxas's registers and spills of each K1/K2 instantiation (store
    form, vector stores, window halo; K1's paced clusters), of each probe instantiation (body,
    table inputs, fast; its shared memory is dynamic, csrc/kparts.cu
    smem_bytes), of split_mm's product and split-K kernels (passes) and of
    the carry kernel (vector copies, roots in shared memory), from the
    build log, and any performance remark it made."""
    import re

    from sdft_tpu_torch.kernels import _build

    entries, remarks = _build.ptxas_report(log)
    found = {"spectra": 0, "scan": 0, "kparts": 0, "split_mm": 0, "carry": 0}
    for name, regs, st, ld, smem in entries:
        k12 = re.match(r"_ZN4sdft\d+(spectra|scan)_kernelILi(\d)ELb(\d)ELi(\d)E(?:Lb(\d)E)?",
                       name)
        kp = re.match(r"_ZN6kparts13kparts_kernelILi(\d)ELb(\d)ELb(\d)E", name)
        sm = re.match(r"_ZN8split_mm\d+(split_mm_kernel|split_mm_reduce)ILi(\d)E", name)
        cf = re.match(r"_ZN4sdft5front11carry_frontILb(\d)ELb(\d)E", name)
        if k12:
            kind, store, vec, halo, paced = k12.groups()
            label = f"{kind}_kernel<store={store}, vector={vec}, halo={halo}" + (
                f", paced={paced}>" if paced else ">")
        elif kp:
            kind = "kparts"
            label = "kparts_kernel<body={}, tables={}, fast={}>".format(*kp.groups())
        elif sm:
            kind = "split_mm"
            label = "{}<passes={}>".format(*sm.groups())
        elif cf:
            kind = "carry"
            label = "carry_front<vector={}, shared_rows={}>".format(*cf.groups())
        else:
            continue
        found[kind] += 1
        print(f"ptxas: {label}: {regs} registers, spill {st}/{ld} B, static smem {smem} B",
              flush=True)
    for line in remarks:
        print(f"ptxas: {line}", flush=True)
    for kind, n in found.items():
        if not n:
            raise AssertionError(f"no {kind} kernel in the build log {log}")


def matmul_flags() -> str:
    """The flags the port sets around its matmuls and must restore."""
    mm = torch.backends.cuda.matmul
    return (f"matmul.allow_tf32={mm.allow_tf32} cudnn.allow_tf32={torch.backends.cudnn.allow_tf32} "
            f"matmul.allow_bf16_reduced_precision_reduction="
            f"{mm.allow_bf16_reduced_precision_reduction}")


def main() -> int:
    card = require_cuda()
    dev = torch.device("cuda", 0)
    print(card, flush=True)
    flags = matmul_flags()
    print(f"torch {torch.__version__} cuda {torch.version.cuda}; {flags}", flush=True)

    import sdft_tpu_torch as T
    from sdft_tpu_torch.kernels import _build, carry as F, kparts as P, scan as Q, spectra as S
    from sdft_tpu_torch.kernels import split_mm as M

    t0 = time.perf_counter()
    lib = _build.build()
    _build.library()
    print(f"build: {time.perf_counter() - t0:.2f} s -> {lib.name}", flush=True)
    print_ptxas(lib.with_suffix(".log"))

    def done(part: str) -> None:
        print(f"elapsed: {part} done {time.perf_counter() - t0:.1f} s after the build began",
              flush=True)

    S.LAUNCHES = S.PACED_LAUNCHES = Q.LAUNCHES = F.LAUNCHES = 0
    errs = main_path(T, dev)
    torch.cuda.synchronize()
    launches = {"spectra": S.LAUNCHES, "scan": Q.LAUNCHES, "carry": F.LAUNCHES}
    P.LAUNCHES.update(make=0, tables=0)
    M.LAUNCHES = 0
    errs.update(driver_path(T, dev))
    torch.cuda.synchronize()
    launches.update(kparts_make=P.LAUNCHES["make"], kparts_tables=P.LAUNCHES["tables"],
                    split_mm=M.LAUNCHES)
    print(f"main path launches: {launches}", flush=True)
    done("parts a and b")
    for name, n in launches.items():
        if n <= 0:
            raise AssertionError(f"kernel {name} was not launched on the main path")
    cli_ref = errs.pop("cli")
    S.LAUNCHES = S.PACED_LAUNCHES = Q.LAUNCHES = F.LAUNCHES = 0
    errs.update(stream_path(T, dev))
    torch.cuda.synchronize()
    part_c = {"spectra": S.LAUNCHES, "scan": Q.LAUNCHES, "carry": F.LAUNCHES}
    print(f"stream part launches: {part_c}", flush=True)
    for name, n in part_c.items():
        if n <= 0:
            raise AssertionError(f"kernel {name} was not launched by the stream part")
        launches[name] += n
    done("part c")
    cells = graph_cells(T, Q, dev)
    S.LAUNCHES = S.PACED_LAUNCHES = Q.LAUNCHES = M.LAUNCHES = F.LAUNCHES = 0
    graph_peaks = graph_path(T, S, Q, M, dev, card, cells)
    torch.cuda.synchronize()
    part_f = {"spectra": S.LAUNCHES, "scan": Q.LAUNCHES, "split_mm": M.LAUNCHES,
              "carry": F.LAUNCHES}
    print(f"graphs part launches: {part_f}", flush=True)
    for name, n in part_f.items():
        if n <= 0:
            raise AssertionError(f"kernel {name} was not launched by the graphed paths")
    for name, n in part_f.items():
        launches[name] += n
    done("part f")
    with tempfile.TemporaryDirectory() as tmp:
        # a one-rank NCCL group of its own for part d and its timings
        import torch.distributed as dist
        from sdft_tpu_torch import parallel as par

        par.multihost.initialize(f"file://{tmp}/group", 1, 0)
        try:
            mesh = par.make_mesh(1, 1, 1)
            print(f"sharded: mesh {mesh}, backend {dist.get_backend()}", flush=True)
            S.LAUNCHES = S.PACED_LAUNCHES = Q.LAUNCHES = F.LAUNCHES = 0
            shard_errs, jobs, by_program = sharded_path(T, S, Q, dev, card, cli_ref, mesh)
            torch.cuda.synchronize()
            part_d = {"spectra": S.LAUNCHES, "scan": Q.LAUNCHES, "carry": F.LAUNCHES}
            print(f"sharded part launches: {part_d}; by program (K1, K2): {by_program}",
                  flush=True)
            if by_program.get("sharded_sdft_pallas", [0])[0] <= 0:
                raise AssertionError("sharded_sdft_pallas did not launch K1")
            if by_program.get("sharded_roundtrip_pallas", [0, 0])[1] <= 0:
                raise AssertionError("sharded_roundtrip_pallas did not launch K2")
            if part_d["carry"] <= 0:
                raise AssertionError("the sharded kernel programs did not launch the carry kernel")
            for name, n in part_d.items():
                launches[name] += n
            errs.update(shard_errs)
            done("part d")
            shard_times = sharded_timings(T, jobs, card, dev, mesh)
            done("part d's timings")
            # part e begins here, in part d's group, and goes on after
            # phase 5: once another process had used the card (the
            # crosscheck's subprocess), every later device_time of this
            # process lost 1-3 of 10 K1 events (PERF.md section 6)
            S.LAUNCHES = S.PACED_LAUNCHES = Q.LAUNCHES = F.LAUNCHES = 0
            t_tools = time.perf_counter()
            tools = {"bench_mesh": bench_mesh(card)}
            part_e = {"spectra": S.LAUNCHES, "scan": Q.LAUNCHES, "carry": F.LAUNCHES}
            t_tools = time.perf_counter() - t_tools
        finally:
            par.multihost.shutdown()

    vs_plain = kernels_vs_plain(T, S, Q, dev)
    vs_plain.update({f"kparts_{v}": e for v, e in probes_vs_plain(P, dev).items()})
    vs_plain["split_mm"] = split_mm_vs_plain(dev)
    vs_plain["carry"] = carry_vs_plain(T, dev)
    times = timings(T, S, Q, dev, card)
    times["split_mm"] = split_mm_timings(dev, card)
    times["carry"] = carry_timings(T, dev, card)
    times.update(driver_timings(T, P, dev, card, times["k1_planar_float32"][0]))
    times.update(stream_timings(T, dev, card, times["k1_planar_float32"][0]))
    times["graphs"] = graph_timings(T, dev, card, cells)
    done("phases 4 and 5")
    S.LAUNCHES = S.PACED_LAUNCHES = Q.LAUNCHES = F.LAUNCHES = 0
    t0_tools = time.perf_counter()
    tools.update(tools_path(T, S, Q, card))
    torch.cuda.synchronize()
    part_e = {"spectra": part_e["spectra"] + S.LAUNCHES, "scan": part_e["scan"] + Q.LAUNCHES,
              "carry": part_e["carry"] + F.LAUNCHES}
    print(f"tools part launches: {part_e}", flush=True)
    for name, n in part_e.items():
        if n <= 0:
            raise AssertionError(f"kernel {name} was not launched by the tools part")
        launches[name] += n
    print(f"elapsed: part e took {t_tools + time.perf_counter() - t0_tools:.1f} s", flush=True)
    done("part e")
    print(f"main path errors: {json.dumps(errs)}", flush=True)
    print(f"graphs: peak GiB above the inputs (graphed, eager): "
          f"{json.dumps({k: [v['graphed'], v['eager']] for k, v in graph_peaks.items()})}",
          flush=True)
    print(f"sharded timings (wall ms, device ms, peak GiB): {json.dumps(shard_times)}",
          flush=True)
    print(f"matmul flags after the run: {matmul_flags()}", flush=True)
    if matmul_flags() != flags:
        raise AssertionError(f"the run left the matmul flags at {matmul_flags()}, not {flags}")

    src = "sdft_tpu_torch/kernels/csrc/"
    k1, k2 = times["k1_planar_float32"], times["k2_packed"]
    sm = times["split_mm"]["totals 8x32768", 3]
    cf = times["carry"]["8x44100 m=1000"]
    (b1, bp1, bb1, bby1, bl1, _), (b2, bp2, bb2, bby2) = times["batch"]["k1"], times["batch"]["k2"]
    kernels = [
        {"name": "spectra", "route": "cuda", "source": src + "spectra.cu",
         "replaces": "sdft_tpu/kernels/analysis_pallas.py:509",
         "launches": launches["spectra"], "max_abs_err": vs_plain["spectra"],
         "ms": k1[0], "plain_ms": k1[1], "bound_ms": k1[2], "bound_by": k1[3],
         "library_ms": times["k1_library"],
         "batch": {"shape": "8x32768 planar f32", "ms": b1, "plain_ms": bp1, "bound_ms": bb1,
                   "bound_by": bby1, "library_ms": bl1},
         "k1_spectra_cell": {"shape": "8x44100 m=1000 planar f32, paced",
                             **dict(zip(("ms", "plain_ms", "bound_ms", "bound_by", "unpaced_ms"),
                                        times["batch"]["k1_spectra_cell"]))},
         "sharded_by": {p: n[0] for p, n in by_program.items() if n[0]}},
        {"name": "scan", "route": "cuda", "source": src + "scan.cu",
         "replaces": "sdft_tpu/kernels/analysis_pallas.py:147",
         "launches": launches["scan"], "max_abs_err": vs_plain["scan"],
         "ms": k2[0], "plain_ms": k2[1], "bound_ms": k2[2], "bound_by": k2[3],
         "library_ms": None,
         "batch": {"shape": "8x8000 m=1000 packed f32", "ms": b2, "plain_ms": bp2,
                   "bound_ms": bb2, "bound_by": bby2, "library_ms": None},
         "hop1_cell": {"shape": "8x44100 m=1000 packed f32",
                       **dict(zip(("ms", "plain_ms", "bound_ms", "bound_by"),
                                  times["batch"]["k2_hop1_cell"]))},
         "sharded_by": {p: n[1] for p, n in by_program.items() if n[1]}},
        {"name": "kparts_make", "route": "cuda", "source": src + "kparts.cu",
         "replaces": "scripts/archive/exp_kparts.py:41",
         "launches": launches["kparts_make"], "max_abs_err": vs_plain["kparts_full"],
         "ms": times["kparts_full"][0], "plain_ms": times["kparts_full"][1],
         "bound_ms": times["kparts_full"][2], "bound_by": times["kparts_full"][3],
         "library_ms": None},
        {"name": "kparts_tables", "route": "cuda", "source": src + "kparts.cu",
         "replaces": "scripts/archive/exp_kparts.py:215",
         "launches": launches["kparts_tables"], "max_abs_err": vs_plain["kparts_tables"],
         "ms": times["kparts_tables"][0], "plain_ms": times["kparts_tables"][1],
         "bound_ms": times["kparts_tables"][2], "bound_by": times["kparts_tables"][3],
         "library_ms": None},
        {"name": "split_mm", "route": "cuda", "source": src + "split_mm.cu",
         "replaces": "sdft_tpu/ops/lti.py:255",
         "note": "the TPU matrix unit's multi-pass dot (lax.Precision.HIGH, _dot4): no Pallas "
                 "source; timed at totals 8x32768 with three products",
         "launches": launches["split_mm"], "max_abs_err": vs_plain["split_mm"][0],
         "max_err_of_scale": vs_plain["split_mm"][1],
         "ms": sm[0], "plain_ms": sm[1], "bound_ms": sm[2], "bound_by": sm[3],
         "library_ms": sm[4],
         "by_shape": {f"{label} x{n}": [round(v[0], 5), round(v[2], 5)]
                      for (label, n), v in times["split_mm"].items()}},
        {"name": "carry", "route": "cuda", "source": src + "carry.cu",
         "replaces": "sdft_tpu/kernels/analysis_pallas.py:632-748",
         "note": "the launcher-side _spectra_prologue, left to XLA by the JAX package: no "
                 "Pallas source; timed at 8x44100 m=1000",
         "launches": launches["carry"], "max_abs_err": vs_plain["carry"],
         "ms": cf[0], "plain_ms": cf[1], "bound_ms": cf[2], "bound_by": cf[3],
         "library_ms": None, "graph_ms": cf[4],
         "by_shape": {label: [round(v[0], 5), round(v[2], 5)]
                      for label, v in times["carry"].items()}},
    ]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--cards"]:
        sys.exit(cards_main(int(sys.argv[2])))
    sys.exit(main())
