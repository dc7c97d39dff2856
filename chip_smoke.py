#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path once on one GPU and check it.

    python3 chip_smoke.py          # from the repository root, one CUDA card

Phases, each of which raises on failure (the script then exits non-zero):

  1. device    require CUDA; print the card's name and power limit, the
               torch version and both TF32 flags;
  2. build     build the kernels from sdft_tpu_torch/kernels/csrc;
  3. main path, in three parts, each with the launch counts set to 0 just
               before it and read just after:
     a. spectra ``sdft``/``sdft_power`` at the flagship size (m = 4096,
               Hann, float32, two chained 16384-sample blocks) and at
               m = 1000 for all four windows with latency 0.5 and a ROI;
               ``isdft`` and ``roundtrip`` with a low-pass transform;
               ``roundtrip_hopped(hop=1)`` at m = 1000 over 4 blocks of
               8000 samples.  K1 and K2 must have been launched;
     b. driver ``roundtrip`` without a transform (the collapsed LTI form)
               at the flagship size; ``roundtrip_hopped`` at m = 1000 with
               hop = 100 over 4 blocks of 16000 and hop = 4 over 4 blocks
               of 4000; ``sdft_hopped`` at hop = 100; the CLI in-process on
               an 8 s, 44100 Hz WAV (m = 1000, hop = 100, hann, latency 1),
               in float64 and with --fd32; ``profiling.kernel_parts``, the
               five probes of K1's parts at m = 4096, K = 128, PAD = 64 and
               512 tiles.  The probe kernel must have been launched, for
               both TPU functions it ports;
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
               have been launched.
     Every result is held against the float64 ``ops`` path on the card;
  4. kernels   each kernel against its plain PyTorch version on the same
               inputs, at the main path's shapes;
  5. timings   device times (torch.profiler) of each kernel and its plain
               version at m = 4096 on 65536-sample blocks (K1, all five
               store forms, each beside the bytes it moves, its bound and
               its share of the bound), m = 1000 on 8000-sample blocks (K2)
               and the probes at 512 tiles; torch.stft at hop 1 beside K1
               (its library yardstick, held against K1's spectra); ``sdft``
               on 8 channels of 32768 (device, wall, peak memory: each
               channel's spectra written in place); the
               collapsed round trip for k_tile in {128, 256, 512, 1024} at
               m = 4096 on 65536-sample blocks and on 8 channels of 32768,
               FP32 against TF32; the hop = 100 driver on 4000- and
               16000-sample blocks with its device idle share; wall
               times (CUDA events) of the public calls; ``Streamer.run``
               against a sequential loop, on the collapsed round trip
               (host-bound) and on 8 x 16384 through K1 with a packed
               transform (device-bound), and ``run_hopped`` against its
               per-block loop (host clock, in turns, median and range);
               the float32x2 tier's two legs beside float64 ``ops``, with
               their peak device memory.

The line before the last is a JSON summary of the kernels; the last line is
{"ok": true, "device": {...}}.  Inputs are made from a fixed seed.
"""

from __future__ import annotations

import json
import pathlib
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

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

    def lowpass(z):
        keep = (torch.arange(z.shape[-1], device=z.device) < z.shape[-1] // 4)
        return z * keep.to(z.real.dtype)

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


def driver_path(T, dev) -> dict:
    """Phase 3b: the collapsed round trip, the driver protocol at hop > 1,
    the hopped analysis, the CLI and the probes of K1's parts."""
    from sdft_tpu_torch import cli, profiling
    from sdft_tpu_torch.io.dump import load_complex
    from sdft_tpu_torch.io.wav import read_wav, write_wav

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
    rng = np.random.default_rng(SEED + 12)
    with tempfile.TemporaryDirectory() as tmp:
        src = f"{tmp}/src.wav"
        write_wav(src, (rng.standard_normal(8 * 44100).clip(-3, 3) / 3), 44100)
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

    # -- the probes of K1's parts at the script's shapes, 512 tiles (2 GiB
    # stored per call, as K1's flagship block)
    parts = profiling.kernel_parts(nt=512, reps=2)
    for v, r in parts.items():
        print(f"  kernel_parts {v}: {r['ms']:.4f} ms ({r['us_per_tile']:.3f} us/tile, "
              f"{r['stored_gbs']:.1f} GB/s stored)", flush=True)
        if not r["finite"]:
            raise AssertionError(f"kernel_parts {v}: output not finite")
    return errs


def probe_bounds(P, nt: int = 512) -> dict:
    """Bounds of the probes' two TPU functions at the main path's shapes
    (m = 4096, K = 128, PAD = 64, nt tiles): the rows of c0 read, the
    thi/tlo tiles, the tables of "tables", and two (K, m) f32 planes per
    tile stored; six bf16 products of (K, K) by (K, m) per tile on the
    tensor cores, and about 8 f32 flops per stored value."""
    m, K, pad = 4096, 128, 64
    W = m + 2 * pad
    out = 2 * nt * K * m * 4
    read = nt * 2 * W * 4 + 2 * nt * K * K * 2
    tc, f32 = 12 * nt * K * K * m, 8 * 2 * nt * K * m
    res = {"full": bound(read + out, f32, tc),
           "tables": bound(read + out + 2 * K * W * (4 + 2), f32, tc)}
    for v, (b_ms, b_by) in res.items():
        print(f"  kparts {v} nt={nt}: bound {b_ms:.4f} ms ({b_by})", flush=True)
    return res


def probes_vs_plain(P, dev) -> dict:
    """Phase 4, the probes: each variant against its plain version on the
    same seeded inputs at 512 tiles.  store and vpu 2e-6 abs; the products'
    f32 sums run in another order on the tensor cores, so dots, full and
    tables are held at 1e-5 of the products' size (the convolution cancels
    most of it in the output)."""
    out = {}
    p = P.probe_inputs(512, seed=SEED + 13, device=dev)
    for v in P.VARIANTS:
        got = P.launch_kparts(v, p)
        want = P.kparts_reference(v, p)
        limit = 2e-6 if v in ("store", "vpu") else 1e-5 * P.product_scale(v, p)
        out[v] = max(maxerr(g, w) for g, w in zip(got, want))
        gate(f"kparts {v} vs plain (abs)", out[v], limit)
        del got, want
    return out


def kernels_vs_plain(T, S, Q, dev) -> dict:
    """Phase 4: each kernel against its plain version on the same inputs."""
    out = {}
    plan = T.Plan(4096, window="hann", precision=T.FAST_PRECISION)
    st, _ = T.sdft(plan, T.init_state(plan, device=dev), signal(777, SEED + 3, dev))
    pro = S.spectra_prologue(plan, st, signal(16384, SEED + 4, dev))
    k1 = 0.0
    for form, dtype in S.STORES:
        got = S.launch_spectra(plan, pro, form, dtype)
        # bf16 outputs are held against the plain version's float32 values:
        # the kernel's plane must be that value rounded once to bf16
        # (at most 2^-8 relative), within the f32 gate
        want = S.spectra_reference(plan, pro, form, "float32")
        got = got if isinstance(got, tuple) else (got,)
        want = want if isinstance(want, tuple) else (want,)
        for g, w in zip(got, want):
            if dtype == "bfloat16":
                err = ((g.double() - w.double()).abs()
                       - 2.0**-8 * w.double().abs()).max().item()
                gate(f"K1 {form} {dtype} vs plain f32 (abs beyond bf16 rounding)",
                     max(err, 0.0), 2e-6)
            else:
                err = maxerr(g, w)
                gate(f"K1 {form} {dtype} vs plain (abs)", err, 2e-6)
                k1 = max(k1, err)
    out["spectra"] = k1

    plan = T.Plan(1000, window="hann", precision=T.FAST_PRECISION)
    st, _ = T.sdft(plan, T.init_state(plan, device=dev), signal(555, SEED + 5, dev))
    pro = S.spectra_prologue(plan, st, signal(8000, SEED + 6, dev))
    synth = Q.synthesis_row(plan, dev)
    dk, yk = Q.launch_scan(plan, pro, synth, "packed")
    dr, yr = Q.forward_and_y_reference(plan, pro, synth, "packed")
    gate("K2 spectra vs plain (abs)", maxerr(dk, dr), 2e-6)
    # y: atomics sum the blocks' partial rows in a run-dependent order
    gate("K2 y vs plain (abs)", maxerr(yk, yr), 1e-5)
    out["scan"] = maxerr(dk, dr)
    return out


def wall_ms(fn, reps: int, warmup: int = 2) -> float:
    """Wall time per call between CUDA events, back to back: what a caller
    sees, host overhead included."""
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


def device_ms(fn, reps: int, warmup: int = 2) -> float:
    """Device time per call: the summed durations of the kernels and copies
    the calls ran on the card (torch.profiler), so the host's gaps between
    launches do not count."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    us = sum(e.self_device_time_total for e in prof.key_averages())
    if us <= 0:
        raise RuntimeError("the profiler saw no device time")
    return us / 1e3 / reps


#: published H100 SXM peaks (NVIDIA data sheet, dense): HBM bytes/s, FP32
#: flop/s outside the tensor cores, bf16 tensor-core flop/s
PEAK_BYTES, PEAK_F32, PEAK_BF16_TC = 3.35e12, 67e12, 989e12
#: flops per output bin of the tile body (running sum 4, phasor product 6,
#: demodulation 6, Hann stencil 8, power 3: about 25) and of K2's y (4 more)
K1_FLOPS_PER_BIN, K2_FLOPS_PER_BIN = 25, 29
#: bytes per output bin of each K1 store form
FORM_BYTES = {("packed", "float32"): 8, ("planar", "float32"): 8,
              ("planar", "bfloat16"): 4, ("power", "float32"): 4, ("power", "bfloat16"): 2}


def bound(nbytes: float, f32_flops: float = 0.0, tc_flops: float = 0.0) -> tuple:
    """The least time the card could take (ms) and what bounds it: bytes
    over HBM's rate, or operations over their peak rates."""
    t_bytes = nbytes / PEAK_BYTES * 1e3
    t_ops = (f32_flops / PEAK_F32 + tc_flops / PEAK_BF16_TC) * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


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
    t_pro = device_ms(lambda: S.spectra_prologue(plan, st, x), 10)
    w_pro = wall_ms(lambda: S.spectra_prologue(plan, st, x), 10)
    print(f"timing: K1 prologue m={m} M={M}: device {t_pro:.4f} ms, wall "
          f"{w_pro:.4f} ms [{card}]", flush=True)
    for form, dtype in S.STORES:
        k = device_ms(lambda: S.launch_spectra(plan, pro, form, dtype), 10)
        p = device_ms(lambda: S.spectra_reference(plan, pro, form, dtype), 3, 1)
        nbytes = M * m * FORM_BYTES[form, dtype] + tile_input_bytes(pro)
        b_ms, b_by = bound(nbytes, K1_FLOPS_PER_BIN * M * m)
        print(f"timing: K1 {form} {dtype} m={m} M={M}: kernel device {k:.4f} ms "
              f"({M / k * 1e3:.4e} samples/s, {nbytes / k / 1e6:.1f} GB/s), {nbytes / 1e9:.4f} GB "
              f"moved, bound {b_ms:.4f} ms ({b_by}), {b_ms / k:.1%} of bound; plain device "
              f"{p:.4f} ms; {S.store_bytes(m, form, dtype)}-byte stores [{card}]", flush=True)
        res[f"k1_{form}_{dtype}"] = (k, p, b_ms, b_by)
    for dtype in (None, "bfloat16"):
        e2e = wall_ms(lambda: T.sdft(plan, st, x, "planar", dtype), 10)
        dev_t = device_ms(lambda: T.sdft(plan, st, x, "planar", dtype), 10)
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
    k = device_ms(lambda: Q.launch_scan(plan, pro, synth, "packed"), 20)
    p = device_ms(lambda: Q.forward_and_y_reference(plan, pro, synth, "packed"), 5, 1)
    nbytes = B * m * 8 + B * 4 + tile_input_bytes(pro) + synth.numel() * 4
    b_ms, b_by = bound(nbytes, K2_FLOPS_PER_BIN * B * m)
    print(f"timing: K2 packed m={m} B={B}: kernel device {k:.4f} ms "
          f"({B / k * 1e3:.4e} samples/s, {nbytes / k / 1e6:.1f} GB/s), bound {b_ms:.4f} ms "
          f"({b_by}), {b_ms / k:.1%} of bound; plain device {p:.4f} ms; no single "
          f"PyTorch call computes it (library: none) [{card}]", flush=True)
    xs = signal(8 * B, SEED + 9, dev).reshape(8, B)
    chain = wall_ms(lambda: T.roundtrip_hopped(plan, st, xs, 1), 3, 1) / 8
    chain_dev = device_ms(lambda: T.roundtrip_hopped(plan, st, xs, 1), 3, 1) / 8
    print(f"timing: roundtrip_hopped(hop=1) m={m} B={B} refresh_every=1: wall "
          f"{chain:.4f} ms per block ({B / chain * 1e3:.4e} samples/s), device "
          f"{chain_dev:.4f} ms per block [{card}]", flush=True)
    res["k2_packed"] = (k, p, b_ms, b_by)
    res["sdft_batch"] = batch_timings(T, dev, card)
    return res


def stft_beside_k1(T, plan, x, card: str) -> float:
    """torch.stft at hop 1 as K1's library yardstick (the port never calls
    it): its device time, and its frames against K1's spectra.  Frame f of
    the periodic-Hann STFT of 2m points, scaled by 1/(2m), is K1's row
    f + 2m - 1 (the demodulation leaves no per-bin phase); the top `halo`
    bins differ, since the reference mirrors around bin m-1 there."""
    m = plan.dftsize
    n = 2 * m
    win = torch.hann_window(n, periodic=True, device=x.device)

    def stft():
        return torch.stft(x, n_fft=n, hop_length=1, window=win, center=False,
                          return_complex=True)

    lib_ms = device_ms(stft, 3, 1)
    lib_wall = wall_ms(stft, 3, 1)
    z = stft()
    _, d = T.sdft(plan, T.init_state(plan, device=x.device), x)
    err = scale = 0.0
    top = 0.0
    for f0 in range(0, z.shape[1], 8192):
        ref = z[:, f0:f0 + 8192].T / n
        got = torch.view_as_complex(d[f0 + n - 1:f0 + n - 1 + ref.shape[0]])
        diff = (got - ref[:, :m]).abs()
        err = max(err, diff[:, :m - 1].max().item())
        top = max(top, diff[:, m - 1].max().item())
        scale = max(scale, ref.abs().max().item())
    agree = err <= 3e-6 * scale
    print(f"timing: torch.stft(n_fft={n}, hop_length=1, hann periodic, center=False) on "
          f"{x.numel()} samples: device {lib_ms:.4f} ms, wall {lib_wall:.4f} ms; frames / "
          f"(2m) vs K1 rows 2m-1.. bins 0..m-2: {err:.3e} ({err / scale:.3e} of scale, "
          f"{'agree' if agree else 'DO NOT agree'} at 3e-6), bin m-1 {top:.3e} (the "
          f"reference's mirror around m-1) [{card}]", flush=True)
    if not agree:
        raise AssertionError("torch.stft and K1 do not agree")
    del z, d
    return lib_ms


def batch_timings(T, dev, card: str, m: int = 4096, C: int = 8, M: int = 32768) -> tuple:
    """sdft on an 8 x 32768 channel batch, planar f32: each channel's K1
    launch writes its slice of the batch's outputs, so the peak device
    memory above the inputs is the 8 GiB of spectra, not twice that."""
    plan = T.Plan(m, window="hann", precision=T.FAST_PRECISION)
    st = T.init_state(plan, channels=C, device=dev)
    xs = signal(C * M, SEED + 40, dev).reshape(C, M)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    out = T.sdft(plan, st, xs, "planar")
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    del out
    d = device_ms(lambda: T.sdft(plan, st, xs, "planar"), 3, 1)
    w = wall_ms(lambda: T.sdft(plan, st, xs, "planar"), 3, 1)
    spectra = 2 * C * M * m * 4
    print(f"timing: sdft C={C} M={M} m={m} planar f32: device {d:.4f} ms, wall {w:.4f} ms, "
          f"peak {peak / 2**30:.3f} GiB above the inputs for {spectra / 2**30:.1f} GiB of "
          f"spectra [{card}]", flush=True)
    if peak > 1.25 * spectra:
        raise AssertionError(f"channel batch peak {peak / 2**30:.2f} GiB: spectra copied")
    return d, w, peak


def driver_timings(T, P, dev, card: str, k1_ms: float) -> dict:
    """Phase 5, this slice's calls: the collapsed round trip per k_tile and
    FP32 against TF32, the hop = 100 driver, and the probes beside K1."""
    from sdft_tpu_torch import profiling
    from sdft_tpu_torch.ops import lti

    res = {}
    m = 4096
    plan = T.Plan(m, window="hann", precision=T.FAST_PRECISION)
    for C, M in ((1, 65536), (8, 32768)):
        st = T.init_state(plan, channels=None if C == 1 else C, device=dev)
        x = signal(C * M, SEED + 14, dev)
        x = x if C == 1 else x.reshape(C, M)
        cost = profiling.roundtrip_cost(plan, C * M)
        for K in (128, 256, 512, 1024):
            d = device_ms(lambda: lti.roundtrip_block_lti(plan, st, x, K), 10)
            w = wall_ms(lambda: lti.roundtrip_block_lti(plan, st, x, K), 10)
            print(f"timing: roundtrip (collapsed) m={m} C={C} M={M} k_tile={K}: device "
                  f"{d:.4f} ms, wall {w:.4f} ms ({C * M / w * 1e3:.4e} samples/s, "
                  f"{cost.hbm_bytes / d / 1e6:.3f} GB/s of roundtrip_cost bytes) [{card}]",
                  flush=True)
            res[f"lti_C{C}_K{K}"] = (d, w)
        best = min((128, 256, 512, 1024), key=lambda K: res[f"lti_C{C}_K{K}"][0])
        print(f"timing: fastest k_tile by device time at C={C} M={M}: {best}; "
              f"default_k_tile({M}, {m}) = {lti.default_k_tile(M, m)}", flush=True)

    # FP32 against TF32 on the flagship block, both against float64
    M = 65536
    x = signal(M, SEED + 15, dev)
    p64 = f64(plan)
    _, d64 = T.sdft(p64, T.init_state(p64, device=dev), x)
    y64 = T.isdft(p64, d64)
    del d64
    for mxu in ("highest", "high"):
        pl = T.Plan(m, window="hann", precision=T.Precision("float32", "float32", mxu=mxu))
        st = T.init_state(pl, device=dev)
        _, y = T.roundtrip(pl, st, x)
        err = maxerr(y, y64)
        d = device_ms(lambda: T.roundtrip(pl, st, x), 10)
        w = wall_ms(lambda: T.roundtrip(pl, st, x), 10)
        print(f"timing: roundtrip (collapsed) mxu={mxu} m={m} M={M}: error vs f64 "
              f"{err:.3e} (split4 gate 5e-4), device {d:.4f} ms, wall {w:.4f} ms "
              f"[{card}]", flush=True)
        res[f"mxu_{mxu}"] = (err, d, w)
    tf32_ok = res["mxu_high"][0] <= 5e-4 and res["mxu_high"][1] < res["mxu_highest"][1]
    print(f"timing: TF32 within split4's gate and faster: {tf32_ok}", flush=True)

    # the driver protocol at hop = 100, 8 chained blocks
    m, hop = 1000, 100
    plan = T.Plan(m, window="hann", precision=T.FAST_PRECISION)
    st = T.init_state(plan, device=dev)
    for B in (4000, 16000):
        xs = signal(8 * B, SEED + 16, dev).reshape(8, B)
        w = wall_ms(lambda: T.roundtrip_hopped(plan, st, xs, hop), 3, 1) / 8
        d = device_ms(lambda: T.roundtrip_hopped(plan, st, xs, hop), 3, 1) / 8
        print(f"timing: roundtrip_hopped(hop={hop}) m={m} B={B} refresh_every=1: wall "
              f"{w:.4f} ms per block ({B / w * 1e3:.4e} samples/s), device {d:.4f} ms "
              f"per block, device idle {max(0.0, 1 - d / w):.1%} [{card}]", flush=True)
        res[f"hop100_B{B}"] = (d, w)

    # the probes at 512 tiles beside K1's tiles (128 samples x 4096 bins).
    # CUDA events: each call is one launch of ~1 ms or more (the profiler
    # has summed one launch of five for the store probe)
    p = P.probe_inputs(512, seed=SEED + 17, device=dev)
    for v in P.VARIANTS:
        k = wall_ms(lambda: P.launch_kparts(v, p), 5, 1)
        pl = wall_ms(lambda: P.kparts_reference(v, p), 2, 1)
        print(f"timing: kparts {v} nt=512: kernel {k:.4f} ms ({k * 1e3 / 512:.3f} "
              f"us/tile, {2 * 512 * 128 * 4096 * 4 / k / 1e6:.1f} GB/s stored), plain "
              f"{pl:.4f} ms (CUDA events) [{card}]", flush=True)
        res[f"kparts_{v}"] = (k, pl)
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
    for hop, B, nb, chain, d_lim, y_lim in ((100, HOP100_BLOCK, 8, 8, 1e-7, 1e-6),
                                            (1, HOP1_BLOCK, 4, 4, 1e-6, 1e-5)):
        xs = host_signal(nb * B, SEED + 22 + hop).reshape(nb, B)
        got = list(T.Streamer(hplan, refresh_every=1, device=dev).run_hopped(
            list(xs), hop, chain=chain))
        _, hd, ys = T.roundtrip_hopped(hplan, T.init_state(hplan, device=dev),
                                       torch.as_tensor(xs, device=dev), hop, refresh_every=1)
        hd, ys = hd.cpu().numpy(), ys.cpu().numpy()
        e_d = max(host_err(g[0], w) for g, w in zip(got, hd))
        e_y = max(host_err(g[1], w) for g, w in zip(got, ys))
        # hop = 1 runs K2, whose y atomics sum in a run-dependent order
        gate(f"Streamer.run_hopped(hop={hop}) m={HOP_M} {nb} x {B} spectra vs "
             "roundtrip_hopped (abs)", e_d, d_lim)
        gate(f"Streamer.run_hopped(hop={hop}) samples vs roundtrip_hopped (abs)", e_y, y_lim)
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
        dv = device_ms(fn, 2, 1)
        w = wall_ms(fn, 2, 1)
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


def print_ptxas(log: pathlib.Path) -> None:
    """ptxas's registers and spills of each K1/K2 instantiation (store
    form, vector stores, window halo), from the build log."""
    import re

    found = 0
    for block in log.read_text().split("Compiling entry function")[1:]:
        name = re.match(r" '_ZN4sdft\d+(spectra|scan)_kernelILi(\d)ELb(\d)ELi(\d)E", block)
        regs = re.search(r"Used (\d+) registers", block)
        spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", block)
        if name and regs and spill:
            found += 1
            kind, store, vec, halo = name.groups()
            print(f"ptxas: {kind}_kernel<store={store}, vector={vec}, halo={halo}>: "
                  f"{regs.group(1)} registers, spill {spill.group(1)}/{spill.group(2)} B",
                  flush=True)
    if not found:
        print("ptxas: no K1/K2 entries found in the build log", flush=True)


def main() -> int:
    card = require_cuda()
    dev = torch.device("cuda", 0)
    print(card, flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda}; "
          f"matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32} "
          f"cudnn.allow_tf32={torch.backends.cudnn.allow_tf32}", flush=True)

    import sdft_tpu_torch as T
    from sdft_tpu_torch.kernels import _build, kparts as P, scan as Q, spectra as S

    t0 = time.perf_counter()
    lib = _build.build()
    _build.library()
    print(f"build: {time.perf_counter() - t0:.2f} s -> {lib.name}", flush=True)
    print_ptxas(lib.with_suffix(".log"))

    S.LAUNCHES = Q.LAUNCHES = 0
    errs = main_path(T, dev)
    torch.cuda.synchronize()
    launches = {"spectra": S.LAUNCHES, "scan": Q.LAUNCHES}
    P.LAUNCHES.update(make=0, tables=0)
    errs.update(driver_path(T, dev))
    torch.cuda.synchronize()
    launches.update(kparts_make=P.LAUNCHES["make"], kparts_tables=P.LAUNCHES["tables"])
    print(f"main path launches: {launches}", flush=True)
    for name, n in launches.items():
        if n <= 0:
            raise AssertionError(f"kernel {name} was not launched on the main path")
    S.LAUNCHES = Q.LAUNCHES = 0
    errs.update(stream_path(T, dev))
    torch.cuda.synchronize()
    part_c = {"spectra": S.LAUNCHES, "scan": Q.LAUNCHES}
    print(f"stream part launches: {part_c}", flush=True)
    for name, n in part_c.items():
        if n <= 0:
            raise AssertionError(f"kernel {name} was not launched by the stream part")
        launches[name] += n

    vs_plain = kernels_vs_plain(T, S, Q, dev)
    vs_plain.update({f"kparts_{v}": e for v, e in probes_vs_plain(P, dev).items()})
    times = timings(T, S, Q, dev, card)
    times.update(driver_timings(T, P, dev, card, times["k1_planar_float32"][0]))
    times.update(stream_timings(T, dev, card, times["k1_planar_float32"][0]))
    print(f"main path errors: {json.dumps(errs)}", flush=True)
    print(f"TF32 after the run: matmul.allow_tf32="
          f"{torch.backends.cuda.matmul.allow_tf32} "
          f"cudnn.allow_tf32={torch.backends.cudnn.allow_tf32}", flush=True)

    src = "sdft_tpu_torch/kernels/csrc/"
    k1, k2 = times["k1_planar_float32"], times["k2_packed"]
    kp = probe_bounds(P)
    kernels = [
        {"name": "spectra", "route": "cuda", "source": src + "spectra.cu",
         "replaces": "sdft_tpu/kernels/analysis_pallas.py:509",
         "launches": launches["spectra"], "max_abs_err": vs_plain["spectra"],
         "ms": k1[0], "plain_ms": k1[1], "bound_ms": k1[2], "bound_by": k1[3],
         "library_ms": times["k1_library"]},
        {"name": "scan", "route": "cuda", "source": src + "scan.cu",
         "replaces": "sdft_tpu/kernels/analysis_pallas.py:147",
         "launches": launches["scan"], "max_abs_err": vs_plain["scan"],
         "ms": k2[0], "plain_ms": k2[1], "bound_ms": k2[2], "bound_by": k2[3],
         "library_ms": None},
        {"name": "kparts_make", "route": "cuda", "source": src + "kparts.cu",
         "replaces": "scripts/archive/exp_kparts.py:41",
         "launches": launches["kparts_make"], "max_abs_err": vs_plain["kparts_full"],
         "ms": times["kparts_full"][0], "plain_ms": times["kparts_full"][1],
         "bound_ms": kp["full"][0], "bound_by": kp["full"][1], "library_ms": None},
        {"name": "kparts_tables", "route": "cuda", "source": src + "kparts.cu",
         "replaces": "scripts/archive/exp_kparts.py:215",
         "launches": launches["kparts_tables"], "max_abs_err": vs_plain["kparts_tables"],
         "ms": times["kparts_tables"][0], "plain_ms": times["kparts_tables"][1],
         "bound_ms": kp["tables"][0], "bound_by": kp["tables"][1], "library_ms": None},
    ]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
