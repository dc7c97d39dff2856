#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path once on one GPU and check it.

    python3 chip_smoke.py          # from the repository root, one CUDA card

Phases, each of which raises on failure (the script then exits non-zero):

  1. device    require CUDA; print the card's name and power limit, the
               torch version and both TF32 flags;
  2. build     build the kernels from sdft_tpu_torch/kernels/csrc;
  3. main path, in two parts, each with the launch counts set to 0 just
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
               both TPU functions it ports.
     Every result is held against the float64 ``ops`` path on the card;
  4. kernels   each kernel against its plain PyTorch version on the same
               inputs, at the main path's shapes;
  5. timings   device times (torch.profiler) of each kernel and its plain
               version at m = 4096 on 65536-sample blocks (K1), m = 1000 on
               8000-sample blocks (K2) and the probes at 512 tiles; the
               collapsed round trip for k_tile in {128, 256, 512, 1024} at
               m = 4096 on 65536-sample blocks and on 8 channels of 32768,
               FP32 against TF32; the hop = 100 driver on 4000- and
               16000-sample blocks with its device idle share; and wall
               times (CUDA events) of the public calls.

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


def signal(n: int, seed: int, device) -> torch.Tensor:
    x = np.random.default_rng(seed).standard_normal(n).clip(-1, 1)
    return torch.as_tensor(x.astype(np.float32), device=device)


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


def timings(T, S, Q, dev, card: str) -> dict:
    """Phase 5: kernel and plain-version times at the main path's shapes.
    "device" is the card's busy time per call (profiler), "wall" the time
    per call back to back (CUDA events)."""
    res = {}
    from sdft_tpu_torch.kernels._build import library

    lib = library()
    print(f"timing: resident blocks per SM at K={S.TILE_K}: spectra "
          f"{lib.sdft_spectra_occupancy(S.TILE_K, 1)}, scan "
          f"{lib.sdft_scan_occupancy(S.TILE_K, 1)} (hann)", flush=True)
    m, M = 4096, 65536
    plan = T.Plan(m, window="hann", precision=T.FAST_PRECISION)
    st = T.init_state(plan, device=dev)
    x = signal(M, SEED + 7, dev)
    pro = S.spectra_prologue(plan, st, x)
    t_pro = device_ms(lambda: S.spectra_prologue(plan, st, x), 10)
    w_pro = wall_ms(lambda: S.spectra_prologue(plan, st, x), 10)
    print(f"timing: K1 prologue m={m} M={M}: device {t_pro:.4f} ms, wall "
          f"{w_pro:.4f} ms [{card}]", flush=True)
    for form, dtype in (("planar", "float32"), ("planar", "bfloat16"),
                        ("power", "bfloat16")):
        k = device_ms(lambda: S.launch_spectra(plan, pro, form, dtype), 10)
        p = device_ms(lambda: S.spectra_reference(plan, pro, form, dtype), 3, 1)
        nbytes = M * m * (2 if form == "planar" else 1) * (4 if dtype == "float32" else 2)
        print(f"timing: K1 {form} {dtype} m={m} M={M}: kernel device {k:.4f} ms "
              f"({M / k * 1e3:.4e} samples/s, {nbytes / k / 1e6:.1f} GB/s "
              f"stored), plain device {p:.4f} ms [{card}]", flush=True)
        res[f"k1_{form}_{dtype}"] = (k, p)
    for dtype in (None, "bfloat16"):
        e2e = wall_ms(lambda: T.sdft(plan, st, x, "planar", dtype), 10)
        dev_t = device_ms(lambda: T.sdft(plan, st, x, "planar", dtype), 10)
        print(f"timing: sdft planar {dtype or 'float32'} m={m} M={M}: wall "
              f"{e2e:.4f} ms ({M / e2e * 1e3:.4e} samples/s), device "
              f"{dev_t:.4f} ms [{card}]", flush=True)
    del pro

    m, B = 1000, 8000
    plan = T.Plan(m, window="hann", precision=T.FAST_PRECISION)
    st = T.init_state(plan, device=dev)
    x = signal(B, SEED + 8, dev)
    pro = S.spectra_prologue(plan, st, x)
    synth = Q.synthesis_row(plan, dev)
    k = device_ms(lambda: Q.launch_scan(plan, pro, synth, "packed"), 20)
    p = device_ms(lambda: Q.forward_and_y_reference(plan, pro, synth, "packed"), 5, 1)
    print(f"timing: K2 packed m={m} B={B}: kernel device {k:.4f} ms "
          f"({B / k * 1e3:.4e} samples/s, {B * m * 8 / k / 1e6:.1f} GB/s "
          f"stored), plain device {p:.4f} ms [{card}]", flush=True)
    xs = signal(8 * B, SEED + 9, dev).reshape(8, B)
    chain = wall_ms(lambda: T.roundtrip_hopped(plan, st, xs, 1), 3, 1) / 8
    chain_dev = device_ms(lambda: T.roundtrip_hopped(plan, st, xs, 1), 3, 1) / 8
    print(f"timing: roundtrip_hopped(hop=1) m={m} B={B} refresh_every=1: wall "
          f"{chain:.4f} ms per block ({B / chain * 1e3:.4e} samples/s), device "
          f"{chain_dev:.4f} ms per block [{card}]", flush=True)
    res["k2_packed"] = (k, p)
    return res


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

    vs_plain = kernels_vs_plain(T, S, Q, dev)
    vs_plain.update({f"kparts_{v}": e for v, e in probes_vs_plain(P, dev).items()})
    times = timings(T, S, Q, dev, card)
    times.update(driver_timings(T, P, dev, card, times["k1_planar_float32"][0]))
    print(f"main path errors: {json.dumps(errs)}", flush=True)
    print(f"TF32 after the run: matmul.allow_tf32="
          f"{torch.backends.cuda.matmul.allow_tf32} "
          f"cudnn.allow_tf32={torch.backends.cudnn.allow_tf32}", flush=True)

    src = "sdft_tpu_torch/kernels/csrc/"
    kernels = [
        {"name": "spectra", "route": "cuda", "source": src + "spectra.cu",
         "replaces": "sdft_tpu/kernels/analysis_pallas.py:509",
         "launches": launches["spectra"], "max_abs_err": vs_plain["spectra"],
         "ms": times["k1_planar_float32"][0],
         "plain_ms": times["k1_planar_float32"][1]},
        {"name": "scan", "route": "cuda", "source": src + "scan.cu",
         "replaces": "sdft_tpu/kernels/analysis_pallas.py:147",
         "launches": launches["scan"], "max_abs_err": vs_plain["scan"],
         "ms": times["k2_packed"][0], "plain_ms": times["k2_packed"][1]},
        {"name": "kparts_make", "route": "cuda", "source": src + "kparts.cu",
         "replaces": "scripts/archive/exp_kparts.py:41",
         "launches": launches["kparts_make"], "max_abs_err": vs_plain["kparts_full"],
         "ms": times["kparts_full"][0], "plain_ms": times["kparts_full"][1]},
        {"name": "kparts_tables", "route": "cuda", "source": src + "kparts.cu",
         "replaces": "scripts/archive/exp_kparts.py:215",
         "launches": launches["kparts_tables"], "max_abs_err": vs_plain["kparts_tables"],
         "ms": times["kparts_tables"][0], "plain_ms": times["kparts_tables"][1]},
    ]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
