"""Time this version's K1, K2 and probes of K1's parts against another
version of the port, in turns on one card.

    git archive <commit> sdft_tpu_torch | tar -x -C DIR
    mv DIR/sdft_tpu_torch DIR/sdft_tpu_torch_old
    python -m sdft_tpu_torch.kernels.compare_bodies DIR [--probes-only | --split] [K1,K2 ...]

DIR holds the other version's package under the name ``sdft_tpu_torch_old``
(its imports are relative, so it loads beside this one and builds its own
library).  Each K1,K2 pair builds this version's kernels with those bins a
thread (``-DSDFT_K1_STRIP``, ``-DSDFT_K2_STRIP``; default: the built-in
4,4; K2 at 2 runs one 2-bin strip a thread instead of two).  It
prints ptxas's K2 registers, each build's resident blocks per SM and K2's
wave at each K2 shape.  For K1's five store forms at m = 4096,
M = 65536, for K2 (packed f32 + y, Hann) at m = 1000 on one channel's and
8 channels' 8000-sample blocks and on the hop-1 chain cell's 8 x 44100
block, and for the split of that block (K2 with y alone, no spectra store;
K1's five store forms at m = 1000, planar f32 the same 8 bytes a bin
without y) it prints each body's largest difference from the other version
on the same inputs and the profiler's device time of its kernels, in turns
(other, pairs, pairs reversed, other), then ``sdft`` on an 8 x 32768
channel batch (planar f32) of both versions: device time, wall time and
peak memory above the inputs.  Last (alone with --probes-only) the five
probes (``kernels.kparts``) at 512 tiles, m = 4096, K = 128, PAD = 64: each
variant's largest difference from the other version on the same seeded
inputs and the time per launch between CUDA events (5 launches after 2), in
turns (other, this, this, other).

--split runs only the split of K1 at m near 1000 (``split``): the five
store forms, Hann, 8 channels at equal bytes for m in SPLIT_M, the other
version against this one unpaced and, in the paced forms, paced
(``spectra.paced`` forced either way), both also built with write-back
stores (-DSDFT_WB_STORES), and at m = 1000 the unpaced launch into rows
padded to PAD_LD bins (a build with -DSDFT_ROW_STRIDE=PAD_LD); each build's
resident blocks and clusters, then each body's difference from the other
version and its device time beside the spectra's bound, in turns.
"""

from __future__ import annotations

import concurrent.futures
import ctypes
import os
import re
import subprocess
import sys
import time

import numpy as np
import torch

FORMS = (("planar", "float32"), ("packed", "float32"), ("planar", "bfloat16"),
         ("power", "float32"), ("power", "bfloat16"))
#: K2's timed shapes (channels, samples) at m = 1000: one channel's and a
#: batch's 8000-sample block, and the hop-1 chain cell's 8 x 44100 block
K2_SHAPES = ((1, 8000), (8, 8000), (8, 44100))
#: the shape at which K2 is split into y alone and K1 at m = 1000
SPLIT = (8, 44100)
#: samples per tile (kernels.spectra.TILE_K)
TILE = 128
#: K1's split at m near 1000 (--split): dftsizes whose f32 rows are 256-byte
#: aligned (960, 1024) or not (992, 1000, 1008), at SPLIT's bytes; the
#: padded-stride probe writes m = 1000 into rows of PAD_LD bins
SPLIT_M = (960, 992, 1000, 1008, 1024)
PAD_LD = 1024


def label(key) -> str:
    """A timed body's name in the printout."""
    if key in FORMS:
        return f"K1 {' '.join(key)} m=4096 1x65536"
    if key in K2_SHAPES:
        return f"K2 packed + y m=1000 {key[0]}x{key[1]}"
    if key == "y only":
        return f"K2 y only (no spectra) m=1000 {SPLIT[0]}x{SPLIT[1]}"
    return f"K1 {' '.join(key[1:])} m=1000 {SPLIT[0]}x{SPLIT[1]}"


def card_name() -> str:
    """The card's name and power limit (nvidia-smi)."""
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip()


def k2_wave(per_sm: int, sms: int, bins: int, m: int, C: int, M: int) -> str:
    """K2's one wave of resident blocks over (bin chunks of 32 * bins bins,
    tile groups of 4 tiles; csrc/common.cuh, launch_tiles): the groups each
    block walks, as a mean and at most."""
    chunks, nt = -(-m // (32 * bins)), -(-M // TILE)
    groups = C * -(-nt // 4)
    grid_y = max(1, min(per_sm * sms // chunks, groups))
    return (f"{groups} groups over {grid_y} blocks a chunk, {groups / grid_y:.2f} (at most "
            f"{-(-groups // grid_y)}) a block")


def kernel_ms(fn, name: str, reps: int = 10) -> float:
    """Device time per call of the kernels whose name holds ``name``."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    us = sum(e.self_device_time_total for e in prof.key_averages() if name in e.key)
    if us <= 0:
        raise RuntimeError(f"the profiler saw no {name}")
    return us / 1e3 / reps


def build_variant(k1: int, k2: int, *defines: str):
    """This version's K1/K2 library with strips of k1 and k2 bins and the
    macros ``defines`` (e.g. SDFT_WB_STORES)."""
    from . import _build

    out = _build.BUILD_DIR / "_".join(("strips", str(k1), str(k2), *defines))
    out.mkdir(parents=True, exist_ok=True)
    flags = (*_build.flags(), f"-DSDFT_K1_STRIP={k1}", f"-DSDFT_K2_STRIP={k2}",
             *(f"-D{d}" for d in defines))
    objs = [str(out / (s + ".o")) for s in ("spectra.cu", "scan.cu")]
    cmds = [[_build.nvcc(), *flags, "-c", str(_build.CSRC / s), "-o", o]
            for s, o in zip(("spectra.cu", "scan.cu"), objs)]
    with concurrent.futures.ThreadPoolExecutor(2) as pool:
        log = "".join(pool.map(_build._run, cmds))
    (out / "lib.log").write_text(log)
    so = str(out / "lib.so")
    _build._run([_build.nvcc(), *_build.ARCH, "-shared", "-o", so, *objs])
    lib = ctypes.CDLL(so)
    for name in ("sdft_spectra_launch", "sdft_scan_launch", "sdft_spectra_occupancy",
                 "sdft_scan_occupancy", "sdft_spectra_clusters"):
        fn = getattr(lib, name)
        fn.argtypes = list(_build.SIGNATURES[name])
        fn.restype = ctypes.c_int
    return lib, log


def signal(n: int, seed: int, dev) -> torch.Tensor:
    """n seeded float32 samples in [-1, 1] on ``dev``."""
    x = np.random.default_rng(seed).standard_normal(n).clip(-1, 1).astype(np.float32)
    return torch.as_tensor(x, device=dev)


def launch_k1(S, lib, plan, pro, form: str, dtype: str, paced: bool, ld: int = 0):
    """This version's K1 through ``lib`` with the pacing forced either way,
    into output rows ``ld`` bins apart (0: m, the public layout; a library
    built with -DSDFT_ROW_STRIDE=ld writes such rows); returns the planes'
    first m bins a row."""
    from . import _build

    m = plan.dftsize
    ld = ld or m
    outs = S.empty_outputs(pro.lead, ld, form, dtype, pro.c0.device)
    planes = outs if isinstance(outs, tuple) else (outs,)
    args = S.launch_args(plan, pro)
    err = lib.sdft_spectra_launch(
        *args[:3], planes[0].data_ptr(), planes[-1].data_ptr() if form == "planar" else None,
        *args[3:], S.STORES[form, dtype], int(S.vector_stores(m)), int(paced),
        torch.cuda.current_stream().cuda_stream)
    _build.check(err, "sdft_spectra_launch")
    return tuple(t[..., :m, :] if form == "packed" else t[..., :m] for t in planes)


def split(dev, card: str) -> None:
    """K1's split at m near 1000 (module docstring, --split)."""
    import sdft_tpu_torch as T
    import sdft_tpu_torch_old as TO
    from sdft_tpu_torch_old.kernels import spectra as SO

    from .. import profiling
    from . import scan as Q, spectra as S

    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(4) as pool:
        builds = {name: pool.submit(build_variant, S.STRIP, Q.BINS, d)
                  for name, d in (("wb", "SDFT_WB_STORES"),
                                  ("stride", f"SDFT_ROW_STRIDE={PAD_LD}"))}
        pool.submit(SO.library).result()
        libs = {"this": pool.submit(S.library).result(),
                **{name: f.result()[0] for name, f in builds.items()}}
    print(f"builds {time.perf_counter() - t0:.1f} s", flush=True)
    for name, lib in libs.items():
        print(f"{name} build (Hann, K={TILE}): K1 resident blocks/SM "
              f"{lib.sdft_spectra_occupancy(TILE)} (packed f32), resident clusters of 8 "
              f"blocks {lib.sdft_spectra_clusters(TILE, 8)} (paced planar f32)", flush=True)
    C = SPLIT[0]
    for m in SPLIT_M:
        M = round(SPLIT[1] * 1000 / m)
        x = signal(C * M, 20 + m % 7, dev).reshape(C, M)
        p, po = (P.Plan(m, window="hann", precision=P.FAST_PRECISION) for P in (T, TO))
        pro = S.spectra_prologue(p, T.init_state(p, channels=C, device=dev), x)
        pro_o = SO.spectra_prologue(po, TO.init_state(po, channels=C, device=dev), x)
        for form, dtype in FORMS:
            calls = {"other": lambda: SO.launch_spectra(po, pro_o, form, dtype)}
            paceable = (form, dtype) in S.PACED_FORMS
            for name, lib, paced in (("unpaced", libs["this"], False),
                                     ("paced", libs["this"], True),
                                     ("wb stores", libs["wb"], False),
                                     ("wb paced", libs["wb"], True)):
                if paceable or not paced:
                    calls[name] = (lambda lib=lib, paced=paced:
                                   launch_k1(S, lib, p, pro, form, dtype, paced))
            if m == 1000:
                calls[f"rows of {PAD_LD}"] = lambda: launch_k1(S, libs["stride"], p, pro, form,
                                                               dtype, False, PAD_LD)
            want = calls["other"]()
            want = want if isinstance(want, tuple) else (want,)
            same = {n: all(torch.equal(a, b) for a, b in zip(fn(), want))
                    for n, fn in calls.items() if n != "other"}
            del want
            order = list(calls)
            times = {}
            for who in order + order[::-1]:
                times.setdefault(who, []).append(kernel_ms(calls[who], "spectra_kernel", 10))
            planes = 2 if form == "planar" else 1
            bound = profiling.bound(planes * S.row_bytes(m, form, dtype) * C * M)[0]
            print(f"K1 {form} {dtype} m={m} {C}x{M} (rows of {S.row_bytes(m, form, dtype)} B, "
                  f"bound {bound:.4f} ms; device ms in turns, share of the bound) [{card}]",
                  flush=True)
            for who in order:
                t = times[who]
                tag = "" if who == "other" else f", bit for bit the other's: {same[who]}"
                print(f"  {who}: {'/'.join(f'{v:.4f}' for v in t)} "
                      f"({100 * bound / max(t):.1f}-{100 * bound / min(t):.1f} %){tag}",
                      flush=True)
            torch.cuda.empty_cache()
        del pro, pro_o
        torch.cuda.empty_cache()


def compare_probes(dev, card: str, nt: int = 512) -> None:
    """The five probes of this version and the other, in turns."""
    from sdft_tpu_torch_old.kernels import kparts as PO

    from ..profiling import wall_time
    from . import kparts as P

    PO.library()
    P.library()
    p = P.probe_inputs(nt, seed=11, device=dev)
    po = PO.Probe(*p)
    calls = {"other": lambda v: PO.launch_kparts(v, po), "this": lambda v: P.launch_kparts(v, p)}
    for v in P.VARIANTS:
        got, want = calls["this"](v), calls["other"](v)
        err = max((a - b).abs().max().item() for a, b in zip(got, want))
        scale = max(b.abs().max().item() for b in want)
        print(f"kparts {v} nt={nt}: largest difference from the other version {err:.3e} "
              f"(outputs up to {scale:.3e})", flush=True)
        del got, want
    order = ("other", "this", "this", "other")
    times = {}
    for who in order:
        for v in P.VARIANTS:
            times.setdefault((who, v), []).append(wall_time(lambda: calls[who](v), 5, 2))
    print(f"kparts ms per launch (CUDA events), in turns {' '.join(order)} (nt={nt}, m=4096, "
          f"K=128, PAD=64) [{card}]", flush=True)
    for v in P.VARIANTS:
        print(f"  {v}: " + "; ".join(
            f"{w} {'/'.join(f'{t:.4f}' for t in times[(w, v)])}" for w in ("other", "this")),
            flush=True)


def main(argv) -> int:
    if not torch.cuda.is_available():
        raise RuntimeError("compare_bodies needs a CUDA device")
    probes_only, split_only = "--probes-only" in argv, "--split" in argv
    argv = [a for a in argv if a not in ("--probes-only", "--split")]
    sys.path.insert(0, os.path.abspath(argv[0]))
    card = card_name()
    print(card, flush=True)
    if probes_only:
        compare_probes(torch.device("cuda", 0), card)
        return 0
    if split_only:
        split(torch.device("cuda", 0), card)
        return 0
    import sdft_tpu_torch as T
    import sdft_tpu_torch_old as TO
    from sdft_tpu_torch_old.kernels import scan as QO, spectra as SO

    from . import _build, scan as Q, spectra as S

    pairs = [tuple(int(a) for a in v.split(",")) for v in argv[1:]] or [(S.STRIP, Q.BINS)]
    dev = torch.device("cuda", 0)
    t0 = time.perf_counter()
    SO.library()
    libs = {v: build_variant(*v)[0] for v in pairs}
    print(f"builds {time.perf_counter() - t0:.1f} s", flush=True)
    for v in pairs:
        entries, _ = _build.ptxas_report(_build.BUILD_DIR / f"strips_{v[0]}_{v[1]}" / "lib.log")
        regs = {}
        for name, r, spill, _, _ in entries:
            k = re.match(r"_ZN4sdft11scan_kernelILi0ELb1ELi(\d)E", name)
            if k:
                regs[k.group(1)] = f"{r}/{spill}"
        print(f"strips {v}: ptxas registers/spill stores of K2 packed f32 by halo: "
              + ", ".join(f"{h}: {t}" for h, t in sorted(regs.items())), flush=True)
    saved = (S.STRIP, Q.BINS, S.library, Q.library)

    def use(v):
        S.STRIP, Q.BINS = v
        S.library = Q.library = lambda: libs[v]

    def planes(t):
        return t if isinstance(t, tuple) else (t,)

    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for v, lib in libs.items():
        per_sm = lib.sdft_scan_occupancy(TILE)
        print(f"strips {v}: resident blocks/SM at K={TILE} (hann): K1 "
              f"{lib.sdft_spectra_occupancy(TILE)} (resident clusters of 8, paced planar f32: "
              f"{lib.sdft_spectra_clusters(TILE, 8)}), K2 {per_sm}; K2 "
              + ", ".join(f"{C}x{M}: {k2_wave(per_sm, sms, v[1], 1000, C, M)}"
                          for C, M in K2_SHAPES), flush=True)
    x1 = signal(65536, 7, dev)
    p1, p1o = (P.Plan(4096, window="hann", precision=P.FAST_PRECISION) for P in (T, TO))
    p2, p2o = (P.Plan(1000, window="hann", precision=P.FAST_PRECISION) for P in (T, TO))
    pro1 = S.spectra_prologue(p1, T.init_state(p1, device=dev), x1)
    pro1o = SO.spectra_prologue(p1o, TO.init_state(p1o, device=dev), x1)
    syn, syno = Q.synthesis_row(p2, dev), QO.synthesis_row(p2o, dev)
    pro2, pro2o = {}, {}
    for C, M in K2_SHAPES:
        x = signal(C * M, 8 + C, dev).reshape((C, M) if C > 1 else (M,))
        ch = {"channels": C} if C > 1 else {}
        pro2[C, M] = S.spectra_prologue(p2, T.init_state(p2, device=dev, **ch), x)
        pro2o[C, M] = SO.spectra_prologue(p2o, TO.init_state(p2o, device=dev, **ch), x)
    k1000 = tuple(("m=1000", *f) for f in FORMS)
    keys = (*FORMS, *K2_SHAPES, "y only", *k1000)
    calls = {}
    for who, SS, QQ, pa, pb, pr1, pr2, sy in (
            ("other", SO, QO, p1o, p2o, pro1o, pro2o, syno),
            ("this", S, Q, p1, p2, pro1, pro2, syn)):
        c = {f: (lambda f=f, SS=SS, pa=pa, pr1=pr1: SS.launch_spectra(pa, pr1, *f))
             for f in FORMS}
        for k in K2_SHAPES:
            c[k] = lambda k=k, QQ=QQ, pb=pb, pr2=pr2, sy=sy: QQ.launch_scan(pb, pr2[k], sy,
                                                                            "packed")
        c["y only"] = lambda QQ=QQ, pb=pb, pr2=pr2, sy=sy: (
            QQ.launch_scan(pb, pr2[SPLIT], sy, None)[1])
        for f in FORMS:
            c["m=1000", *f] = lambda f=f, SS=SS, pb=pb, pr2=pr2: SS.launch_spectra(
                pb, pr2[SPLIT], *f)
        calls[who] = c
    for v in pairs:
        use(v)
        for key in keys:
            got, want = calls["this"][key](), calls["other"][key]()
            if key in K2_SHAPES:
                (got, y), (want, yo) = got, want
                print(f"strips {v} {label(key)}: largest difference from the other version: "
                      f"spectra {(got - want).abs().max().item():.3e}, y "
                      f"{(y - yo).abs().max().item():.3e}", flush=True)
                continue
            err = max((a.float() - b.float()).abs().max().item()
                      for a, b in zip(planes(got), planes(want)))
            print(f"strips {v} {label(key)}: largest difference from the other version "
                  f"{err:.3e}", flush=True)
            del got, want
    order = ["other", *pairs]
    times = {}
    for who in order + order[::-1]:
        if who != "other":
            use(who)
        fns = calls["other" if who == "other" else "this"]
        for key in keys:
            k1 = key in FORMS or key in k1000
            times.setdefault((who, key), []).append(
                kernel_ms(fns[key], "spectra_kernel" if k1 else "scan_kernel", 10 if k1 else 20))
    print(f"device ms, in turns {' '.join(map(str, order + order[::-1]))} [{card}]", flush=True)
    for key in keys:
        print(f"  {label(key)}: " + "; ".join(
            f"{w} {'/'.join(f'{t:.4f}' for t in times[(w, key)])}" for w in order), flush=True)
    del pro1, pro1o, pro2, pro2o, calls

    use(pairs[0])
    C, M = 8, 32768
    xs = signal(C * M, 9, dev).reshape(C, M)
    st, sto = T.init_state(p1, channels=C, device=dev), TO.init_state(p1o, channels=C, device=dev)
    batch = {"other": lambda: TO.sdft(p1o, sto, xs, "planar"),
             "this": lambda: T.sdft(p1, st, xs, "planar")}
    for who in ("other", "this", "this", "other"):
        fn = batch[who]
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        out = fn()
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() - base
        del out
        d = kernel_ms(fn, "", 3)
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(3):
            fn()
        b.record()
        b.synchronize()
        print(f"sdft C={C} M={M} planar f32, {who} version: device {d:.4f} ms, wall "
              f"{a.elapsed_time(b) / 3:.4f} ms, peak {peak / 2**30:.3f} GiB above the "
              f"inputs [{card}]", flush=True)
    S.STRIP, Q.BINS, S.library, Q.library = saved
    del batch, st, sto, xs
    torch.cuda.empty_cache()
    compare_probes(dev, card)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
