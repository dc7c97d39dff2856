"""Time this version's K1 and K2 against another version of the port, in
turns on one card.

    git archive <commit> sdft_tpu_torch | tar -x -C DIR
    mv DIR/sdft_tpu_torch DIR/sdft_tpu_torch_old
    python -m sdft_tpu_torch.kernels.compare_bodies DIR [K1,K2 ...]

DIR holds the other version's package under the name ``sdft_tpu_torch_old``
(its imports are relative, so it loads beside this one and builds its own
library).  Each K1,K2 pair builds this version's kernels with those strip
widths (``-DSDFT_K1_STRIP``, ``-DSDFT_K2_STRIP``; default: the built-in
4,2).  For K1's five store forms at m = 4096, M = 65536 and for K2 at
m = 1000, B = 8000 it prints each body's largest difference from the other
version on the same inputs and the profiler's device time of its kernel,
in turns (other, pairs, pairs reversed, other), then ``sdft`` on an 8 x
32768 channel batch (planar f32) of both versions: device time, wall time
and peak memory above the inputs.
"""

from __future__ import annotations

import concurrent.futures
import ctypes
import os
import subprocess
import sys
import time

import numpy as np
import torch

FORMS = (("planar", "float32"), ("packed", "float32"), ("planar", "bfloat16"),
         ("power", "float32"), ("power", "bfloat16"))


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


def build_variant(k1: int, k2: int):
    """This version's K1/K2 library with strips of k1 and k2 bins."""
    from . import _build

    out = _build.BUILD_DIR / f"strips_{k1}_{k2}"
    out.mkdir(parents=True, exist_ok=True)
    flags = (*_build.FLAGS, f"-DSDFT_K1_STRIP={k1}", f"-DSDFT_K2_STRIP={k2}")
    objs = [str(out / (s + ".o")) for s in ("spectra.cu", "scan.cu")]
    cmds = [[_build.nvcc(), *flags, "-c", str(_build.CSRC / s), "-o", o]
            for s, o in zip(("spectra.cu", "scan.cu"), objs)]
    with concurrent.futures.ThreadPoolExecutor(2) as pool:
        log = "".join(pool.map(_build._run, cmds))
    so = str(out / "lib.so")
    _build._run([_build.nvcc(), *_build.ARCH, "-shared", "-o", so, *objs])
    lib = ctypes.CDLL(so)
    for name in ("sdft_spectra_launch", "sdft_scan_launch", "sdft_spectra_occupancy",
                 "sdft_scan_occupancy"):
        fn = getattr(lib, name)
        fn.argtypes = list(_build.SIGNATURES[name])
        fn.restype = ctypes.c_int
    return lib, log


def main(argv) -> int:
    if not torch.cuda.is_available():
        raise RuntimeError("compare_bodies needs a CUDA device")
    sys.path.insert(0, os.path.abspath(argv[0]))
    import sdft_tpu_torch as T
    import sdft_tpu_torch_old as TO
    from sdft_tpu_torch_old.kernels import scan as QO, spectra as SO

    from . import scan as Q, spectra as S

    pairs = [tuple(int(a) for a in v.split(",")) for v in argv[1:]] or [(S.STRIP, Q.STRIP)]
    dev = torch.device("cuda", 0)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip()
    print(card, flush=True)
    t0 = time.perf_counter()
    SO.library()
    libs = {v: build_variant(*v)[0] for v in pairs}
    print(f"builds {time.perf_counter() - t0:.1f} s", flush=True)
    saved = (S.STRIP, Q.STRIP, S.library, Q.library)

    def use(v):
        S.STRIP, Q.STRIP = v
        S.library = Q.library = lambda: libs[v]

    def sig(n, seed):
        x = np.random.default_rng(seed).standard_normal(n).clip(-1, 1).astype(np.float32)
        return torch.as_tensor(x, device=dev)

    def planes(t):
        return t if isinstance(t, tuple) else (t,)

    for v, lib in libs.items():
        print(f"strips {v}: resident blocks/SM at K=128 (hann): K1 "
              f"{lib.sdft_spectra_occupancy(128)}, K2 {lib.sdft_scan_occupancy(128)}", flush=True)
    x1, x2 = sig(65536, 7), sig(8000, 8)
    p1, p1o = (P.Plan(4096, window="hann", precision=P.FAST_PRECISION) for P in (T, TO))
    p2, p2o = (P.Plan(1000, window="hann", precision=P.FAST_PRECISION) for P in (T, TO))
    pro1 = S.spectra_prologue(p1, T.init_state(p1, device=dev), x1)
    pro1o = SO.spectra_prologue(p1o, TO.init_state(p1o, device=dev), x1)
    pro2 = S.spectra_prologue(p2, T.init_state(p2, device=dev), x2)
    pro2o = SO.spectra_prologue(p2o, TO.init_state(p2o, device=dev), x2)
    syn, syno = Q.synthesis_row(p2, dev), QO.synthesis_row(p2o, dev)
    calls = {"other": {f: (lambda f=f: SO.launch_spectra(p1o, pro1o, *f)) for f in FORMS}}
    calls["other"]["K2"] = lambda: QO.launch_scan(p2o, pro2o, syno, "packed")
    for v in pairs:
        calls[v] = {f: (lambda f=f: S.launch_spectra(p1, pro1, *f)) for f in FORMS}
        calls[v]["K2"] = lambda: Q.launch_scan(p2, pro2, syn, "packed")
    for v in pairs:
        use(v)
        for key in (*FORMS, "K2"):
            got, want = planes(calls[v][key]()), planes(calls["other"][key]())
            err = max((a.float() - b.float()).abs().max().item() for a, b in zip(got, want))
            print(f"strips {v} {' '.join(key) if key != 'K2' else 'K2 spectra'}: largest "
                  f"difference from the other version {err:.3e}", flush=True)
        _, y = Q.launch_scan(p2, pro2, syn, "packed")
        _, yo = QO.launch_scan(p2o, pro2o, syno, "packed")
        print(f"strips {v} K2 y: largest difference {(y - yo).abs().max().item():.3e}", flush=True)
    order = ["other", *pairs]
    times = {}
    for who in order + order[::-1]:
        if who != "other":
            use(who)
        for key in (*FORMS, "K2"):
            name = "scan_kernel" if key == "K2" else "spectra_kernel"
            times.setdefault((who, key), []).append(
                kernel_ms(calls[who][key], name, 20 if key == "K2" else 10))
    print(f"device ms, in turns {' '.join(map(str, order + order[::-1]))} (K1 m=4096 "
          f"M=65536, K2 m=1000 B=8000) [{card}]", flush=True)
    for key in (*FORMS, "K2"):
        print(f"  {' '.join(key) if key != 'K2' else 'K2 packed + y'}: " + "; ".join(
            f"{w} {'/'.join(f'{t:.4f}' for t in times[(w, key)])}" for w in order), flush=True)
    del pro1, pro1o

    use(pairs[0])
    C, M = 8, 32768
    xs = sig(C * M, 9).reshape(C, M)
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
    S.STRIP, Q.STRIP, S.library, Q.library = saved
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
