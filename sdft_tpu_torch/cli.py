"""Reference-protocol CLI driver (counterpart of ``sdft_tpu.cli``).

Mirrors the reference test drivers' 7-positional-argument protocol
(test/test.c:41-47, test/test.py:16-22):

    python -m sdft_tpu_torch <dftsize> <hopsize> <window> <latency> <src.wav> <out.wav> <out.dft>

Reads the source WAV (mean-mixed to mono), truncates it to whole hops,
streams it through the driver protocol (``api.roundtrip_hopped``), writes
the synthesized WAV and dumps the first DFT vector of every hop as raw
complex128 — the comparator format of test/main.py:46-49.

Optional flags after the 7 positionals:
  --fd32        float32 time and frequency domain (the GPU fast path);
                without it the plan is float64 throughout, and on a GPU
                that really runs in float64
  --block N     N-sample blocks per driver step (default: at least 16000
                samples, a whole number of tiles); the output does not
                depend on it beyond rounding
  --device D    the torch device to run on (default cuda:0); --device cpu
                is the only way onto the CPU
  --mesh CxTxB  run the driver over a (channel, time, bins) mesh of ranks
                (``parallel.sharded_roundtrip_hopped``: one fused sharded
                body per block); C must be 1 (the driver is mono).  torch
                is multi-controller: start one process per rank,
                ``torchrun --standalone --nproc-per-node N -m sdft_tpu_torch
                ... --mesh 1xTxB`` (N = T*B; NCCL, one card per rank, or
                Gloo with --device cpu); a plain ``python -m`` run makes a
                one-rank group itself, for --mesh 1x1x1.  Every rank reads
                the WAV, rank 0 writes the outputs.  Blocks default to
                tile*T rounded up to >= 16000 samples; the trailing partial
                block runs on the single-device path with the carried state

Subcommands, as ``python -m sdft_tpu``'s:

    python -m sdft_tpu_torch bench [m] [block] [runs] [--device D] [--mesh CxTxB]
    python -m sdft_tpu_torch trace <logdir> <7 driver args> [flags]

``bench`` is ``profiling.bench_cli``; ``trace`` runs the driver inside
``profiling.trace``, which writes a Chrome trace into ``logdir``.
"""

from __future__ import annotations

import sys
import time

import numpy as np
import torch

from .api import roundtrip, roundtrip_hopped, sdft_hopped
from .config import Precision
from .cplx import to_complex
from .io.dump import dump_complex
from .io.wav import read_wav, write_wav
from .ops.lti import driver_sub_factor
from .plan import Plan
from .state import State, init_state, require_device

#: Cap on the hop-DFT bytes one driver segment holds on the device (the
#: outputs are fetched per segment): bounds device memory for long streams.
_SUPER_DFT_BYTES = 256 << 20


def _value(extras: list, flag: str) -> str:
    i = extras.index(flag)
    if i + 1 >= len(extras):
        raise SystemExit(f"{flag} needs a value")
    return extras[i + 1]


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if argv and argv[0] == "bench":
        from .profiling import bench_cli
        return bench_cli(argv[1:])
    if argv and argv[0] == "trace" and len(argv) > 1:
        from .profiling import trace
        with trace(argv[1]):
            return main(argv[2:])
    if len(argv) < 7:
        print(__doc__)
        return 1

    dftsize = int(argv[0])
    hopsize = int(argv[1])
    window = argv[2]
    latency = float(argv[3])
    srcfile, wavfile, dftfile = argv[4:7]
    extras = argv[7:]
    device = require_device(_value(extras, "--device") if "--device" in extras
                            else "cuda:0")
    fd = "float32" if "--fd32" in extras else "float64"
    mesh_axes = _mesh_axes(_value(extras, "--mesh")) if "--mesh" in extras else None

    # hops shorter than 8 samples run tiles of several hops (ops.lti); under
    # --mesh a block splits into T local blocks of whole tiles
    unit = hopsize * driver_sub_factor(hopsize) * (mesh_axes[1] if mesh_axes else 1)
    block = unit * max(1, -(-16000 // unit))
    if "--block" in extras:
        block = int(_value(extras, "--block"))
    if block <= 0 or block % hopsize:
        raise SystemExit(f"--block {block} must be a positive multiple of "
                         f"hopsize {hopsize}")
    if mesh_axes and block % unit:
        raise SystemExit(f"--block {block} must be a multiple of tile*T = {unit} "
                         "under --mesh")

    plan = Plan(dftsize, window=window, latency=latency,
                precision=Precision(td=fd, fd=fd))
    x, sr = read_wav(srcfile)
    size = (x.size // hopsize) * hopsize
    if size == 0:
        raise SystemExit(f"{srcfile}: shorter than one hop ({hopsize} samples)")
    if mesh_axes:
        return _main_mesh(plan, mesh_axes, device, x[:size], sr, block, hopsize,
                          srcfile, wavfile, dftfile)
    print(f"{device}\t{srcfile} {x.size} {sr}")

    # segments of at most _SUPER_DFT_BYTES of hop spectra; the stream is
    # zero-padded to whole segments, which changes only the carry past its
    # end, and the outputs are cut back
    nb = min(_blocks_per_segment(plan, block, hopsize), -(-size // block))
    seg = nb * block
    padded = -(-size // seg) * seg
    xp = torch.zeros(padded, dtype=plan.precision.td_dtype, device=device)
    xp[:size] = torch.as_tensor(x[:size]).to(device=device, dtype=xp.dtype)

    state = init_state(plan, device=device)
    ys, hop_dfts = [], []
    t0 = time.perf_counter()
    for i in range(0, padded, seg):
        state, hd, yy = roundtrip_hopped(plan, state, xp[i:i + seg].view(nb, block),
                                         hopsize)
        ys.append(yy.reshape(-1).cpu().numpy())
        hop_dfts.append(to_complex(hd.reshape(-1, dftsize, 2)))
        print(f"{min(i + seg, size) * 100 // size}%")
    elapsed = time.perf_counter() - t0

    _write(wavfile, dftfile, ys, hop_dfts, sr, size, hopsize, elapsed)
    return 0


def _mesh_axes(spec: str) -> tuple:
    try:
        axes = tuple(int(p) for p in spec.lower().split("x"))
    except ValueError:
        axes = ()
    if len(axes) != 3 or min(axes) < 1:
        raise SystemExit(f"--mesh expects CxTxB (e.g. 1x4x2), got {spec!r}")
    if axes[0] != 1:
        raise SystemExit("--mesh channel axis must be 1 (mono driver)")
    return axes


def _blocks_per_segment(plan: Plan, block: int, hopsize: int) -> int:
    """Blocks of one driver segment: at most _SUPER_DFT_BYTES of hop spectra."""
    bin_bytes = 2 * plan.precision.fd_dtype.itemsize  # packed re/im pair
    return max(1, _SUPER_DFT_BYTES // ((block // hopsize) * plan.dftsize * bin_bytes))


def _write(wavfile, dftfile, ys, hop_dfts, sr, size, hopsize, elapsed):
    y = np.concatenate(ys).astype(np.float64)[:size]
    write_wav(wavfile, y, sr)
    dump_complex(dftfile, np.concatenate(hop_dfts)[:size // hopsize])
    print(f"{size} samples in {elapsed:.3f}s = {size / elapsed:,.0f} samples/s")


def _main_mesh(plan: Plan, axes: tuple, device: torch.device, x: np.ndarray, sr: int,
               block: int, hopsize: int, srcfile: str, wavfile: str, dftfile: str) -> int:
    """The driver over a mesh of ranks: whole blocks through
    ``sharded_roundtrip_hopped``, segment by segment, then the trailing
    partial block on the single-device path with the carried state (the
    JAX CLI's order, sdft_tpu/cli.py:126-164).  Rank 0 prints and writes."""
    import torch.distributed as dist

    from .parallel import make_mesh, multihost, sharded_roundtrip_hopped

    created = not (dist.is_available() and dist.is_initialized())
    multihost.initialize(device_type=device.type)
    try:
        mesh = make_mesh(*axes, device_type=device.type)
        dev = multihost.mesh_device(mesh)
        rank0 = dist.get_rank() == 0
        size = x.size
        if rank0:
            print(f"{dev} mesh {'x'.join(map(str, axes))}\t{srcfile} {size} {sr}")
        m = plan.dftsize
        state = init_state(plan, channels=1, device=dev)
        mesh_size = (size // block) * block  # whole sharded blocks
        seg = min(_blocks_per_segment(plan, block, hopsize), max(1, mesh_size // block)) * block
        xd = torch.as_tensor(x).to(device=dev, dtype=plan.precision.td_dtype)
        ys, hop_dfts = [], []
        t0 = time.perf_counter()
        for i in range(0, mesh_size, seg):
            chunk = xd[i:min(i + seg, mesh_size)]
            state, hd, yy = sharded_roundtrip_hopped(plan, mesh, state,
                                                     chunk.view(-1, 1, block), hopsize)
            hd, yy = hd.full_tensor(), yy.full_tensor()
            ys.append(yy.reshape(-1).cpu().numpy())
            hop_dfts.append(to_complex(hd.reshape(-1, m, 2)))
            if rank0:
                print(f"{min(i + seg, mesh_size) * 100 // size}%")
        if mesh_size < size:
            st = State(*(a.full_tensor() for a in state)) if mesh_size else state
            tail = xd[None, mesh_size:]
            _, hd = sdft_hopped(plan, st, tail, hopsize)
            _, yy = roundtrip(plan, st, tail)
            ys.append(yy[0].cpu().numpy())
            hop_dfts.append(to_complex(hd[0]))
            if rank0:
                print("100%")
        elapsed = time.perf_counter() - t0
        if rank0:
            _write(wavfile, dftfile, ys, hop_dfts, sr, size, hopsize, elapsed)
    finally:
        if created:
            dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
