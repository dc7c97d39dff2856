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
  --mesh CxTxB  the sharded driver: not ported yet (ROADMAP queue 1, item 11)

The ``bench`` and ``trace`` subcommands of ``python -m sdft_tpu`` are not
ported yet (ROADMAP queue 1, item 12).
"""

from __future__ import annotations

import sys
import time

import numpy as np
import torch

from .api import roundtrip_hopped
from .config import Precision
from .cplx import to_complex
from .io.dump import dump_complex
from .io.wav import read_wav, write_wav
from .ops.lti import driver_sub_factor
from .plan import Plan
from .state import init_state

#: Cap on the hop-DFT bytes one driver segment holds on the device (the
#: outputs are fetched per segment): bounds device memory for long streams.
_SUPER_DFT_BYTES = 256 << 20


def _value(extras: list, flag: str) -> str:
    i = extras.index(flag)
    if i + 1 >= len(extras):
        raise SystemExit(f"{flag} needs a value")
    return extras[i + 1]


def _device(extras: list) -> torch.device:
    """The device named by --device, else cuda:0; raises when that is a
    CUDA device and there is no card (never falls back to the CPU)."""
    dev = torch.device(_value(extras, "--device") if "--device" in extras
                       else "cuda:0")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"no CUDA device for {dev}: the driver runs on "
                           "cuda:0; pass --device cpu to run on the CPU")
    return dev


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if argv and argv[0] in ("bench", "trace"):
        raise NotImplementedError(
            f"the {argv[0]} subcommand is not ported yet (ROADMAP queue 1, "
            "item 12)")
    if len(argv) < 7:
        print(__doc__)
        return 1

    dftsize = int(argv[0])
    hopsize = int(argv[1])
    window = argv[2]
    latency = float(argv[3])
    srcfile, wavfile, dftfile = argv[4:7]
    extras = argv[7:]
    if "--mesh" in extras:
        raise NotImplementedError(
            "--mesh (the sharded driver) is not ported yet (ROADMAP queue 1, "
            "item 11)")
    device = _device(extras)
    fd = "float32" if "--fd32" in extras else "float64"

    # hops shorter than 8 samples run tiles of several hops (ops.lti)
    tile = hopsize * driver_sub_factor(hopsize)
    block = tile * max(1, -(-16000 // tile))
    if "--block" in extras:
        block = int(_value(extras, "--block"))
    if block <= 0 or block % hopsize:
        raise SystemExit(f"--block {block} must be a positive multiple of "
                         f"hopsize {hopsize}")

    plan = Plan(dftsize, window=window, latency=latency,
                precision=Precision(td=fd, fd=fd))
    x, sr = read_wav(srcfile)
    print(f"{device}\t{srcfile} {x.size} {sr}")
    size = (x.size // hopsize) * hopsize
    if size == 0:
        raise SystemExit(f"{srcfile}: shorter than one hop ({hopsize} samples)")

    # segments of at most _SUPER_DFT_BYTES of hop spectra; the stream is
    # zero-padded to whole segments, which changes only the carry past its
    # end, and the outputs are cut back
    bin_bytes = 8 if fd == "float32" else 16  # packed re/im pair
    bytes_per_block = (block // hopsize) * dftsize * bin_bytes
    nb = min(max(1, _SUPER_DFT_BYTES // bytes_per_block), -(-size // block))
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

    y = np.concatenate(ys).astype(np.float64)[:size]
    write_wav(wavfile, y, sr)
    dump_complex(dftfile, np.concatenate(hop_dfts)[:size // hopsize])
    print(f"{size} samples in {elapsed:.3f}s = {size / elapsed:,.0f} samples/s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
