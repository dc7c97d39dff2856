"""Driver-protocol streaming with the PyTorch port (twin of
examples/streaming.py): the reference's hop-chunked usage.

The reference drivers stream hop-sized chunks through persistent plan
state, keeping each hop's first DFT vector (test/test.c:69-83).  Here the
same protocol runs through ``Streamer.run_hopped``, which groups blocks
into chains of one ``api.roundtrip_hopped`` call each.

Checks the contract as it goes: the chained hop spectra equal a per-block
path (``sdft_hopped`` + ``roundtrip`` per block) at 1e-12 — the plan is
float64, which a card runs in float64 — and the synthesized stream
reconstructs the input at the algorithmic SNR (~31 dB on noise at
latency 1).

    python examples/streaming_torch.py [dftsize] [hop] [--device D]
"""

import argparse
import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

import numpy as np  # noqa: E402

from sdft_tpu_torch import (Plan, Precision, Streamer, init_state, iter_blocks,  # noqa: E402
                            roundtrip, roundtrip_snr_db, sdft_hopped)
from sdft_tpu_torch.cplx import to_numpy  # noqa: E402


def main(dftsize=256, hop=32, device="cuda:0"):
    rng = np.random.default_rng(0)
    x = np.clip(rng.standard_normal(40 * hop * 8), -3, 3) / 2
    block = 8 * hop

    plan = Plan(dftsize, window="hann", precision=Precision("float64", "float64"))

    hops, ys = [], []
    for hd, y in Streamer(plan, device=device).run_hopped(iter_blocks(x, block), hop,
                                                          chain=16):
        hops.append(hd)
        ys.append(y)
    y = np.concatenate(ys)
    dfts = np.concatenate(hops)  # (n_hops, m, 2): first spectrum per hop

    want = []
    st = init_state(plan, device=device)
    for blk in iter_blocks(x, block):
        _, hd = sdft_hopped(plan, st, blk, hop)
        st, _ = roundtrip(plan, st, blk)
        want.append(to_numpy(hd))
    want = np.concatenate(want)
    err = float(np.abs(dfts - want).max())
    if not err <= 1e-12:
        raise AssertionError(f"chained hop spectra vs per-block path: {err:.3e} > 1e-12")

    snr = roundtrip_snr_db(x, y, plan)
    print(f"m={dftsize} hop={hop}: {x.size} samples, {dfts.shape[0]} hop spectra "
          f"(vs per-block {err:.1e}), round-trip SNR {snr:.2f} dB")
    if not snr > 25.0:
        raise AssertionError(f"round-trip SNR {snr:.2f} dB <= 25")
    print("OK")
    return snr


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("dftsize", type=int, nargs="?", default=256)
    ap.add_argument("hop", type=int, nargs="?", default=32)
    ap.add_argument("--device", default="cuda:0")
    args = ap.parse_args()
    main(args.dftsize, args.hop, device=args.device)
