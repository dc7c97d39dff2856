"""The comparison that decides ``correct``: what the timed path produced for
one block late in the window, and the carried state after it, against the
plain reference (``reference``) worked out from the same input samples.

The numbers compared (each against its limit in ``limits/<cell>.json``):

  * ``spectra_err``: max |spectrum - reference| over every channel, sample
    and bin of the block, over max |reference| (the spectra's scale);
  * ``hop_spectra_err``: the same over the first-of-hop spectra;
  * ``samples_err``: max |sample - reference| of the synthesized samples;
  * ``acc_err``: max |accumulator - reference| over max |reference|;
  * ``delayline_err``: max |delayline - the last 2m input samples|;
  * ``offset_err``: max |offset - samples streamed mod 2m|.

An outcome is given as callables that return a chunk of positions at a
time, so the program's stored outputs and the control's computed ones are
compared alike, in pieces that fit beside the program's state.
"""

from __future__ import annotations

import math

import torch

from . import reference as ref

def planar(re: torch.Tensor, im: torch.Tensor):
    """A chunk reader of planar (C, L, m) spectra."""
    return lambda pos: torch.complex(re[:, pos].double(), im[:, pos].double())


def packed(d: torch.Tensor):
    """A chunk reader of packed (C, L, m, 2) spectra."""
    return lambda pos: torch.complex(d[:, pos, :, 0].double(), d[:, pos, :, 1].double())


def rows(y: torch.Tensor):
    """A chunk reader of (C, L) samples."""
    return lambda pos: y[:, pos].double()


def _max(a: torch.Tensor) -> float:
    return float(a.max()) if a.numel() else 0.0


def compare(spec: ref.Spec, xext: torch.Tensor, got: dict, offset_after: int,
            tail: torch.Tensor | None = None) -> dict:
    """The numbers compared, for whichever outputs ``got`` holds.

    Args:
      spec: the configuration's reference spec.
      xext: (C, 2m + L) float64 input samples: the 2m before the block,
        then the block (a sub-block for one time shard of a mesh).
      got: readers ``spectra`` (positions -> (C, R, m) complex),
        ``hop_spectra`` (with ``hop``: hop indices -> (C, R, m)),
        ``samples`` (positions -> (C, R)), and ``state`` (offset (C,),
        delayline (C, 2m), accumulator (C, m) complex), any subset.
      offset_after: samples streamed up to the end of the block, mod 2m.
      tail: the stream's last 2m samples at the end of the block, if
        ``xext`` ends before it (a time shard's sub-block).
    """
    C, L = xext.shape[0], xext.shape[1] - spec.n2
    dev = xext.device
    out = {}

    def spectra_at(pos):
        return ref.spectra(spec, xext, pos)

    if "spectra" in got or "samples" in got:
        err = scale = yerr = 0.0
        for pos in ref.chunks(spec, C, torch.arange(L, device=dev)):
            want = spectra_at(pos)
            if "spectra" in got:
                err = max(err, _max((got["spectra"](pos) - want).abs()))
                scale = max(scale, _max(want.abs()))
            if "samples" in got:
                yerr = max(yerr, _max((got["samples"](pos) - ref.synthesis(spec, want)).abs()))
            del want
        if "spectra" in got:
            out["spectra_err"] = err / scale
        if "samples" in got:
            out["samples_err"] = yerr
    if "hop_spectra" in got:
        hop = got["hop"]
        err = scale = 0.0
        for j in ref.chunks(spec, C, torch.arange(-(-L // hop), device=dev)):
            want = spectra_at(j * hop)
            err = max(err, _max((got["hop_spectra"](j) - want).abs()))
            scale = max(scale, _max(want.abs()))
        out["hop_spectra_err"] = err / scale
    if "state" in got:
        offset, delayline, acc = got["state"]
        tail = xext[:, -spec.n2:] if tail is None else tail
        want = ref.accumulator(spec, tail, offset_after)
        out["acc_err"] = _max((acc.to(want.dtype) - want).abs()) / _max(want.abs())
        out["delayline_err"] = _max((delayline.double() - tail).abs())
        out["offset_err"] = _max((offset.to(torch.int64) - offset_after).abs().double())
    return {k: float(v) for k, v in out.items()}


def verdict(numbers: dict, limit: dict) -> tuple:
    """(correct, [(name, value, limit)]): every number within its limit
    (and a number), and every limit given a number."""
    rows_ = [(k, numbers.get(k, math.nan), float(v)) for k, v in sorted(limit.items())]
    ok = bool(rows_) and all(math.isfinite(v) and v <= lim for _, v, lim in rows_)
    return ok, rows_
