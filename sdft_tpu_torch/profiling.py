"""Cost accounting and the K1-part probes (counterpart of part of
``sdft_tpu.profiling``).

  * :class:`OpCost`, :func:`analysis_cost`, :func:`synthesis_cost`,
    :func:`roundtrip_cost` — analytic flops and device-memory bytes of the
    blockwise SDFT ops, the inputs of a roofline;
  * :func:`kernel_parts` — drives the probes of K1's parts
    (``kernels.kparts``) on the card and times each.

The JAX package's ``trace``, ``benchmark*``, its scaling model and its
``bench`` CLI are not ported yet (ROADMAP queue 1, item 12).
"""

from __future__ import annotations

import dataclasses

import torch

from .kernels import kparts as _kparts
from .plan import Plan
from .windows import WINDOW_HALO

__all__ = ["OpCost", "analysis_cost", "synthesis_cost", "roundtrip_cost",
           "kernel_parts"]


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
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(reps):
            _kparts.kparts(v, p)
        b.record()
        b.synchronize()
        ms = a.elapsed_time(b) / reps
        out[v] = {"ms": ms, "us_per_tile": ms * 1e3 / nt,
                  "stored_gbs": stored / ms / 1e6, "finite": finite}
    return out
