"""Public entry points (counterpart of ``sdft_tpu.api``).

    state, dfts = sdft(plan, state, samples)   # dfts packed (..., M, m, 2)
    samples     = isdft(plan, dfts)

``samples`` is (M,) for one channel or (C, M) for a channel batch; the
state is batched iff the samples are.  Work runs on the device of the
state; numpy inputs are moved there.

Dispatch mirrors ``api._use_pallas`` (api.py:66-67) through a predicate of
the plan alone, ``kernel_supported``: float32 plans with 128 <= m <= 2^19
go through the kernel wrappers on every device (the plain PyTorch versions
on a CPU tensor, the CUDA kernels on a CUDA tensor); other plans (float64,
m < 128) take the reference ``ops`` path.  A channel batch on a kernel plan
runs one prologue and one launch for all its channels, the counterpart of
the JAX package's vmap over its Pallas calls (sdft_tpu/api.py:57-63,
319-326); the ``ops`` path runs its channels one after another.

Extended plans (``Precision(fd="float32x2")``) run ``sdft`` and ``isdft``
in the double-word tier (``ops.twofloat``), as ``sdft_tpu.api`` does; every
other entry point treats them as float32 (``fd_dtype``) on the ``ops`` path,
since ``kernel_supported`` takes float32 FD plans only.
"""

from __future__ import annotations

import numpy as np
import torch

from . import graphs
from .cplx import from_complex, pack, unpack
from .kernels.spectra import forward_block, forward_block_power, kernel_supported
from .ops import lti
from .ops.analysis import refresh_state, sdft_block
from .ops.synthesis import isdft_block
from .ops.twofloat import isdft_block_df, sdft_block_df
from .plan import Plan
from .state import State, batch_state, stack_states


def _samples(state: State, samples, ndims=(1, 2)) -> torch.Tensor:
    x = torch.as_tensor(samples, device=state.offset.device)
    if x.ndim not in ndims:
        raise ValueError(f"samples must be (M,) or (C, M), got {tuple(x.shape)}")
    return x


def _per_channel(fn, state: State, x: torch.Tensor):
    """Run ``fn(state, samples) -> (state, out)`` for one channel or each
    channel of a batch, stacking the channels' outputs (the ``ops`` path of
    plans the kernels do not take)."""
    if x.ndim == 1:
        return fn(state, x)
    outs = [fn(batch_state(state, c), xc) for c, xc in enumerate(x)]
    st = stack_states([o[0] for o in outs])
    first = outs[0][1]
    if isinstance(first, tuple):
        return st, tuple(torch.stack([o[1][j] for o in outs])
                         for j in range(len(first)))
    return st, torch.stack([o[1] for o in outs])


def _sdft_ops(plan: Plan, layout: str, spectra_dtype: str | None):
    def run(st, x):
        st, d = sdft_block(plan, st, x)
        if layout != "planar":
            return st, d
        re, im = d[..., 0].contiguous(), d[..., 1].contiguous()
        if spectra_dtype:
            re, im = re.to(getattr(torch, spectra_dtype)), im.to(getattr(torch, spectra_dtype))
        return st, (re, im)
    return run


def sdft(plan: Plan, state: State, samples, layout: str = "packed",
         spectra_dtype: str | None = None):
    """Forward analysis: one spectrum per input sample.

    Args:
      plan: the plan.
      state: carry from ``init_state`` (batched iff samples are batched).
      samples: (M,) or (C, M) real samples.
      layout: "packed" returns spectra with a trailing re/im axis of size 2;
        "planar" returns a (re, im) pair of real tensors.
      spectra_dtype: None or "bfloat16" (planar only): the element type of
        the emitted planes; the scan itself stays in the plan's precision.

    Returns:
      (new_state, dfts) with dfts packed (M, m, 2) / (C, M, m, 2), or the
      planar pair of (M, m) / (C, M, m) tensors.
    """
    if layout not in ("packed", "planar"):
        raise ValueError(f"layout must be 'packed' or 'planar', got {layout!r}")
    if spectra_dtype and layout != "planar":
        raise ValueError("spectra_dtype requires layout='planar'")
    x = _samples(state, samples)
    if plan.precision.extended:
        # double-word tier (ops.twofloat): dfts gain a trailing (hi, lo)
        # axis, (..., M, m, 2, 2)
        if layout != "packed" or spectra_dtype:
            raise ValueError("the float32x2 extended tier emits packed "
                             "(hi, lo) spectra only")
        return sdft_block_df(plan, state, x)
    if kernel_supported(plan, x.shape[-1], spectra_dtype):
        return forward_block(plan, state, x, layout, spectra_dtype)
    return _per_channel(_sdft_ops(plan, layout, spectra_dtype), state, x)


def sdft_power(plan: Plan, state: State, samples,
               spectra_dtype: str | None = None):
    """Forward analysis emitting the power spectrum |dft|^2 per sample:
    (new_state, power) with power (M, m) / (C, M, m) real."""
    x = _samples(state, samples)
    if kernel_supported(plan, x.shape[-1], spectra_dtype):
        return forward_block_power(plan, state, x, spectra_dtype)

    def run(st, xc):
        st, d = sdft_block(plan, st, xc)
        p = d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1]
        return st, (p.to(getattr(torch, spectra_dtype)) if spectra_dtype else p)

    return _per_channel(run, state, x)


def isdft(plan: Plan, dfts) -> torch.Tensor:
    """Inverse synthesis: one sample per spectrum (c/src/sdft/sdft.h:666-672).

    Accepts packed (..., M, m, 2) tensors or arrays, or complex ones.  An
    extended (float32x2) plan takes the (..., M, m, 2, 2) (hi, lo) spectra
    of ``sdft`` and returns the correctly rounded samples (the ``hi`` half
    of ``ops.twofloat.isdft_block_df``) in the TD dtype."""
    if isinstance(dfts, torch.Tensor) and dfts.is_complex():
        dfts = pack(dfts)
    elif isinstance(dfts, np.ndarray) and np.iscomplexobj(dfts):
        dfts = torch.as_tensor(from_complex(
            dfts, dtype=np.float64 if plan.precision.fd_dtype == torch.float64
            else np.float32))
    dfts = torch.as_tensor(dfts)
    if plan.precision.extended:
        if dfts.ndim not in (4, 5) or tuple(dfts.shape[-2:]) != (2, 2):
            raise ValueError(
                "the float32x2 extended tier synthesizes from the packed "
                f"(..., M, m, 2, 2) (hi, lo) spectra, got {tuple(dfts.shape)}")
        hi, _ = isdft_block_df(plan, dfts)
        return hi.to(plan.precision.td_dtype)
    if dfts.ndim not in (3, 4) or dfts.shape[-1] != 2:
        raise ValueError(
            f"dfts must be packed (M, m, 2) or (C, M, m, 2), got {tuple(dfts.shape)}")
    return isdft_block(plan, dfts)


def _refresh(plan: Plan, state: State) -> State:
    if state.offset.ndim == 0:
        return refresh_state(plan, state)
    return stack_states([refresh_state(plan, batch_state(state, c))
                         for c in range(state.offset.shape[0])])


def refresh(plan: Plan, state: State) -> State:
    """Exactly rebuild the accumulator from the delayline (drift reset); on
    the card as one graph (``graphs``)."""
    if graphs.active(state.offset):
        return graphs.run("refresh", (plan,), lambda st: _refresh(plan, st), state)
    return _refresh(plan, state)


def roundtrip(plan: Plan, state: State, samples, transform=None):
    """sdft -> [transform ->] isdft round trip of one block.

    Without a transform the chain is linear time-invariant and runs in its
    collapsed form (``ops.lti.roundtrip_block_lti``): three GEMMs and a
    prefix over tiles, no spectra in memory (a "high" or "split4" plan
    splits the GEMMs, ``Precision.passes``).  The state it returns is the
    one ``sdft`` returns (a split plan's accumulator up to its split
    class), so the two forms interleave on one stream.

    With a transform, the complex (M, m) [(C, M, m)] spectra are
    materialized, mapped by ``transform`` to the same shape, and
    synthesized.  They come from the same route as ``sdft``'s (K1 for the
    plans ``kernel_supported`` takes), so a transform fused here and the
    same transform applied to ``sdft``'s packed spectra agree.  (The JAX
    package reads them from its XLA path here, api.py:128-139.)

    Returns (new_state, y) with y (M,) or (C, M).
    """
    x = _samples(state, samples)
    if transform is None:
        return lti.roundtrip_block_lti(plan, state, x)
    if kernel_supported(plan, x.shape[-1]):
        st, d = forward_block(plan, state, x)
    else:
        st, d = _per_channel(lambda s, xc: sdft_block(plan, s, xc), state, x)
    z = transform(unpack(d))
    if tuple(z.shape) != tuple(d.shape[:-1]):
        raise ValueError(
            f"transform must preserve the spectra shape {tuple(d.shape[:-1])}, "
            f"returned {tuple(z.shape)}")
    return st, isdft_block(plan, pack(z))


def roundtrip_hopped(plan: Plan, state: State, blocks, hop: int,
                     refresh_every: int | None = 1, k_tile: int | None = None):
    """Chained driver-protocol segment (test/test.c:69-83): the first
    spectrum of every hop and the synthesized samples of a stack of blocks.

    Args:
      plan: the plan.
      state: carry (unbatched for (nb, B) blocks, batched for (nb, C, B)).
      blocks: (nb, B) or (nb, C, B), B a multiple of ``hop``.
      hop: hop size in samples.
      refresh_every: accumulator refresh cadence in blocks (None: off).
      k_tile: for hop < 8, the multi-hop tile target (default 8: tiles of
        ceil(k_tile/hop) hops); ignored for hop >= 8.

    Returns (new_state, hop_dfts, ys): hop_dfts packed (nb, B//hop, m, 2)
    [(nb, C, B//hop, m, 2)], ys (nb, B) [(nb, C, B)].  hop = 1 with a
    plan the kernels take runs one K2 launch per block, for all channels.
    """
    xs = _samples(state, blocks, ndims=(2, 3))
    return lti.roundtrip_hopped_chain(plan, state, xs, hop, k_tile, refresh_every)


def sdft_hopped(plan: Plan, state: State, samples, hop: int):
    """Forward analysis emitting one spectrum per ``hop`` samples (at
    samples 0, hop, 2*hop, ... of the block); the carry advances over every
    sample, so it interleaves with ``sdft`` and ``roundtrip`` on a stream.

    Returns (new_state, dfts) with dfts packed (ceil(M/hop), m, 2) or
    (C, ceil(M/hop), m, 2).
    """
    return lti.sdft_hopped(plan, state, _samples(state, samples), hop)


def sdft_interleaved(plan: Plan, state: State, frames, layout: str = "packed",
                     spectra_dtype: str | None = None):
    """Forward analysis of interleaved multi-channel audio: ``frames`` is
    (M, C), one C-channel frame per time step (the layout of the
    reference's ``sdft_sdft_nd``, c/src/sdft/sdft.h:615-633).  Spectra come
    back channel-major, (C, M, m, 2), as from ``sdft`` on the (C, M) batch."""
    x = torch.as_tensor(frames, device=state.offset.device)
    if x.ndim != 2:
        raise ValueError(f"frames must be (M, C) interleaved, got {tuple(x.shape)}")
    return sdft(plan, state, x.T, layout=layout, spectra_dtype=spectra_dtype)


def isdft_interleaved(plan: Plan, dfts) -> torch.Tensor:
    """Inverse synthesis returning interleaved (M, C) frames (the layout of
    ``sdft_isdft_nd``, c/src/sdft/sdft.h:676-694)."""
    y = isdft(plan, dfts)
    if y.ndim != 2:
        raise ValueError("isdft_interleaved needs channel-batched spectra "
                         "(C, M, m, 2)")
    return y.T
