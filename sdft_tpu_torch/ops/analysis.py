"""Forward SDFT analysis in its reference block form (counterpart of
``sdft_tpu.ops.analysis``).

The per-sample recursion of the reference (c/src/sdft/sdft.h:562-598)

    delta   = x[t] - x[t-2m]
    acc[i] += T_i^(t mod 2m) * delta
    aux[i]  = acc[i] * conj(T_i^((t+1) mod 2m))
    dft     = window_convolve(hermitian_pad(aux))

becomes, for a block of M samples, one outer product, one prefix sum along
time and one elementwise demodulation, all with exact integer-exponent
phases.  This is the path for plans the kernels do not take (float64
plans, m < 128) and the plain form the kernels are held against.
"""

from __future__ import annotations

import torch

from ..config import fp32_matmul
from ..cplx import pack, unpack
from ..plan import Plan
from ..state import State
from .convolve import window_convolve
from .twiddle import fiddle_block, roi_mask


def comb(plan: Plan, state: State, samples: torch.Tensor):
    """Comb stage: (delta in TD precision, new delayline) for one channel."""
    M = samples.shape[-1]
    samples = samples.to(plan.precision.td_dtype)
    line = torch.cat([state.delayline.to(samples.dtype), samples])
    return samples - line[:M], line[M:]


def sdft_block(plan: Plan, state: State, samples: torch.Tensor):
    """One block of samples for a single channel.

    Returns (new_state, dfts) with dfts packed (M, m, 2) in FD precision.
    """
    m = plan.dftsize
    (M,) = samples.shape
    delta, new_delayline = comb(plan, state, samples)
    delta = delta.to(plan.precision.fd_dtype)

    fid, conj_base = fiddle_block(plan, state.offset, M)
    rot = delta[:, None].to(plan.precision.fdx_dtype) * fid
    if plan.roi is not None:
        mask = roi_mask(plan, samples.device, plan.precision.fd_dtype)
        rot = rot * mask
    rot[0, :] += unpack(state.accumulator.to(plan.precision.fd_dtype))
    acc = torch.cumsum(rot, dim=0)

    aux = acc * (torch.conj(fid) * conj_base[None, :])
    out = window_convolve(plan, aux)
    if plan.roi is not None:
        out = out * mask
    new_state = State(
        offset=torch.remainder(state.offset + M, 2 * m).to(state.offset.dtype),
        delayline=new_delayline,
        # a copy: a view would keep the whole (M, m) prefix alive
        accumulator=pack(acc[-1, :].clone()).to(state.accumulator.dtype),
    )
    return new_state, pack(out)


def refresh_state(plan: Plan, state: State) -> State:
    """Rebuild the accumulator exactly from the delayline (one channel):
    acc[i] = sum_j delayline[j] * T_i^((offset + j) mod 2m), which discards
    every rounding error the running sum has absorbed."""
    m = plan.dftsize
    fd = plan.precision.fd_dtype
    P, _ = fiddle_block(plan, state.offset, 2 * m)
    d = state.delayline.to(fd)
    with fp32_matmul():
        acc_re = d @ P.real.contiguous()
        acc_im = d @ P.imag.contiguous()
    acc = torch.stack([acc_re, acc_im], dim=-1)
    if plan.roi is not None:
        acc = acc * roi_mask(plan, d.device, fd)[:, None]
    return State(offset=state.offset, delayline=state.delayline,
                 accumulator=acc.to(state.accumulator.dtype))
