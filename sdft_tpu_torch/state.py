"""The carry state of a sliding DFT stream (counterpart of
``sdft_tpu.state``).

  * ``offset``      — samples processed so far, reduced mod 2m, int32
  * ``delayline``   — last 2m input samples, TD dtype
  * ``accumulator`` — per-bin running sum of rotated deltas, packed complex
    (..., m, 2) in the FD real dtype

A batched state carries a leading channel axis on every field.  The
checkpoint helpers use the JAX package's ``.npz`` keys, so a state written
by either package continues the stream in the other.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .plan import Plan


class State(NamedTuple):
    """Carry state for one SDFT stream (or a channel batch of them)."""

    offset: torch.Tensor       # () or (C,) int32, in [0, 2m)
    delayline: torch.Tensor    # (..., 2m) td dtype — oldest first
    accumulator: torch.Tensor  # (..., m, 2) fd real — packed complex


def require_device(device: torch.device | str) -> torch.device:
    """``torch.device(device)``; raises when that is a CUDA device and there
    is no card (nothing falls back to the CPU)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"no CUDA device for {dev}: pass device='cpu' "
                           "(the CLI: --device cpu) to run on the CPU")
    return dev


def init_state(plan: Plan, channels: int | None = None,
               device: torch.device | str = "cuda:0") -> State:
    """Time-zero state on ``device`` (the card unless the caller asks for
    the CPU; raises without one); with ``channels``, a batched state."""
    device = require_device(device)
    m = plan.dftsize
    shape = () if channels is None else (channels,)
    return State(
        offset=torch.zeros(shape, dtype=torch.int32, device=device),
        delayline=torch.zeros(shape + (2 * m,), dtype=plan.precision.td_dtype,
                              device=device),
        accumulator=torch.zeros(shape + (m, 2), dtype=plan.precision.fd_dtype,
                                device=device),
    )


def reset_state(plan: Plan, state: State) -> State:
    """Time-zero state with the shape, dtypes and device of ``state``."""
    return State(*(torch.zeros_like(a) for a in state))


def state_to_arrays(state: State) -> dict[str, np.ndarray]:
    """Host-side snapshot with the JAX package's keys and dtypes."""
    return {
        "offset": state.offset.detach().cpu().numpy().astype(np.int32),
        "delayline": state.delayline.detach().cpu().numpy(),
        "accumulator": state.accumulator.detach().cpu().numpy(),
    }


def state_from_arrays(arrays, device: torch.device | str = "cuda:0") -> State:
    """State from a snapshot (this package's or ``sdft_tpu``'s) on
    ``device`` (the card unless the caller asks for the CPU)."""
    device = require_device(device)
    return State(
        offset=torch.as_tensor(np.array(arrays["offset"], np.int32),
                               device=device),
        delayline=torch.as_tensor(np.array(arrays["delayline"]), device=device),
        accumulator=torch.as_tensor(np.array(arrays["accumulator"]),
                                    device=device),
    )


def batch_state(state: State, c: int) -> State:
    """Channel ``c`` of a batched state."""
    return State(*(a[c] for a in state))


def stack_states(states) -> State:
    """Batched state from a list of per-channel states."""
    return State(*(torch.stack(list(a)) for a in zip(*states)))
