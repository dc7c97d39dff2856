"""Faults planted under a run by the benchmark's own tests
(``tests/test_bench_faults.py``), to see ``correct`` come out false.  A
fault replaces an entry function of the port in this process, so the
timed path runs broken underneath an unchanged harness:

  * ``state_unchanged``: the step returns the state it was given;
  * ``half_batch``: half of the channels' outputs are left out (zeros);
  * ``no_exchange``: a time shard takes no comb history from the shard
    before it, and keeps its own tail as the stream's (the exchange
    between cards left out);
  * ``altered``: one output value is changed where it is produced.

The benchmark's command never plants one."""

from __future__ import annotations

import contextlib

import torch


def _local(t):
    return t.to_local() if hasattr(t, "to_local") else t


def _tensors(x) -> list:
    if isinstance(x, (tuple, list)):
        return [t for y in x for t in _tensors(y)]
    return [_local(x)] if isinstance(x, torch.Tensor) else []


def _wrap(mod, name: str, axis: int, fault: str, state_arg: int = 1):
    """Wrap ``mod.name`` (its state the ``state_arg``-th positional
    argument, its outputs after the state, channels along ``axis``)."""
    f = getattr(mod, name)

    def broken(*args, **kwargs):
        out = f(*args, **kwargs)
        outs = _tensors(out[1:])
        if fault == "state_unchanged":
            return (args[state_arg], *out[1:])
        with torch.no_grad():
            if fault == "half_batch":
                for t in outs:
                    t.narrow(axis, t.shape[axis] // 2, t.shape[axis] - t.shape[axis] // 2).zero_()
            elif fault == "altered":
                outs[0].view(-1)[-1] += 1.0
        return out

    setattr(mod, name, broken)
    return mod, name, f


def _no_exchange():
    from sdft_tpu_torch.parallel import sharded

    def comb_history(delayline, samples, n2, ax):
        return delayline, samples[:, -n2:].contiguous()

    f = sharded._comb_history
    sharded._comb_history = comb_history
    return sharded, "_comb_history", f


@contextlib.contextmanager
def planted(fault: str | None):
    """Run the enclosed code with ``fault`` planted (None: none), and put
    the port's functions back afterwards."""
    if fault is None:
        yield
        return
    import sdft_tpu_torch as T
    from sdft_tpu_torch import parallel
    from sdft_tpu_torch.stream import streamer

    if fault == "no_exchange":
        undo = [_no_exchange()]
    elif fault in ("state_unchanged", "half_batch", "altered"):
        undo = [_wrap(T, "sdft", 0, fault),
                _wrap(parallel, "sharded_sdft_pallas", 0, fault, state_arg=2),
                _wrap(streamer, "_roundtrip", 0, fault),
                _wrap(streamer, "_roundtrip_hopped", 1, fault)]
    else:
        raise ValueError(f"unknown fault {fault!r}")
    try:
        yield
    finally:
        for mod, name, f in undo:
            setattr(mod, name, f)
