"""``api.roundtrip_hopped`` at hop = 1, the reference driver's protocol on
every sample (one spectrum and one synthesized sample per input sample),
against the benchmark's plain reference (``benchmark/reference.py``:
each spectrum by a float64 ``rfft`` of its own 2m samples, plain torch
that imports neither JAX nor the port).  On the CPU the chain runs K2's
plain version; a plan the kernels refuse runs the driver body.  Each case
checks every hop spectrum, every sample and the state carried out of two
chained calls, and the counters of the route the blocks took.

Tolerances, against float64 over 24-bit input: the spectra within 1e-5 of
their scale and the accumulator within 1e-5 of its scale, the samples
within 2e-5 absolute.  The program's float32 pipeline reads at most
1.04e-6, 1.35e-6 and 2.0e-6 over this grid; the reference computed in the
precision below the configuration's (``reference.Control``: TF32 products,
float32 sums, carried or rebuilt as the program carries it) reads at
least 5.8e-4, 2.2e-4 and 3.9e-4 at these sizes, which
``test_control_fails_the_tolerances`` holds with ten times room.  The
delayline and the offset are exact."""

import importlib.util
import itertools
import os
import sys

import pytest
import torch

import sdft_tpu_torch as T
from sdft_tpu_torch.ops import lti

HERE = os.path.dirname(os.path.abspath(__file__))


def _load(name, path):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod         # its dataclasses look their module up
    spec.loader.exec_module(mod)
    return mod


R = _load("bench_reference", os.path.join(HERE, "..", "benchmark", "reference.py"))

F32 = T.Precision("float32", "float32")
#: samples of each block
B = 512
#: spectra and accumulator (of their scale), samples (absolute)
SPECTRA_TOL, ACC_TOL, SAMPLES_TOL = 1e-5, 1e-5, 2e-5


def _stream(seed: int, nb: int, C: int, M: int, device="cpu") -> torch.Tensor:
    """(nb, C, M) float32 24-bit samples k / 2^23, k uniform in [-2^23, 2^23)."""
    g = torch.Generator(device=device).manual_seed(seed)
    k = torch.randint(-(1 << 23), 1 << 23, (nb, C, M), generator=g, dtype=torch.int32,
                      device=device)
    return k.to(torch.float32) / float(1 << 23)


def _chain(plan, x, chain, refresh_every, device="cpu"):
    """Two chained ``roundtrip_hopped`` calls of ``chain`` blocks each over
    x (nb, C, M) from rest; a single channel as unbatched (nb, M) blocks.
    Returns (state, hop spectra (nb, C, M, m, 2), samples (nb, C, M))."""
    C = x.shape[1]
    batched = C > 1
    st = T.init_state(plan, channels=C if batched else None, device=device)
    hds, ys = [], []
    for c in range(x.shape[0] // chain):
        xs = x[c * chain:(c + 1) * chain]
        st, hd, y = T.roundtrip_hopped(plan, st, xs if batched else xs[:, 0], 1,
                                       refresh_every=refresh_every)
        hds.append(hd if batched else hd[:, None])
        ys.append(y if batched else y[:, None])
    return st, torch.cat(hds), torch.cat(ys)


def _errors(spec, x, st, hd, ys) -> dict:
    """The largest errors of the outputs and the state against the float64
    reference, the spectra and accumulator over their scale."""
    nb, C, M = x.shape
    n2 = spec.n2
    flat = torch.cat([x.new_zeros(C, n2, dtype=torch.float64),
                      x.permute(1, 0, 2).reshape(C, nb * M).double()], dim=1)
    err = scale = yerr = 0.0
    for b in range(nb):
        xext = flat[:, b * M:b * M + n2 + M]
        for pos in R.chunks(spec, C, torch.arange(M, device=x.device)):
            want = R.spectra(spec, xext, pos)
            got = torch.complex(hd[b, :, pos, :, 0].double(), hd[b, :, pos, :, 1].double())
            err = max(err, float((got - want).abs().max()))
            scale = max(scale, float(want.abs().max()))
            yerr = max(yerr, float((ys[b, :, pos].double() - R.synthesis(spec, want))
                                   .abs().max()))
    tail = flat[:, -n2:]
    acc = R.accumulator(spec, tail, nb * M)
    got_acc = torch.view_as_complex(st.accumulator.float().reshape(C, spec.m, 2)
                                    .contiguous()).to(acc.dtype)
    return {"spectra": err / scale, "samples": yerr,
            "acc": float((got_acc - acc).abs().max() / acc.abs().max()),
            "delayline": float((st.delayline.reshape(C, n2).double() - tail).abs().max()),
            "offset": float((st.offset.reshape(C).to(torch.int64) - nb * M % n2)
                            .abs().max())}


def _check(e: dict):
    assert e["spectra"] <= SPECTRA_TOL, e
    assert e["samples"] <= SAMPLES_TOL, e
    assert e["acc"] <= ACC_TOL, e
    assert e["delayline"] == 0.0 and e["offset"] == 0.0, e


GRID = list(itertools.product((128, 1000), ("hann", "blackman"), (1, 2), (1, 4), (1, None)))


@pytest.mark.parametrize("m,window,C,chain,refresh_every", GRID)
def test_hop1_chain_against_the_float64_reference(m, window, C, chain, refresh_every):
    plan = T.Plan(m, window=window, precision=F32)
    x = _stream(1000 * m + 10 * C + chain, 2 * chain, C, B)
    k2, body = lti.K2_BLOCKS, lti.BODY_BLOCKS
    st, hd, ys = _chain(plan, x, chain, refresh_every)
    assert (lti.K2_BLOCKS - k2, lti.BODY_BLOCKS - body) == (2 * chain, 0)
    _check(_errors(R.Spec(m, window, 1.0), x, st, hd, ys))


def test_a_plan_the_kernels_refuse_runs_the_driver_body():
    """m = 64 is below the kernels' range: the chain takes the driver body,
    counted as such, with the same outputs up to the same tolerances."""
    plan = T.Plan(64, window="hann", precision=F32)
    assert not T.kernel_supported(plan, B)
    x = _stream(64, 4, 2, B)
    k2, body = lti.K2_BLOCKS, lti.BODY_BLOCKS
    st, hd, ys = _chain(plan, x, 2, 1)
    assert (lti.K2_BLOCKS - k2, lti.BODY_BLOCKS - body) == (0, 4)
    _check(_errors(R.Spec(64, "hann", 1.0), x, st, hd, ys))


@pytest.mark.parametrize("refresh_every", [1, None])
def test_control_fails_the_tolerances(refresh_every):
    """The reference in TF32 products, standing where the program stands
    (the last block of the same two chains of 4, its accumulator carried
    or rebuilt as the program's), fails every tolerance above."""
    m, C, chain = 1000, 2, 4
    x = _stream(1000 * m + 10 * C + chain, 2 * chain, C, B)
    spec = R.Spec(m, "hann", 1.0)
    b = 2 * chain - 1
    ctl = R.Control(spec, lambda k: x[k], B, b, refresh_every)
    flat = torch.cat([x.new_zeros(C, spec.n2, dtype=torch.float64),
                      x.permute(1, 0, 2).reshape(C, -1).double()], dim=1)
    xext = flat[:, b * B:b * B + spec.n2 + B]
    pos = torch.arange(B)
    want = R.spectra(spec, xext, pos)
    got = ctl.spectra(pos)
    assert float((got - want).abs().max() / want.abs().max()) > 10 * SPECTRA_TOL
    assert float((ctl.samples(pos) - R.synthesis(spec, want)).abs().max()) > 10 * SAMPLES_TOL
    acc = R.accumulator(spec, flat[:, -spec.n2:], (b + 1) * B)
    _, _, ctl_acc = ctl.state()
    assert float((ctl_acc.to(acc.dtype) - acc).abs().max() / acc.abs().max()) > 10 * ACC_TOL


@pytest.mark.cuda
def test_hop1_chain_on_the_card_at_the_cells_widths():
    """The benchmark cell's shape on the card: 8 x 44100 blocks, m = 1000,
    Hann, refresh after every block, chains of 2: one prologue replay and
    one K2 launch a block, every spectrum and sample against the float64
    reference, and a second run from the same state equal bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run: python -m pytest "
                    "tests/test_torch_hop1_chain.py -m cuda on the card)")
    from sdft_tpu_torch.kernels import scan

    dev = torch.device("cuda", 0)
    plan = T.Plan(1000, window="hann", precision=F32)
    x = _stream(2**31 + 77, 2, 8, 44100, dev)
    st0 = T.init_state(plan, channels=8, device=dev)
    k2, launches = lti.K2_BLOCKS, scan.LAUNCHES
    st, hd, ys = T.roundtrip_hopped(plan, st0, x, 1, refresh_every=1)
    assert (lti.K2_BLOCKS - k2, scan.LAUNCHES - launches) == (2, 2)
    e = _errors(R.Spec(1000, "hann", 1.0), x, st, hd, ys)
    print("hop=1 chain on the card, 8 x 44100, errors against float64:", e)
    _check(e)
    st2, hd2, ys2 = T.roundtrip_hopped(plan, st0, x, 1, refresh_every=1)
    torch.cuda.synchronize()
    assert torch.equal(hd, hd2) and torch.equal(ys, ys2)
    assert all(torch.equal(a, b) for a, b in zip(st, st2))
