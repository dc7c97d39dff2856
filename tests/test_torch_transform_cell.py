"""``api.roundtrip(transform=...)``: every sample's spectrum from K1 (its
plain version on the CPU), the caller's transform, then
``ops.synthesis.isdft_block``, held over three chained blocks to the
benchmark's plain float64 reference (``benchmark/reference.py``: each
spectrum by ``rfft`` of its own 2m samples, the same transform, the direct
synthesis sum), with the carried state after each block; a control that
rounds the spectra to TF32 before synthesis fails the same tolerance; the
route counters and the two spans of the materialized route.  The ``-m
cuda`` test runs the benchmark cell's shape (``m1000-c8.transform``) on
the card, held to the same samples tolerance beside the same control."""

import json
import math

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function

import sdft_tpu_torch as T
from benchmark import checks
from benchmark import reference as R
from benchmark import spec as bench_spec
from sdft_tpu_torch import graphs, tracing
from sdft_tpu_torch.kernels import carry, spectra

F32 = T.Precision("float32", "float32")
BLOCKS = 3

#: samples: max |y - reference| over max |reference|.  float32 spectra
#: from a carried running sum over three blocks, summed over m bins, read
#: at most 2.3e-6 of scale in every case below; spectra rounded to TF32
#: (10 mantissa bits, 2^-11 relative) before the same synthesis read 6.1e-5
#: of scale or more.  At the benchmark cell's 8 x 44100 on an H100 the
#: three blocks read 2.9e-6 to 5.5e-6, their TF32 control 3.2e-4 to
#: 3.5e-4.  The limit sits between with room on both sides.
SAMPLES_TOL = 1.5e-5
#: accumulator: max |acc - reference| over max |reference|; the float32
#: carry read at most 1.5e-6 here (the benchmark's exact cells allow 1e-5
#: and more after thousands of blocks).
ACC_TOL = 1e-5


def identity(z):
    return z


def lowpass(z):
    """A brickwall low-pass: the bins at or above m/4 zeroed."""
    m = z.shape[-1]
    return z * (torch.arange(m, device=z.device) < m // 4).to(z.real.dtype)


def gain(z):
    """A per-bin complex gain, magnitudes in [0.5, 1.5), seeded phases."""
    m = z.shape[-1]
    g = torch.Generator().manual_seed(m)
    r = 0.5 + torch.rand(m, generator=g, dtype=torch.float64)
    phase = 2 * math.pi * torch.rand(m, generator=g, dtype=torch.float64)
    return z * torch.polar(r, phase).to(device=z.device, dtype=z.dtype)


TRANSFORMS = {"identity": identity, "lowpass": lowpass, "gain": gain}


def tf32_spectra(transform):
    """The control: the transform's spectra rounded to TF32."""
    def f(z):
        z = transform(z)
        return torch.complex(R.tf32(z.real.contiguous()), R.tf32(z.imag.contiguous()))
    return f


def _blocks(C, M, m):
    rng = np.random.default_rng(C * M + m)
    return torch.as_tensor(rng.uniform(-1, 1, (BLOCKS, C, M)).astype(np.float32))


def _errors(C, M, m, window, latency, name, control=False) -> list:
    """Per block: (samples error over scale, accumulator error over scale,
    delayline error, offset error) against the reference."""
    plan = T.Plan(m, window=window, latency=latency, precision=F32)
    ref = R.Spec(m, window, latency)
    transform = TRANSFORMS[name]
    xs = _blocks(C, M, m)
    st = T.init_state(plan, channels=C, device="cpu")
    hist = torch.zeros(C, 2 * m, dtype=torch.float64)
    out = []
    for b in range(BLOCKS):
        st, y = T.roundtrip(plan, st, xs[b],
                            transform=tf32_spectra(transform) if control else transform)
        assert y.shape == (C, M) and y.dtype == torch.float32
        xext = torch.cat([hist, xs[b].double()], dim=1)
        want = R.synthesis(ref, transform(R.spectra(ref, xext, torch.arange(M))))
        hist = xext[:, -2 * m:]
        after = ((b + 1) * M) % (2 * m)
        acc = R.accumulator(ref, hist, after)
        got = torch.view_as_complex(st.accumulator.float().contiguous()).to(acc.dtype)
        out.append((float((y.double() - want).abs().max() / want.abs().max()),
                    float((got - acc).abs().max() / acc.abs().max()),
                    float((st.delayline.double() - hist).abs().max()),
                    int((st.offset - after).abs().max())))
    return out


SHAPES = [(2, 512, 128), (3, 2048, 128), (2, 1024, 1000)]


@pytest.mark.parametrize("name", list(TRANSFORMS))
@pytest.mark.parametrize("latency", [1.0, 0.5])
@pytest.mark.parametrize("window", ["hann", "blackman"])
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_roundtrip_transform_matches_the_reference(shape, window, latency, name):
    """Three chained blocks: each block's samples and the state after it."""
    for ys, acc, line, offset in _errors(*shape, window, latency, name):
        assert ys <= SAMPLES_TOL and acc <= ACC_TOL
        assert line == 0.0 and offset == 0


@pytest.mark.parametrize("latency", [1.0, 0.5])
@pytest.mark.parametrize("name", list(TRANSFORMS))
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_tf32_spectra_fail_the_samples_tolerance(shape, name, latency):
    """The control: spectra rounded to TF32 before synthesis put more than
    SAMPLES_TOL into the samples of every block, so the tolerance tells the
    float32 path from the next precision below it."""
    for ys, *_ in _errors(*shape, "hann", latency, name, control=True):
        assert ys > SAMPLES_TOL


def _counts() -> dict:
    c = tracing.counters()
    return {k: c[k] for k in ("ops.synthesis.blocks", "api.roundtrip.collapsed",
                              "api.roundtrip.materialized")}


def _delta(before: dict) -> tuple:
    now = _counts()
    return tuple(now[k] - before[k] for k in before)


def test_route_counters_count_each_call():
    """A transform materializes the spectra and synthesizes once a call; no
    transform takes the collapsed route and synthesizes nothing."""
    plan = T.Plan(128, window="hann", precision=F32)
    st = T.init_state(plan, channels=2, device="cpu")
    xs = _blocks(2, 512, 128)
    before = _counts()
    for x in xs:
        st, _ = T.roundtrip(plan, st, x, transform=identity)
    assert _delta(before) == (BLOCKS, 0, BLOCKS)
    before = _counts()
    for x in xs[:2]:
        st, _ = T.roundtrip(plan, st, x)
    assert _delta(before) == (0, 2, 0)
    before = _counts()
    T.isdft(plan, T.sdft(plan, st, xs[0])[1])
    assert _delta(before) == (1, 0, 0)


def _spans(path) -> list:
    events = json.loads(open(path).read())["traceEvents"]
    return sorted(((e["name"], float(e["ts"]), float(e["ts"]) + float(e["dur"]))
                   for e in events if e.get("ph") == "X"
                   and e["name"].startswith(("sdft.", "test."))), key=lambda s: s[1])


def _inside(inner, outer) -> bool:
    return outer[1] <= inner[1] and inner[2] <= outer[2]


def test_transform_and_synthesis_spans(tmp_path):
    """Under a profiler the caller's transform lies in
    ``sdft.api.roundtrip.transform`` and the synthesis in
    ``sdft.ops.synthesis.isdft``, once each, in that order, inside the
    call's ``sdft.api.roundtrip``; the collapsed route enters neither."""
    plan = T.Plan(128, window="hann", precision=F32)
    st = T.init_state(plan, channels=2, device="cpu")
    x = _blocks(2, 512, 128)[0]

    def marked(z):
        with record_function("test.transform"):
            return z * 2

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        T.roundtrip(plan, st, x, transform=marked)
        T.roundtrip(plan, st, x)
    path = str(tmp_path / "trace.json")
    prof.export_chrome_trace(path)
    spans = _spans(path)
    api = [s for s in spans if s[0] == "sdft.api.roundtrip"]
    (tf,) = [s for s in spans if s[0] == "sdft.api.roundtrip.transform"]
    (syn,) = [s for s in spans if s[0] == "sdft.ops.synthesis.isdft"]
    (user,) = [s for s in spans if s[0] == "test.transform"]
    assert len(api) == 2
    assert _inside(tf, api[0]) and _inside(syn, api[0]) and _inside(user, tf)
    assert tf[2] <= syn[1]


def test_new_spans_enter_nothing_without_a_profiler(monkeypatch):
    """No profiler records: neither span enters a record function
    (monkeypatched to raise), and the counters still count."""
    def refuse(name):
        raise AssertionError(f"record function entered for {name}")

    monkeypatch.setattr(tracing, "_Record", refuse)
    plan = T.Plan(128, window="hann", precision=F32)
    st = T.init_state(plan, channels=2, device="cpu")
    before = _counts()
    T.roundtrip(plan, st, _blocks(2, 512, 128)[0], transform=gain)
    assert _delta(before) == (1, 0, 1)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run: python -m pytest "
                    "tests/test_torch_transform_cell.py -m cuda on the card)")
    graphs.clear()
    yield torch.device("cuda", 0)
    graphs.clear()
    torch.cuda.empty_cache()


@pytest.mark.cuda
def test_cuda_transform_cell_shape(cuda_device):
    """``m1000-c8.transform``'s block on the card, 8 x 44100 at m = 1000
    through its entry's identity transform: once the prologue's graph is
    captured, one K1 launch (packed, never paced), one carry launch and
    one synthesis a block.  Each block's samples are held, in chunks, to
    SAMPLES_TOL of the reference's scale, and the state after it to the
    cell's own limits (``benchmark/limits/m1000-c8.transform.json``, whose
    5e-3 absolute on the samples leaves room for thousands of blocks of the
    carry's drift, and so would not see a synthesis in lower precision).
    The control runs the same blocks with the spectra rounded to TF32
    before synthesis, as a TF32 product reads them, and fails SAMPLES_TOL
    in every block."""
    from benchmark.entries.roundtrip import TRANSFORMS as CELL_TRANSFORMS
    from benchmark.harness import make_plan, ref_spec

    cell = bench_spec.cell("m1000-c8.transform")
    C, M = int(cell.config["channels"]), int(cell.traffic["samples_per_card"])
    plan, ref = make_plan(cell.config), ref_spec(cell.config)
    assert not spectra.paced(plan.dftsize, "packed", "float32")
    transform = CELL_TRANSFORMS[cell.traffic["transform"]]
    control = tf32_spectra(transform)
    g = torch.Generator(device=cuda_device).manual_seed(2**31 + 27)
    xs = torch.rand((BLOCKS, C, M), generator=g, device=cuda_device) * 2 - 1
    st = st_c = T.init_state(plan, channels=C, device=cuda_device)
    T.roundtrip(plan, st, xs[0], transform=transform)       # captures the prologue's graph
    hist = torch.zeros(C, ref.n2, dtype=torch.float64, device=cuda_device)
    for b in range(BLOCKS):
        k1, paced, front = spectra.LAUNCHES, spectra.PACED_LAUNCHES, carry.LAUNCHES
        before = _counts()
        st, y = T.roundtrip(plan, st, xs[b], transform=transform)
        torch.cuda.synchronize(cuda_device)
        assert (spectra.LAUNCHES - k1, spectra.PACED_LAUNCHES - paced,
                carry.LAUNCHES - front) == (1, 0, 1)
        assert _delta(before) == (1, 0, 1)
        st_c, y_c = T.roundtrip(plan, st_c, xs[b], transform=control)
        xext = torch.cat([hist, xs[b].double()], dim=1)
        err = err_c = scale = 0.0
        for pos in R.chunks(ref, C, torch.arange(M, device=cuda_device)):
            want = R.synthesis(ref, transform(R.spectra(ref, xext, pos)))
            err = max(err, float((y[:, pos].double() - want).abs().max()))
            err_c = max(err_c, float((y_c[:, pos].double() - want).abs().max()))
            scale = max(scale, float(want.abs().max()))
            del want
        print(f"block {b}: samples {err / scale:.3e} of scale ({err:.3e} absolute), "
              f"TF32 control {err_c / scale:.3e}")
        assert err / scale <= SAMPLES_TOL < err_c / scale
        after = ((b + 1) * M) % ref.n2
        numbers = checks.compare(ref, xext, {"state": (
            st.offset, st.delayline,
            torch.view_as_complex(st.accumulator.float().contiguous()))}, after)
        numbers["samples_err"] = err
        correct, rows = checks.verdict(numbers, cell.limits)
        assert correct, rows
        hist = xext[:, -ref.n2:]
