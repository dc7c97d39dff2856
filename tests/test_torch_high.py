"""The port's ``mxu="high"``: the JAX package's three-pass split class,
exact FP32 everywhere else, and no TF32 anywhere.

A "high" float32 plan splits each operand of the contractions where
``sdft_tpu`` reads ``mxu_precision`` (the collapsed round trip, the driver
at hop > 1, ``sdft_hopped``, the same in each sharded rank) into masked
bf16 halves and sums hh, hl and lh in float32 as (hh + hl) + lh
(``kernels.split_mm``, whose plain version runs here on the CPU).  K1's
prologue, K2's y, the refresh and ``isdft`` stay exact FP32, as
``sdft_tpu`` pins HIGHEST there.

Gates:
  * no float32 matmul of any public entry point on a "high" plan runs
    with ``torch.backends.cuda.matmul.allow_tf32`` on (a dispatch mode
    reads the flag at every mm, addmm, bmm, mv and dot), whatever the
    caller set;
  * the plain three-pass product: its halves bit for bit
    ``sdft_tpu.ops.lti._split_mask``'s; at K = 1 (no sum along K) bit for
    bit (hh + hl) + lh of JAX's halves in float32; at larger K within 1e-6
    of scale of the same three products formed by JAX from its own halves
    (float32 summation order only);
  * the pipeline at m = 128 and 256 against float64 at the class's gates
    on the card (hop spectra 2e-6 abs, samples 1e-4 abs), and unequal to
    the exact plan's result.  Against ``sdft_tpu``'s "high" plan the same
    gates hold, not a tighter one: XLA's CPU backend ignores HIGH, so that
    side is exact FP32 and differs from the port by the class itself (at
    the card's driver cell, m = 1000, hop = 100, 2 x 16000, by 1.3e-5 of
    the spectra's scale and 2.2e-5 of the samples', which
    test_high_class_against_exact_fp32_at_the_driver_cell prints);
  * float64 and float32x2 plans ignore "high": bit for bit "highest".
The sharded "high" programs are held to the unsharded "high" calls in
tests/test_torch_sharded.py (the Gloo ranks it already spawns).  The
``-m cuda`` tests hold the kernel to its plain version and "high" to
"highest" bit for bit where ``sdft_tpu`` is exact; they skip without a
card.
"""

import importlib.util
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

import sdft_tpu as J
import sdft_tpu_torch as T
from sdft_tpu.ops import lti as j_lti
from sdft_tpu_torch import graphs
from sdft_tpu_torch.kernels import split_mm as M
from sdft_tpu_torch.ops import lti

HIGH = J.Precision("float32", "float32", mxu="high")
#: the class's gates against float64 (PERF.md section 2, the "high" row)
SPECTRA_ABS, SAMPLES_ABS = 2e-6, 1e-4


def _signal(n, seed=0):
    return (np.clip(np.random.default_rng(seed).standard_normal(n), -3, 3) / 2).astype(
        np.float32)


def _np(a):
    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def _abs(got, want):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.abs(got.astype(np.float64) - want).max())


def _rel(got, want):
    return _abs(got, want) / max(float(np.abs(_np(want)).max()), 1e-300)


def _plans(m, precision=HIGH, **kw):
    jp = J.Plan(m, window="hann", precision=precision, **kw)
    return jp, T.plan_from_jax(jp)


def _with(tp, **precision):
    return tp.with_(precision=T.Precision(**{"td": tp.precision.td, "fd": tp.precision.fd,
                                             "mxu": tp.precision.mxu, **precision}))


def _f64(tp):
    return _with(tp, td="float64", fd="float64", mxu="highest")


# -- the fault: TF32 under a "high" plan ------------------------------------------------

class _MatmulFlags(TorchDispatchMode):
    """Records ``allow_tf32`` at every matmul dispatched inside it."""

    OPS = {torch.ops.aten.mm.default, torch.ops.aten.addmm.default,
           torch.ops.aten.bmm.default, torch.ops.aten.baddbmm.default,
           torch.ops.aten.mv.default, torch.ops.aten.addmv.default,
           torch.ops.aten.dot.default}

    def __init__(self):
        super().__init__()
        self.seen = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func in self.OPS:
            self.seen.append(torch.backends.cuda.matmul.allow_tf32)
        return func(*args, **(kwargs or {}))


def _lowpass(z):
    return z * (torch.arange(z.shape[-1]) < z.shape[-1] // 4)


ENTRY_POINTS = ["sdft", "sdft_power", "isdft", "refresh", "roundtrip", "roundtrip_transform",
                "roundtrip_hopped_1", "roundtrip_hopped_4", "roundtrip_hopped_100",
                "sdft_hopped", "streamer_run"]


def _entry_points(tp):
    """name -> a call of the public entry point on a "high" plan (m = 128)."""
    cpu = dict(device="cpu")
    x = torch.as_tensor(_signal(1600, seed=3))
    xs = x.reshape(4, 400)
    st = T.init_state(tp, **cpu)
    d = T.sdft(tp, st, x[:400])[1]
    return {
        "sdft": lambda: T.sdft(tp, st, x),
        "sdft_power": lambda: T.sdft_power(tp, st, x),
        "isdft": lambda: T.isdft(tp, d),
        "refresh": lambda: T.refresh(tp, T.sdft(tp, st, x)[0]),
        "roundtrip": lambda: T.roundtrip(tp, st, x),
        "roundtrip_transform": lambda: T.roundtrip(tp, st, x, transform=_lowpass),
        "roundtrip_hopped_1": lambda: T.roundtrip_hopped(tp, st, xs, 1),
        "roundtrip_hopped_4": lambda: T.roundtrip_hopped(tp, st, xs, 4),
        "roundtrip_hopped_100": lambda: T.roundtrip_hopped(tp, st, xs, 100),
        "sdft_hopped": lambda: T.sdft_hopped(tp, st, x, 100),
        "streamer_run": lambda: list(T.Streamer(tp, **cpu).run(list(_np(xs)))),
    }


@pytest.mark.parametrize("caller", [False, True], ids=["caller_off", "caller_on"])
@pytest.mark.parametrize("entry", ENTRY_POINTS)
def test_no_matmul_of_a_high_plan_runs_with_tf32(entry, caller):
    """Every public entry point on a "high" plan: at each float32 matmul
    the TF32 flag is off, whatever the caller left it at, and the caller's
    value is back afterwards."""
    _, tp = _plans(128)
    call = _entry_points(tp)[entry]
    saved = torch.backends.cuda.matmul.allow_tf32
    try:
        torch.backends.cuda.matmul.allow_tf32 = caller
        with _MatmulFlags() as mode:
            call()
        assert torch.backends.cuda.matmul.allow_tf32 is caller
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved
    assert mode.seen, f"{entry} ran no matmul"
    assert not any(mode.seen), f"{entry}: {sum(mode.seen)} of {len(mode.seen)} matmuls with TF32"


# -- the three-pass product ----------------------------------------------------------

def _jax_halves(a):
    """JAX's in-program halves of ``a`` as float32 numpy, read with gradual
    underflow (the inputs below hold no subnormals)."""
    hi, lo = j_lti._split_mask(jnp.asarray(a))
    return np.asarray(hi, np.float32), np.asarray(lo, np.float32)


def test_three_pass_halves_are_jax_split():
    rng = np.random.default_rng(5)
    a = (rng.standard_normal((7, 33)) * 10).astype(np.float32)
    x = M.split_mask(torch.as_tensor(a))
    hi, lo = _jax_halves(a)
    np.testing.assert_array_equal(x.hi.float().numpy(), hi)
    np.testing.assert_array_equal(x.lo.float().numpy(), lo)


def test_three_pass_products_exact_and_summed_hh_hl_then_lh():
    """At K = 1 each output is one product per pass, exact in float32: the
    result is bit for bit (hh + hl) + lh of JAX's halves in float32 (and
    not hh + (hl + lh), which differs on these inputs)."""
    rng = np.random.default_rng(6)
    a = (rng.standard_normal((64, 1)) * 3).astype(np.float32)
    b = rng.standard_normal((1, 96))
    bh, bl = (np.asarray(h, np.float32) for h in j_lti._bf16_split_host(b))
    ah, al = _jax_halves(a)
    got = M.split_mm_reference(torch.as_tensor(a), lti._split_host(b, "cpu"), 3).numpy()
    hh, hl, lh = ah * bh, ah * bl, al * bh        # float32, each exact
    for p, (u, v) in zip((hh, hl, lh), ((ah, bh), (ah, bl), (al, bh))):
        np.testing.assert_array_equal(p.astype(np.float64), u.astype(np.float64) * v)
    np.testing.assert_array_equal(got, (hh + hl) + lh)
    assert not np.array_equal(got, hh + (hl + lh))


@pytest.mark.parametrize("shape", [(64, 256, 96), (37, 100, 200), (5, 8, 2000)])
def test_three_pass_matches_jax_formed_products(shape):
    """Against hh, hl and lh formed by JAX from its own halves (float32
    products of bf16 values, summed along K in float32): within 1e-6 of
    scale.  Three passes, not four: the ll product is left out (the four
    product form differs from it), and the class is not exact FP32."""
    rows, K, n = shape
    rng = np.random.default_rng(rows + K)
    a = (rng.standard_normal((rows, K)) * 4).astype(np.float32)
    b = rng.standard_normal((K, n))
    bh, bl = (jnp.asarray(h, jnp.float32) for h in j_lti._bf16_split_host(b))
    ah, al = (jnp.asarray(h) for h in _jax_halves(a))
    want = np.asarray((ah @ bh + ah @ bl) + al @ bh)
    table = lti._split_host(b, "cpu")
    got = M.split_mm(torch.as_tensor(a), table, 3)
    assert got.dtype == torch.float32 and _rel(got, want) <= 1e-6
    four = M.split_mm(torch.as_tensor(a), table, 4)
    assert not torch.equal(got, four)
    exact = a.astype(np.float64) @ b.astype(np.float32)
    assert 1e-7 < _rel(got, exact) <= 1e-4
    # out given: the finished sum added to what it holds
    base = torch.as_tensor(rng.standard_normal((rows, n)).astype(np.float32))
    acc = M.split_mm(torch.as_tensor(a), table, 3, out=base.clone())
    assert torch.equal(acc, base + got)


# -- the pipeline --------------------------------------------------------------------------

def _state(J_or_T, plan, C, **kw):
    return J_or_T.init_state(plan, **kw) if C is None else J_or_T.init_state(
        plan, channels=C, **kw)


def _spectra64(tp, x):
    """Float64 spectra of every sample of the (C, n) or (n,) stream."""
    p64 = _f64(tp)
    rows = x[None] if x.ndim == 1 else x
    d = [T.sdft(p64, T.init_state(p64, device="cpu"), torch.as_tensor(r, dtype=torch.float64))[1]
         for r in rows]
    return d[0] if x.ndim == 1 else torch.stack(d)


@pytest.mark.parametrize("m", [128, 256])
@pytest.mark.parametrize("C", [None, 2])
def test_high_roundtrip_meets_its_class(m, C):
    """The collapsed round trip over two chained blocks: y within 1e-4 of
    float64 and of ``sdft_tpu``'s "high" plan (exact FP32 on the CPU),
    unequal to the port's exact plan; the state's offset and delayline
    exact, its accumulator within 1e-3 of sdft_tpu's."""
    jp, tp = _plans(m)
    B = 8 * m
    x = _signal((C or 1) * 2 * B, seed=m).reshape(C or 1, 2 * B)
    x = x[0] if C is None else x
    d64 = _spectra64(tp, x)
    y64 = T.isdft(_f64(tp), d64)
    ts, js, te = (_state(T, tp, C, device="cpu"), _state(J, jp, C),
                  _state(T, _with(tp, mxu="highest"), C, device="cpu"))
    for b in range(2):
        blk = x[..., b * B:(b + 1) * B]
        ts, ty = T.roundtrip(tp, ts, blk)
        js, jy = J.roundtrip(jp, js, blk)
        te, ye = T.roundtrip(_with(tp, mxu="highest"), te, blk)
        assert _abs(ty, y64[..., b * B:(b + 1) * B]) <= SAMPLES_ABS
        assert _abs(ty, jy) <= SAMPLES_ABS
        assert not torch.equal(ty, ye)
        np.testing.assert_array_equal(_np(ts.offset), _np(js.offset))
        np.testing.assert_array_equal(_np(ts.delayline), _np(js.delayline))
        assert _abs(ts.accumulator, js.accumulator) <= 1e-3


@pytest.mark.parametrize("m", [128, 256])
@pytest.mark.parametrize("hop", [4, 100])
@pytest.mark.parametrize("C", [None, 2])
def test_high_driver_meets_its_class(m, hop, C):
    """``roundtrip_hopped`` (refresh every block): hop spectra within 2e-6
    of float64 and of sdft_tpu's, samples within 1e-4; both unequal to the
    exact plan's (the totals are split too, unlike split4's)."""
    jp, tp = _plans(m)
    nb, B = 3, 400
    x = _signal((C or 1) * nb * B, seed=m + hop).reshape(C or 1, nb * B)
    xs = x.reshape(C or 1, nb, B).transpose(1, 0, 2)
    xs = xs[:, 0] if C is None else xs
    ts, thd, tys = T.roundtrip_hopped(tp, _state(T, tp, C, device="cpu"), xs, hop)
    js, jhd, jys = J.roundtrip_hopped(jp, _state(J, jp, C), xs, hop)
    _, ehd, eys = T.roundtrip_hopped(_with(tp, mxu="highest"),
                                     _state(T, tp, C, device="cpu"), xs, hop)
    d64 = _spectra64(tp, x[0] if C is None else x)
    y64 = T.isdft(_f64(tp), d64)
    hd = thd.reshape(-1, m, 2) if C is None else thd.permute(1, 0, 2, 3, 4).reshape(C, -1, m, 2)
    ys = tys.reshape(-1) if C is None else tys.permute(1, 0, 2).reshape(C, -1)
    assert _abs(hd, d64[..., ::hop, :, :]) <= SPECTRA_ABS
    assert _abs(ys, y64) <= SAMPLES_ABS
    assert _abs(thd, jhd) <= SPECTRA_ABS and _abs(tys, jys) <= SAMPLES_ABS
    assert not torch.equal(thd, ehd) and not torch.equal(tys, eys)
    np.testing.assert_array_equal(_np(ts.offset), _np(js.offset))


@pytest.mark.parametrize("m", [128, 256])
@pytest.mark.parametrize("hop", [4, 100])
def test_high_sdft_hopped_meets_its_class(m, hop):
    jp, tp = _plans(m)
    x = _signal(1200, seed=2 * m + hop)
    _, hd = T.sdft_hopped(tp, T.init_state(tp, device="cpu"), x, hop)
    _, jhd = J.sdft_hopped(jp, J.init_state(jp), x, hop)
    _, ehd = T.sdft_hopped(_with(tp, mxu="highest"), T.init_state(tp, device="cpu"), x, hop)
    assert _abs(hd, _spectra64(tp, x)[::hop]) <= SPECTRA_ABS
    assert _abs(hd, jhd) <= SPECTRA_ABS
    assert not torch.equal(hd, ehd)


def test_high_class_against_exact_fp32_at_the_driver_cell(capsys):
    """The driver at m = 1000, hop = 100 on two blocks of 16000 (the card's
    cell): the "high" hop spectra and samples against the exact plan's,
    both as sdft_tpu's side would read them, printed, and within the
    float64 gates."""
    _, tp = _plans(1000)
    xs = _signal(32000, seed=19).reshape(2, 16000)
    _, hd, ys = T.roundtrip_hopped(tp, T.init_state(tp, device="cpu"), xs, 100)
    _, ehd, eys = T.roundtrip_hopped(_with(tp, mxu="highest"), T.init_state(tp, device="cpu"),
                                     xs, 100)
    with capsys.disabled():
        print(f"\nhigh vs exact FP32, m=1000 hop=100: spectra {_rel(hd, ehd):.2e} of scale, "
              f"samples {_rel(ys, eys):.2e} of scale")
    assert _abs(hd, ehd) <= SPECTRA_ABS and _abs(ys, eys) <= SAMPLES_ABS


@pytest.mark.parametrize("fd", ["float64", "float32x2"])
def test_high_is_ignored_off_float32_plans(fd):
    """As in the JAX package, a float64 or float32x2 plan ignores "high":
    bit for bit the "highest" plan, and no split table is built."""
    _, tp = _plans(96, J.Precision("float32", fd, mxu="high"))
    ex = _with(tp, mxu="highest")
    assert not tp.precision.high and tp.precision.passes == 0
    x = torch.as_tensor(_signal(768, seed=4))
    for call in (lambda p: T.roundtrip(p, T.init_state(p, device="cpu"), x),
                 lambda p: T.roundtrip_hopped(p, T.init_state(p, device="cpu"),
                                              x.reshape(2, 384), 32),
                 lambda p: T.sdft_hopped(p, T.init_state(p, device="cpu"), x, 32)):
        for u, v in zip(graphs.leaves(call(tp)), graphs.leaves(call(ex))):
            assert torch.equal(u, v)


def test_high_tables_are_split_where_jax_reads_mxu_precision():
    """A "high" plan's round-trip, hop and stepped tables are ``Split``
    pairs whose halves are JAX's host split of its tables; a split4 plan's
    hop and stepped tables stay exact (JAX reads split4 as HIGHEST there)."""
    _, tp = _plans(96)
    cpu = torch.device("cpu")
    fine, GLT, PQ = lti._lti_consts_device(tp, 32, torch.float32, cpu)
    assert all(isinstance(t, M.Split) for t in (fine, GLT, PQ))
    j = j_lti._lti_consts_split_device(J.Plan(96, window="hann", precision=J.Precision(
        "float32", "float32", mxu="split4")), 32)
    for half in (0, 1):
        np.testing.assert_array_equal(GLT[half].float().numpy(),
                                      np.asarray(j[4 + half], np.float32))
    sf, _ = lti._stepped_consts_device(tp, 4, 2, torch.float32, cpu)
    assert isinstance(sf, M.Split) and isinstance(lti._hop_consts_device(tp, 32, torch.float32,
                                                                         cpu), M.Split)
    s4 = _with(tp, mxu="split4")
    assert not isinstance(lti._hop_consts_device(s4, 32, torch.float32, cpu), M.Split)
    assert not isinstance(lti._stepped_consts_device(s4, 4, 2, torch.float32, cpu)[0], M.Split)


def test_high_graphs_hold_their_own_key_and_equal_eager():
    """Under the CPU stand-in capture backend: a "high" block replays a
    graph of its own beside the exact plan's, bit for bit its eager run."""
    spec = importlib.util.spec_from_file_location(
        "graph_stub", os.path.join(os.path.dirname(os.path.abspath(__file__)), "helpers",
                                   "graph_stub.py"))
    stub = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(stub)
    _, tp = _plans(96)
    x = torch.as_tensor(_signal(384, seed=14))
    xs = x.reshape(3, 128)
    with stub.installed():
        outs = {}
        for p in (tp, _with(tp, mxu="highest")):
            st = T.init_state(p, device="cpu")
            for name, call in (("rt", lambda: lti.roundtrip_block_lti(p, st, x, 32)),
                               ("drv", lambda: T.roundtrip_hopped(p, st, xs, 4)),
                               ("hop", lambda: T.sdft_hopped(p, st, x, 32))):
                outs[p.precision.mxu, name] = call()
                with graphs.disabled():
                    eager = call()
                for a, b in zip(graphs.leaves(outs[p.precision.mxu, name]),
                                graphs.leaves(eager)):
                    assert torch.equal(a, b)
        names = [e.name for e in graphs.entries()]
        assert names.count("roundtrip_block_lti") == 2 and names.count("sdft_hopped") == 2
    for name in ("rt", "drv", "hop"):
        assert not torch.equal(graphs.leaves(outs["high", name])[-1],
                               graphs.leaves(outs["highest", name])[-1])


# -- on the card -----------------------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run: python -m pytest tests/test_torch_high.py "
                    "-m cuda on the card)")
    graphs.clear()
    yield torch.device("cuda", 0)
    graphs.clear()


@pytest.mark.cuda
@pytest.mark.parametrize("passes", [3, 4])
@pytest.mark.parametrize("shape", [(256, 1024, 8192), (64, 1024, 1024), (64, 8192, 1024),
                                   (160, 100, 2000), (160, 2000, 100), (37, 8, 4000),
                                   (1, 33, 7)])
def test_cuda_split_mm_matches_the_plain_version(cuda_device, shape, passes):
    """The kernel against its plain version on the same inputs: within
    2e-6 of scale (the float32 sums along K in another order); its halves
    bit for bit ``split_mask``'s; ``out`` accumulates after the sum."""
    rows, K, n = shape
    rng = np.random.default_rng(rows + K + n)
    a = torch.as_tensor((rng.standard_normal((rows, K)) * 4).astype(np.float32))
    b = lti._split_host(rng.standard_normal((K, n)), "cpu")
    bc = b.map(lambda h: h.to(cuda_device))
    want = M.split_mm(a, b, passes)
    got = M.split_mm(a.to(cuda_device), bc, passes)
    assert got.dtype == torch.float32 and _rel(got.cpu(), want.numpy()) <= 2e-6
    base = torch.as_tensor(rng.standard_normal((rows, n)).astype(np.float32))
    acc = M.split_mm(a.to(cuda_device), bc, passes, out=base.to(cuda_device))
    assert torch.equal(acc, base.to(cuda_device) + got)
    halves = M.launch_split_mask(a.to(cuda_device))
    ref = M.split_mask(a.to(cuda_device))
    assert torch.equal(halves.hi, ref.hi) and torch.equal(halves.lo, ref.lo)


@pytest.mark.cuda
@pytest.mark.parametrize("entry", ["sdft_packed", "sdft_planar", "sdft_power", "hop1_chain",
                                   "refresh", "isdft"])
def test_cuda_high_is_exact_where_jax_is(cuda_device, entry):
    """Where ``sdft_tpu`` pins HIGHEST (K1's prologue, K2's y, the refresh,
    ``isdft``): a "high" plan's outputs bit for bit the "highest" plan's."""
    _, tp = _plans(1000)
    ex = _with(tp, mxu="highest")
    x = torch.as_tensor(_signal(16000, seed=7), device=cuda_device)
    calls = {
        "sdft_packed": lambda p: T.sdft(p, T.init_state(p, device=cuda_device), x),
        "sdft_planar": lambda p: T.sdft(p, T.init_state(p, device=cuda_device), x,
                                        layout="planar"),
        "sdft_power": lambda p: T.sdft_power(p, T.init_state(p, device=cuda_device), x),
        "hop1_chain": lambda p: T.roundtrip_hopped(p, T.init_state(p, device=cuda_device),
                                                   x.reshape(2, 8000), 1),
        "refresh": lambda p: T.refresh(p, T.sdft(p, T.init_state(p, device=cuda_device), x)[0]),
        "isdft": lambda p: T.isdft(p, T.sdft(ex, T.init_state(ex, device=cuda_device), x)[1]),
    }
    for u, v in zip(graphs.leaves(calls[entry](tp)), graphs.leaves(calls[entry](ex))):
        assert torch.equal(u, v)


@pytest.mark.cuda
@pytest.mark.parametrize("path", ["roundtrip", "driver-hop100", "driver-hop4", "sdft_hopped"])
def test_cuda_high_graphed_equals_eager_and_launches_the_kernel(cuda_device, path):
    big = T.Plan(4096, window="hann", precision=T.Precision("float32", "float32", mxu="high"))
    drv = big.with_(dftsize=1000)
    x = torch.as_tensor(_signal(65536, seed=33), device=cuda_device)
    calls = {
        "roundtrip": lambda p: T.roundtrip(p, T.init_state(p, device=cuda_device), x),
        "driver-hop100": lambda p: T.roundtrip_hopped(
            p, T.init_state(p, device=cuda_device), x[:64000].reshape(4, 16000), 100),
        "driver-hop4": lambda p: T.roundtrip_hopped(
            p, T.init_state(p, device=cuda_device), x[:16000].reshape(4, 4000), 4),
        "sdft_hopped": lambda p: T.sdft_hopped(p, T.init_state(p, device=cuda_device),
                                               x[:16000], 100),
    }
    plan = big if path == "roundtrip" else drv
    got = calls[path](plan)
    M.LAUNCHES = 0
    again = calls[path](plan)
    assert M.LAUNCHES > 0
    with graphs.disabled():
        eager = calls[path](plan)
    exact = calls[path](plan.with_(precision=T.FAST_PRECISION))
    torch.cuda.synchronize()
    for a, b, c in zip(graphs.leaves(got), graphs.leaves(eager), graphs.leaves(again)):
        assert torch.equal(a, b) and torch.equal(c, b)
    assert not torch.equal(graphs.leaves(got)[-1], graphs.leaves(exact)[-1])

