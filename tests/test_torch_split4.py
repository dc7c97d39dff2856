"""The port's ``mxu="split4"`` against the JAX package's (mirrors
tests/test_lti.py:362-399).

A split4 plan splits both GEMM operands into masked bf16 hi + lo halves
and sums the four cross products in float32: in the collapsed round trip
(totals and synthesis) and in the driver's synthesis.  The same seeded
numpy inputs go through ``sdft_tpu`` (CPU, x64) and the port on the CPU,
where ``kernels.split_mm.split_mm`` with four products (the counterpart
of ``_dot4``) runs its plain version.

Gates: the halves bit for bit; ``split_mm`` within 1e-6 of the output's
scale (float32 summation order only); the round trip and the driver's
samples within 2e-6 of scale of JAX's at the same tile (the activations'
split turns an ulp of difference in the carry into a difference of the
split class, about 1e-6 of scale here); against the port's exact plan
within the JAX test's 1e-3 and not equal; the driver's hop spectra and
state equal to the exact plan's bit for bit.  The ``-m cuda`` tests hold
the card's kernel to the plain version and the graphs to eager.
"""

import contextlib
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sdft_tpu as J
import sdft_tpu_torch as T
from sdft_tpu.ops import lti as j_lti
from sdft_tpu_torch import graphs
from sdft_tpu_torch.config import bf16_products
from sdft_tpu_torch.kernels.split_mm import Split, split_mask, split_mm
from sdft_tpu_torch.ops import lti

SPLIT4 = J.Precision("float32", "float32", mxu="split4")
M_BINS = 96
#: JAX's default tile for a 384-sample block (sdft_tpu.ops.lti.default_k_tile)
K_TILE = 32


def _signal(n, seed=0):
    return (np.clip(np.random.default_rng(seed).standard_normal(n), -3, 3) / 2).astype(
        np.float32)


def _np(a):
    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def _rel(got, want):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    return np.abs(got.astype(np.float64) - want).max() / max(np.abs(want).max(), 1e-300)


def _plans(precision=SPLIT4, **kw):
    jp = J.Plan(M_BINS, window="hann", precision=precision, **kw)
    return jp, T.plan_from_jax(jp)


def _exact(tp):
    return tp.with_(precision=T.FAST_PRECISION)


def _bits(a):
    """The bf16 bit patterns of a JAX, ml_dtypes or torch bf16 array."""
    if isinstance(a, torch.Tensor):
        return a.view(torch.int16).numpy()
    return np.asarray(a).view(np.int16)


@contextlib.contextmanager
def _subnormals(flush: bool):
    """This thread's float32 subnormal mode for the block (FTZ and DAZ
    when ``flush``), and the mode put back after it.  A worker that loaded
    the native oracle (-ffast-math) flushes for the rest of the process."""
    before = bool(np.float32(1e-39) * np.float32(1.0) == 0)
    torch.set_flush_denormal(flush)
    try:
        yield
    finally:
        torch.set_flush_denormal(before)


# -- the split --------------------------------------------------------------------

def _pattern(bits):
    return np.asarray(bits, dtype=np.uint32).view(np.float32)


_RNG = np.random.default_rng(41)
SPLIT_CASES = {
    "positive": _RNG.uniform(1e-3, 1e3, 64).astype(np.float32),
    "negative": -_RNG.uniform(1e-3, 1e3, 64).astype(np.float32),
    # low half-words at, just under and just over the rounding boundary,
    # a carry into the exponent, both signs
    "ties": _pattern([0x3F808000, 0x3F807FFF, 0x3F808001, 0x3FFF8000, 0x3FFFFFFF,
                      0xBF808000, 0xBF807FFF, 0xBFFF8000, 0x3F818000, 0x40008000]),
    "near_max": _pattern([0x7F7FFFFF, 0x7F7F8000, 0x7F7F7FFF, 0x7F7E8000, 0xFF7FFFFF,
                          0xFF7F7FFF, 0x7F000000]),
    "subnormal": _pattern([0x00000001, 0x00007FFF, 0x00008000, 0x0000FFFF, 0x007FFFFF,
                           0x007F8000, 0x80008000, 0x807FFFFF, 0x00800000]),
    "zero": _pattern([0x00000000, 0x80000000]),
}


@pytest.mark.parametrize("case", sorted(SPLIT_CASES))
@pytest.mark.parametrize("jax_form", ["program", "host"])
def test_split_mask_equals_jax_bit_for_bit(case, jax_form):
    """``split_mask`` against JAX's in-program ``_split_mask`` and its host
    ``_bf16_split_host``: both halves, every bit.  XLA's CPU runtime
    flushes float32 subnormals (its lo of 0x007FFFFF is -2^-126, the input
    read as zero), so against the program the port runs in the same mode;
    with gradual underflow, the mode of the card's float32 arithmetic, it
    equals the host split."""
    a = SPLIT_CASES[case]
    with _subnormals(jax_form == "program"):
        got = split_mask(torch.as_tensor(a))
    with _subnormals(False), np.errstate(over="ignore", invalid="ignore"):
        if jax_form == "program":
            want = j_lti._split_mask(jnp.asarray(a))
        else:
            want = j_lti._bf16_split_host(a)
    np.testing.assert_array_equal(_bits(got.hi), _bits(want[0]))
    np.testing.assert_array_equal(_bits(got.lo), _bits(want[1]))


def test_split_tables_equal_jax_host_split():
    """The cached device tables: the interleaved fine and PQ tables split
    into the halves of JAX's planar fine_re/fine_im and P^T/Q^T; GLT as
    is."""
    jp, tp = _plans()
    fine, GLT, PQ = lti._lti_consts_split_device(tp, K_TILE, torch.device("cpu"))
    j = j_lti._lti_consts_split_device(jp, K_TILE)
    fre, fim, glt, pt, qt = (j[2 * i:2 * i + 2] for i in range(5))
    def value(a):       # the port's sin table holds -0.0 where JAX's holds +0.0
        return np.asarray(a, np.float32) if not isinstance(a, torch.Tensor) else a.float()

    for half in (0, 1):
        for got, want in ((fine[half][:, 0::2], fre[half]), (fine[half][:, 1::2], fim[half]),
                          (GLT[half], glt[half]), (PQ[half][0::2], pt[half]),
                          (PQ[half][1::2], qt[half])):
            np.testing.assert_array_equal(value(got).numpy(), value(want))


@pytest.mark.parametrize("shape", [(64, 256, 96), (3 * 12, K_TILE, 2 * M_BINS)])
def test_dot4_matches_jax(shape):
    rows, K, n = shape
    rng = np.random.default_rng(rows + K)
    a = (rng.standard_normal((rows, K)) * 8).astype(np.float32)
    b = rng.standard_normal((K, n))
    bh, bl = j_lti._bf16_split_host(b)
    want = np.asarray(j_lti._dot4(jnp.asarray(a), jnp.asarray(bh), jnp.asarray(bl)))
    got = split_mm(torch.as_tensor(a), lti._split_host(b, "cpu"), 4)
    assert got.dtype == torch.float32
    assert _rel(got, want) <= 1e-6
    # the split class: the product of the split operands, not float32's
    exact = a.astype(np.float64) @ b.astype(np.float32)
    assert 1e-7 < _rel(got, exact) <= 1e-4


# -- the collapsed round trip --------------------------------------------------------

def _channels_state(J_or_T, plan, C, **kw):
    return (J_or_T.init_state(plan, **kw) if C == 1
            else J_or_T.init_state(plan, channels=C, **kw))


def _rt_blocks(C, seed=6, B=384, nb=2):
    x = _signal(C * nb * B, seed=seed + C)
    blocks = [x.reshape(C, nb * B)[:, b * B:(b + 1) * B] for b in range(nb)]
    return [b[0] for b in blocks] if C == 1 else blocks


@pytest.mark.parametrize("C", [1, 3])
def test_split4_roundtrip_matches_jax(C):
    """Two chained blocks: y and the state within 2e-6 of scale of JAX's
    split4 ``roundtrip_block_lti`` at the same tile."""
    jp, tp = _plans()
    js, ts = _channels_state(J, jp, C), _channels_state(T, tp, C, device="cpu")
    for blk in _rt_blocks(C):
        js, jy = j_lti.roundtrip_block_lti(jp, js, blk, K_TILE)
        ts, ty = lti.roundtrip_block_lti(tp, ts, torch.as_tensor(blk), K_TILE)
        assert ty.dtype == torch.float32
        assert _rel(ty, jy) <= 2e-6
        assert _rel(ts.accumulator, js.accumulator) <= 2e-6
        np.testing.assert_array_equal(_np(ts.offset), _np(js.offset))
        np.testing.assert_array_equal(_np(ts.delayline), _np(js.delayline))


@pytest.mark.parametrize("C", [1, 3])
def test_split4_roundtrip_differs_from_the_exact_plan_within_its_class(C):
    """Against the port's exact FP32 plan (tests/test_lti.py:362-380's
    1e-3; the accumulator at its 1e-2): close, and not equal, so the mode
    is no longer exact FP32 under another name."""
    _, tp = _plans()
    te = _exact(tp)
    s4, se = _channels_state(T, tp, C, device="cpu"), _channels_state(T, te, C, device="cpu")
    for blk in _rt_blocks(C):
        s4, y4 = T.roundtrip(tp, s4, blk)
        se, ye = T.roundtrip(te, se, blk)
        assert float((y4 - ye).abs().max()) <= 1e-3
        assert float((s4.accumulator - se.accumulator).abs().max()) <= 1e-2
        assert not torch.equal(y4, ye)
        assert not torch.equal(s4.accumulator, se.accumulator)


@pytest.mark.parametrize("C", [1, 3])
def test_split4_state_from_the_port_continues_in_jax(C):
    """A split4 state the port carried out of block 0 continues in the JAX
    package as JAX's own state does."""
    jp, tp = _plans()
    b0, b1 = _rt_blocks(C, seed=9)
    ts, _ = lti.roundtrip_block_lti(tp, _channels_state(T, tp, C, device="cpu"),
                                    torch.as_tensor(b0), K_TILE)
    js, _ = j_lti.roundtrip_block_lti(jp, _channels_state(J, jp, C), b0, K_TILE)
    _, want = j_lti.roundtrip_block_lti(jp, js, b1, K_TILE)
    _, got = j_lti.roundtrip_block_lti(jp, J.state_from_arrays(T.state_to_arrays(ts)),
                                       b1, K_TILE)
    assert _rel(got, want) <= 2e-6


def test_split4_property_and_flag():
    """split4 holds for mxu="split4" on float32 FD plans only (float64 and
    float32x2 ignore the mode, as in the JAX package); ``bf16_products``
    clears the reduced-precision flag and restores the caller's value."""
    assert T.Precision("float32", "float32", mxu="split4").split4
    assert not T.Precision("float32", "float64", mxu="split4").split4
    assert not T.Precision("float32", "float32x2", mxu="split4").split4
    assert not T.FAST_PRECISION.split4
    assert not T.Precision("float32", "float32", mxu="high").split4
    flag = torch.backends.cuda.matmul
    saved = flag.allow_bf16_reduced_precision_reduction
    try:
        for before in (True, False):
            flag.allow_bf16_reduced_precision_reduction = before
            with bf16_products():
                assert flag.allow_bf16_reduced_precision_reduction is False
            assert flag.allow_bf16_reduced_precision_reduction is before
    finally:
        flag.allow_bf16_reduced_precision_reduction = saved


def test_float64_split4_plan_equals_the_exact_plan():
    """A float64 plan ignores split4: bit for bit the "highest" plan."""
    p4 = T.Plan(M_BINS, precision=T.Precision("float64", "float64", mxu="split4"))
    ph = T.Plan(M_BINS, precision=T.Precision("float64", "float64"))
    x = torch.as_tensor(_signal(384, seed=5).astype(np.float64))
    s4, y4 = T.roundtrip(p4, T.init_state(p4, device="cpu"), x)
    sh, yh = T.roundtrip(ph, T.init_state(ph, device="cpu"), x)
    assert torch.equal(y4, yh) and torch.equal(s4.accumulator, sh.accumulator)


# -- the driver: the synthesis split, the totals, carry and spectra exact -------------

DRIVER_HOPS = [32, 4]    # one hop per tile; stepped tiles of two hops


def _driver_blocks(hop, C=None, nb=3, B=128):
    x = _signal(nb * B * (C or 1), seed=8 + hop)
    return x.reshape(nb, B) if C is None else x.reshape(nb, C, B)


@pytest.mark.parametrize("hop", DRIVER_HOPS)
def test_split4_driver_spectra_and_state_equal_the_exact_plan(hop):
    """tests/test_lti.py:383-399's contract: the hop spectra (and with them
    the totals, the carry and the state) bit for bit an exact plan's; the
    samples within 1e-3 of it and not equal."""
    _, tp = _plans()
    te = _exact(tp)
    xs = torch.as_tensor(_driver_blocks(hop))
    s4, hd4, y4 = T.roundtrip_hopped(tp, T.init_state(tp, device="cpu"), xs, hop)
    se, hde, ye = T.roundtrip_hopped(te, T.init_state(te, device="cpu"), xs, hop)
    assert torch.equal(hd4, hde)
    for a, b in zip(s4, se):
        assert torch.equal(a, b)
    assert float((y4 - ye).abs().max()) <= 1e-3 and not torch.equal(y4, ye)


@pytest.mark.parametrize("C", [None, 2])
@pytest.mark.parametrize("hop", DRIVER_HOPS)
def test_split4_driver_matches_jax(hop, C):
    """``roundtrip_hopped`` of a split4 plan against JAX's: samples within
    2e-6 of scale, hop spectra at the driver's 2e-7 (tests/test_tpu.py:274)."""
    jp, tp = _plans()
    xs = _driver_blocks(hop, C)
    js, jhd, jys = J.roundtrip_hopped(jp, _channels_state(J, jp, C or 1), xs, hop)
    ts, thd, tys = T.roundtrip_hopped(tp, _channels_state(T, tp, C or 1, device="cpu"),
                                      xs, hop)
    assert _rel(tys, jys) <= 2e-6
    assert float(np.abs(_np(thd) - _np(jhd)).max()) <= 2e-7
    np.testing.assert_array_equal(_np(ts.offset), _np(js.offset))


def test_split4_driver_block_matches_the_chain():
    """``roundtrip_hopped_block`` takes the same split synthesis as the
    chain: one block, bit for bit."""
    _, tp = _plans()
    x = torch.as_tensor(_driver_blocks(32)[0])
    st = T.init_state(tp, device="cpu")
    s1, hd1, y1 = lti.roundtrip_hopped_block(tp, st, x, 32, True)
    s2, hd2, y2 = T.roundtrip_hopped(tp, st, x[None], 32)
    assert torch.equal(hd1, hd2[0]) and torch.equal(y1, y2[0])


def test_split4_graphs_hold_their_own_key_and_equal_eager():
    """Under the CPU stand-in capture backend: a split4 block replays a
    graph of its own beside the exact plan's, bit for bit its eager run."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "graph_stub", os.path.join(os.path.dirname(os.path.abspath(__file__)), "helpers",
                                   "graph_stub.py"))
    stub = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(stub)
    _, tp = _plans()
    x = torch.as_tensor(_signal(384, seed=14))
    with stub.installed():
        outs = {}
        for p in (tp, _exact(tp)):
            st = T.init_state(p, device="cpu")
            outs[p.precision.mxu] = lti.roundtrip_block_lti(p, st, x, K_TILE)
            with graphs.disabled():
                eager = lti.roundtrip_block_lti(p, st, x, K_TILE)
            for a, b in zip(graphs.leaves(outs[p.precision.mxu]), graphs.leaves(eager)):
                assert torch.equal(a, b)
        assert [e.name for e in graphs.entries()] == ["roundtrip_block_lti"] * 2
    assert not torch.equal(outs["split4"][1], outs["highest"][1])


# -- what split4 leaves exact -------------------------------------------------------------

def test_sharded_driver_chain_ignores_split4():
    """The sharded driver chain reads split4 as exact FP32, as the JAX
    package's sharded programs do: bit for bit the exact plan's, on a
    one-rank Gloo mesh."""
    from sdft_tpu_torch import parallel as par
    from sdft_tpu_torch.parallel import multihost

    _, tp = _plans()
    xs = torch.as_tensor(_driver_blocks(32, C=1))
    saved = {k: os.environ.pop(k) for k in ("MASTER_ADDR", "WORLD_SIZE") if k in os.environ}
    multihost.initialize(device_type="cpu")
    try:
        mesh = par.single_device_mesh("cpu")
        outs = [[t.full_tensor() for t in graphs.leaves(par.sharded_roundtrip_hopped(
            p, mesh, T.init_state(p, channels=1, device="cpu"), xs, 32))]
            for p in (tp, _exact(tp))]
    finally:
        multihost.shutdown()
        os.environ.update(saved)
    assert len(outs[0]) == len(outs[1])
    for a, b in zip(*outs):
        assert torch.equal(a, b)


def test_sdft_hopped_ignores_split4():
    _, tp = _plans()
    x = torch.as_tensor(_signal(640, seed=12))
    a = T.sdft_hopped(tp, T.init_state(tp, device="cpu"), x, 32)
    b = T.sdft_hopped(_exact(tp), T.init_state(tp, device="cpu"), x, 32)
    for u, v in zip(graphs.leaves(a), graphs.leaves(b)):
        assert torch.equal(u, v)


# -- on the card -----------------------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run: python -m pytest "
                    "tests/test_torch_split4.py -m cuda on the card)")
    graphs.clear()
    yield torch.device("cuda", 0)
    graphs.clear()


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(256, 1024, 8192), (64, 1024, 1024), (37, 96, 192)])
def test_cuda_dot4_matches_the_plain_version(cuda_device, shape):
    """The card's kernel (bf16 tensor cores, four products) against the
    plain version on the same halves: within 2e-6 of scale (float32
    summation order)."""
    rows, K, n = shape
    rng = np.random.default_rng(rows)
    a = torch.as_tensor((rng.standard_normal((rows, K)) * 4).astype(np.float32))
    b = lti._split_host(rng.standard_normal((K, n)), "cpu")
    want = split_mm(a, b, 4)
    got = split_mm(a.to(cuda_device), Split(b.hi.to(cuda_device), b.lo.to(cuda_device)), 4)
    assert got.dtype == torch.float32
    assert _rel(got.cpu(), want.numpy()) <= 2e-6


@pytest.mark.cuda
def test_cuda_split4_flags_are_restored(cuda_device):
    _, tp = _plans()
    tp = tp.with_(dftsize=1024)
    x = torch.as_tensor(_signal(16384, seed=3), device=cuda_device)
    flags = torch.backends.cuda.matmul
    saved = (flags.allow_tf32, flags.allow_bf16_reduced_precision_reduction)
    try:
        for before in ((True, True), (False, False)):
            flags.allow_tf32, flags.allow_bf16_reduced_precision_reduction = before
            T.roundtrip(tp, T.init_state(tp, device=cuda_device), x)
            assert (flags.allow_tf32, flags.allow_bf16_reduced_precision_reduction) == before
    finally:
        flags.allow_tf32, flags.allow_bf16_reduced_precision_reduction = saved


@pytest.mark.cuda
@pytest.mark.parametrize("path", ["roundtrip", "roundtrip-batch", "driver-hop100",
                                  "driver-hop4"])
def test_cuda_split4_graphed_equals_eager_and_differs_from_exact(cuda_device, path):
    big = T.Plan(4096, window="hann", precision=T.Precision("float32", "float32",
                                                             mxu="split4"))
    drv = big.with_(dftsize=1000)
    x = torch.as_tensor(_signal(65536, seed=33), device=cuda_device)
    calls = {
        "roundtrip": lambda p: T.roundtrip(p, T.init_state(p, device=cuda_device), x),
        "roundtrip-batch": lambda p: T.roundtrip(
            p, T.init_state(p, channels=2, device=cuda_device), x.reshape(2, -1)),
        "driver-hop100": lambda p: T.roundtrip_hopped(
            p, T.init_state(p, device=cuda_device), x[:64000].reshape(4, 16000), 100),
        "driver-hop4": lambda p: T.roundtrip_hopped(
            p, T.init_state(p, device=cuda_device), x[:16000].reshape(4, 4000), 4),
    }
    plan = drv if path.startswith("driver") else big
    got = calls[path](plan)
    again = calls[path](plan)
    with graphs.disabled():
        eager = calls[path](plan)
    exact = calls[path](plan.with_(precision=T.FAST_PRECISION))
    torch.cuda.synchronize()
    for a, b, c in zip(graphs.leaves(got), graphs.leaves(eager), graphs.leaves(again)):
        assert torch.equal(a, b) and torch.equal(c, b)
    y, ye = graphs.leaves(got)[-1], graphs.leaves(exact)[-1]
    assert not torch.equal(y, ye) and float((y - ye).abs().max()) <= 1e-3
    if path.startswith("driver"):     # the hop spectra stay exact
        assert torch.equal(graphs.leaves(got)[-2], graphs.leaves(exact)[-2])
