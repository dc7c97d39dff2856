"""The probes of K1's parts (``kernels.kparts``) against the archived TPU
microbenchmarks they port, scripts/archive/exp_kparts.py.

Each test loads the script into a fresh module object, sets its shape
globals small, swaps its ``bench`` for one that keeps each kernel factory,
and runs the kept factories in Pallas's TPU interpret mode on seeded
inputs.  The script itself is not edited.  Gates: store and vpu 2e-6 abs;
dots, full and tables 1e-5 of the output's scale (bf16 products are exact
in f32; only the order of the f32 sums differs).
"""

import importlib.util
import pathlib
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

import sdft_tpu_torch as T
from sdft_tpu_torch import profiling
from sdft_tpu_torch.kernels import kparts as P

SCRIPT = pathlib.Path(__file__).resolve().parents[1] / "scripts" / "archive" / "exp_kparts.py"
M, K, PAD, NT = 64, 16, 4, 3
#: the kept benchmark names of exp_kparts.py, by the port's variant
NAMES = {"store": "store-only", "dots": "dots-only (6)", "vpu": "vpu carry+conv",
         "full": "full", "tables": "full w/ table-ins"}


def _load_script():
    """exp_kparts.py as a fresh module at the small shapes: {name: mk}."""
    spec = importlib.util.spec_from_file_location("exp_kparts_probe", SCRIPT)
    mod = importlib.util.module_from_spec(spec)
    path = list(sys.path)
    try:
        spec.loader.exec_module(mod)
    finally:
        sys.path[:] = path  # the script prepends "." to sys.path
    mod.m, mod.K, mod.PAD, mod.NT, mod.NT_LO = M, K, PAD, NT, 1
    mod.W = M + 2 * PAD
    kept = {}
    mod.bench = lambda name, mk, args, n=6: kept.setdefault(name.strip(), mk)
    mod.main()
    mod.main2()
    return kept


def _script_tables(p):
    """The tables main2 builds (exp_kparts.py:185-188): d1 = 1, d2 = 0.5."""
    d1 = torch.ones(K, M + 2 * PAD)
    d2 = d1 * 0.5
    return p._replace(d1=d1, d2=d2, b1=d1.to(torch.bfloat16), b2=d2.to(torch.bfloat16))


@pytest.mark.parametrize("variant", P.VARIANTS)
def test_reference_matches_the_tpu_probe_in_interpret_mode(variant):
    mk = _load_script()[NAMES[variant]]
    p = P.probe_inputs(NT, M, K, PAD, seed=7, device="cpu")
    if variant == "tables":
        p = _script_tables(p)
    args = (jnp.asarray(p.c0.numpy()), jnp.asarray(p.thi.float().numpy(), jnp.bfloat16),
            jnp.asarray(p.tlo.float().numpy(), jnp.bfloat16))
    with pltpu.force_tpu_interpret_mode():
        want = [np.asarray(o, np.float64) for o in mk(NT)(*args)]
    got = [o.double().numpy() for o in P.kparts(variant, p)]
    for g, w in zip(got, want):
        assert g.shape == w.shape == (NT * K, M)
        err = np.abs(g - w).max()
        if variant in ("store", "vpu"):
            assert err <= 2e-6, err
        else:
            assert err <= 1e-5 * np.abs(w).max(), (err, np.abs(w).max())


def test_table_matches_the_script_including_negative_products():
    """dmf at w < PAD has k*(w - PAD) < 0; the mod must be non-negative."""
    p = P.probe_inputs(1, M, K, PAD, device="cpu")
    cos, sin = P.dmf_table(p)
    k = np.arange(K)[:, None]
    r = np.mod(k * (np.arange(M + 2 * PAD)[None, :] - PAD), 2 * M)
    ang = np.float32(-np.pi / M) * r.astype(np.float32)
    np.testing.assert_allclose(cos.numpy(), np.cos(ang), atol=1e-6)
    np.testing.assert_allclose(sin.numpy(), np.sin(ang), atol=1e-6)


def test_cpu_probe_runs_the_plain_version_without_counting():
    before = dict(P.LAUNCHES)
    p = P.probe_inputs(2, M, K, PAD, seed=1, device="cpu")
    for v in P.VARIANTS:
        got = P.kparts(v, p)
        want = P.kparts_reference(v, p)
        assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert P.LAUNCHES == before
    with pytest.raises(ValueError, match="variant"):
        P.kparts_reference("dot", p)


def test_launch_and_timing_refuse_cpu_tensors():
    p = P.probe_inputs(1, M, K, PAD, device="cpu")
    with pytest.raises(ValueError, match="CUDA"):
        P.launch_kparts("full", p)
    with pytest.raises(RuntimeError, match="card"):
        profiling.kernel_parts(nt=1, m=M, K=K, pad=PAD, device="cpu")


def test_every_tile_is_its_own_function_of_its_inputs():
    """Tile t reads only rows 8t, 8t+1 of c0 and its K rows of thi/tlo:
    a probe over 3 tiles equals three one-tile probes stacked."""
    p = P.probe_inputs(3, M, K, PAD, seed=3, device="cpu")
    whole = P.kparts_reference("full", p)
    for t in range(3):
        one = p._replace(c0=p.c0[8 * t:8 * t + 8], thi=p.thi[K * t:K * (t + 1)],
                         tlo=p.tlo[K * t:K * (t + 1)])
        for w, o in zip(whole, P.kparts_reference("full", one)):
            assert torch.equal(w[K * t:K * (t + 1)], o)


@pytest.mark.parametrize("window,latency,fd", [("hann", 1.0, "float32"),
                                               ("blackman", 0.5, "float64")])
def test_cost_model_matches_jax(window, latency, fd):
    import sdft_tpu as J
    from sdft_tpu import profiling as j_profiling

    jp = J.Plan(1000, window=window, latency=latency, precision=J.Precision(fd, fd))
    tp = T.plan_from_jax(jp)
    for name in ("analysis_cost", "synthesis_cost", "roundtrip_cost"):
        got = getattr(profiling, name)(tp, 4096)
        want = getattr(j_profiling, name)(jp, 4096)
        assert (got.flops, got.hbm_bytes) == (want.flops, want.hbm_bytes)
        assert got.intensity == want.intensity


# -- the wrapper's grid and refusals -------------------------------------------------

#: resident blocks of one wave on an H100: 132 SMs at 1, 2 or 3 blocks each
WAVES = (132, 264, 396)


@pytest.mark.parametrize("wave", WAVES)
@pytest.mark.parametrize("m", [64, 200, 4096])
@pytest.mark.parametrize("nt", [1, 3, 512, 1000])
def test_grid_owns_every_tile_and_column_once_within_one_wave(nt, m, wave):
    splits = P.tile_splits(nt, m, wave)
    spans = -(-m // P.BLOCK_COLS)
    assert 1 <= splits <= nt and spans * splits <= wave
    owned = np.zeros((nt, m), np.int64)
    for span in range(spans):
        cols = slice(span * P.BLOCK_COLS, min(m, (span + 1) * P.BLOCK_COLS))
        for split in range(splits):
            tiles = P.tile_range(split, nt, splits)
            assert len(tiles) >= 1  # the kernel gives every block a tile
            owned[tiles.start:tiles.stop, cols] += 1
    assert (owned == 1).all()
    # no block could be added without leaving the wave or the tiles
    assert splits == nt or spans * (splits + 1) > wave or splits == 65535


def test_grid_refuses_more_spans_than_a_wave():
    with pytest.raises(ValueError, match="more than the 132 blocks of one wave"):
        P.tile_splits(4, 64 * 133, 132)
    assert P.tile_splits(4, 64 * 132, 132) == 1


def _on_meta(p):
    """The probe's tensors as CUDA-typed stand-ins: ``_check`` reads only
    devices, dtypes and shapes before it refuses a shape."""
    class Cuda:
        def __init__(self, t):
            self.dtype, self.shape, self.device = t.dtype, t.shape, torch.device("cuda", 0)

        def is_contiguous(self):
            return True

        def data_ptr(self):
            return 0

    return p._replace(**{f: Cuda(getattr(p, f)) for f in ("c0", "thi", "tlo", "d1", "d2",
                                                         "b1", "b2")})


@pytest.mark.parametrize("kw,message", [
    (dict(nt=1, m=64, K=24, pad=4), "K must be a multiple of 16"),
    (dict(nt=1, m=64, K=144, pad=4), r"in \[16, 128\]"),
    (dict(nt=1, m=64, K=16, pad=0), "pad >= 1"),
])
def test_check_refuses_shapes_with_their_reason(kw, message):
    p = P.probe_inputs(seed=0, device="cpu", **kw)
    with pytest.raises(ValueError, match=message):
        P._check(_on_meta(p))


def test_check_refuses_a_table_past_the_32_bit_index():
    p = _on_meta(P.probe_inputs(1, 64, 16, 4, device="cpu"))
    wide = p._replace(m=2 ** 27)  # K * W = 16 * (2^27 + 8) >= 2^31
    with pytest.raises(ValueError, match="overflows the table's 32-bit index"):
        P._check(wide)


def test_check_names_the_tensor_it_refuses():
    p = P.probe_inputs(2, M, K, PAD, device="cpu")
    bad = _on_meta(p._replace(tlo=p.tlo.float()))
    with pytest.raises(ValueError, match="tlo: need contiguous 32-byte aligned torch.bfloat16"):
        P._check(bad)
    P._check(_on_meta(p))  # and takes the right shapes


def test_probe_inputs_default_to_the_card():
    if torch.cuda.is_available():
        assert P.probe_inputs(1, M, K, PAD).c0.device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="pass device='cpu'"):
            P.probe_inputs(1, M, K, PAD)
    p = P.probe_inputs(1, M, K, PAD, device="cpu")
    assert all(getattr(p, f).device.type == "cpu" for f in ("c0", "thi", "tlo", "d1", "b2"))


def test_probe_bounds_count_the_bytes_each_variant_moves():
    b = profiling.kernel_part_bounds(512)
    assert set(b) == set(P.VARIANTS)
    assert all(by == "bytes" for _, by in b.values())
    out_ms = 2 * 512 * 128 * 4096 * 4 / 3.35e12 * 1e3
    assert b["store"][0] == pytest.approx(out_ms)
    assert b["store"][0] < b["vpu"][0] < b["dots"][0] < b["full"][0] < b["tables"][0]
    assert b["full"][0] == pytest.approx(0.6562, abs=1e-4)
    assert b["tables"][0] == pytest.approx(0.6582, abs=1e-4)


# -- on the card -----------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run: python -m pytest "
                    "tests/test_torch_kparts.py -m cuda on the card)")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("m,K,pad,nt", [(64, 16, 4, 3), (200, 48, 9, 5), (4096, 128, 64, 4),
                                        (203, 128, 3, 7), (1000, 128, 64, 37),
                                        (4100, 80, 5, 9)])
def test_cuda_kernel_matches_plain_version(cuda_device, m, K, pad, nt):
    p = P.probe_inputs(nt, m, K, pad, seed=5, device=cuda_device)
    for v in P.VARIANTS:
        got = P.launch_kparts(v, p)
        want = P.kparts_reference(v, p)
        # the products' f32 sums are taken in another order on the tensor
        # cores: 1e-5 of their size (the convolution cancels most of it)
        limit = 2e-6 if v in ("store", "vpu") else 1e-5 * P.product_scale(v, p)
        for g, w in zip(got, want):
            err = (g.double() - w.double()).abs().max().item()
            assert err <= limit, (v, err, limit)
    torch.cuda.synchronize()
    res = profiling.kernel_parts(nt=nt, m=m, K=K, pad=pad, reps=1, device=cuda_device)
    assert all(r["finite"] and r["ms"] > 0 for r in res.values())
