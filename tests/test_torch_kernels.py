"""The kernel wrappers: their plain PyTorch versions against the Pallas
kernels they replace, run by the JAX package in interpret mode on the CPU.

On a CPU tensor each wrapper runs its kernel's plain version; the CUDA
kernels themselves run only on the card (``-m cuda`` tests below, which
skip here).  Gates, from tests/test_pallas_kernels.py:

  * K1 (``_kernel_spectra_conv``): atol 2e-6, rtol 1e-4 (:47-48);
  * K2 (``_kernel``): spectra <= 1.5e-5 of the spectrum scale (the mxu2
    in-kernel cumsum class of the JAX side, tests/test_tpu.py:411-417),
    y atol 5e-4 (:78);
  * carried accumulators within 4 * eps32 * M of the f64 oracle (:54-58).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sdft_tpu as J
import sdft_tpu_torch as T
from sdft_tpu.kernels import (forward_and_y_pallas, forward_block_pallas,
                              forward_block_power)
from sdft_tpu.kernels import roundtrip_block_fused as j_roundtrip_block_fused
from sdft_tpu_torch.kernels import _build, scan, spectra

F32 = J.FAST_PRECISION


def _signal(n, seed=0):
    return np.random.default_rng(seed).standard_normal(n).clip(-1, 1).astype(np.float32)


def _plans(m, **kw):
    jp = J.Plan(m, precision=F32, **kw)
    return jp, T.plan_from_jax(jp)


def _accumulator_f64(m, x):
    """acc[i] = sum_k delta[k] * T_i^k for one block from rest."""
    n2 = 2 * m
    x = np.asarray(x, np.float64)
    delta = x - np.pad(x, (n2, 0))[: x.size]
    k = np.arange(x.size)
    ph = np.exp(-1j * (np.pi / m) * ((k[:, None] * np.arange(m)[None, :]) % n2))
    acc = (delta[:, None] * ph).sum(axis=0)
    return np.stack([acc.real, acc.imag], axis=-1)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run: python -m pytest "
                    "tests/test_torch_kernels.py -m cuda on the card)")
    return torch.device("cuda", 0)


# -- dispatch ----------------------------------------------------------------------

def test_kernel_supported_mirrors_plan_supported():
    from sdft_tpu.kernels import plan_supported

    for m, prec, want in [(128, F32, True), (4096, F32, True), (127, F32, False),
                          (1000, J.DEFAULT_PRECISION, False),
                          (1000, J.Precision("float64", "float64"), False),
                          (1000, J.Precision("float32", "float32x2"), False)]:
        jp = J.Plan(m, precision=prec)
        assert T.kernel_supported(T.plan_from_jax(jp), 1000) is want
        assert plan_supported(jp, 1000) is want
    assert not T.kernel_supported(T.Plan((1 << 19) + 1, precision=T.FAST_PRECISION), 8)


def test_wrappers_refuse_non_cuda_tensors_at_launch():
    """The launch path never falls back: on a tensor that is not on a CUDA
    device it raises before touching the library."""
    _, tp = _plans(256)
    pro = spectra.spectra_prologue(tp, T.init_state(tp, device="cpu"), torch.as_tensor(_signal(100)))
    with pytest.raises(ValueError, match="CUDA"):
        spectra.launch_spectra(tp, pro)
    with pytest.raises(ValueError, match="CUDA"):
        scan.launch_scan(tp, pro, scan.synthesis_row(tp, "cpu"))


def test_cpu_wrapper_runs_the_plain_version_without_counting():
    _, tp = _plans(256)
    before = (spectra.LAUNCHES, scan.LAUNCHES)
    x = torch.as_tensor(_signal(200))
    T.sdft(tp, T.init_state(tp, device="cpu"), x)
    T.roundtrip_hopped(tp, T.init_state(tp, device="cpu"), x.reshape(2, 100), 1)
    assert (spectra.LAUNCHES, scan.LAUNCHES) == before


def test_failed_build_raises_with_compiler_output(monkeypatch, tmp_path):
    fake = tmp_path / "nvcc"
    fake.write_text("#!/bin/sh\necho 'error: no such target' >&2\nexit 2\n")
    fake.chmod(0o755)
    monkeypatch.setattr(_build, "nvcc", lambda: str(fake))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="no such target"):
        _build.build()
    assert list((tmp_path / "build").iterdir()) == []  # no partial library


def test_nvcc_lookup_raises_when_absent(monkeypatch, tmp_path):
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setattr(_build.os, "access", lambda *a: False)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.nvcc()


def test_library_path_tracks_the_sources():
    p = _build.library_path()
    assert p.parent == _build.BUILD_DIR and p.name.startswith("libsdft_kernels_")
    assert all((_build.CSRC / s).is_file() for s in _build.SOURCES + _build.HEADERS)


@pytest.mark.parametrize("nt", [5, 32, 70, 96])
def test_prologue_prefix_over_tiles_matches_a_sequential_sum(nt):
    rng = np.random.default_rng(nt)
    z = rng.standard_normal((nt, 9)) + 1j * rng.standard_normal((nt, 9))
    got = spectra._prefix_tiles(torch.as_tensor(z, dtype=torch.complex128))
    np.testing.assert_allclose(got.numpy(), np.cumsum(z, axis=0), rtol=0, atol=1e-12)


def test_long_block_prologue_matches_the_ops_path():
    """A block of 40 tiles (the two-level prefix) against the f32 ops path
    (JAX's XLA path is the same math; both are held at the f32 class)."""
    _, tp = _plans(128, window="hann")
    x = torch.as_tensor(_signal(40 * spectra.TILE_K - 3, seed=4))
    st, d = T.sdft(tp, T.init_state(tp, device="cpu"), x)
    from sdft_tpu_torch.ops.analysis import sdft_block

    st2, d2 = sdft_block(tp, T.init_state(tp, device="cpu"), x)
    np.testing.assert_allclose(d.numpy(), d2.numpy(), atol=2e-6, rtol=1e-4)
    bound = 4 * np.finfo(np.float32).eps * x.numel()
    err = np.abs(st.accumulator.numpy() - _accumulator_f64(128, x.numpy())).max()
    assert err < bound, (err, bound)


# -- K1 plain version vs forward_block_pallas(interpret=True) -----------------------

K1_CASES = [  # (m, window, roi, M0, M1): two chained blocks, ragged M
    (256, "boxcar", None, 128, 200),
    (256, "hann", None, 384, 64),
    (250, "hamming", (3, 240), 130, 250),
    (256, "blackman", (0, 100), 257, 129),
    (130, "blackman", None, 100, 160),
]


@pytest.mark.parametrize("m,window,roi,M0,M1", K1_CASES)
def test_k1_plain_matches_pallas_interpret(m, window, roi, M0, M1):
    jp, tp = _plans(m, window=window, roi=roi)
    x = _signal(M0 + M1, seed=m + M0)
    js, ts = J.init_state(jp), T.init_state(tp, device="cpu")
    for blk in (x[:M0], x[M0:]):
        js, jd = forward_block_pallas(jp, js, blk, interpret=True)
        ts, td = T.sdft(tp, ts, blk)
        np.testing.assert_allclose(td.numpy(), np.asarray(jd), atol=2e-6, rtol=1e-4)
    bound = 4 * np.finfo(np.float32).eps * (M0 + M1)
    err = np.abs(ts.accumulator.numpy().astype(np.float64)
                 - np.asarray(js.accumulator, np.float64)).max()
    assert err < bound, (err, bound)
    assert int(ts.offset) == int(js.offset)
    np.testing.assert_array_equal(ts.delayline.numpy(), np.asarray(js.delayline))
    if roi is not None:
        outside = np.ones(m, bool)
        outside[roi[0]:roi[1]] = False
        assert np.all(td.numpy()[:, outside] == 0)


def test_k1_accumulator_vs_f64_oracle():
    _, tp = _plans(256, window="hann")
    x = _signal(3 * 128, seed=9)
    ts, _ = T.sdft(tp, T.init_state(tp, device="cpu"), x)
    err = np.abs(ts.accumulator.numpy() - _accumulator_f64(256, x)).max()
    assert err < 4 * np.finfo(np.float32).eps * x.size


@pytest.mark.parametrize("out_dtype", [None, "bfloat16"])
def test_k1_planar_and_power_match_pallas_interpret(out_dtype):
    jp, tp = _plans(256, window="blackman", roi=(5, 250))
    x = _signal(300, seed=3)
    _, (jre, jim) = forward_block_pallas(jp, J.init_state(jp), x, interpret=True,
                                         layout="planar", out_dtype=out_dtype)
    _, (re, im) = T.sdft(tp, T.init_state(tp, device="cpu"), x, "planar", out_dtype)
    assert re.dtype == (torch.bfloat16 if out_dtype else torch.float32)
    # bf16 planes: one bf16 rounding of values that agree to 2e-6
    rtol = 2.0**-7 if out_dtype else 1e-4
    for g, w in ((re, jre), (im, jim)):
        np.testing.assert_allclose(g.float().numpy(), np.asarray(w, np.float32),
                                   atol=2e-6, rtol=rtol)
    _, jpw = forward_block_power(jp, J.init_state(jp), x, interpret=True,
                                 out_dtype=out_dtype)
    _, pw = T.sdft_power(tp, T.init_state(tp, device="cpu"), x, out_dtype)
    np.testing.assert_allclose(pw.float().numpy(), np.asarray(jpw, np.float32),
                               atol=2e-6, rtol=rtol)


def test_k1_packed_equals_planar_and_rejects_bf16_packed():
    _, tp = _plans(256)
    x = torch.as_tensor(_signal(100, seed=1))
    _, packed = T.sdft(tp, T.init_state(tp, device="cpu"), x)
    _, (re, im) = T.sdft(tp, T.init_state(tp, device="cpu"), x, layout="planar")
    assert torch.equal(packed[..., 0], re) and torch.equal(packed[..., 1], im)
    with pytest.raises(ValueError):
        T.sdft(tp, T.init_state(tp, device="cpu"), x, spectra_dtype="bfloat16")
    with pytest.raises(ValueError):
        spectra.forward_block(tp, T.init_state(tp, device="cpu"), x, "packed", "bfloat16")


# -- K2 plain version vs forward_and_y_pallas(interpret=True) -----------------------

@pytest.mark.parametrize("m,window,latency,roi,M", [
    (256, "hann", 1.0, None, 256),
    (250, "blackman", 0.5, (4, 200), 300),
    (130, "hamming", 0.5, None, 129),
])
def test_k2_plain_matches_pallas_interpret(m, window, latency, roi, M):
    jp, tp = _plans(m, window=window, latency=latency, roi=roi)
    x = _signal(M + 77, seed=m)
    js, _ = forward_block_pallas(jp, J.init_state(jp), x[:77], interpret=True)
    ts, _ = T.sdft(tp, T.init_state(tp, device="cpu"), x[:77])
    js, jd, jy = forward_and_y_pallas(jp, js, x[77:], interpret=True)
    ts, td, ty = scan.forward_and_y(tp, ts, torch.as_tensor(x[77:]))
    scale = np.abs(np.asarray(jd)).max()
    assert np.abs(td.numpy() - np.asarray(jd)).max() <= 1.5e-5 * scale
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), atol=5e-4)
    np.testing.assert_allclose(ts.accumulator.numpy(), np.asarray(js.accumulator),
                               atol=4 * np.finfo(np.float32).eps * (M + 77))
    _, (re, im), _ = scan.forward_and_y(tp, T.init_state(tp, device="cpu"), torch.as_tensor(x), "planar")
    _, pk, _ = scan.forward_and_y(tp, T.init_state(tp, device="cpu"), torch.as_tensor(x))
    assert torch.equal(pk[..., 0], re) and torch.equal(pk[..., 1], im)


@pytest.mark.parametrize("latency", [1.0, 0.5])
def test_fused_roundtrip_matches_pallas_interpret(latency):
    jp, tp = _plans(256, window="hann", latency=latency)
    x = _signal(4 * 128, seed=1)
    _, jy = j_roundtrip_block_fused(jp, J.init_state(jp), x, interpret=True)
    _, ty = scan.roundtrip_block_fused(tp, T.init_state(tp, device="cpu"), torch.as_tensor(x))
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), atol=5e-4, rtol=1e-3)


@pytest.mark.parametrize("channels", [None, 2])
def test_roundtrip_transform_reads_the_k1_spectra(channels):
    """On a plan the kernels take, roundtrip(transform) reads its spectra
    from the K1 wrapper, so it equals sdft -> transform -> isdft bit for bit
    (the JAX package reads its XLA path there instead, api.py:128-139)."""
    _, tp = _plans(128, window="hann", latency=0.5)
    shape = (channels, 300) if channels else (300,)
    x = torch.as_tensor(np.random.default_rng(4).standard_normal(shape)
                        .clip(-1, 1).astype(np.float32))
    mask = torch.arange(128) < 40
    st0 = T.init_state(tp, channels, device="cpu")
    assert T.kernel_supported(tp, x.shape[-1])
    st, y = T.roundtrip(tp, st0, x, transform=lambda z: z * mask)
    want_st, d = T.sdft(tp, st0, x)
    want = T.isdft(tp, d * mask[:, None])
    assert torch.equal(y, want)
    assert torch.equal(st.accumulator, want_st.accumulator)
    assert torch.equal(st.delayline, want_st.delayline)


# -- the store form each shape takes, and in-place outputs ---------------------------

@pytest.mark.parametrize("m,form,dtype,want", [
    (4096, "planar", "float32", 16), (4096, "packed", "float32", 16),
    (4096, "planar", "bfloat16", 8), (4096, "power", "bfloat16", 8),
    (4096, "power", "float32", 16), (1000, "planar", "bfloat16", 8),
    (256, "packed", "float32", 16), (129, "planar", "float32", 4),
    (129, "packed", "float32", 8), (130, "power", "bfloat16", 2)])
def test_wrapper_chooses_vector_or_scalar_stores(m, form, dtype, want):
    """Vector stores (16 bytes for f32 planes and packed f32, 8 for bf16 and
    power bf16 at STRIP = 4) exactly when every strip starts aligned,
    m % STRIP == 0; otherwise the scalar-store instantiation."""
    assert spectra.STRIP == 4
    assert spectra.store_bytes(m, form, dtype) == want
    assert spectra.vector_stores(m) is (m % spectra.STRIP == 0)


@pytest.mark.parametrize("m,want", [(1000, True), (130, True), (129, False)])
def test_k2_strip_choice(m, want):
    """K2 runs strips of two bins: vector stores whenever m is even."""
    assert scan.STRIP == 2
    assert spectra.vector_stores(m, scan.STRIP) is want


def test_allocate_validates_in_place_outputs():
    _, tp = _plans(256)
    pro = spectra.spectra_prologue(tp, T.init_state(tp, device="cpu"),
                                   torch.as_tensor(_signal(100)))
    out = spectra.empty_outputs((2, 100), 256, "planar", "bfloat16", "cpu")
    got, (p0, p1) = spectra.allocate(pro, 256, "planar", "bfloat16", (out[0][1], out[1][1]))
    assert p0 == out[0][1].data_ptr() and p1 == out[1][1].data_ptr()
    for bad in ((out[0][1], out[1][1].float()), (out[0][:, :50], out[1][:, :50])):
        with pytest.raises(ValueError):
            spectra.allocate(pro, 256, "planar", "bfloat16", bad)
    with pytest.raises(ValueError, match="CUDA"):
        spectra.forward_block(tp, T.init_state(tp, device="cpu"), torch.as_tensor(_signal(100)),
                              out=spectra.empty_outputs((100,), 256, "packed", "float32", "cpu"))


BATCH_CASES = [  # (m, window, roi, C, M)
    (256, "hann", None, 3, 300),
    (250, "blackman", (3, 245), 2, 129),
]


@pytest.mark.parametrize("m,window,roi,C,M", BATCH_CASES)
@pytest.mark.parametrize("call", ["sdft", "sdft planar", "sdft_power", "sdft_power bf16"])
def test_channel_batch_on_kernel_plans_matches_jax_vmapped(m, window, roi, C, M, call):
    """(C, M) batches on kernel plans against sdft_tpu's batched (vmapped)
    result, at the float32 class (atol 2e-6, rtol 1e-4; bf16 planes one
    bf16 rounding, rtol 2^-7)."""
    jp, tp = _plans(m, window=window, roi=roi)
    x = _signal(C * M, seed=m + C).reshape(C, M)
    assert T.kernel_supported(tp, M)
    name, *kind = call.split()
    args = {"sdft": ("planar",) if kind == ["planar"] else (),
            "sdft_power": ("bfloat16",) if kind == ["bf16"] else ()}[name]
    js, jd = getattr(J, name)(jp, J.init_state(jp, channels=C), x, *args)
    ts, td = getattr(T, name)(tp, T.init_state(tp, channels=C, device="cpu"), x, *args)
    rtol = 2.0**-7 if kind == ["bf16"] else 1e-4
    for g, w in zip(td if isinstance(td, tuple) else (td,), jd if isinstance(jd, tuple) else (jd,)):
        assert tuple(g.shape) == tuple(np.shape(w))
        np.testing.assert_allclose(g.float().numpy(), np.asarray(w, np.float32),
                                   atol=2e-6, rtol=rtol)
    np.testing.assert_allclose(ts.accumulator.numpy(), np.asarray(js.accumulator),
                               atol=4 * np.finfo(np.float32).eps * M)


def test_channel_batch_roundtrip_transform_matches_jax_vmapped():
    """roundtrip(transform) of a (C, M) batch on a kernel plan against
    sdft_tpu's batched result, at the float32 round-trip class (1e-5)."""
    jp, tp = _plans(256, window="hann", latency=0.5)
    x = _signal(3 * 200, seed=21).reshape(3, 200)
    _, jy = J.roundtrip(jp, J.init_state(jp, channels=3), x,
                        transform=lambda z: z * (jnp.arange(z.shape[-1]) < 60))
    _, ty = T.roundtrip(tp, T.init_state(tp, channels=3, device="cpu"), x,
                        transform=lambda z: z * (torch.arange(z.shape[-1]) < 60))
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), atol=1e-5)


# -- on the card: each kernel against its plain version ------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("m,window,roi,M", [(256, "boxcar", None, 300),
                                            (1000, "blackman", (3, 900), 4000)])
def test_cuda_kernels_match_plain_versions(cuda_device, m, window, roi, M):
    tp = T.Plan(m, window=window, roi=roi, latency=0.5, precision=T.FAST_PRECISION)
    st, _ = T.sdft(tp, T.init_state(tp, device=cuda_device),
                   torch.as_tensor(_signal(333, 1), device=cuda_device))
    pro = spectra.spectra_prologue(tp, st, torch.as_tensor(_signal(M, 2), device=cuda_device))
    for form, dtype in spectra.STORES:
        got = spectra.launch_spectra(tp, pro, form, dtype)
        want = spectra.spectra_reference(tp, pro, form, "float32")
        got = got if isinstance(got, tuple) else (got,)
        want = want if isinstance(want, tuple) else (want,)
        rtol = 2.0**-8 if dtype == "bfloat16" else 0.0
        for g, w in zip(got, want):
            torch.testing.assert_close(g.float(), w, atol=2e-6, rtol=rtol)
    synth = scan.synthesis_row(tp, cuda_device)
    dk, yk = scan.launch_scan(tp, pro, synth, "packed")
    dr, yr = scan.forward_and_y_reference(tp, pro, synth, "packed")
    torch.testing.assert_close(dk, dr, atol=2e-6, rtol=0.0)
    # y: the atomics sum the blocks' partial rows in a run-dependent order
    torch.testing.assert_close(yk, yr, atol=1e-5, rtol=0.0)
    torch.cuda.synchronize()


CARD_M = [128, 129, 1000, 4096]
CARD_WINDOWS = ["boxcar", "hann", "blackman"]  # halo 0, 1, 2


def _card_rois(m):
    return [(0, m), (3, m - 5), (0, 100)]


@pytest.mark.cuda
@pytest.mark.parametrize("m", CARD_M)
@pytest.mark.parametrize("window", CARD_WINDOWS)
@pytest.mark.parametrize("roi_case", [0, 1, 2])
def test_cuda_every_store_form_and_k2_match_plain_versions(cuda_device, m, window, roi_case):
    """Every K1 store form and K2 against the plain versions at a ragged M
    (a multiple of neither K nor 16): f32 atol 2e-6, bf16 one rounding
    (2^-8 relative) on top, y 1e-5 (atomics in a run-dependent order).
    Packed f32 equals planar f32 bit for bit; power f32 equals re*re +
    im*im of the planar f32 output to 1 ulp."""
    roi = _card_rois(m)[roi_case]
    tp = T.Plan(m, window=window, roi=roi, latency=0.5, precision=T.FAST_PRECISION)
    st, _ = T.sdft(tp, T.init_state(tp, device=cuda_device),
                   torch.as_tensor(_signal(333, 1), device=cuda_device))
    M = 2 * spectra.TILE_K + 37
    pro = spectra.spectra_prologue(tp, st, torch.as_tensor(_signal(M, 2), device=cuda_device))
    got = {}
    for form, dtype in spectra.STORES:
        got[form, dtype] = spectra.launch_spectra(tp, pro, form, dtype)
        want = spectra.spectra_reference(tp, pro, form, "float32")
        g = got[form, dtype] if isinstance(got[form, dtype], tuple) else (got[form, dtype],)
        w = want if isinstance(want, tuple) else (want,)
        rtol = 2.0**-8 if dtype == "bfloat16" else 0.0
        for a, b in zip(g, w):
            torch.testing.assert_close(a.float(), b, atol=2e-6, rtol=rtol)
    re, im = got["planar", "float32"]
    packed = got["packed", "float32"]
    assert torch.equal(packed[..., 0], re) and torch.equal(packed[..., 1], im)
    pw, ref = got["power", "float32"], re * re + im * im
    top = torch.maximum(pw, ref)
    spacing = torch.nextafter(top, torch.full_like(top, float("inf"))) - top
    assert ((pw - ref).abs() <= spacing).all()
    synth = scan.synthesis_row(tp, cuda_device)
    for layout in ("packed", "planar", None):
        dk, yk = scan.launch_scan(tp, pro, synth, layout)
        dr, yr = scan.forward_and_y_reference(tp, pro, synth, layout)
        if layout == "packed":
            torch.testing.assert_close(dk, dr, atol=2e-6, rtol=0.0)
            k2_packed = dk
        elif layout == "planar":
            assert torch.equal(dk[0], k2_packed[..., 0]) and torch.equal(dk[1], k2_packed[..., 1])
        torch.testing.assert_close(yk, yr, atol=1e-5, rtol=0.0)
    torch.cuda.synchronize()


@pytest.mark.cuda
@pytest.mark.parametrize("m,window", [(1000, "hann"), (129, "blackman")])
def test_cuda_channel_batch_equals_per_channel_launches(cuda_device, m, window):
    """A (C=3, M) batch writes each channel's slice in place: every form
    equals the per-channel launches bit for bit, and nothing is stacked."""
    tp = T.Plan(m, window=window, precision=T.FAST_PRECISION)
    x = torch.as_tensor(_signal(3 * 777, 5).reshape(3, 777), device=cuda_device)
    st0 = T.init_state(tp, channels=3, device=cuda_device)
    calls = {"packed": lambda s, v: T.sdft(tp, s, v),
             "planar": lambda s, v: T.sdft(tp, s, v, "planar"),
             "planar bf16": lambda s, v: T.sdft(tp, s, v, "planar", "bfloat16"),
             "power": lambda s, v: T.sdft_power(tp, s, v),
             "power bf16": lambda s, v: T.sdft_power(tp, s, v, "bfloat16")}
    for name, call in calls.items():
        before = spectra.LAUNCHES
        st, out = call(st0, x)
        assert spectra.LAUNCHES == before + 3, name
        for c in range(3):
            sc, oc = call(T.init_state(tp, device=cuda_device), x[c])
            for a, b in zip(out if isinstance(out, tuple) else (out,),
                            oc if isinstance(oc, tuple) else (oc,)):
                assert torch.equal(a[c], b), (name, c)
            assert torch.equal(st.accumulator[c], sc.accumulator)
    torch.cuda.synchronize()
