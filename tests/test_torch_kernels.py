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

import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sdft_tpu as J
import sdft_tpu_torch as T
from sdft_tpu.kernels import (forward_and_y_pallas, forward_block_pallas,
                              forward_block_power)
from sdft_tpu.kernels import roundtrip_block_fused as j_roundtrip_block_fused
from sdft_tpu.ops.lti import _chain_hop1_pallas_jit
from sdft_tpu_torch import graphs
from sdft_tpu_torch.kernels import _build, scan, spectra
from sdft_tpu_torch.kernels import carry as carry_kernel
from sdft_tpu_torch.ops import carry, lti
from sdft_tpu_torch.state import State, batch_state, stack_states

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


def test_wrappers_refuse_non_cuda_tensors_at_launch(monkeypatch):
    """The launch path never falls back: on a tensor that is not on a CUDA
    device it raises before touching the library, and the carry kernel's
    wrapper raises on a wrong dtype or shape too."""
    _, tp = _plans(256)
    st = T.init_state(tp, device="cpu")
    x = torch.as_tensor(_signal(100))
    pro = spectra.spectra_prologue(tp, st, x)
    for module in (spectra, scan, carry_kernel):
        monkeypatch.setattr(module, "library", lambda: pytest.fail("touched the library"))
    with pytest.raises(ValueError, match="CUDA"):
        spectra.launch_spectra(tp, pro)
    with pytest.raises(ValueError, match="CUDA"):
        scan.launch_scan(tp, pro, scan.synthesis_row(tp, "cpu"))
    fine, _ = spectra._spectra_tables(tp, spectra.TILE_K, x.device)
    batched = State(*(a[None] for a in st))
    with pytest.raises(ValueError, match="CUDA"):
        carry_kernel.launch_carry(tp, batched, x[None], fine)
    for args in ((batched, x[None].double(), fine),
                 (batched._replace(offset=batched.offset.long()), x[None], fine),
                 (batched._replace(accumulator=batched.accumulator[..., :1]), x[None], fine),
                 (batched, x, fine),
                 (batched, x[None], fine[:64]),
                 (batched, x.reshape(1, 100)[:, ::2], fine)):
        with pytest.raises(ValueError, match=r"need (contiguous|\(C, M\))"):
            carry_kernel.launch_carry(tp, *args)


def test_cpu_wrapper_runs_the_plain_version_without_counting():
    _, tp = _plans(256)
    before = (spectra.LAUNCHES, scan.LAUNCHES, carry_kernel.LAUNCHES)
    x = torch.as_tensor(_signal(200))
    T.sdft(tp, T.init_state(tp, device="cpu"), x)
    T.roundtrip_hopped(tp, T.init_state(tp, device="cpu"), x.reshape(2, 100), 1)
    assert (spectra.LAUNCHES, scan.LAUNCHES, carry_kernel.LAUNCHES) == before


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


def test_carry_kernel_source_and_signature_are_registered():
    """csrc/carry.cu is built with the other sources, its C entry's
    declared arguments match the source's, and its kernels' names are none
    the benchmark's readers take for K1, K2 or NCCL."""
    assert "carry.cu" in _build.SOURCES and (_build.CSRC / "carry.cu").is_file()
    src = (_build.CSRC / "carry.cu").read_text()
    params = re.search(r'extern "C" int sdft_carry_launch\(([^)]*)\)', src).group(1)
    sig = _build.SIGNATURES["sdft_carry_launch"]
    assert len(sig) == len(params.split(",")) == 16
    kinds = [_build._I if re.match(r"\s*int ", p) else _build._P for p in params.split(",")]
    assert list(sig) == kinds
    kernels = re.findall(r"__global__ void(?: __launch_bounds__\([^)]*\))?\s+(\w+)\(", src)
    assert kernels == ["carry_front"]
    assert not any(w in k for k in kernels for w in ("spectra_kernel", "scan_kernel", "nccl"))
    assert carry_kernel.K == spectra.TILE_K


@pytest.mark.parametrize("nt", [5, 32, 70, 96])
def test_prologue_prefix_over_tiles_matches_a_sequential_sum(nt):
    rng = np.random.default_rng(nt)
    z = rng.standard_normal((nt, 9)) + 1j * rng.standard_normal((nt, 9))
    got = carry._prefix_tiles(torch.as_tensor(z, dtype=torch.complex128))
    np.testing.assert_allclose(got.numpy(), np.cumsum(z, axis=0), rtol=0, atol=1e-12)


def test_prologue_at_an_odd_dftsize_builds_no_table_of_m_rows():
    """At odd m the tile phase rows T_i^(t*K) have a period of m tiles: a
    256-sample block (2 tiles) at m = 8191 evaluates two of them, so the
    prologue's host allocations stay far below one m x m table (537 MB in
    complex64), and its carries equal the ops path's carry front
    (``ops.lti``'s fine table of K = 128) at the f32 class."""
    import tracemalloc

    _, tp = _plans(8191, window="hann")
    x = torch.as_tensor(_signal(256, seed=2))
    tracemalloc.start()
    try:
        st, _ = T.sdft(tp, T.init_state(tp, device="cpu"), torch.as_tensor(_signal(77, 1)))
        pro = spectra.spectra_prologue(tp, st, x)
        peak = tracemalloc.get_traced_memory()[1]
    finally:
        tracemalloc.stop()
    assert peak < 64 << 20, peak
    fine = lti._hop_consts_device(tp, spectra.TILE_K, torch.float32, x.device)
    _, c0, want = carry.carry(tp, State(*(a[None] for a in st)), x[None], fine)
    bound = 4 * np.finfo(np.float32).eps * (77 + 256)
    np.testing.assert_allclose(pro.c0.numpy(), torch.view_as_real(c0).numpy(), rtol=0, atol=bound)
    np.testing.assert_allclose(pro.state.accumulator.numpy(), want.accumulator[0].numpy(),
                               rtol=0, atol=bound)


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


@pytest.mark.parametrize("form,dtype", list(spectra.STORES))
@pytest.mark.parametrize("m", [100, 128, 129, 960, 992, 1000, 1001, 1008, 1024, 1025, 4096])
def test_k1_paces_where_chunk_edges_split_256_byte_units(m, form, dtype):
    """K1 runs as paced clusters exactly in the paced forms (planar f32 and
    bf16, power f32) with vector stores, where a row of the form is no
    multiple of 256 bytes and the row's 2 to 8 chunks of 128 bins fill one
    cluster: at m = 1000 (rows of 4000 and 2000 B), never at m = 1024 or
    4096, at 960 only planar bf16 (1920 B rows), never in a row of one
    chunk (m = 100, 128), past 8 chunks (m = 1025) or with scalar stores
    (m = 1001); packed f32 and power bf16 never."""
    elem = {"packed": 8, "planar": 4, "power": 4}[form] // (2 if dtype == "bfloat16" else 1)
    assert spectra.row_bytes(m, form, dtype) == m * elem
    want = ((form, dtype) in spectra.PACED_FORMS and m % 4 == 0 and m * elem % 256 != 0
            and 128 < m <= 1024)
    assert spectra.paced(m, form, dtype) is want
    if m == 1000:
        assert want is ((form, dtype) != ("packed", "float32")
                        and (form, dtype) != ("power", "bfloat16"))
    if m in (100, 128, 1001, 1024, 1025, 4096) or (m == 960 and dtype == "float32"):
        assert not want


def test_k1_paced_forms_and_cluster_bound_match_the_build():
    """The build takes the wrapper's paced forms (``_build.flags`` passes
    their store codes' mask as SDFT_PACED_STORES, which csrc/spectra.cu's
    paceable reads and cannot build without) and cluster size
    (csrc/common.cuh: MAX_CLUSTER, which the launcher checks)."""
    mask = sum(1 << spectra.STORES[f] for f in spectra.PACED_FORMS)
    assert mask == 0b01110    # planar f32, planar bf16, power f32
    flags = _build.flags()
    assert flags[:len(_build.FLAGS)] == _build.FLAGS
    assert [f for f in flags if "PACED" in f] == [f"-DSDFT_PACED_STORES={mask}"]
    src = (_build.CSRC / "spectra.cu").read_text()
    assert "#ifndef SDFT_PACED_STORES\n#error" in src
    assert re.search(r"constexpr bool paceable\(int store\) \{\s*return "
                     r"\(SDFT_PACED_STORES >> store\) & 1;", src)
    assert spectra.MAX_CLUSTER == _header_int("MAX_CLUSTER") == 8
    assert "(a.paced && chunks > MAX_CLUSTER)" in (_build.CSRC / "common.cuh").read_text()


def test_k1_launch_passes_the_rule_and_counts_paced_launches(monkeypatch):
    """launch_spectra hands the C entry the rule's flag, one argument for
    each of the source's parameters as the declared signature types them,
    and counts the paced launches apart."""
    calls = []

    class Lib:
        def sdft_spectra_launch(self, *args):
            calls.append(args)
            return 0

    monkeypatch.setattr(spectra, "library", lambda: Lib())
    monkeypatch.setattr(spectra, "launch_args", lambda plan, pro: (1, 2, 3, 1000, 1, 8, 128, 1,
                                                                 1, 0.5, 0.25, 0.0, 0, 1000))
    monkeypatch.setattr(spectra, "allocate", lambda *a, **k: ("out", (4, 5)))
    monkeypatch.setattr(torch.cuda, "device", lambda dev: __import__("contextlib").nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda dev: type("S", (), {"cuda_stream": 9})())
    pro = type("P", (), {"c0": torch.zeros(1)})()
    launches, paced = spectra.LAUNCHES, spectra.PACED_LAUNCHES
    for m, want in ((1000, 1), (1024, 0)):
        plan = type("Plan", (), {"dftsize": m})()
        assert spectra.launch_spectra(plan, pro, "planar", "float32") == "out"
        assert calls[-1][-2:] == (want, 9)
    src = (_build.CSRC / "spectra.cu").read_text()
    params = re.search(r'extern "C" int sdft_spectra_launch\(([^)]*)\)', src).group(1).split(",")
    kinds = [{"int": _build._I, "float": _build._F}.get(p.split()[0], _build._P) for p in params]
    assert list(_build.SIGNATURES["sdft_spectra_launch"]) == kinds
    assert len(calls[-1]) == len(kinds) == 20
    assert (spectra.LAUNCHES - launches, spectra.PACED_LAUNCHES - paced) == (2, 1)


@pytest.mark.parametrize("m,want", [(1000, True), (130, True), (129, False)])
def test_k2_strip_choice(m, want):
    """K2 runs strips of two bins: vector stores whenever m is even."""
    assert scan.STRIP == 2
    assert spectra.vector_stores(m, scan.STRIP) is want


def _header_int(name):
    src = (_build.CSRC / "common.cuh").read_text()
    return int(re.search(rf"(?:#define|constexpr int) {name}\s*=?\s*(\d+)", src).group(1))


@pytest.mark.parametrize("m,chunks", [(1000, 8), (1024, 8), (129, 2), (128, 1), (4096, 32)])
def test_k2_y_part_matches_the_build(m, chunks):
    """The wrapper's strip and bins a thread are the build's (csrc/common.cuh:
    K2_STRIP, the default SDFT_K2_STRIP that K2_BINS takes), so its y_part
    has one row per chunk of 32 * BINS bins, the count the launch checks."""
    assert scan.STRIP == _header_int("K2_STRIP") == 2
    assert scan.BINS == _header_int("SDFT_K2_STRIP") == 4
    assert "constexpr int K2_BINS = SDFT_K2_STRIP;" in (_build.CSRC / "common.cuh").read_text()
    assert scan.y_chunks(m) == chunks == -(-m // (32 * scan.BINS))
    assert "y_chunks != (m + chunk_bins(K2_BINS) - 1) / chunk_bins(K2_BINS)" in (
        _build.CSRC / "scan.cu").read_text()


@pytest.mark.parametrize("M,want", [(44100, 44128), (8000, 8000), (777, 800), (1, 32)])
def test_k2_y_rows_fill_whole_sectors(M, want):
    """A channel's rows of the partial row sums: M up to a 128-byte line,
    so every eight rows a warp stores start on a 32-byte sector; the launch
    refuses fewer than M or a count that is no multiple of 8."""
    assert scan.y_rows(M) == want and want >= M and want % 32 == 0
    src = (_build.CSRC / "scan.cu").read_text()
    assert "y_rows < M" in src and "y_rows % 8" in src


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
    # the plain version fills ``out`` in place on the CPU, as the kernel
    # does on the card, and refuses malformed outputs alike
    x = torch.as_tensor(_signal(100))
    _, want = spectra.forward_block(tp, T.init_state(tp, device="cpu"), x)
    dest = spectra.empty_outputs((100,), 256, "packed", "float32", "cpu")
    _, got = spectra.forward_block(tp, T.init_state(tp, device="cpu"), x, out=dest)
    assert got is dest and torch.equal(dest, want)
    with pytest.raises(ValueError, match="packed output"):
        spectra.forward_block(tp, T.init_state(tp, device="cpu"), x, out=dest[:50])


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


# -- the channel axis: one prologue and one launch per (C, M) batch ----------------

#: (m, window, roi, M): a ragged M (no multiple of K = 128), each window halo,
#: ROIs, a block of 40 tiles (the two-level prefix over tiles) and an odd m
#: (tile phase rows of period m tiles)
CHANNEL_CASES = [
    (256, "boxcar", None, 300),
    (250, "hann", (3, 240), 129),
    (256, "blackman", (0, 100), 4 * 128 + 37),
    (128, "hann", None, 40 * 128 - 3),
    (8191, "hann", None, 256),
]


def _desynchronized(tp, C, seed):
    """A batched state whose channels sit at different offsets: channel c
    has run 37*c + 11 samples of its own; returns (state, samples run)."""
    sts = [T.sdft(tp, T.init_state(tp, device="cpu"),
                  torch.as_tensor(_signal(37 * c + 11, seed + c)))[0] for c in range(C)]
    return stack_states(sts), 37 * (C - 1) + 11


def _jax_state(ts):
    return J.state_from_arrays(T.state_to_arrays(ts))


def _vmapped(fn, js, x):
    """The JAX package's channel batch of a Pallas kernel (the vmap of
    sdft_tpu/api.py:57-63, 319-326), in interpret mode."""
    import jax

    return jax.vmap(fn)(js, jnp.asarray(x))


@pytest.mark.parametrize("m,window,roi,M", CHANNEL_CASES)
def test_batched_prologue_matches_per_channel_prologues(m, window, roi, M):
    """One prologue over a (C, M) batch of channels at different offsets
    against one prologue per channel: deltas, offsets and delaylines
    exactly, carries and accumulators at the f32 class (4 * eps32 * the
    samples each has summed); shapes (C, nt*K) and (C, nt, m, 2)."""
    _, tp = _plans(m, window=window, roi=roi)
    C = 3
    st, ran = _desynchronized(tp, C, seed=m)
    assert len(set(st.offset.tolist())) == C
    x = torch.as_tensor(_signal(C * M, seed=M).reshape(C, M))
    pro = spectra.spectra_prologue(tp, st, x)
    nt = -(-M // spectra.TILE_K)
    assert tuple(pro.delta.shape) == (C, nt * spectra.TILE_K)
    assert tuple(pro.c0.shape) == (C, nt, m, 2) and pro.lead == (C, M)
    bound = 4 * np.finfo(np.float32).eps * (M + ran)
    for c in range(C):
        one = spectra.spectra_prologue(tp, batch_state(st, c), x[c])
        assert one.lead == (M,) and tuple(one.c0.shape) == (1, nt, m, 2)
        assert torch.equal(pro.delta[c], one.delta[0])
        assert torch.equal(pro.phase, one.phase)
        np.testing.assert_allclose(pro.c0[c].numpy(), one.c0[0].numpy(), rtol=0, atol=bound)
        assert int(pro.state.offset[c]) == int(one.state.offset)
        assert torch.equal(pro.state.delayline[c], one.state.delayline)
        np.testing.assert_allclose(pro.state.accumulator[c].numpy(),
                                   one.state.accumulator.numpy(), rtol=0, atol=bound)


def test_prologue_refuses_mismatched_batching():
    _, tp = _plans(256)
    x = torch.as_tensor(_signal(200).reshape(2, 100))
    with pytest.raises(ValueError, match="batched"):
        spectra.spectra_prologue(tp, T.init_state(tp, device="cpu"), x)
    with pytest.raises(ValueError, match="batched"):
        spectra.spectra_prologue(tp, T.init_state(tp, channels=2, device="cpu"), x[0])


@pytest.mark.parametrize("m,window,roi,M", CHANNEL_CASES[:3])
@pytest.mark.parametrize("form", ["packed", "planar", "planar bf16", "power", "power bf16"])
def test_batched_k1_plain_matches_jax_vmapped_kernel(m, window, roi, M, form):
    """The batched plain K1 (one prologue, one call) on channels at
    different offsets against the JAX package's vmap over
    ``forward_block_pallas``/``forward_block_power`` in interpret mode:
    atol 2e-6, rtol 1e-4 (bf16 planes: one bf16 rounding, rtol 2^-7);
    accumulators within 4 * eps32 * samples."""
    jp, tp = _plans(m, window=window, roi=roi)
    C = 3
    st, ran = _desynchronized(tp, C, seed=m + 1)
    x = _signal(C * M, seed=M + 1).reshape(C, M)
    kind, *dt = form.split()
    dtype = "bfloat16" if dt else None
    if kind == "power":
        js, jd = _vmapped(lambda s, v: forward_block_power(jp, s, v, interpret=True,
                                                           out_dtype=dtype), _jax_state(st), x)
        ts, td = T.sdft_power(tp, st, x, dtype)
    else:
        js, jd = _vmapped(lambda s, v: forward_block_pallas(
            jp, s, v, interpret=True, layout=kind, out_dtype=dtype), _jax_state(st), x)
        ts, td = T.sdft(tp, st, x, kind, dtype)
    rtol = 2.0**-7 if dtype else 1e-4
    for g, w in zip(td if isinstance(td, tuple) else (td,), jd if isinstance(jd, tuple) else (jd,)):
        assert tuple(g.shape) == tuple(np.shape(w))
        np.testing.assert_allclose(g.float().numpy(), np.asarray(w, np.float32),
                                   atol=2e-6, rtol=rtol)
    np.testing.assert_allclose(ts.accumulator.numpy(), np.asarray(js.accumulator),
                               rtol=0, atol=4 * np.finfo(np.float32).eps * (M + ran))
    np.testing.assert_array_equal(ts.offset.numpy(), np.asarray(js.offset))


@pytest.mark.parametrize("m,window,latency,roi,refresh_every", [
    (256, "hann", 1.0, None, 1),
    (250, "blackman", 0.5, (4, 200), 2),
    (130, "boxcar", 0.5, None, None),
])
def test_batched_k2_plain_matches_jax_vmapped_hop1_chain(m, window, latency, roi,
                                                         refresh_every):
    """The hop=1 chain on a (nb, C, B) batch, one plain K2 call per block,
    against the JAX package's hop=1 chain, whose body vmaps
    ``forward_and_y_pallas`` over the channels (sdft_tpu/ops/lti.py:968-970),
    in interpret mode: spectra at that kernel's class (1.5e-5 of scale,
    tests/test_tpu.py:411-417) and within atol 2e-6, rtol 1e-4 of the vmapped
    K1 on the same blocks; samples against the JAX chain in float64 at
    1e-5 (the JAX f32 kernel's own y lies 2e-5 from float64 here)."""
    jp, tp = _plans(m, window=window, latency=latency, roi=roi)
    C, nb, B = 3, 2, 300
    xs = _signal(nb * C * B, seed=m + 2).reshape(nb, C, B)
    js, jhd, _ = _chain_hop1_pallas_jit(jp, J.init_state(jp, channels=C), xs,
                                        refresh_every, True)
    ts, thd, tys = T.roundtrip_hopped(tp, T.init_state(tp, channels=C, device="cpu"), xs, 1,
                                      refresh_every=refresh_every)
    assert tuple(thd.shape) == (nb, C, B, m, 2) and tuple(tys.shape) == (nb, C, B)
    jhd = np.asarray(jhd)
    assert np.abs(thd.numpy() - jhd).max() <= 1.5e-5 * np.abs(jhd).max()
    _, jd = _vmapped(lambda s, v: forward_block_pallas(jp, s, v, interpret=True),
                     J.init_state(jp, channels=C), xs[0])
    np.testing.assert_allclose(thd[0].numpy(), np.asarray(jd), atol=2e-6, rtol=1e-4)
    p64 = J.Plan(m, window=window, latency=latency, roi=roi,
                 precision=J.Precision("float64", "float64"))
    _, _, ys64 = J.roundtrip_hopped(p64, J.init_state(p64, channels=C), xs.astype(np.float64),
                                    1, refresh_every=refresh_every)
    np.testing.assert_allclose(tys.numpy(), np.asarray(ys64), rtol=0, atol=1e-5)
    np.testing.assert_allclose(ts.accumulator.numpy(), np.asarray(js.accumulator), rtol=0,
                               atol=4 * np.finfo(np.float32).eps * nb * B)


@pytest.mark.parametrize("call", ["sdft", "sdft planar bf16", "sdft_power", "forward_and_y",
                                  "fused", "roundtrip transform"])
def test_one_channel_batch_equals_the_unbatched_call_bit_for_bit(call):
    """A (1, M) batch runs the same ops on the same shapes as the (M,)
    block, so each output and the state equal the unbatched call's bit for
    bit."""
    _, tp = _plans(250, window="blackman", latency=0.5, roi=(3, 240))
    x = torch.as_tensor(_signal(2 * 128 + 37, seed=7))
    st1, _ = T.sdft(tp, T.init_state(tp, device="cpu"), torch.as_tensor(_signal(99, 8)))
    stb = State(*(a[None] for a in st1))
    fns = {"sdft": lambda s, v: T.sdft(tp, s, v),
           "sdft planar bf16": lambda s, v: T.sdft(tp, s, v, "planar", "bfloat16"),
           "sdft_power": lambda s, v: T.sdft_power(tp, s, v),
           "forward_and_y": lambda s, v: scan.forward_and_y(tp, s, v),
           "fused": lambda s, v: scan.roundtrip_block_fused(tp, s, v),
           "roundtrip transform": lambda s, v: T.roundtrip(tp, s, v, transform=lambda z: z * 0.5)}
    one, batch = fns[call](st1, x), fns[call](stb, x[None])
    for a, b in zip(graphs.leaves(one), graphs.leaves(batch)):
        assert tuple(b.shape) == (1, *a.shape)
        assert torch.equal(b[0], a)


# -- on the card: each kernel against its plain version ------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("m,window,roi,M", [(256, "boxcar", None, 300),
                                            (1000, "blackman", (3, 900), 4000),
                                            (8191, "hann", None, 256)])
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
    # y: the chunks' partial rows are added in another order than the
    # plain version's matmul
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
    (2^-8 relative) on top, y 1e-5 (the chunks' sums in another order).
    Packed f32 equals planar f32 bit for bit, and K2's spectra equal K1's
    packed f32 bit for bit; power f32 equals re*re + im*im of the planar
    f32 output to 1 ulp."""
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
            assert torch.equal(dk, packed)  # K2's bins run K1's recurrence and stencil
            k2_packed = dk
        elif layout == "planar":
            assert torch.equal(dk[0], k2_packed[..., 0]) and torch.equal(dk[1], k2_packed[..., 1])
        torch.testing.assert_close(yk, yr, atol=1e-5, rtol=0.0)
    torch.cuda.synchronize()


@pytest.mark.cuda
@pytest.mark.parametrize("window,roi,C,M", [("hann", None, 8, 44100),
                                            ("blackman", None, 3, 2 * 128 + 37),
                                            ("boxcar", (3, 995), 3, 777),
                                            ("hann", (0, 100), 1, 300)])
def test_cuda_paced_k1_equals_the_unpaced_launch_bit_for_bit(cuda_device, window, roi, C, M):
    """At m = 1000 the paced forms run K1 as paced clusters, one paced
    launch a call, and write bit for bit what the unpaced launch writes:
    the spectra cell's 8 x 44100 block, a ragged C = 3 batch (M no multiple
    of the tile, so warps of the last group run a tile past the end) and
    restricted ROIs.  The other forms launch unpaced, and the C entry
    refuses to pace them."""
    tp = T.Plan(1000, window=window, roi=roi, precision=T.FAST_PRECISION)
    x = torch.as_tensor(_signal(C * M, 7).reshape(C, M), device=cuda_device)
    pro = spectra.spectra_prologue(tp, T.init_state(tp, channels=C, device=cuda_device), x)
    for form, dtype in spectra.STORES:
        paced = (form, dtype) in spectra.PACED_FORMS
        assert spectra.paced(1000, form, dtype) is paced
        before = spectra.LAUNCHES, spectra.PACED_LAUNCHES
        got = spectra.launch_spectra(tp, pro, form, dtype)
        assert (spectra.LAUNCHES - before[0], spectra.PACED_LAUNCHES - before[1]) == (1, paced)
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(spectra, "paced", lambda *args: not paced)
            if not paced:
                with pytest.raises(RuntimeError, match="sdft_spectra_launch"):
                    spectra.launch_spectra(tp, pro, form, dtype)
                continue
            want = spectra.launch_spectra(tp, pro, form, dtype)
        assert (spectra.LAUNCHES - before[0], spectra.PACED_LAUNCHES - before[1]) == (2, 1)
        for a, b in zip(got if isinstance(got, tuple) else (got,),
                        want if isinstance(want, tuple) else (want,)):
            assert torch.equal(a, b), (form, dtype)
        del got, want
    torch.cuda.synchronize()


@pytest.mark.cuda
@pytest.mark.parametrize("m,window,M", [(1000, "hann", 8000), (4096, "blackman", 2 * 128 + 37),
                                        (129, "boxcar", 777), (1000, "hann", 44100)])
def test_cuda_k2_y_is_deterministic(cuda_device, m, window, M):
    """Two K2 launches on the same inputs give the same y and spectra bit
    for bit (the chunks' partial rows are added in a fixed order), on one
    channel and on a batch."""
    tp = T.Plan(m, window=window, precision=T.FAST_PRECISION)
    st, _ = T.sdft(tp, T.init_state(tp, device=cuda_device),
                   torch.as_tensor(_signal(333, 1), device=cuda_device))
    pro = spectra.spectra_prologue(tp, st, torch.as_tensor(_signal(M, 2), device=cuda_device))
    synth = scan.synthesis_row(tp, cuda_device)
    runs = [scan.launch_scan(tp, pro, synth, "packed") for _ in range(3)]
    for d, y in runs[1:]:
        assert torch.equal(y, runs[0][1]) and torch.equal(d, runs[0][0])
    _, y_only = scan.launch_scan(tp, pro, synth, None)
    assert torch.equal(y_only, runs[0][1])
    # and on a (C=3, M) batch, one launch each time
    xs = torch.as_tensor(_signal(3 * M, 3).reshape(3, M), device=cuda_device)
    prob = spectra.spectra_prologue(tp, T.init_state(tp, channels=3, device=cuda_device), xs)
    runs = [scan.launch_scan(tp, prob, synth, "packed") for _ in range(3)]
    for d, y in runs[1:]:
        assert torch.equal(y, runs[0][1]) and torch.equal(d, runs[0][0])
    assert torch.equal(scan.launch_scan(tp, prob, synth, None)[1], runs[0][1])
    torch.cuda.synchronize()


@pytest.mark.cuda
def test_cuda_k2_at_the_hop1_cells_block(cuda_device):
    """The hop-1 chain cell's block, 8 x 44100 at m = 1000, Hann, in one
    launch: spectra within 2e-6 of the plain version and bit for bit K1's
    packed spectra on the same prologue (each bin runs the same recurrence
    and stencil in both), y within 1e-5 of the plain version; planar equals
    packed and y is the same in every form."""
    tp = T.Plan(1000, window="hann", precision=T.FAST_PRECISION)
    x = torch.as_tensor(_signal(8 * 44100, 6).reshape(8, 44100), device=cuda_device)
    pro = spectra.spectra_prologue(tp, T.init_state(tp, channels=8, device=cuda_device), x)
    synth = scan.synthesis_row(tp, cuda_device)
    dk, yk = scan.launch_scan(tp, pro, synth, "packed")
    assert torch.equal(dk, spectra.launch_spectra(tp, pro, "packed", "float32"))
    dr, yr = scan.forward_and_y_reference(tp, pro, synth, "packed")
    torch.testing.assert_close(dk, dr, atol=2e-6, rtol=0.0)
    torch.testing.assert_close(yk, yr, atol=1e-5, rtol=0.0)
    del dr
    (re_, im_), yp = scan.launch_scan(tp, pro, synth, "planar")
    assert torch.equal(re_, dk[..., 0]) and torch.equal(im_, dk[..., 1])
    assert torch.equal(yp, yk) and torch.equal(scan.launch_scan(tp, pro, synth, None)[1], yk)
    torch.cuda.synchronize()


@pytest.mark.cuda
def test_cuda_sharded_hop1_round_trip_repeats_bit_for_bit(cuda_device, tmp_path):
    """sharded_roundtrip_pallas (one K2 launch per block on the one-rank
    NCCL mesh) run twice over the same chained blocks gives the same
    spectra and samples bit for bit."""
    import torch.distributed as dist

    from sdft_tpu_torch import parallel as par

    par.multihost.initialize(f"file://{tmp_path}/group", 1, 0)
    try:
        mesh = par.make_mesh(1, 1, 1)
        tp = T.Plan(1000, window="hann", precision=T.FAST_PRECISION)
        xs = torch.as_tensor(_signal(3 * 8000, 4), device=cuda_device).reshape(3, 1, 8000)

        def chain():
            st, outs = T.init_state(tp, channels=1, device=cuda_device), []
            for x in xs:
                st, d, y = par.sharded_roundtrip_pallas(tp, mesh, st, x)
                outs += [d.to_local(), y.to_local()]
            return outs + [st.accumulator.to_local()]

        launches = scan.LAUNCHES
        first, second = chain(), chain()
        assert scan.LAUNCHES - launches == 6
        assert all(torch.equal(a, b) for a, b in zip(first, second))
    finally:
        dist.destroy_process_group()


@pytest.mark.cuda
@pytest.mark.parametrize("m,window", [(1000, "hann"), (129, "blackman")])
def test_cuda_channel_batch_equals_per_channel_launches(cuda_device, m, window):
    """A (C=3, M) batch of channels at different offsets is one K1 launch
    per call, and one K2 launch: each store form and K2's spectra and y
    equal, channel by channel, a C = 1 launch on that channel's slice of the
    same prologue bit for bit.  Against the per-channel API calls the batch
    is held at the f32 class (2e-6 of scale, accumulators 4 * eps32 *
    samples): its totals GEMM on (C*nt, K) rows may take another cuBLAS
    algorithm than one channel's (nt, K)."""
    tp = T.Plan(m, window=window, latency=0.5, precision=T.FAST_PRECISION)
    C, M = 3, 777
    sts = [T.sdft(tp, T.init_state(tp, device=cuda_device),
                  torch.as_tensor(_signal(37 * c + 11, 4 + c), device=cuda_device))[0]
           for c in range(C)]
    st0 = stack_states(sts)
    x = torch.as_tensor(_signal(C * M, 5).reshape(C, M), device=cuda_device)
    pro = spectra.spectra_prologue(tp, st0, x)
    for form, dtype in spectra.STORES:
        before = spectra.LAUNCHES
        out = spectra.launch_spectra(tp, pro, form, dtype)
        assert spectra.LAUNCHES == before + 1
        for c in range(C):
            oc = spectra.launch_spectra(tp, pro.channel(c), form, dtype)
            for a, b in zip(out if isinstance(out, tuple) else (out,),
                            oc if isinstance(oc, tuple) else (oc,)):
                assert torch.equal(a[c], b), (form, dtype, c)
    synth = scan.synthesis_row(tp, cuda_device)
    for layout in ("packed", "planar", None):
        before = scan.LAUNCHES
        dk, yk = scan.launch_scan(tp, pro, synth, layout)
        assert scan.LAUNCHES == before + 1 and tuple(yk.shape) == (C, M)
        for c in range(C):
            d1, y1 = scan.launch_scan(tp, pro.channel(c), synth, layout)
            assert torch.equal(yk[c], y1), (layout, c)
            if layout:
                assert all(torch.equal(a[c], b) for a, b in zip(
                    dk if layout == "planar" else (dk,), d1 if layout == "planar" else (d1,)))
    calls = {"packed": lambda s, v: T.sdft(tp, s, v),
             "planar": lambda s, v: T.sdft(tp, s, v, "planar"),
             "planar bf16": lambda s, v: T.sdft(tp, s, v, "planar", "bfloat16"),
             "power": lambda s, v: T.sdft_power(tp, s, v),
             "power bf16": lambda s, v: T.sdft_power(tp, s, v, "bfloat16")}
    for name, call in calls.items():
        before = spectra.LAUNCHES
        st, out = call(st0, x)
        assert spectra.LAUNCHES == before + 1, name
        for c in range(C):
            sc, oc = call(sts[c], x[c])
            for a, b in zip(out if isinstance(out, tuple) else (out,),
                            oc if isinstance(oc, tuple) else (oc,)):
                scale = b.float().abs().max().item()
                rtol = 2.0**-7 if "bf16" in name else 0.0
                torch.testing.assert_close(a[c].float(), b.float(), atol=2e-6 * scale, rtol=rtol)
            torch.testing.assert_close(st.accumulator[c], sc.accumulator, rtol=0,
                                       atol=4 * np.finfo(np.float32).eps * (M + 100))
    torch.cuda.synchronize()


# -- on the card: the carry kernel against ops.carry.carry -----------------------------

CARRY_M = [128, 1000, 1001, 4096, 8191]
CARRY_PLANS = [("boxcar", None), ("hann", "inner"), ("blackman", None),
               ("boxcar", "low"), ("hann", None), ("blackman", "inner")]


def _carry_inputs(m, window, roi, C, M, dev, lead=333):
    """A plan, a (C,) batched state after ``lead`` samples of the plain
    front with each channel moved to its own offset, (C, M) samples and the
    kernels' fine table, all on ``dev``."""
    roi = {None: None, "inner": (3, m - 5), "low": (0, 100)}[roi]
    tp = T.Plan(m, window=window, roi=roi, precision=T.FAST_PRECISION)
    fine, _ = spectra._spectra_tables(tp, spectra.TILE_K, dev)
    xs = torch.as_tensor(_signal(C * (lead + M), C).reshape(C, lead + M), device=dev)
    _, _, st = carry.carry(tp, T.init_state(tp, channels=C, device=dev), xs[:, :lead], fine)
    offsets = [(lead + 611 * c) % (2 * m) for c in range(C)]
    st = State(torch.tensor(offsets, dtype=torch.int32, device=dev), st.delayline.contiguous(),
               st.accumulator)
    return tp, st, xs[:, lead:].contiguous(), fine


@pytest.mark.cuda
@pytest.mark.parametrize("m", CARRY_M)
@pytest.mark.parametrize("C", [1, 8])
@pytest.mark.parametrize("M", ["1", "100", "2m-1", "44100"])
def test_cuda_carry_kernel_matches_the_plain_front(cuda_device, m, C, M):
    """The carry kernel against ``ops.carry.carry`` on the card, with each
    window and with and without a ROI, every channel at its own offset:
    the deltas, the next delayline and offset bit for bit; c0 and the end
    accumulator within 4 * eps32 * (samples so far + M) (the totals and the
    prefix are summed in another order than the GEMM and the cumsums)."""
    M = {"1": 1, "100": 100, "2m-1": 2 * m - 1, "44100": 44100}[M]
    for window, roi in CARRY_PLANS:
        tp, st, x, fine = _carry_inputs(m, window, roi, C, M, cuda_device)
        dt, c0, want = carry.carry(tp, st, x, fine)
        before = carry_kernel.LAUNCHES
        delta, c0k, got = carry_kernel.launch_carry(tp, st, x, fine)
        assert carry_kernel.LAUNCHES == before + 1
        assert torch.equal(delta, dt.reshape(C, -1)), (window, roi)
        assert torch.equal(got.delayline, want.delayline) and torch.equal(got.offset, want.offset)
        bound = 4 * np.finfo(np.float32).eps * (333 + M)
        torch.testing.assert_close(c0k, torch.view_as_real(c0), rtol=0, atol=bound)
        torch.testing.assert_close(got.accumulator, want.accumulator, rtol=0, atol=bound)
    torch.cuda.synchronize()


@pytest.mark.cuda
@pytest.mark.parametrize("m,C,M", [(1000, 8, 44100), (8191, 1, 300), (129, 3, 777)])
def test_cuda_carry_kernel_repeats_bit_for_bit(cuda_device, m, C, M):
    """Five launches on the same inputs give the same c0 and end
    accumulator bit for bit (every output has one writer, summed in a fixed
    order), and ``spectra_prologue`` is that launch, an unbatched block as
    C = 1."""
    tp, st, x, fine = _carry_inputs(m, "hann", None, C, M, cuda_device)
    runs = [carry_kernel.launch_carry(tp, st, x, fine) for _ in range(5)]
    for delta, c0, end in runs[1:]:
        assert torch.equal(c0, runs[0][1]) and torch.equal(end.accumulator, runs[0][2].accumulator)
        assert torch.equal(delta, runs[0][0])
    pro = spectra.spectra_prologue(tp, st, x)
    assert torch.equal(pro.c0, runs[0][1]) and torch.equal(pro.delta, runs[0][0])
    one = spectra.spectra_prologue(tp, batch_state(st, 0), x[0])
    assert torch.equal(one.c0, runs[0][1][:1]) and one.state.accumulator.shape == (m, 2)
    assert torch.equal(one.state.accumulator, runs[0][2].accumulator[0])
    torch.cuda.synchronize()


@pytest.mark.cuda
def test_cuda_carry_kernel_takes_more_channels_than_a_grid_axis(cuda_device):
    """65537 channels, more than the grid's channel axis takes (65535):
    the entry launches once per 65535 channels, each on its own slices, and
    the result is the plain front's, as at any C."""
    m, C, M = 128, 65537, 100
    tp, st, x, fine = _carry_inputs(m, "hann", None, C, M, cuda_device)
    dt, c0, want = carry.carry(tp, st, x, fine)
    delta, c0k, got = carry_kernel.launch_carry(tp, st, x, fine)
    assert torch.equal(delta, dt.reshape(C, -1))
    assert torch.equal(got.delayline, want.delayline) and torch.equal(got.offset, want.offset)
    bound = 4 * np.finfo(np.float32).eps * (333 + M)
    torch.testing.assert_close(c0k, torch.view_as_real(c0), rtol=0, atol=bound)
    torch.testing.assert_close(got.accumulator, want.accumulator, rtol=0, atol=bound)
    torch.cuda.synchronize()


@pytest.mark.cuda
def test_cuda_carry_kernel_launches_once_a_replay(cuda_device):
    """The prologue's graph captures one carry launch, and each replay adds
    it to ``counters()``."""
    from sdft_tpu_torch import tracing

    tp = T.Plan(1000, window="hann", precision=T.FAST_PRECISION)
    st = T.init_state(tp, channels=2, device=cuda_device)
    x = torch.as_tensor(_signal(2 * 5000, 6).reshape(2, 5000), device=cuda_device)
    spectra.prologue(tp, st, x)
    (entry,) = [e for e in graphs.entries() if e.name == "spectra_prologue"
                and e.key[1] == (tp,) and e.key[2][-1][0] == (2, 5000)]
    assert entry.launches == {"carry": 1}
    before = tracing.counters()["kernels.carry.launches"]
    for _ in range(3):
        spectra.prologue(tp, st, x)
    assert tracing.counters()["kernels.carry.launches"] - before == 3
    torch.cuda.synchronize()
