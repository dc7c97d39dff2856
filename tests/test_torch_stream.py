"""The port's Streamer against ``sdft_tpu.stream`` (mirrors tests/test_stream.py
case by case): chunk invariance, checkpoint/resume within and across the
two packages, the transform hooks and the chained driver protocol.

Float64 plans, the same seeded numpy inputs in both packages on the CPU,
gated at 1e-12 absolute (the JAX cases' own tolerance).  ``Streamer.run``'s
unsynchronized copy back runs only on a CUDA device (``-m cuda``).
"""

import numpy as np
import pytest
import torch

import sdft_tpu as J
import sdft_tpu_torch as T
from sdft_tpu.cplx import from_complex as j_from_complex
from sdft_tpu.cplx import to_complex as j_to_complex
from sdft_tpu.stream import Streamer as JStreamer
from sdft_tpu.stream import iter_blocks as j_iter_blocks
from sdft_tpu_torch.stream import Streamer, iter_blocks

F64 = J.Precision(td="float64", fd="float64")
TOL = 1e-12


def _signal(n, seed=0):
    return np.clip(np.random.default_rng(seed).standard_normal(n), -1, 1)


def _plans(m, precision=F64, **kw):
    jp = J.Plan(m, precision=precision, **kw)
    return jp, T.plan_from_jax(jp)


def _np(a):
    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def test_streamer_roundtrip_matches_batch():
    m = 32
    n = 12 * m
    x = _signal(n)
    jp, tp = _plans(m)
    _, dfts = J.sdft(jp, J.init_state(jp), x)
    want = np.asarray(J.isdft(jp, dfts))

    streamer = Streamer(tp, device="cpu")
    got = list(streamer.run(iter_blocks(x, 96)))
    assert all(isinstance(b, np.ndarray) for b in got)
    np.testing.assert_allclose(np.concatenate(got), want, atol=TOL)
    assert streamer.samples_processed == n
    js = JStreamer(jp)
    np.testing.assert_allclose(np.concatenate(got),
                               np.concatenate(list(js.run(j_iter_blocks(x, 96)))), atol=TOL)
    np.testing.assert_allclose(_np(streamer.state.accumulator),
                               np.asarray(js.state.accumulator), atol=TOL)


def test_streamer_checkpoint_resume(tmp_path):
    m = 16
    x = _signal(8 * m, seed=1)
    jp, tp = _plans(m)
    half = x.size // 2

    ref = Streamer(tp, device="cpu")
    want = [_np(ref.process(b)) for b in iter_blocks(x, 32)]
    jref = JStreamer(jp)
    np.testing.assert_allclose(
        np.concatenate(want),
        np.concatenate([np.asarray(jref.process(b)) for b in j_iter_blocks(x, 32)]),
        atol=TOL)

    a = Streamer(tp, device="cpu")
    got_first = [_np(a.process(b)) for b in iter_blocks(x[:half], 32)]
    ckpt = tmp_path / "state.npz"
    a.checkpoint(ckpt)

    b = Streamer(tp, device="cpu")
    b.restore(ckpt)
    assert b.samples_processed == half
    got_second = [_np(b.process(blk)) for blk in iter_blocks(x[half:], 32)]

    np.testing.assert_allclose(np.concatenate(got_first + got_second),
                               np.concatenate(want), atol=0)
    b.reset()
    assert b.samples_processed == 0 and int(b.state.offset) == 0
    assert not b.state.delayline.any()


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_checkpoint_crosses_packages(tmp_path, direction):
    """A checkpoint written by one package's Streamer restores in the other's
    and continues the stream: the second half equals the uninterrupted run."""
    m = 24
    x = _signal(10 * m, seed=4)
    jp, tp = _plans(m, window="hamming", latency=0.5)
    half = 5 * m
    want = np.concatenate(list(JStreamer(jp).run(j_iter_blocks(x, 40))))
    ckpt = tmp_path / "state.npz"
    if direction == "jax_to_port":
        first = JStreamer(jp)
        list(first.run(j_iter_blocks(x[:half], 40)))
        first.checkpoint(ckpt)
        second = Streamer(tp, device="cpu")
    else:
        first = Streamer(tp, device="cpu")
        list(first.run(iter_blocks(x[:half], 40)))
        first.checkpoint(ckpt)
        second = JStreamer(jp)
    second.restore(ckpt)
    assert second.samples_processed == half
    got = np.concatenate([_np(y) for y in second.run(iter_blocks(x[half:], 40))])
    np.testing.assert_allclose(got, want[half:], atol=TOL)
    with np.load(ckpt) as data:
        assert sorted(data.files) == ["accumulator", "delayline", "offset",
                                      "samples_processed"]


def test_streamer_multichannel_and_transform():
    m = 16
    C = 2
    x = np.stack([_signal(6 * m, seed=2), _signal(6 * m, seed=3)])
    jp, tp = _plans(m)

    streamer = Streamer(tp, channels=C, device="cpu")
    # spectral transform: zero everything -> output must be zero
    out = np.concatenate(
        list(streamer.run(iter_blocks(x, 48), transform=lambda d: d * 0)), axis=-1)
    assert out.shape == x.shape
    np.testing.assert_array_equal(out, np.zeros_like(out))
    # the identity transform on packed spectra equals the JAX stream
    s2 = Streamer(tp, channels=C, device="cpu")
    got = np.concatenate(list(s2.run(iter_blocks(x, 48), transform=lambda d: d)), axis=-1)
    want = np.concatenate(list(JStreamer(jp, channels=C).run(
        j_iter_blocks(x, 48), transform=lambda d: d)), axis=-1)
    np.testing.assert_allclose(got, want, atol=TOL)


def test_iter_blocks_pad_and_truncate():
    x = np.arange(10.0)
    assert [b.shape[-1] for b in iter_blocks(x, 4)] == [4, 4]
    padded = list(iter_blocks(x, 4, pad=True))
    assert [b.shape[-1] for b in padded] == [4, 4, 4]
    np.testing.assert_array_equal(padded[-1], [8, 9, 0, 0])
    x2 = np.arange(22.0).reshape(2, 11)
    for pad in (False, True):
        for got, want in zip(iter_blocks(x2, 4, pad), j_iter_blocks(x2, 4, pad),
                             strict=True):
            np.testing.assert_array_equal(got, want)


def test_streamer_fused_transform_matches_host_transform():
    """run(fuse_transform=True) with a complex transform inside
    api.roundtrip equals the packed-transform path, and both equal JAX."""
    from sdft_tpu_torch.cplx import from_complex, to_complex

    m = 32
    jp, tp = _plans(m, window="hann", precision=J.DEFAULT_PRECISION)
    rng = np.random.default_rng(19)
    x = (rng.standard_normal(8 * m) * 0.25).clip(-1, 1)
    blocks = [x[i:i + 2 * m] for i in range(0, x.size, 2 * m)]
    mask = (np.arange(m) < m // 2).astype(np.float64)

    def fused(z):  # complex (M, m) tensor inside api.roundtrip
        return z * torch.as_tensor(mask, device=z.device)

    def hosty(d):  # packed (M, m, 2) at the boundary
        return from_complex(to_complex(d) * mask)

    s1 = Streamer(tp, device="cpu")
    got = np.concatenate(list(s1.run(blocks, transform=fused, fuse_transform=True)))
    s2 = Streamer(tp, device="cpu")
    want = np.concatenate(list(s2.run(blocks, transform=hosty)))
    np.testing.assert_allclose(got, want, atol=1e-9)
    np.testing.assert_allclose(_np(s1.state.accumulator), _np(s2.state.accumulator),
                               atol=TOL)
    js = JStreamer(jp)
    jwant = np.concatenate(list(js.run(
        blocks, transform=lambda d: j_from_complex(j_to_complex(np.asarray(d)) * mask))))
    np.testing.assert_allclose(want, jwant, atol=TOL)
    np.testing.assert_allclose(_np(s2.state.accumulator), np.asarray(js.state.accumulator),
                               atol=TOL)


def test_fused_and_packed_transforms_share_the_kernel_spectra():
    """For a plan the kernels take, api.roundtrip(transform) reads its
    spectra from the K1 wrapper, as sdft does, so the two transform paths of
    run() agree bit for bit; both match the JAX Streamer at the float32
    round-trip class (atol 1e-5, tests/test_torch_lti.py)."""
    jp, tp = _plans(128, precision=J.FAST_PRECISION, window="blackman")
    x = (np.random.default_rng(23).standard_normal(4 * 256) * 0.25).clip(-1, 1)
    blocks = list(x.astype(np.float32).reshape(4, 256))
    mask = torch.arange(128) < 40
    fused = list(Streamer(tp, device="cpu").run(blocks, transform=lambda z: z * mask,
                                                fuse_transform=True))
    packed = list(Streamer(tp, device="cpu").run(blocks,
                                                 transform=lambda d: d * mask[:, None]))
    for f, p in zip(fused, packed, strict=True):
        np.testing.assert_array_equal(f, p)
    jmask = np.asarray(mask)
    want = list(JStreamer(jp).run(blocks, transform=lambda z: z * jmask, fuse_transform=True))
    np.testing.assert_allclose(np.concatenate(fused), np.concatenate(want), atol=1e-5)


def test_streamer_fused_transform_requires_default_ops():
    s = Streamer(T.Plan(16), device="cpu")
    with pytest.raises(ValueError, match="fuse_transform"):
        list(s.run([np.zeros(32)], fuse_transform=True))
    s = Streamer(T.Plan(16), forward=lambda st, x: T.sdft(T.Plan(16), st, x), device="cpu")
    with pytest.raises(ValueError, match="fuse_transform"):
        list(s.run([np.zeros(32)], transform=lambda z: z, fuse_transform=True))


def test_run_hopped_chained_matches_unchained():
    """run_hopped (grouped chains) equals the per-block hopped analysis +
    round trip for every group size, and the JAX Streamer's run_hopped."""
    jp, tp = _plans(80)
    hop, B = 10, 80
    rng = np.random.default_rng(9)
    x = np.clip(rng.standard_normal(7 * B), -3, 3) / 2

    ref_state = T.init_state(tp, device="cpu")
    want = []
    for blk in iter_blocks(x, B):
        _, hd = T.sdft_hopped(tp, ref_state, blk, hop)
        ref_state, y = T.roundtrip(tp, ref_state, blk)
        want.append((_np(hd), _np(y)))
    jwant = list(JStreamer(jp).run_hopped(j_iter_blocks(x, B), hop, chain=3))

    for chain in (1, 3, 16):
        s = Streamer(tp, refresh_every=2, device="cpu")
        got = list(s.run_hopped(iter_blocks(x, B), hop, chain=chain))
        assert len(got) == len(want)
        for (hd_g, y_g), (hd_w, y_w) in zip(got, want):
            np.testing.assert_allclose(hd_g, hd_w, atol=TOL)
            np.testing.assert_allclose(y_g, y_w, atol=TOL)
        assert s.samples_processed == x.size
    for (hd_g, y_g), (hd_j, y_j) in zip(got, jwant, strict=True):
        np.testing.assert_allclose(hd_g, hd_j, atol=TOL)
        np.testing.assert_allclose(y_g, y_j, atol=TOL)


@pytest.mark.parametrize("chain", [1, 3, 16])
def test_run_hopped_yields_a_chain_once_the_next_is_queued(chain):
    """run_hopped yields bit for bit what one roundtrip_hopped call a chain
    gives (7 blocks: the last chain short at 3 and 16), yields chain k's
    blocks only once chain k+1's blocks were pulled and its samples
    counted (the last chain once the input ended), and counts every
    sample."""
    tp = T.Plan(80, window="hann", precision=T.Precision("float32", "float32"))
    hop, B, nb = 10, 80, 7
    xs = (np.random.default_rng(11).standard_normal((nb, 2, B)).clip(-3, 3) / 2
          ).astype(np.float32)
    state, want = T.init_state(tp, 2, device="cpu"), []
    for k in range(0, nb, chain):
        state, hd, ys = T.roundtrip_hopped(tp, state, torch.as_tensor(xs[k:k + chain]), hop,
                                           refresh_every=2)
        want += zip(_np(hd), _np(ys))
    pulled = 0

    def feed():
        nonlocal pulled
        for x in xs:
            pulled += 1
            yield x

    s = Streamer(tp, channels=2, refresh_every=2, device="cpu")
    got = []
    for i, out in enumerate(s.run_hopped(feed(), hop, chain=chain)):
        assert pulled == min(nb, (i // chain + 2) * chain), (i, pulled)
        assert s.samples_processed == pulled * B
        got.append(out)
    assert len(got) == nb and s.samples_processed == nb * B
    for (hd_g, y_g), (hd_w, y_w) in zip(got, want, strict=True):
        np.testing.assert_array_equal(hd_g, hd_w)
        np.testing.assert_array_equal(y_g, y_w)
    np.testing.assert_array_equal(_np(s.state.accumulator), _np(state.accumulator))


def test_refresh_cadence_matches_jax():
    """refresh_every rebuilds the accumulator on the same blocks in both
    packages (and restarts at a restore)."""
    jp, tp = _plans(32, precision=J.FAST_PRECISION)
    x = _signal(8 * 64, seed=5).astype(np.float32)
    s, js = Streamer(tp, refresh_every=3, device="cpu"), JStreamer(jp, refresh_every=3)
    for blk in iter_blocks(x, 64):
        s.roundtrip(blk)
        js.roundtrip(blk)
        np.testing.assert_allclose(_np(s.state.accumulator), np.asarray(js.state.accumulator),
                                   atol=4 * np.finfo(np.float32).eps * 64)
    assert s._blocks_since_refresh == js._blocks_since_refresh == 2


def test_streamer_needs_a_card_unless_told_otherwise():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Streamer(T.Plan(16))
    assert Streamer(T.Plan(16), device="cpu").device == torch.device("cpu")


@pytest.mark.cuda
@pytest.mark.parametrize("channels", [None, 2])
def test_run_on_the_card_matches_cpu(channels):
    """On the card, run() copies each block back without a sync and waits
    only for the previous one; its outputs equal the CPU loop's (float64),
    none of the yielded arrays aliases another, and the state matches."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run: python -m pytest "
                    "tests/test_torch_stream.py -m cuda on the card)")
    tp = T.Plan(64, window="hann", precision=T.Precision("float64", "float64"))
    shape = (channels, 7 * 256) if channels else (7 * 256,)
    x = np.random.default_rng(3).standard_normal(shape).clip(-1, 1)
    gpu = Streamer(tp, channels=channels)
    cpu = Streamer(tp, channels=channels, device="cpu")
    got = list(gpu.run(iter_blocks(x, 256)))
    want = list(cpu.run(iter_blocks(x, 256)))
    assert len({b.__array_interface__["data"][0] for b in got}) == len(got)
    np.testing.assert_allclose(np.concatenate(got, -1), np.concatenate(want, -1), atol=1e-12)
    np.testing.assert_allclose(_np(gpu.state.accumulator), _np(cpu.state.accumulator),
                               atol=1e-12)
    mask = torch.arange(64, device="cuda") < 16
    got = list(Streamer(tp, channels=channels).run(
        iter_blocks(x, 256), transform=lambda d: d * mask[:, None]))
    want = list(Streamer(tp, channels=channels, device="cpu").run(
        iter_blocks(x, 256), transform=lambda d: d * mask.cpu()[:, None]))
    np.testing.assert_allclose(np.concatenate(got, -1), np.concatenate(want, -1), atol=1e-12)


@pytest.mark.cuda
def test_run_hopped_on_the_card_copies_home_pinned():
    """On the card, run_hopped(hop=100, chain=4) on 8 channels equals one
    roundtrip_hopped call over the same 10 blocks bit for bit; every chain
    comes home in pinned memory (``PINNED_COPIES`` counts each), and the
    arrays yielded two chains earlier still hold their values once the
    generator has moved on."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run: python -m pytest "
                    "tests/test_torch_stream.py -m cuda on the card)")
    from sdft_tpu_torch.stream import streamer

    tp = T.Plan(1000, window="hann", precision=T.FAST_PRECISION)
    hop, B, nb, chain = 100, 1600, 10, 4
    xs = (np.random.default_rng(17).standard_normal((nb, 8, B)).clip(-3, 3) / 3
          ).astype(np.float32)
    _, hd, ys = T.roundtrip_hopped(tp, T.init_state(tp, 8), torch.as_tensor(xs, device="cuda"),
                                   hop, refresh_every=1)
    hd, ys = hd.cpu().numpy(), ys.cpu().numpy()
    copies = streamer.PINNED_COPIES
    gen = Streamer(tp, channels=8, refresh_every=1).run_hopped(iter(xs), hop, chain=chain)
    got = []
    for b, (hd_b, y_b) in enumerate(gen):
        got.append((hd_b, y_b, hd_b.copy(), y_b.copy()))
        if b >= 2 * chain:      # two chains back: held by the caller alone
            old = got[b - 2 * chain]
            np.testing.assert_array_equal(old[0], old[2])
            np.testing.assert_array_equal(old[1], old[3])
    assert streamer.PINNED_COPIES - copies == -(-nb // chain)
    assert len(got) == nb
    for b, (hd_b, y_b, _, _) in enumerate(got):
        np.testing.assert_array_equal(hd_b, hd[b])
        np.testing.assert_array_equal(y_b, ys[b])
