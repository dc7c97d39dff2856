"""SPMD sharded SDFT/iSDFT over a ('channel', 'time', 'bins') mesh on
``torch.distributed`` (counterpart of ``sdft_tpu.parallel.sharded``).

Every rank runs the same program on its shard; the cross-rank traffic is
``torch.distributed`` collectives on the mesh's axis groups, and always
moves real (packed) tensors:

  * time axis  — each rank scans its contiguous sample block locally, then
    the per-rank block totals are combined into an exclusive prefix by an
    all_gather and a masked sum: the inter-block carry combine of the
    associative scan.  The predecessor's 2m-sample tail (comb-stage
    history) arrives by one send/recv to the next time rank;
  * bins axis  — rotation, scan and demodulation are bin-local; the 3/5-tap
    window convolution exchanges a 1-2 column halo with the neighbour
    shards, while the edge shards build Hermitian guards locally
    (c/src/sdft/sdft.h:589-595);
  * channel axis — independent; no collectives;
  * inverse    — bin-partial synthesis products reduced with all_reduce over
    'bins' (the reduction at c/src/sdft/sdft.h:639-653).

Inputs are ``DTensor``s with the placements below, or plain tensors and
arrays that every rank holds in full (each rank takes its shard, as
``multihost.global_array`` does).  Outputs are ``DTensor``s:
``.to_local()`` is the rank's shard, ``.full_tensor()`` gathers the whole.

Layout contracts (checked): samples (C, M) with C % mesh.channel == 0 and
M % mesh.time == 0; dftsize m % mesh.bins == 0 and m/bins > the window's
halo.  Local time blocks M/time >= 2m keep the comb exchange to one
neighbour send/recv; shorter blocks all_gather the sample blocks
(``_comb_history``).

The JAX package runs each program as one jit-compiled shard_map.  Here
each rank runs in a process of its own, and on the card each program's
per-rank body, its collectives included, replays as a CUDA graph
(``graphs``; one graph per block for the driver chain), keyed on the plan,
the mesh shape, this rank's coordinates, the global block length and the
program's static arguments.  K1 and K2 launch straight after the replay of
the kernel programs' graph, into outputs the caller owns.  The DTensor
steps around the body (taking each rank's shard, assembling the outputs)
stay outside every graph.  On the CPU and inside ``graphs.disabled()`` the
bodies run eagerly.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import DTensor, Replicate, Shard

from .. import graphs
from ..config import fp32_matmul
from ..cplx import pack, unpack
from ..kernels.scan import _scan
from ..kernels.spectra import (_check_dtype, _prefix_tiles, _spectra, kernel_supported,
                               spectra_prologue)
from ..kernels.split_mm import Split
from ..ops.convolve import convolve_padded
from ..ops.lti import (_hop_aux, _hop_consts_device, _lti_consts_device, _mm, _phase_rows,
                       _refresh_fused, _stepped_consts_device, _synthesis_mm,
                       default_k_tile, driver_sub_factor)
from ..ops.twiddle import fiddle_rows, roi_mask, synthesis_twiddles
from ..plan import Plan
from ..state import State
from ..windows import WINDOW_HALO
from .mesh import AXES
from .multihost import global_array, host_local_to_global, mesh_device

# Placements (one per mesh axis: channel, time, bins) of the batched State:
# the accumulator shards over bins, offset and delayline replicate over
# time and bins.  Spectra are packed (trailing re/im axis of 2).
STATE_SPECS = State(
    offset=(Shard(0), Replicate(), Replicate()),
    delayline=(Shard(0), Replicate(), Replicate()),
    accumulator=(Shard(0), Replicate(), Shard(1)),
)
SAMPLE_SPEC = (Shard(0), Shard(1), Replicate())
DFT_SPEC = (Shard(0), Shard(1), Shard(2))


# -- placing values on the mesh ----------------------------------------------------

def _local(mesh: DeviceMesh, x, placements) -> torch.Tensor:
    """This rank's shard of ``x``: a DTensor's local tensor (redistributed
    to ``placements`` first if it has others), or the shard
    ``multihost.global_array`` cuts from a value every rank holds in full,
    cut here by slicing (the layout contracts make every shard even)
    without building the DTensor."""
    if isinstance(x, DTensor):
        if x.device_mesh != mesh:
            raise ValueError("DTensor input lives on another mesh")
        if tuple(x.placements) != tuple(placements):
            x = x.redistribute(mesh, placements)
        return x.to_local()
    t = torch.as_tensor(x, device=mesh_device(mesh))
    for i, p in enumerate(placements):
        if isinstance(p, Shard):
            n = t.shape[p.dim] // mesh.size(i)
            t = t.narrow(p.dim, mesh.get_local_rank(i) * n, n)
    return t.contiguous()


def _local_state(mesh: DeviceMesh, state: State) -> State:
    return State(*(_local(mesh, a, p) for a, p in zip(state, STATE_SPECS)))


def _global_state(mesh: DeviceMesh, state: State) -> State:
    return State(*(host_local_to_global(mesh, p, a.contiguous())
                   for a, p in zip(state, STATE_SPECS)))


def state_sharding(mesh: DeviceMesh, state: State) -> State:
    """``state`` (a batched State every rank holds in full) placed onto the
    mesh as DTensors with ``STATE_SPECS`` (the counterpart of
    ``jax.device_put(state, state_sharding(mesh))``)."""
    return State(*(global_array(mesh, p, a) for a, p in zip(state, STATE_SPECS)))


# -- collectives -------------------------------------------------------------------

class _Axes(NamedTuple):
    """This rank's coordinates and the axis groups it talks on."""

    nc: int                    # channel shards
    d: int                     # time coordinate
    nt: int                    # time shards
    time: dist.ProcessGroup
    b: int                     # bins coordinate
    nb: int                    # bin shards
    bins: dist.ProcessGroup

    def key(self) -> tuple:
        """What a graph of this rank's body depends on besides the plan and
        the program's arguments: the mesh shape, this rank's time and bins
        coordinates, and the identity of each axis group whose collectives
        it captures (those of more than one rank).  The graph's function
        holds these groups, so no other group takes their ``id`` while the
        graph is cached: a group made later, even over the same ranks, gets
        a graph of its own."""
        groups = tuple(id(g) if n > 1 else None
                       for g, n in ((self.time, self.nt), (self.bins, self.nb)))
        return (self.nc, self.nt, self.nb), self.d, self.b, groups


def _axes(mesh: DeviceMesh) -> _Axes:
    t, b = AXES.index("time"), AXES.index("bins")
    return _Axes(mesh.size(AXES.index("channel")),
                 mesh.get_local_rank(t), mesh.size(t), mesh.get_group(t),
                 mesh.get_local_rank(b), mesh.size(b), mesh.get_group(b))


#: capture error mode of the per-rank graphs: a rank's NCCL watchdog
#: thread queries the events of earlier collectives while the rank
#: captures, which a global capture forbids
CAPTURE_MODE = "thread_local"


def _graphed(name: str, ax: _Axes, static: tuple, fn, *args):
    """``fn(*args)``, this rank's body: on the card a replay of its graph
    (``graphs.run``, fresh outputs), keyed on ``ax.key()`` and ``static``;
    eagerly on the CPU and inside ``graphs.disabled()``."""
    if graphs.active(args[-1]):
        return graphs.run(name, (*ax.key(), *static), fn, *args, mode=CAPTURE_MODE)
    return fn(*args)


def _all_gather(x: torch.Tensor, group, n: int) -> torch.Tensor:
    """(n, ...) stack of every rank's ``x`` in the group's rank order."""
    x = x.contiguous()
    if n == 1:
        return x[None]
    out = [torch.empty_like(x) for _ in range(n)]
    dist.all_gather(out, x, group=group)
    return torch.stack(out)


def _all_reduce(x: torch.Tensor, group, n: int) -> torch.Tensor:
    if n > 1:
        x = x.contiguous()
        dist.all_reduce(x, group=group)
    return x


def _neighbours(group, k: int, n: int, to_next: torch.Tensor | None,
                to_prev: torch.Tensor | None):
    """One exchange with both neighbours along an axis of n ranks (k is this
    rank's coordinate): send ``to_next`` to k+1 and ``to_prev`` to k-1
    (None: nothing that way); returns (from_prev, from_next), None at an
    edge.  The ring's wrap-around is not sent."""
    ops, got = [], [None, None]
    for i, (buf, peer) in enumerate(((to_next, k - 1), (to_prev, k + 1))):
        if buf is not None and 0 <= peer < n:
            got[i] = torch.empty_like(buf)
            ops.append(dist.P2POp(dist.irecv, got[i], dist.get_global_rank(group, peer), group))
    for buf, peer in ((to_next, k + 1), (to_prev, k - 1)):
        if buf is not None and 0 <= peer < n:
            ops.append(dist.P2POp(dist.isend, buf.contiguous(),
                                  dist.get_global_rank(group, peer), group))
    if ops:
        for w in dist.batch_isend_irecv(ops):
            w.wait()
    return got[0], got[1]


def _exclusive_prefix(local_total: torch.Tensor, ax: _Axes):
    """Sum of the block totals of the time ranks strictly before this one,
    and the grand total over all of them (real tensors): the inter-block
    carry combine."""
    g = _all_gather(local_total, ax.time, ax.nt)
    mask = (torch.arange(ax.nt, device=g.device) < ax.d).to(g.dtype)
    prefix = (g * mask.reshape((-1,) + (1,) * (g.ndim - 1))).sum(0)
    return prefix, g.sum(0)


def _comb_history(delayline: torch.Tensor, samples: torch.Tensor, n2: int,
                  ax: _Axes):
    """Comb-stage history of this time shard, and the stream's next
    delayline: (hist (C, n2), new_delayline (C, n2)), ``hist`` the n2 = 2m
    samples right before this rank's block in the global stream
    (c/src/sdft/sdft.h:433).

    When the local block L >= 2m the history is the predecessor's tail: one
    send/recv to the next time rank, and a broadcast of the last rank's
    tail.  When L < 2m it spans ceil(2m/L) predecessors: the blocks are
    all_gathered (O(M) traffic, the price of very fine time sharding)."""
    C, L = samples.shape
    if L >= n2:
        tail = samples[:, -n2:].contiguous()
        prev, _ = _neighbours(ax.time, ax.d, ax.nt, tail, None)
        hist = delayline if ax.d == 0 else prev
        if ax.nt > 1:
            tail = tail.clone()
            dist.broadcast(tail, src=dist.get_global_rank(ax.time, ax.nt - 1),
                           group=ax.time)
        return hist, tail
    blocks = _all_gather(samples, ax.time, ax.nt)            # (D, C, L)
    g = torch.cat([delayline, *blocks], dim=-1)              # (C, n2 + M)
    return g[:, ax.d * L:ax.d * L + n2], g[:, -n2:].contiguous()


def _bin_halo_exchange(aux: torch.Tensor, halo: int, ax: _Axes) -> torch.Tensor:
    """Pad the local bin columns with the neighbours' halo columns, and with
    Hermitian guards at the edges of the spectrum: (C, L, mb) complex ->
    (C, L, mb + 2*halo)."""
    if halo == 0:
        return aux
    from_left, from_right = _neighbours(ax.bins, ax.b, ax.nb, pack(aux[..., -halo:].contiguous()),
                                        pack(aux[..., :halo].contiguous()))
    left = (torch.conj(aux[..., 1:halo + 1].flip(-1)) if ax.b == 0
            else unpack(from_left))
    right = (torch.conj(aux[..., -halo - 1:-1].flip(-1)) if ax.b == ax.nb - 1
             else unpack(from_right))
    return torch.cat([left, aux, right], dim=-1).resolve_conj()


# -- per-shard bodies -------------------------------------------------------------

def _bin_range(plan: Plan, ax: _Axes) -> tuple:
    """(first bin, bins) of this rank's shard, on the host."""
    mb = plan.dftsize // ax.nb
    return ax.b * mb, mb


def _bins(plan: Plan, ax: _Axes, device) -> torch.Tensor:
    b0, mb = _bin_range(plan, ax)
    return b0 + torch.arange(mb, device=device)


def _window(plan: Plan, aux: torch.Tensor, bins: torch.Tensor, ax: _Axes) -> torch.Tensor:
    """The window convolution of the local columns, after the halo
    exchange; bins outside the ROI read zero."""
    out = convolve_padded(plan, _bin_halo_exchange(aux, WINDOW_HALO[plan.window], ax))
    if plan.roi is not None:
        out = out * roi_mask(plan, aux.device, plan.precision.fd_dtype)[bins]
    return out


def _comb(plan: Plan, state: State, samples: torch.Tensor, ax: _Axes):
    """(delta (C, L) in FD precision, next delayline) of this shard."""
    td = plan.precision.td_dtype
    x = samples.to(td)
    hist, new_delayline = _comb_history(state.delayline.to(td), x, 2 * plan.dftsize, ax)
    line = torch.cat([hist, x], dim=-1)
    return (x - line[:, :x.shape[-1]]).to(plan.precision.fd_dtype), new_delayline


def _next_offset(plan: Plan, state: State, m_total: int) -> torch.Tensor:
    return torch.remainder(state.offset + m_total, 2 * plan.dftsize).to(state.offset.dtype)


def _forward_local(plan: Plan, state: State, samples: torch.Tensor, ax: _Axes,
                   m_total: int):
    """Per-rank forward body (the scan form): samples (C, L) local block,
    state batched with the accumulator's bin shard (C, mb, 2).  Returns
    (state, dfts (C, L, mb, 2))."""
    fd, cd = plan.precision.fd_dtype, plan.precision.fdx_dtype
    C, L = samples.shape
    dev = samples.device
    bins = _bins(plan, ax, dev)
    mb = bins.numel()
    delta, new_delayline = _comb(plan, state, samples, ax)

    # rotation with exact mod-2m phases; bins outside the ROI are never
    # accumulated (c/src/sdft/sdft.h:570)
    e = state.offset.to(torch.int64)[:, None] + ax.d * L + torch.arange(L, device=dev)
    rot = delta[..., None].to(cd) * fiddle_rows(plan, e, bins=bins).view(C, L, mb)
    if plan.roi is not None:
        rot = rot * roi_mask(plan, dev, fd)[bins]
    if ax.d == 0:  # the carried accumulator seeds the first time shard
        rot[:, 0, :] += unpack(state.accumulator.to(fd))

    # local scan + inter-block carry combine
    cum = torch.cumsum(rot, dim=1)
    prefix, grand = _exclusive_prefix(pack(cum[:, -1, :]), ax)
    cum = cum + unpack(prefix)[:, None, :]

    aux = cum * fiddle_rows(plan, e + 1, conj=True, bins=bins).view(C, L, mb)
    dfts = pack(_window(plan, aux, bins, ax))
    new_state = State(offset=_next_offset(plan, state, m_total),
                      delayline=new_delayline,
                      accumulator=grand.to(state.accumulator.dtype))
    return new_state, dfts


def _inverse_local(plan: Plan, dfts: torch.Tensor, ax: _Axes) -> torch.Tensor:
    """Per-rank synthesis: the local bins' partial products, all_reduced
    over 'bins'.  dfts (C, L, mb, 2) packed -> (C, L) TD samples."""
    fd = plan.precision.fd_dtype
    mb = dfts.shape[-2]
    tw = synthesis_twiddles(plan, dfts.device)[ax.b * mb:(ax.b + 1) * mb]
    with fp32_matmul():
        y = dfts[..., 0].to(fd) @ tw.real.contiguous()
        if plan.latency != 1.0:
            y = y - dfts[..., 1].to(fd) @ tw.imag.contiguous()
    y = _all_reduce(y, ax.bins, ax.nb)
    return (y * plan.synthesis_weight).to(plan.precision.td_dtype)


def _bin_cols(t, b0: int, mb: int, m: int):
    """Columns [b0, b0 + mb) of an (R, ..., m, 2)-interleaved table
    flattened to (R, X*2m): (R, X*2mb), contiguous; of both halves of a
    ``Split`` table."""
    if isinstance(t, Split):
        return t.map(lambda h: _bin_cols(h, b0, mb, m))
    R = t.shape[0]
    return t.view(R, -1, m, 2)[:, :, b0:b0 + mb].reshape(R, -1)


def _bin_rows(PQ, b0: int, mb: int):
    """Rows [2*b0, 2*(b0 + mb)) of the (2m, K) PQ table (or of both halves
    of a ``Split`` one): the local bins' rows."""
    if isinstance(PQ, Split):
        return PQ.map(lambda h: _bin_rows(h, b0, mb))
    return PQ[2 * b0:2 * (b0 + mb)]


def _carry_local(plan: Plan, state: State, samples: torch.Tensor, fine,
                 bins: torch.Tensor, ax: _Axes, m_total: int):
    """The sharded form of ``ops.lti._carry``: the comb deltas in tiles of
    K (the rows of the local ``fine`` columns), each tile's carry in the
    demodulated frame for the local bins, with a two-level prefix (over
    time ranks, then over local tiles), and the state after the block.

    Returns (dt (C, nt, K), c0 (C, nt, mb) complex, new_state)."""
    fd = plan.precision.fd_dtype
    K = fine.shape[0]
    mb = bins.numel()
    C, L = samples.shape
    nt = -(-L // K)
    delta, new_delayline = _comb(plan, state, samples, ax)
    if nt * K != L:  # zero deltas do not perturb the carry
        delta = torch.nn.functional.pad(delta, (0, nt * K - L))
    dt = delta.view(C, nt, K)
    totals = torch.view_as_complex(_mm(plan, dt, fine).view(C, nt, mb, 2))
    row0 = _phase_rows(plan, state.offset.to(torch.int64) + ax.d * L, nt, K, bins)
    rt = row0 * totals
    dev_prefix, grand = _exclusive_prefix(pack(rt.sum(dim=1)), ax)
    acc = state.accumulator.to(fd)
    pre = _prefix_tiles(torch.cat([unpack(acc + dev_prefix)[:, None], rt[:, :-1]], dim=1))
    new_state = State(offset=_next_offset(plan, state, m_total),
                      delayline=new_delayline,
                      accumulator=(acc + grand).to(state.accumulator.dtype))
    return dt, pre * row0.conj(), new_state


def _synthesize_local(plan: Plan, dt: torch.Tensor, c0: torch.Tensor, GLT, PQ,
                      L: int, ax: _Axes) -> torch.Tensor:
    """y = delta @ GLT + c0_re @ P^T + c0_im @ Q^T: each bin shard adds its
    columns' part (GLT, a sum over every bin, on bin shard 0) and the
    all_reduce over 'bins' completes the sum.  (C, L) TD samples."""
    C, nt, K = dt.shape
    c0r = torch.view_as_real(c0).reshape(C * nt, -1)
    y = (_synthesis_mm(plan, dt.reshape(C * nt, K), GLT, c0r, PQ) if ax.b == 0
         else _mm(plan, c0r, PQ))
    y = _all_reduce(y, ax.bins, ax.nb)
    return y.reshape(C, nt * K)[:, :L].to(plan.precision.td_dtype)


def _local_stepped(stepped, b0: int, mb: int, m: int):
    if stepped is None:
        return None
    sf, dr = stepped
    return _bin_cols(sf, b0, mb, m), dr[:, b0:b0 + mb]


def _roundtrip_local_lti(plan: Plan, state: State, samples: torch.Tensor, ax: _Axes,
                         m_total: int):
    """Per-rank collapsed-LTI round trip (see ``ops.lti``).  The Hermitian
    guards and the window convolution are folded into the plan constants
    before the bin slicing, so there is no bin-halo exchange: the only
    collectives are the comb exchange and the carry all_gather over 'time'
    and one all_reduce over 'bins' for the synthesis."""
    m = plan.dftsize
    C, L = samples.shape
    dev = samples.device
    bins = _bins(plan, ax, dev)
    fine, GLT, PQ = _lti_consts_device(plan, default_k_tile(L, m), plan.precision.fd_dtype, dev)
    b0, mb = _bin_range(plan, ax)
    dt, c0, new_state = _carry_local(plan, state, samples, _bin_cols(fine, b0, mb, m), bins,
                                     ax, m_total)
    y = _synthesize_local(plan, dt, c0, GLT, _bin_rows(PQ, b0, mb), L, ax)
    return new_state, y


def _hopped_local(plan: Plan, state: State, samples: torch.Tensor, ax: _Axes, hop: int,
                  sub: int, m_total: int):
    """Per-rank hopped analysis: one spectrum per hop of the global stream
    (the reference driver protocol, test/test.c:69-83), from the tile-start
    carries of tiles of K = hop*sub samples.  ``sub > 1`` (hops shorter
    than 8) emits ``sub`` spectra per tile through the stepped partial
    totals (``ops.lti._stepped_consts_device``)."""
    m = plan.dftsize
    fd = plan.precision.fd_dtype
    L = samples.shape[-1]
    dev = samples.device
    bins = _bins(plan, ax, dev)
    b0, mb = _bin_range(plan, ax)
    fine = _bin_cols(_hop_consts_device(plan, hop * sub, fd, dev), b0, mb, m)
    stepped = (_local_stepped(_stepped_consts_device(plan, hop, sub, fd, dev), b0, mb, m)
               if sub > 1 else None)
    dt, c0, new_state = _carry_local(plan, state, samples, fine, bins, ax, m_total)
    aux = _hop_aux(plan, dt, c0, stepped, hop, L, bins)
    return new_state, pack(_window(plan, aux, bins, ax))


def _driver_block_local(plan: Plan, state: State, samples: torch.Tensor, consts,
                        ax: _Axes, hop: int, m_total: int, refresh: bool):
    """Per-rank fused driver-protocol block (the sharded form of
    ``ops.lti._fused_driver_nd``): the hop spectra and the synthesized
    samples from one comb stage, one totals GEMM and one prefix combine.
    Collectives per block: the comb exchange and the prefix all_gather over
    'time', the window's halo exchange and the synthesis all_reduce over
    'bins'.  ``refresh`` rebuilds the accumulator from the (replicated)
    offset and delayline and keeps this rank's bins."""
    m = plan.dftsize
    L = samples.shape[-1]
    bins = _bins(plan, ax, samples.device)
    b0, mb = _bin_range(plan, ax)
    (fine, GLT, PQ), stepped = consts
    dt, c0, st = _carry_local(plan, state, samples, _bin_cols(fine, b0, mb, m), bins, ax,
                              m_total)
    y = _synthesize_local(plan, dt, c0, GLT, _bin_rows(PQ, b0, mb), L, ax)
    aux = _hop_aux(plan, dt, c0, _local_stepped(stepped, b0, mb, m), hop, L, bins)
    hd = pack(_window(plan, aux, bins, ax))
    if refresh:
        C = st.offset.shape[0]
        zeros = torch.zeros((C, m, 2), dtype=st.accumulator.dtype, device=samples.device)
        full = _refresh_fused(plan, st._replace(accumulator=zeros), plan.precision.fd_dtype)
        st = st._replace(accumulator=full.accumulator[:, b0:b0 + mb].contiguous())
    return st, hd, y


def _kernel_prologue_local(plan: Plan, state: State, samples: torch.Tensor, ax: _Axes,
                           m_total: int):
    """Per-rank prologue of the kernel programs: the kernels' prologue
    (``kernels.spectra.spectra_prologue``) of the local (C, L) block, with
    the global end state in place of the prologue's own.

    Each time shard derives its block-start accumulator from the 2m-sample
    comb history it already receives for the delta stage (the refresh
    identity: the carry is a function of the last 2m samples and the
    offset alone), so the inter-block carry needs no prefix collective:
    the comb exchange is the program's only cross-rank traffic."""
    fd = plan.precision.fd_dtype
    n2 = 2 * plan.dftsize
    C, L = samples.shape
    td = plan.precision.td_dtype
    x = samples.to(td)
    hist, new_delayline = _comb_history(state.delayline.to(td), x, n2, ax)
    zeros = torch.zeros_like(state.accumulator)
    off = torch.remainder(state.offset + ax.d * L, n2).to(state.offset.dtype)
    pro = spectra_prologue(plan, _refresh_fused(plan, State(off, hist, zeros), fd), x)
    # the global end state (the same on every rank): the stream's tail and
    # the end accumulator from the same refresh identity
    end = _refresh_fused(plan, State(_next_offset(plan, state, m_total), new_delayline,
                                     zeros), fd)
    return pro._replace(state=end)


def _forward_local_pallas(plan: Plan, state: State, samples: torch.Tensor, ax: _Axes,
                          m_total: int, layout: str, spectra_dtype: str | None,
                          emit_y: bool):
    """Per-rank body of the kernel programs: the prologue
    (``_kernel_prologue_local``; on the card a replay of its graph), then
    K1 or, with ``emit_y``, K2 once on the local (C, L) block, all its
    channels in one launch straight after the replay, reading the graph's
    static carries and writing only the local (C, L, m) spectra into fresh
    outputs.  The kernels stay out of the graph, so its key holds neither
    the layout nor ``emit_y``."""
    dtype = _check_dtype(spectra_dtype)

    def body(st, x):
        return _kernel_prologue_local(plan, st, x, ax, m_total)

    if graphs.active(samples):
        pro = graphs.replay("sharded_kernel_prologue", (*ax.key(), plan, m_total), body,
                            state, samples, mode=CAPTURE_MODE)
        pro = pro._replace(state=graphs.clone(pro.state))
    else:
        pro = body(state, samples)
    if emit_y:
        dfts, ys = _scan(plan, pro, "packed")
        return pro.state, dfts, ys.to(plan.precision.td_dtype)
    return pro.state, _spectra(plan, pro, layout, dtype)


# -- the programs ------------------------------------------------------------------

def _check_layout(plan: Plan, mesh: DeviceMesh, C: int, M: int):
    if tuple(mesh.mesh_dim_names or ()) != AXES:
        raise ValueError(f"mesh dimensions must be named {AXES}, got {mesh.mesh_dim_names}")
    nc, nt, nb = mesh.shape
    if C % nc:
        raise ValueError(f"channels {C} not divisible by mesh channel={nc}")
    if M % nt:
        raise ValueError(f"block {M} not divisible by mesh time={nt}")
    if plan.dftsize % nb:
        raise ValueError(f"dftsize {plan.dftsize} not divisible by mesh bins={nb}")
    if nb > 1 and plan.dftsize // nb <= WINDOW_HALO[plan.window]:
        raise ValueError("bin shard smaller than window halo")


def _samples_shape(samples, ndim: int = 2) -> tuple:
    shape = tuple((samples if hasattr(samples, "shape") else torch.as_tensor(samples)).shape)
    if len(shape) != ndim:
        raise ValueError(f"samples must have {ndim} axes, got {shape}")
    return shape


def sharded_sdft(plan: Plan, mesh: DeviceMesh, state: State, samples,
                 use_pallas: bool | None = None):
    """Forward analysis over the mesh.

    Args:
      plan: the plan.
      mesh: ('channel', 'time', 'bins') mesh from ``make_mesh``.
      state: batched State (leading channel axis on every field).
      samples: (C, M) samples.
      use_pallas: None (default) runs the kernel program
        (``sharded_sdft_pallas``, K1 per time shard) when the mesh is
        bins=1, lives on the card and ``kernel_supported(plan, M)`` holds,
        as ``api.sdft`` dispatches (its spectra are then K1's f32 class);
        True forces it on any device (on the CPU, K1's plain version runs)
        and raises where it cannot run; False forces the scan form.

    Returns:
      (new_state, dfts): dfts packed (C, M, m, 2), placed ``DFT_SPEC``.
    """
    C, M = _samples_shape(samples)
    _check_layout(plan, mesh, C, M)
    if use_pallas is None:
        use_pallas = (mesh.shape[2] == 1 and mesh.device_type == "cuda"
                      and kernel_supported(plan, M))
    if use_pallas:
        return sharded_sdft_pallas(plan, mesh, state, samples)
    st, dfts = _forward(plan, _axes(mesh), _local_state(mesh, state),
                        _local(mesh, samples, SAMPLE_SPEC), M)
    return _global_state(mesh, st), host_local_to_global(mesh, DFT_SPEC, dfts)


def _forward(plan: Plan, ax: _Axes, state: State, x: torch.Tensor, m_total: int):
    return _graphed("sharded_forward", ax, (plan, m_total),
                    lambda st, xx: _forward_local(plan, st, xx, ax, m_total), state, x)


def _inverse(plan: Plan, ax: _Axes, dfts: torch.Tensor) -> torch.Tensor:
    return _graphed("sharded_inverse", ax, (plan,),
                    lambda d: _inverse_local(plan, d, ax), dfts)


def sharded_isdft(plan: Plan, mesh: DeviceMesh, dfts):
    """Inverse synthesis over the mesh: packed dfts (C, M, m, 2) -> (C, M)
    samples, placed ``SAMPLE_SPEC``."""
    C, M, _, _ = _samples_shape(dfts, 4)
    _check_layout(plan, mesh, C, M)
    y = _inverse(plan, _axes(mesh), _local(mesh, dfts, DFT_SPEC))
    return host_local_to_global(mesh, SAMPLE_SPEC, y)


def sharded_roundtrip(plan: Plan, mesh: DeviceMesh, state: State, samples,
                      *, collapsed: bool = True, transform=None):
    """Fused analysis + synthesis of one block over the mesh.

    With ``collapsed`` (default) each rank runs the LTI form (GEMMs, no
    bin-halo exchange: the guards and the window convolution are folded
    into the plan constants); ``collapsed=False`` runs the scan form (each
    shard's per-sample spectra, then the all_reduce synthesis).  Both give
    the same samples and state up to rounding.

    With ``transform`` (analyze, modify the spectrum, resynthesize:
    python/src/sdft/sdft.py) the scan form runs with ``transform(spectra,
    bins)`` applied to each shard's complex (C, L, mb) spectra before the
    synthesis; ``bins`` are the shard's (mb,) global bin indices, e.g. a
    low-pass ``lambda z, bins: z * (bins < cutoff)``.  It must return the
    same shape.

    Returns (new_state, y): y (C, M), placed ``SAMPLE_SPEC``.
    """
    C, M = _samples_shape(samples)
    _check_layout(plan, mesh, C, M)
    ax = _axes(mesh)
    st = _local_state(mesh, state)
    x = _local(mesh, samples, SAMPLE_SPEC)
    if transform is None and collapsed:
        st, y = _graphed("sharded_roundtrip_lti", ax, (plan, M),
                         lambda s, xx: _roundtrip_local_lti(plan, s, xx, ax, M), st, x)
    elif transform is None:
        # the scan form's forward and inverse, one graph
        def body(s, xx):
            s, d = _forward_local(plan, s, xx, ax, M)
            return s, _inverse_local(plan, d, ax)

        st, y = _graphed("sharded_roundtrip_scan", ax, (plan, M), body, st, x)
    else:
        # the user's callable runs between a graphed forward and a graphed
        # inverse, outside any graph (as api.roundtrip's transform does)
        st, dfts = _forward(plan, ax, st, x, M)
        z = unpack(dfts)
        z2 = transform(z, _bins(plan, ax, z.device))
        if tuple(z2.shape) != tuple(z.shape):
            raise ValueError(f"transform must preserve the local spectra shape "
                             f"{tuple(z.shape)}, returned {tuple(z2.shape)}")
        y = _inverse(plan, ax, pack(z2))
    return _global_state(mesh, st), host_local_to_global(mesh, SAMPLE_SPEC, y)


def sharded_sdft_hopped(plan: Plan, mesh: DeviceMesh, state: State, samples, hop: int):
    """Hopped forward analysis over the mesh: one spectrum per ``hop``
    samples of the global stream (the reference driver protocol,
    test/test.c:69-83).  M/time must be a multiple of ``hop``.  Hops
    shorter than 8 run multi-hop stepped tiles (K = hop*sub) when the local
    block divides into them, and hop-depth tiles otherwise.

    Returns (new_state, dfts): dfts packed (C, M/hop, m, 2), placed
    ``DFT_SPEC``."""
    C, M = _samples_shape(samples)
    _check_layout(plan, mesh, C, M)
    L = M // mesh.shape[1]
    if hop < 1 or L % hop:
        raise ValueError(f"local time block {L} not a multiple of hop {hop}")
    sub = driver_sub_factor(hop)
    if L % (hop * sub):
        sub = 1                      # keep any hop-multiple block legal
    ax = _axes(mesh)
    st, dfts = _graphed("sharded_hopped", ax, (plan, hop, sub, M),
                        lambda s, x: _hopped_local(plan, s, x, ax, hop, sub, M),
                        _local_state(mesh, state), _local(mesh, samples, SAMPLE_SPEC))
    return _global_state(mesh, st), host_local_to_global(mesh, DFT_SPEC, dfts)


def sharded_roundtrip_hopped(plan: Plan, mesh: DeviceMesh, state: State, blocks,
                             hop: int, refresh_every: int | None = 1):
    """The driver protocol over the mesh for a stack of blocks: each block's
    hop spectra and synthesized samples from one fused body per rank
    (``_driver_block_local``), the blocks one after another (the
    counterpart of ``api.roundtrip_hopped``, and the CLI's ``--mesh``
    path).  On the card one block's body is captured once per chain and
    replayed per block (the counterpart of the JAX program's ``lax.scan``
    body), each block's outputs copied into stacks allocated before the
    loop.

    Args:
      plan: the plan.
      mesh: ('channel', 'time', 'bins') mesh.
      state: batched State.
      blocks: (nb, C, B) stacked blocks; the local block B/time must be a
        multiple of the driver tile hop*sub (sub = driver_sub_factor(hop):
        1 for hop >= 8).
      hop: hop size in samples.
      refresh_every: 1 (default) rebuilds the accumulator exactly from the
        delayline after every block; None never does.

    Returns:
      (new_state, hop_dfts, ys): hop_dfts packed (nb, C, B//hop, m, 2) and
      ys (nb, C, B), sharded (-, channel, time[, bins]).
    """
    nblk, C, B = _samples_shape(blocks, 3)
    _check_layout(plan, mesh, C, B)
    sub = driver_sub_factor(hop)
    L = B // mesh.shape[1]
    if L % (hop * sub):
        raise ValueError(f"local time block {L} not a multiple of the driver tile "
                         f"hop*sub = {hop * sub}")
    if refresh_every not in (None, 1):
        raise ValueError("refresh_every must be None or 1 for the sharded driver chain")
    ax = _axes(mesh)
    xs = _local(mesh, blocks, (Shard(1), Shard(2), Replicate()))
    st = _local_state(mesh, state)
    # the exact tables on a split4 plan, as the JAX package's sharded
    # programs read split4 as HIGHEST (sdft_tpu/parallel/sharded.py:638-639);
    # split ones on a "high" plan, whose mxu_precision they read
    fd = plan.precision.fd_dtype
    consts = (_lti_consts_device(plan, hop * sub, fd, xs.device),
              _stepped_consts_device(plan, hop, sub, fd, xs.device) if sub > 1 else None)
    refresh = refresh_every == 1
    _, mb = _bin_range(plan, ax)
    hds = torch.empty((nblk, xs.shape[1], L // hop, mb, 2), dtype=fd,
                      device=xs.device)
    ys = torch.empty(xs.shape, dtype=plan.precision.td_dtype, device=xs.device)

    def block(s, x):
        return _driver_block_local(plan, s, x, consts, ax, hop, B, refresh)

    graphed = graphs.active(xs)
    if graphed:
        # each replay's outputs are copied out before the next replay
        block = graphs.get("sharded_driver_block", (*ax.key(), plan, hop, sub, B, refresh),
                           block, st, xs[0], mode=CAPTURE_MODE)
    for b in range(nblk):
        st, hd, y = block(st, xs[b])
        hds[b] = hd
        ys[b] = y
    return (_global_state(mesh, graphs.clone(st) if graphed else st),
            host_local_to_global(mesh, (Shard(1), Shard(2), Shard(3)), hds),
            host_local_to_global(mesh, (Shard(1), Shard(2), Replicate()), ys))


def _check_kernel_program(name: str, plan: Plan, mesh: DeviceMesh, C: int, M: int,
                          spectra_dtype=None):
    _check_layout(plan, mesh, C, M)
    if mesh.shape[2] != 1:
        raise ValueError(f"{name} shards time/channel only (bins=1 meshes); "
                         "use sharded_sdft for bin-sharded spectra")
    if not kernel_supported(plan, M, spectra_dtype):
        raise ValueError(f"plan {plan} is not one the kernels take; use sharded_sdft")


def sharded_sdft_pallas(plan: Plan, mesh: DeviceMesh, state: State, samples,
                        layout: str = "packed", spectra_dtype: str | None = None):
    """Forward analysis emitting every spectrum over the mesh, through one
    K1 launch per time shard for all its channels (``_forward_local_pallas``).  The
    spectra store, the path's bound, splits linearly over the ``time``
    axis; the only collectives are ``_comb_history``'s (size local blocks
    >= 2m to keep them at one send/recv and a broadcast).

    Requires a bins=1 mesh and a plan the kernels take
    (``kernel_supported``).  The name is the JAX program's; its
    ``interpret`` argument has no counterpart here: on CPU tensors K1's
    plain version runs, on CUDA tensors K1 launches or raises.

    Returns (state, dfts): packed (C, M, m, 2), or with ``layout="planar"``
    the (re, im) pair of (C, M, m) planes, optionally bfloat16
    (``spectra_dtype``), sharded (channel, time)."""
    C, M = _samples_shape(samples)
    if layout not in ("packed", "planar"):
        raise ValueError(f"layout must be 'packed' or 'planar', got {layout!r}")
    if spectra_dtype and layout != "planar":
        raise ValueError("spectra_dtype requires layout='planar'")
    _check_kernel_program("sharded_sdft_pallas", plan, mesh, C, M, spectra_dtype)
    st, dfts = _forward_local_pallas(plan, _local_state(mesh, state),
                                     _local(mesh, samples, SAMPLE_SPEC), _axes(mesh), M,
                                     layout, spectra_dtype, emit_y=False)
    if layout == "planar":
        out = tuple(host_local_to_global(mesh, SAMPLE_SPEC, p) for p in dfts)
    else:
        out = host_local_to_global(mesh, DFT_SPEC, dfts)
    return _global_state(mesh, st), out


def sharded_roundtrip_pallas(plan: Plan, mesh: DeviceMesh, state: State, samples):
    """The hop=1 driver protocol over the mesh: every sample's spectrum and
    the synthesized samples, through one K2 launch per time shard for all
    its channels (the kernel of the single-device hop=1 chain).  Same carry scheme as
    ``sharded_sdft_pallas``; same requirements; no ``interpret`` argument.

    Returns (state, dfts, ys): dfts packed (C, M, m, 2), ys (C, M),
    sharded (channel, time)."""
    C, M = _samples_shape(samples)
    _check_kernel_program("sharded_roundtrip_pallas", plan, mesh, C, M)
    st, dfts, ys = _forward_local_pallas(plan, _local_state(mesh, state),
                                         _local(mesh, samples, SAMPLE_SPEC), _axes(mesh), M,
                                         "packed", None, emit_y=True)
    return (_global_state(mesh, st), host_local_to_global(mesh, DFT_SPEC, dfts),
            host_local_to_global(mesh, SAMPLE_SPEC, ys))
