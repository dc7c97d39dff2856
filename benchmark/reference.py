"""The plain reference the benchmark holds the program to, and its control.

A sliding DFT of size m emits, after every input sample x[t], the windowed
spectrum of the last 2m samples (c/src/sdft/sdft.h:562-598 of the
reference implementation, jurihock/sdft):

    aux_t[i] = sum_n x[t - 2m + 1 + n] * exp(-j*pi*i*n/m),   i = 0..m-1
    dft_t[i] = (c0*aux[i] + c1*(aux[i-1] + aux[i+1])
                          + c2*(aux[i-2] + aux[i+2])) / (2m)

with Hermitian guards past the edges (aux[-k] = conj(aux[k]) and
aux[m-1+k] = conj(aux[m-1-k]), sdft.h:589-595) and the window's taps
(c0, c1, c2).  Bins outside a region of interest are neither accumulated
nor emitted.  The inverse (sdft.h:635-657) is one sample per spectrum,

    y_t = 2 * sum_i Re(dft_t[i] * tw[i]),
    tw[i] = (-1)^i at latency 1, else w * exp(-j*pi*latency*i) with
    w = 2 / (1 - cos(pi*latency)),

and the carried state after a stream of n samples is the offset n mod 2m,
the delayline (the last 2m samples, oldest first) and the accumulator

    acc[i] = exp(-j*pi*i*offset/m) * sum_n delayline[n] * exp(-j*pi*i*n/m).

Here each spectrum is computed directly from its 2m samples, in float64,
by ``torch.fft.rfft``: no running sum, no carry, nothing taken from the
program.

The control (``Control``) is the same definition put in the program's
place and computed in the next precision below the float32, TF32 off,
that the configurations state: every product's operands rounded to TF32
(10 bits of mantissa, round to nearest even), sums in float32 — what a
TF32 tensor-core GEMM computes.  In the program's place it streams: it
carries the accumulator from block to block (acc += T^offset * (delta @
T^k), the block's product as one TF32 GEMM), or rebuilds it from the
delayline after every block where the configuration says so
(``refresh_every``: 1), and emits a block's spectra from the carried
accumulator and the running sum of the block's rotated deltas.  This
module imports torch alone.
"""

from __future__ import annotations

import dataclasses
import math

import torch

#: (centre, first neighbour, second neighbour) taps of each window
TAPS = {"boxcar": (1.0, 0.0, 0.0), "hann": (0.50, -0.25, 0.0),
        "hamming": (0.54, -0.23, 0.0), "blackman": (0.42, -0.25, 0.04)}
HALO = {"boxcar": 0, "hann": 1, "hamming": 1, "blackman": 2}
#: bytes of float64 window data one chunk of the reference may hold
CHUNK_BYTES = 1 << 28


@dataclasses.dataclass(frozen=True)
class Spec:
    """What the reference needs of a configuration."""

    m: int
    window: str = "hann"
    latency: float = 1.0
    roi: tuple | None = None

    @property
    def n2(self) -> int:
        return 2 * self.m

    def mask(self, device) -> torch.Tensor:
        first, last = self.roi or (0, self.m)
        i = torch.arange(self.m, device=device)
        return ((i >= first) & (i < last)).to(torch.float64)


def tf32(a: torch.Tensor) -> torch.Tensor:
    """float32 ``a`` rounded to TF32's 10 mantissa bits (to nearest, ties
    to even), as a tensor core reads a float32 operand in TF32 mode."""
    bits = a.contiguous().view(torch.int32)
    bits = (bits + 0x0FFF + ((bits >> 13) & 1)) & ~0x1FFF
    return bits.view(torch.float32)


def _dft_table(spec: Spec, device) -> torch.Tensor:
    """(2m, 2m) float32, TF32-rounded: [cos | -sin] of pi*(n*i mod 2m)/m,
    the control's DFT as one real matrix (the re and im halves side by
    side)."""
    n = torch.arange(spec.n2, device=device, dtype=torch.int64)
    i = torch.arange(spec.m, device=device, dtype=torch.int64)
    ang = (math.pi / spec.m) * ((n[:, None] * i[None, :]) % spec.n2).to(torch.float64)
    return tf32(torch.cat([torch.cos(ang), -torch.sin(ang)], dim=1).to(torch.float32))


def _aux(spec: Spec, windows: torch.Tensor, table) -> torch.Tensor:
    """(..., 2m) windows -> (..., m) aux spectra: float64 FFT, or the
    control's TF32 product with ``table``."""
    if table is None:
        return torch.fft.rfft(windows.to(torch.float64), dim=-1)[..., :spec.m]
    lead = windows.shape[:-1]
    p = tf32(windows.to(torch.float32)).reshape(-1, spec.n2) @ table
    return torch.complex(p[:, :spec.m], p[:, spec.m:]).reshape(*lead, spec.m)


def _convolve(spec: Spec, aux: torch.Tensor) -> torch.Tensor:
    """The window's bin convolution with the reference's Hermitian guards,
    times 1/(2m); bins outside the ROI zeroed before and after."""
    mask = spec.mask(aux.device).to(aux.real.dtype)
    aux = aux * mask
    h = HALO[spec.window]
    c0, c1, c2 = TAPS[spec.window]
    if h:
        left = torch.conj(aux[..., 1:h + 1].flip(-1))
        right = torch.conj(aux[..., -h - 1:-1].flip(-1))
        aux = torch.cat([left, aux, right], dim=-1)
    n = aux.shape[-1]
    out = c0 * aux[..., h:n - h]
    if h >= 1:
        out = out + c1 * (aux[..., h - 1:n - h - 1] + aux[..., h + 1:n - h + 1])
    if h >= 2:
        out = out + c2 * (aux[..., h - 2:n - h - 2] + aux[..., h + 2:n - h + 2])
    return out * (mask / spec.n2)


def chunks(spec: Spec, channels: int, positions: torch.Tensor):
    """Split ``positions`` into pieces whose windows fit CHUNK_BYTES."""
    rows = max(1, CHUNK_BYTES // (8 * spec.n2 * max(1, channels)))
    return torch.split(positions, rows)


def spectra(spec: Spec, xext: torch.Tensor, positions: torch.Tensor,
            control: bool = False, table=None) -> torch.Tensor:
    """Spectra after the samples at ``positions`` of a block.

    Args:
      xext: (C, 2m + L) samples: the 2m before the block, then the block.
      positions: 1-D int64 indices into the block (0..L-1).
      control: compute the control (TF32 products) instead.
      table: the control's DFT table (``control_table``), to reuse.

    Returns (C, len(positions), m) complex128 (complex64 for the control).
    """
    win = xext.unfold(-1, spec.n2, 1)[:, positions + 1]
    if control and table is None:
        table = _dft_table(spec, xext.device)
    return _convolve(spec, _aux(spec, win, table if control else None))


def control_table(spec: Spec, device) -> torch.Tensor:
    return _dft_table(spec, device)


def synthesis(spec: Spec, dft: torch.Tensor) -> torch.Tensor:
    """(..., m) spectra -> (...,) samples, in the spectra's precision."""
    i = torch.arange(spec.m, device=dft.device, dtype=torch.float64)
    if spec.latency == 1.0:
        tw = torch.complex(1.0 - 2.0 * (i % 2), torch.zeros_like(i))
    else:
        ang = -math.pi * spec.latency * i
        w = 2.0 / (1.0 - math.cos(math.pi * spec.latency))
        tw = w * torch.complex(torch.cos(ang), torch.sin(ang))
    tw = (tw * spec.mask(dft.device)).to(dft.dtype)
    return 2.0 * (dft.real @ tw.real - dft.imag @ tw.imag)


def accumulator(spec: Spec, delayline: torch.Tensor, offset: int,
                control: bool = False, table=None) -> torch.Tensor:
    """(C, 2m) delayline at stream offset ``offset`` (mod 2m) -> (C, m)
    accumulator, complex128 (complex64 for the control)."""
    aux = _aux(spec, delayline, (table if table is not None
                                 else _dft_table(spec, delayline.device)) if control else None)
    i = torch.arange(spec.m, device=delayline.device, dtype=torch.int64)
    ang = (-math.pi / spec.m) * ((i * (offset % spec.n2)) % spec.n2).to(torch.float64)
    rot = torch.complex(torch.cos(ang), torch.sin(ang)).to(aux.dtype)
    return aux * rot * spec.mask(delayline.device).to(aux.real.dtype)


def _phasors(spec: Spec, exponents: torch.Tensor, sign: float = -1.0) -> torch.Tensor:
    """exp(sign*j*pi*(e*i mod 2m)/m) for integer exponents e: (len(e), m)
    complex64 with TF32-rounded parts (the control's operands)."""
    i = torch.arange(spec.m, device=exponents.device, dtype=torch.int64)
    r = (exponents.to(torch.int64).remainder(spec.n2)[:, None] * i[None, :]) % spec.n2
    ang = (sign * math.pi / spec.m) * r.to(torch.float64)
    return torch.complex(tf32(torch.cos(ang).float()), tf32(torch.sin(ang).float()))


class Control:
    """The reference in the program's place, in TF32 products (module
    docstring): ``Control(spec, block, L, b, refresh_every)`` streams
    blocks 0..b-1 (``block(k)``: (C, L) float32 samples) and then serves
    block b's outputs to ``checks.compare`` as readers, in increasing
    positions."""

    def __init__(self, spec: Spec, block, L: int, b: int, refresh_every: int | None):
        if refresh_every not in (None, 1):
            raise ValueError("the control follows refresh_every None or 1")
        self.spec, self.L = spec, L
        C = block(0).shape[0]
        dev = block(0).device
        self.line = torch.zeros(C, spec.n2, device=dev)
        acc = torch.zeros(C, spec.m, dtype=torch.complex64, device=dev)
        table = None if refresh_every else self._block_table(dev)
        for k in range(b):
            delta, off = self._advance(block(k), k)
            if refresh_every:
                continue
            p = tf32(delta) @ table
            acc = acc + torch.complex(p[:, :spec.m], p[:, spec.m:]) * _phasors(
                spec, torch.tensor([off], device=dev))
        del table
        if refresh_every:
            acc = accumulator(spec, self.line.double(), b * L, control=True)
        self.offset = (b * L) % spec.n2
        self.acc_in = acc
        self.x = block(b)
        self.delta = self.x - torch.cat([self.line, self.x], dim=1)[:, :L]
        self.refresh = refresh_every
        self.u = acc.clone()            # running sum up to position self.k
        self.k = 0
        self._chunk = (None, None)

    def _block_table(self, dev) -> torch.Tensor:
        """(L, 2m) float32 [re | im] of T_i^k, k = 0..L-1, TF32-rounded."""
        z = _phasors(self.spec, torch.arange(self.L, device=dev))
        return torch.cat([z.real, z.imag], dim=1)

    def _advance(self, x: torch.Tensor, k: int):
        xl = torch.cat([self.line, x], dim=1)
        self.line = xl[:, -self.spec.n2:]
        return x - xl[:, :self.L], (k * self.L) % self.spec.n2

    def aux(self, pos: torch.Tensor) -> torch.Tensor:
        """(C, R, m) complex64 aux spectra at ascending positions ``pos``
        (positions before the last ones asked for run the block's sum
        again from its start)."""
        if self._chunk[0] is not None and torch.equal(self._chunk[0], pos):
            return self._chunk[1]
        if int(pos[0]) < self.k:        # start the block's running sum again
            self.u, self.k = self.acc_in.clone(), 0
        rows, stop = [], int(pos[-1]) + 1
        want = pos.tolist()
        j = 0
        step = max(1, CHUNK_BYTES // (8 * self.spec.m * self.u.shape[0]))
        while self.k < stop:
            t = torch.arange(self.k, min(stop, self.k + step), device=self.u.device)
            rot = tf32(self.delta[:, t]).to(torch.complex64)[..., None] * _phasors(
                self.spec, self.offset + t)[None]
            csum = self.u[:, None, :] + torch.cumsum(rot, dim=1)
            keep = [w - self.k for w in want[j:] if w < self.k + len(t)]
            if keep:
                idx = torch.tensor(keep, device=t.device)
                demod = _phasors(self.spec, self.offset + t[idx] + 1, sign=1.0)
                z = csum[:, idx]
                rows.append(torch.complex(tf32(z.real.contiguous()), tf32(z.imag.contiguous()))
                            * demod[None])
                j += len(keep)
            self.u = csum[:, -1]
            self.k += len(t)
        out = torch.cat(rows, dim=1)
        self._chunk = (pos, out)
        return out

    def spectra(self, pos: torch.Tensor) -> torch.Tensor:
        return _convolve(self.spec, self.aux(pos))

    def samples(self, pos: torch.Tensor) -> torch.Tensor:
        return synthesis(self.spec, self.spectra(pos))

    def state(self):
        """(offset, delayline, accumulator) after the block."""
        if self.k < self.L:
            self.aux(torch.tensor([self.L - 1], device=self.u.device))
        C = self.u.shape[0]
        line = torch.cat([self.line, self.x], dim=1)[:, -self.spec.n2:]
        off = (self.offset + self.L) % self.spec.n2
        acc = (accumulator(self.spec, line.double(), off, control=True) if self.refresh
               else self.u * self.spec.mask(line.device).to(torch.float32))
        return torch.full((C,), off, device=line.device), line, acc
