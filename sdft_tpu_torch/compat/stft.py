"""FFT-based STFT comparator on ``torch.fft`` (counterpart of
``sdft_tpu.compat.stft``).

The reference ships an STFT/iSTFT class to validate SDFT output against the
classic FFT short-time transform (python/src/sdft/stft.py:17-197).  Same API
here: ``STFT(framesize, hopsize, dftsize, window, shift)`` with ``stft`` /
``istft``, symmetric and asymmetric windows, WOLA synthesis and optional
circular shift.  Framing is ``unfold``; overlap-add is ``index_add_``.
"""

from __future__ import annotations

import numpy as np
import torch

from ..state import require_device


def _symmetric_window(window: str, n: int) -> np.ndarray:
    """Periodic cosine-sum windows (python/src/sdft/stft.py:149-167)."""
    w = str(window).lower()
    t = 2 * np.pi * np.arange(n) / n
    if w == "hann":
        return 0.5 - 0.5 * np.cos(t)
    if w == "hamming":
        return 0.54 - 0.46 * np.cos(t)
    if w == "blackman":
        return 0.42 - 0.5 * np.cos(t) + 0.08 * np.cos(2 * t)
    return np.ones(n)


def _asymmetric_analysis_window(window: str, n: int, m: int) -> np.ndarray:
    """python/src/sdft/stft.py:169-182 (n = analysis size, m = synthesis//2)."""
    left = _symmetric_window(window, 2 * n - 2 * m)
    right = _symmetric_window(window, 2 * m)
    out = np.zeros(n)
    out[: n - m] = left[: n - m]
    out[-m:] = right[-m:]
    return out


def _asymmetric_synthesis_window(window: str, n: int, m: int) -> np.ndarray:
    """python/src/sdft/stft.py:184-197."""
    left = _symmetric_window(window, 2 * n - 2 * m)
    right = _symmetric_window(window, 2 * m)
    out = np.zeros(n)
    out[n - 2 * m: n - m] = np.square(right[:m]) / left[n - 2 * m: n - m]
    out[-m:] = right[-m:]
    return out


class STFT:
    """Short-Time Fourier Transform (reference comparator)."""

    def __init__(self, framesize: int, hopsize: int, dftsize: int | None = None,
                 window: str = "hann", shift: bool = False,
                 device: torch.device | str = "cuda:0"):
        """Create a new STFT plan (python/src/sdft/stft.py:22-52).

        Args:
          framesize: buffer size in samples.
          hopsize: hop size in samples.
          dftsize: optional DFT size enabling asymmetric windows.
          window: window function (boxcar, hann, hamming or blackman).
          shift: enable circular shift.
          device: where the FFTs run (default cuda:0); a CUDA device with no
            card raises, nothing falls back to the CPU.
        """
        self.framesize = framesize
        self.hopsize = hopsize
        self.dftsize = dftsize
        self.window = window
        self.shift = shift
        self.device = require_device(device)

        self.analysis_window_size = framesize if dftsize is None else (dftsize - 1) * 2
        self.synthesis_window_size = framesize
        if self.analysis_window_size < self.synthesis_window_size:
            raise ValueError("Invalid framesize and dftsize combination!")

    def _analysis_window(self) -> np.ndarray:
        n, s = self.analysis_window_size, self.synthesis_window_size
        if n != s:
            return _asymmetric_analysis_window(self.window, n, s // 2)
        return _symmetric_window(self.window, n)

    def _synthesis_window(self) -> np.ndarray:
        n, s = self.analysis_window_size, self.synthesis_window_size
        if n != s:
            return _asymmetric_synthesis_window(self.window, n, s // 2)
        return _symmetric_window(self.window, s)

    def stft(self, samples) -> np.ndarray:
        """Estimate the DFT matrix (frames, frequencies) for a sample array."""
        x = torch.as_tensor(np.atleast_1d(np.asarray(samples)), device=self.device)
        if x.ndim != 1:
            raise ValueError(f"Expected 1D array (samples,), got {tuple(x.shape)}!")
        w = torch.as_tensor(self._analysis_window(), dtype=x.dtype, device=self.device)
        frames = x.unfold(0, self.analysis_window_size, self.hopsize) * w
        if self.shift:
            frames = torch.fft.fftshift(frames, dim=-1)
        return torch.fft.rfft(frames, dim=-1, norm="forward").cpu().numpy()

    def istft(self, dfts) -> np.ndarray:
        """WOLA synthesis from a DFT matrix (python/src/sdft/stft.py:83-123)."""
        dfts = np.atleast_2d(np.asarray(dfts))
        if dfts.ndim != 2:
            raise ValueError(f"Expected 2D array (frames,frequencies), got {dfts.shape}!")
        A = self._analysis_window()
        S = self._synthesis_window()
        W = S * self.hopsize / np.sum(A * S)
        n, hop = self.analysis_window_size, self.hopsize
        frames = torch.fft.irfft(torch.as_tensor(dfts, device=self.device), dim=-1,
                                 norm="forward")
        if self.shift:
            frames = torch.fft.ifftshift(frames, dim=-1)
        frames = frames * torch.as_tensor(W, dtype=frames.dtype, device=self.device)
        nframes = frames.shape[0]
        idx = (torch.arange(nframes, device=self.device)[:, None] * hop
               + torch.arange(n, device=self.device)[None, :])
        out = torch.zeros(nframes * hop + n, dtype=frames.dtype, device=self.device)
        out.index_add_(0, idx.reshape(-1), frames.reshape(-1))
        return out.cpu().numpy()
