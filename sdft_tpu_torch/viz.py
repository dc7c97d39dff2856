"""Spectrogram rendering helpers (counterpart of ``sdft_tpu.viz``).

The reference's plot utilities (test/plot.py:27-68 ``spectrogram``: dB
magnitudes ``20*log10|dft|``, inferno colormap, time/frequency extent from
the sample rate and hop size).  Inputs are complex or packed re/im
``(..., 2)`` spectra as numpy arrays or tensors on any device
(``cplx.to_numpy``).  matplotlib is imported lazily, with the Agg backend,
so the compute path never depends on it.
"""

from __future__ import annotations

import numpy as np

from .cplx import to_numpy

__all__ = ["magnitude_db", "power_db", "spectrogram", "compare_spectrograms"]

#: Floor added before the log so silent bins render at a finite dB level.
_EPS = 1e-12


def _plt():
    try:
        import matplotlib
        matplotlib.use("Agg", force=False)
        import matplotlib.pyplot as plt
        return plt
    except ImportError as e:  # pragma: no cover - environment dependent
        raise ImportError(
            "matplotlib is required for sdft_tpu_torch.viz plotting helpers"
        ) from e


def magnitude_db(dfts) -> np.ndarray:
    """dB magnitude matrix ``20*log10|dft|`` (reference: test/plot.py:49-57)
    of complex (hops, bins) spectra or packed re/im ``(..., 2)`` ones."""
    a = to_numpy(dfts)
    if a.ndim >= 1 and not np.iscomplexobj(a) and a.shape[-1] == 2:
        a = a[..., 0] + 1j * a[..., 1]
    with np.errstate(divide="ignore"):
        return 20.0 * np.log10(np.abs(a) + _EPS)


def power_db(power) -> np.ndarray:
    """dB matrix ``10*log10(power)`` for |dft|^2 planes (``api.sdft_power``)
    — equals magnitude_db of the corresponding complex spectra."""
    p = np.asarray(to_numpy(power), np.float64)
    with np.errstate(divide="ignore"):
        return 10.0 * np.log10(p + _EPS * _EPS)


def spectrogram(dfts, samplerate: int, hopsize: int = 1, *, ax=None,
                vmin: float = -120.0, vmax: float = 0.0, cmap: str = "inferno",
                title: str | None = None):
    """Render a dB spectrogram of SDFT output rows.

    Args:
      dfts: (hops, bins) complex or packed (hops, bins, 2) spectra — one row
        per processed hop, as the driver protocol emits them
        (reference: test/test.c:82 keeps the first DFT vector per hop).
      samplerate: input sample rate in Hz.
      hopsize: samples between consecutive rows (sets the time extent,
        reference: test/plot.py:39-44).
      ax: optional matplotlib axes; a new figure is created otherwise.

    Returns the matplotlib Axes containing the image.
    """
    plt = _plt()
    db = magnitude_db(dfts)
    hops, bins = db.shape
    if ax is None:
        _, ax = plt.subplots(figsize=(10, 5))
    extent = (0.0, hops * hopsize / samplerate, 0.0, samplerate / 2.0)
    im = ax.imshow(db.T, origin="lower", aspect="auto", cmap=cmap,
                   extent=extent, vmin=vmin, vmax=vmax)
    ax.set_xlabel("time [s]")
    ax.set_ylabel("frequency [Hz]")
    if title:
        ax.set_title(title)
    ax.figure.colorbar(im, ax=ax, label="dB")
    return ax


def compare_spectrograms(named_dfts, samplerate: int, hopsize: int = 1, *,
                         path: str | None = None, **kw):
    """Side-by-side spectrograms — the reference's visual proof-of-concept
    (reference: test/main.py:83-86, README.md:121-129).

    Args:
      named_dfts: iterable of (label, dfts) pairs.
      path: if given, the figure is saved there and closed.

    Returns the Figure (already closed if ``path`` was given).
    """
    plt = _plt()
    items = list(named_dfts)
    fig, axes = plt.subplots(1, len(items), figsize=(7 * len(items), 5),
                             squeeze=False)
    for ax, (label, dfts) in zip(axes[0], items):
        spectrogram(dfts, samplerate, hopsize, ax=ax, title=label, **kw)
    fig.tight_layout()
    if path is not None:
        fig.savefig(path, dpi=100)
        plt.close(fig)
    return fig
