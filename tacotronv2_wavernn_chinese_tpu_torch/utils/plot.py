"""Alignment / spectrogram plot artifacts (reference tacotron/utils/plot.py).

Uses matplotlib's object-oriented Figure/Agg API, so rendering is safe from
concurrent threads.  matplotlib is optional: without it the functions write
nothing and return False.
"""

from __future__ import annotations

import numpy as np


def _figure(figsize):
    try:
        from matplotlib.backends.backend_agg import FigureCanvasAgg
        from matplotlib.figure import Figure
    except ImportError:
        return None
    fig = Figure(figsize=figsize)
    FigureCanvasAgg(fig)
    return fig


def plot_alignment(alignment: np.ndarray, path: str, title: str = "") -> bool:
    """Alignment heatmap [T_dec, T_in] -> PNG at ``path``."""
    fig = _figure((8, 6))
    if fig is None:
        return False
    ax = fig.add_subplot()
    im = ax.imshow(np.asarray(alignment).T, aspect="auto", origin="lower", interpolation="none")
    fig.colorbar(im, ax=ax)
    ax.set_xlabel("Decoder timestep")
    ax.set_ylabel("Encoder timestep")
    if title:
        ax.set_title(title, fontsize=8)
    fig.tight_layout()
    fig.savefig(path, format="png")
    return True


def plot_spectrogram(mel: np.ndarray, path: str, title: str = "") -> bool:
    """Mel spectrogram [T, M] -> PNG at ``path``."""
    fig = _figure((10, 4))
    if fig is None:
        return False
    ax = fig.add_subplot()
    im = ax.imshow(np.asarray(mel).T, aspect="auto", origin="lower", interpolation="none")
    fig.colorbar(im, ax=ax)
    if title:
        ax.set_title(title, fontsize=8)
    fig.tight_layout()
    fig.savefig(path, format="png")
    return True
