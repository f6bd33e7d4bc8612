"""Mu-law companding and n-bit label conversion.

Reference: tacotron/datasets/audio.py:8-11 (encode, used for WaveRNN
targets) and wavernn/utils/dsp.py:8-45 (label/float conversions, decode).
The label conversions on the sample-loop path take torch tensors;
``encode_mu_law``, ``decode_mu_law`` and ``float_2_label`` are numpy, for
the host paths (GTA).
"""

from __future__ import annotations

import numpy as np
import torch


def label_2_float(x: torch.Tensor, bits: int) -> torch.Tensor:
    """Integer label [0, 2^bits-1] -> float [-1, 1].

    The op order ``2*x / (n-1) - 1`` is part of the contract: the sample
    loops feed this value back, and the precomputed-reciprocal form differs
    by one ulp for some labels, which lets greedy trajectories diverge."""
    return 2.0 * x.to(torch.float32) / (2**bits - 1.0) - 1.0


def mu_law_expand(labels: torch.Tensor, bits: int) -> torch.Tensor:
    """Labels [0, 2**bits) -> float wav by mu-law expansion
    (reference decode_mu_law with from_labels=True, dsp.py:42-47)."""
    mu = 2**bits - 1
    x = 2.0 * labels.to(torch.float32) / mu - 1.0
    return torch.sign(x) / mu * ((1.0 + mu) ** torch.abs(x) - 1.0)


def bits_from_mu(mu: int) -> int:
    return int(mu).bit_length() - 1


def encode_mu_law(x: np.ndarray, mu: int = 1024) -> np.ndarray:
    """[-1,1] float -> integer label in [0, mu-1] (reference audio.py:8-11)."""
    m = mu - 1
    fx = np.sign(x) * np.log1p(m * np.abs(x)) / np.log1p(np.float32(m))
    return np.floor((fx + 1) / 2 * m + 0.5).astype(np.int32)


def decode_mu_law(y: np.ndarray, mu: int = 1024, from_labels: bool = True) -> np.ndarray:
    """Labels (or [-1,1] floats) -> linear waveform (reference dsp.py:38-45)."""
    m = mu - 1
    if from_labels:
        y = 2.0 * np.asarray(y).astype(np.float32) / (2 ** bits_from_mu(mu) - 1.0) - 1.0
    return np.sign(y) / m * ((1 + m) ** np.abs(y) - 1)


def float_2_label(x: np.ndarray, bits: int) -> np.ndarray:
    """Float [-1, 1] -> integer label, scaled down by the peak when it
    exceeds 1 (reference dsp.py:12-14)."""
    x = x / max(float(np.max(np.abs(x))), 1.0)
    return np.round((x + 1.0) * (2**bits - 1) / 2.0).astype(np.int32)
