"""The acoustic-model <-> vocoder mel range adapters, in numpy on the host."""

from __future__ import annotations

import numpy as np

from ..config import AudioConfig


def mel_to_unit(mel: np.ndarray, cfg: AudioConfig) -> np.ndarray:
    """Acoustic-model mels ([-4, 4]) -> vocoder contract ([0, 1])."""
    m = cfg.max_abs_value
    return np.clip((mel + m) / (2.0 * m), 0.0, 1.0)


def unit_to_mel(unit: np.ndarray, cfg: AudioConfig) -> np.ndarray:
    m = cfg.max_abs_value
    return unit * 2.0 * m - m
