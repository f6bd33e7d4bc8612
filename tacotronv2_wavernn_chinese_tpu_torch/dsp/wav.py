"""Host-side wav post-processing and writing (numpy/scipy)."""

from __future__ import annotations

import numpy as np
from scipy import signal
from scipy.io import wavfile


def dc_notch_filter(wav: np.ndarray) -> np.ndarray:
    """Speex DC-removal notch (reference audio.py:17-23)."""
    notch_radius = 0.982
    den = notch_radius**2 + 0.7 * (1 - notch_radius) ** 2
    b = np.array([1, -2, 1]) * notch_radius
    a = np.array([1, -2 * notch_radius, den])
    return signal.lfilter(b, a, wav)


def postprocess_wav_int16(wav: np.ndarray) -> np.ndarray:
    """DC-notch + peak normalize + 0.95-power compression + full-scale int16
    (reference audio.py:16-28 ``save_wav``; the serving path runs the same
    chain before the WAV container)."""
    wav = np.asarray(wav, dtype=np.float64)
    if wav.size == 0:
        # a stop token that fires at frame 0 gives an empty container
        return np.zeros(0, np.int16)
    wav = dc_notch_filter(wav)
    wav = wav / max(1e-8, np.abs(wav).max()) * 0.999
    f1 = 0.5 * 32767 / max(0.01, np.max(np.abs(wav)))
    f2 = np.sign(wav) * np.power(np.abs(wav), 0.95)
    wav = f1 * f2
    wav *= 32767 / max(0.01, np.max(np.abs(wav)))
    return wav.astype(np.int16)


def save_wav(wav: np.ndarray, path: str, sr: int) -> None:
    """Post-process and write an int16 wav (reference audio.py:25-34)."""
    wavfile.write(path, sr, postprocess_wav_int16(wav))
