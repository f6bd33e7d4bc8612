"""The host's WAV chain in NumPy and SciPy: the DC notch, the peak
normalisation, the 0.95-power companding and the full-scale int16 of the
served WAV (the lturing website's post-processing)."""

from __future__ import annotations

import base64
import io
import wave

import numpy as np
from scipy import signal


def postprocess_int16(wav: np.ndarray) -> np.ndarray:
    wav = np.asarray(wav, np.float64)
    if wav.size == 0:
        return np.zeros(0, np.int16)
    r = 0.982
    wav = signal.lfilter(np.array([1, -2, 1]) * r, np.array([1, -2 * r, r**2 + 0.7 * (1 - r) ** 2]), wav)
    wav = wav / max(1e-8, np.abs(wav).max()) * 0.999
    wav = 0.5 * 32767 / max(0.01, np.max(np.abs(wav))) * (np.sign(wav) * np.power(np.abs(wav), 0.95))
    wav *= 32767 / max(0.01, np.max(np.abs(wav)))
    return wav.astype(np.int16)


def wav_pcm(b64: str) -> np.ndarray:
    """The int16 samples of a base64 WAV."""
    with wave.open(io.BytesIO(base64.b64decode(b64))) as wf:
        return np.frombuffer(wf.readframes(wf.getnframes()), "<i2")
