"""Host-side wav I/O and conditioning (numpy/scipy): load, trim,
preemphasis and its inverse, rescale, and the post chain applied on save
(reference tacotron/datasets/audio.py:14-77)."""

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


def load_wav(path: str, sr: int) -> np.ndarray:
    """Read a wav as mono float32 in [-1, 1], resampled to ``sr``
    (``librosa.core.load(path, sr=sr)``, reference audio.py:15)."""
    file_sr, data = wavfile.read(path)
    if data.dtype == np.int16:
        wav = data.astype(np.float32) / 32768.0
    elif data.dtype == np.int32:
        wav = data.astype(np.float32) / 2147483648.0
    elif data.dtype == np.uint8:
        wav = (data.astype(np.float32) - 128.0) / 128.0
    else:
        wav = data.astype(np.float32)
    if wav.ndim > 1:
        wav = wav.mean(axis=1)
    if file_sr != sr:
        from math import gcd

        g = gcd(sr, file_sr)
        wav = signal.resample_poly(wav, sr // g, file_sr // g).astype(np.float32)
    return wav


def preemphasis(wav: np.ndarray, k: float, preemphasize: bool = True) -> np.ndarray:
    if preemphasize:
        return signal.lfilter([1, -k], [1], wav)
    return wav


def inv_preemphasis(wav: np.ndarray, k: float, inv_preemphasize: bool = True) -> np.ndarray:
    """IIR y[t] = x[t] + k*y[t-1] along the last axis (reference audio.py:55)."""
    if inv_preemphasize:
        return signal.lfilter([1], [1, -k], wav)
    return wav


def trim_silence(wav: np.ndarray, top_db: float = 25.0, frame_length: int = 2048,
                 hop_length: int = 512) -> np.ndarray:
    """Trim leading/trailing silence (``librosa.effects.trim``): per-frame
    RMS in dB relative to the loudest frame, keeping the span of frames
    louder than ``-top_db``."""
    if len(wav) < frame_length:
        return wav
    # center-padded framing like librosa.feature.rms(center=True)
    pad = frame_length // 2
    ypad = np.pad(wav, (pad, pad))
    n_frames = 1 + (len(ypad) - frame_length) // hop_length
    idx = np.arange(n_frames)[:, None] * hop_length + np.arange(frame_length)[None, :]
    rms = np.sqrt(np.mean(ypad[idx] ** 2, axis=1))
    ref = rms.max()
    if ref <= 0:
        return wav
    db = 20.0 * np.log10(np.maximum(rms, 1e-10) / ref)
    loud = np.nonzero(db > -top_db)[0]
    if len(loud) == 0:
        return wav
    start = int(loud[0]) * hop_length
    end = min(len(wav), int(loud[-1] + 1) * hop_length)
    return wav[start:end]


def rescale(wav: np.ndarray, rescaling_max: float = 0.999) -> np.ndarray:
    """Peak-normalize (a digitally silent input is left at zero, not NaN)."""
    return wav / max(1e-8, np.abs(wav).max()) * rescaling_max
