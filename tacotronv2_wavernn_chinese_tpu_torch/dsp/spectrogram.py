"""STFT / mel spectrogram pipeline on torch tensors.

The same conventions as the JAX package's pipeline (reference
tacotron/datasets/audio.py:86-102, 203-295):

* hann window (periodic) of ``win_size`` centered inside ``n_fft``;
* signal center-padded by ``n_fft//2`` with zeros (librosa
  ``pad_mode='constant'``);
* mel filterbank: Slaney scale, Slaney area normalization (librosa defaults);
* ``amp_to_db(|D|**2)`` with a -100 dB floor, 20 dB reference subtraction;
* symmetric [-4, 4] clipped normalization.

The transforms mirror the JAX package's explicitly instead of calling
``torch.stft``/``torch.istft`` (which pad by reflection and check the window
envelope): framing is ``unfold`` of the zero-padded signal (the JAX index
gather), the DFTs are ``torch.fft.rfft``/``irfft``, the overlap-add is
``torch.nn.functional.fold`` (the JAX scatter-add), and the inverse divides
by ``max(sum of squared windows, 1e-10)`` and trims ``n_fft//2`` at both
ends.  On the card the FFTs run in cuFFT and the mel projection in one
matmul.  Every transform takes a leading batch axis.

The constructors (windows, the mel basis) are numpy, and so are
``mel_to_unit``/``unit_to_mel``, which the host paths use.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from ..config import AudioConfig
from ..utils import resolve_device

# ---------------------------------------------------------------------------
# Static constructors (numpy)
# ---------------------------------------------------------------------------


def hann_window(win_size: int) -> np.ndarray:
    """Periodic Hann window (scipy ``get_window('hann', n, fftbins=True)``)."""
    n = np.arange(win_size)
    return (0.5 - 0.5 * np.cos(2.0 * np.pi * n / win_size)).astype(np.float32)


def padded_window(win_size: int, n_fft: int) -> np.ndarray:
    """Window centered inside the FFT frame (librosa ``util.pad_center``)."""
    win = hann_window(win_size)
    lpad = (n_fft - win_size) // 2
    out = np.zeros(n_fft, dtype=np.float32)
    out[lpad : lpad + win_size] = win
    return out


def _hz_to_mel_slaney(f: np.ndarray) -> np.ndarray:
    f = np.asarray(f, dtype=np.float64)
    f_sp = 200.0 / 3
    min_log_hz = 1000.0
    min_log_mel = min_log_hz / f_sp
    logstep = np.log(6.4) / 27.0
    mel = f / f_sp
    log_region = f >= min_log_hz
    mel = np.where(log_region, min_log_mel + np.log(np.maximum(f, 1e-10) / min_log_hz) / logstep, mel)
    return mel


def _mel_to_hz_slaney(m: np.ndarray) -> np.ndarray:
    m = np.asarray(m, dtype=np.float64)
    f_sp = 200.0 / 3
    min_log_hz = 1000.0
    min_log_mel = min_log_hz / f_sp
    logstep = np.log(6.4) / 27.0
    f = m * f_sp
    log_region = m >= min_log_mel
    return np.where(log_region, min_log_hz * np.exp(logstep * (m - min_log_mel)), f)


def mel_basis(sample_rate: int, n_fft: int, num_mels: int, fmin: float, fmax: float) -> np.ndarray:
    """Slaney-normalized triangular mel filterbank, shape [num_mels, 1+n_fft/2]
    (``librosa.filters.mel`` defaults, htk=False, norm='slaney')."""
    fftfreqs = np.linspace(0.0, sample_rate / 2.0, 1 + n_fft // 2)
    mel_pts = np.linspace(_hz_to_mel_slaney(fmin), _hz_to_mel_slaney(fmax), num_mels + 2)
    hz_pts = _mel_to_hz_slaney(mel_pts)
    fdiff = np.diff(hz_pts)
    ramps = hz_pts[:, None] - fftfreqs[None, :]
    lower = -ramps[:-2] / fdiff[:-1, None]
    upper = ramps[2:] / fdiff[1:, None]
    weights = np.maximum(0.0, np.minimum(lower, upper))
    enorm = 2.0 / (hz_pts[2 : num_mels + 2] - hz_pts[:num_mels])
    weights *= enorm[:, None]
    return weights.astype(np.float32)


def num_frames(n_samples: int, n_fft: int, hop_size: int) -> int:
    """Frame count for a center-padded signal (librosa convention)."""
    return 1 + (n_samples + 2 * (n_fft // 2) - n_fft) // hop_size


# ---------------------------------------------------------------------------
# Transforms on tensors ([..., samples] and [..., frames, bins])
# ---------------------------------------------------------------------------


def _window(win_size: int, n_fft: int, device) -> torch.Tensor:
    return torch.as_tensor(padded_window(win_size, n_fft), device=device)


def stft(y: torch.Tensor, n_fft: int, hop_size: int, win_size: int) -> torch.Tensor:
    """Complex STFT of [..., samples] -> [..., frames, 1 + n_fft//2]."""
    pad = n_fft // 2
    ypad = F.pad(y, (pad, pad))
    frames = ypad.unfold(-1, n_fft, hop_size) * _window(win_size, n_fft, y.device)
    return torch.fft.rfft(frames, dim=-1)


def _overlap_add(frames: torch.Tensor, hop_size: int) -> torch.Tensor:
    """[B, frames, n_fft] -> [B, n_fft + hop*(frames-1)] summed at stride hop."""
    B, n_fr, n_fft = frames.shape
    total = n_fft + hop_size * (n_fr - 1)
    out = F.fold(frames.transpose(1, 2), output_size=(1, total), kernel_size=(1, n_fft),
                 stride=(1, hop_size))
    return out.reshape(B, total)


def window_envelope(n_fr: int, n_fft: int, hop_size: int, win_size: int, device) -> torch.Tensor:
    """max(overlap-added squared window, 1e-10) over [n_fft + hop*(n_fr-1)]
    samples: the inverse's normalizer."""
    w = _window(win_size, n_fft, device)
    wsq = _overlap_add((w * w).expand(1, n_fr, n_fft), hop_size)[0]
    return torch.clamp_min(wsq, 1e-10)


def istft(spec: torch.Tensor, n_fft: int, hop_size: int, win_size: int, length: int | None = None,
          envelope: torch.Tensor | None = None) -> torch.Tensor:
    """Inverse STFT [..., frames, bins] -> [..., samples] with windowed
    overlap-add and squared-window normalization, trimming the ``n_fft//2``
    center padding (``librosa.istft``, reference audio.py:209-210).
    ``envelope`` is ``window_envelope`` for these frames, when the caller
    holds it already (Griffin-Lim's loop)."""
    lead, n_fr = spec.shape[:-2], spec.shape[-2]
    frames = torch.fft.irfft(spec, n=n_fft, dim=-1) * _window(win_size, n_fft, spec.device)
    y = _overlap_add(frames.reshape(-1, n_fr, n_fft), hop_size)
    if envelope is None:
        envelope = window_envelope(n_fr, n_fft, hop_size, win_size, spec.device)
    y = y / envelope
    pad = n_fft // 2
    y = y[:, pad : y.shape[1] - pad]
    if length is not None:
        y = y[:, :length]
    return y.reshape(*lead, y.shape[1])


def amp_to_db(x: torch.Tensor, min_level_db: float) -> torch.Tensor:
    min_level = math.exp(min_level_db / 20.0 * math.log(10.0))
    return 20.0 * torch.log10(torch.clamp_min(x, min_level))


def db_to_amp(x: torch.Tensor) -> torch.Tensor:
    return torch.pow(10.0, x * 0.05)


def normalize(S: torch.Tensor, cfg: AudioConfig) -> torch.Tensor:
    """dB spectrogram -> normalized range ([-4,4] symmetric by default)."""
    scaled = (S - cfg.min_level_db) / (-cfg.min_level_db)
    if cfg.symmetric_mels:
        out = 2.0 * cfg.max_abs_value * scaled - cfg.max_abs_value
        lo, hi = -cfg.max_abs_value, cfg.max_abs_value
    else:
        out = cfg.max_abs_value * scaled
        lo, hi = 0.0, cfg.max_abs_value
    if cfg.allow_clipping_in_normalization:
        out = torch.clamp(out, lo, hi)
    return out


def denormalize(D: torch.Tensor, cfg: AudioConfig) -> torch.Tensor:
    if cfg.symmetric_mels:
        if cfg.allow_clipping_in_normalization:
            D = torch.clamp(D, -cfg.max_abs_value, cfg.max_abs_value)
        return (D + cfg.max_abs_value) * (-cfg.min_level_db) / (2.0 * cfg.max_abs_value) + cfg.min_level_db
    if cfg.allow_clipping_in_normalization:
        D = torch.clamp(D, 0.0, cfg.max_abs_value)
    return D * (-cfg.min_level_db) / cfg.max_abs_value + cfg.min_level_db


def mel_to_unit(mel: np.ndarray, cfg: AudioConfig) -> np.ndarray:
    """Acoustic-model mels ([-4, 4]) -> vocoder contract ([0, 1])."""
    m = cfg.max_abs_value
    return np.clip((mel + m) / (2.0 * m), 0.0, 1.0)


def unit_to_mel(unit: np.ndarray, cfg: AudioConfig) -> np.ndarray:
    m = cfg.max_abs_value
    return unit * 2.0 * m - m


class MelPipeline:
    """Wav -> normalized mel/linear spectrograms on ``device`` (None: the
    card, raising without one).  The mel basis lives on the device; its
    pseudo-inverse is taken on the host in float32, as the JAX pipeline
    does, and moved there too."""

    def __init__(self, cfg: AudioConfig, device=None):
        self.cfg = cfg
        self.device = resolve_device(device)
        w = mel_basis(cfg.sample_rate, cfg.n_fft, cfg.num_mels, cfg.fmin, cfg.fmax)
        self._mel_w = torch.as_tensor(w, device=self.device)
        self._inv_mel_w = torch.as_tensor(np.linalg.pinv(w), device=self.device)

    def _tensor(self, x) -> torch.Tensor:
        return torch.as_tensor(x, dtype=torch.float32, device=self.device)

    def stft_mag(self, wav) -> torch.Tensor:
        c = self.cfg
        D = stft(self._tensor(wav), c.n_fft, c.hop_size, c.win_size)
        return torch.abs(D) ** c.magnitude_power

    def melspectrogram(self, wav) -> torch.Tensor:
        """[..., samples] wav -> [..., frames, num_mels] normalized mel
        (reference audio.py:95)."""
        c = self.cfg
        mel = torch.matmul(self.stft_mag(wav), self._mel_w.T)
        return normalize(amp_to_db(mel, c.min_level_db) - c.ref_level_db, c)

    def linearspectrogram(self, wav) -> torch.Tensor:
        c = self.cfg
        return normalize(amp_to_db(self.stft_mag(wav), c.min_level_db) - c.ref_level_db, c)

    def mel_to_linear_mag(self, mel_norm) -> torch.Tensor:
        """Normalized mel -> linear magnitude (for Griffin-Lim)."""
        c = self.cfg
        S = denormalize(self._tensor(mel_norm), c)
        amp = db_to_amp(S + c.ref_level_db) ** (1.0 / c.magnitude_power)
        return torch.clamp_min(torch.matmul(amp, self._inv_mel_w.T), 1e-10)

    def linear_to_mag(self, lin_norm) -> torch.Tensor:
        c = self.cfg
        S = denormalize(self._tensor(lin_norm), c)
        return db_to_amp(S + c.ref_level_db) ** (1.0 / c.magnitude_power)
