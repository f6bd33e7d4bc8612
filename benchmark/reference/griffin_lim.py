"""Griffin-Lim reconstruction of a served mel, as the lturing recipe
serves it without a vocoder (librosa conventions, audio.py of the
reference): denormalise the [-4, 4] mel to dB, back to amplitude, through
the pseudo-inverse of the Slaney mel filterbank, raise to ``power``, then
``griffin_lim_iters`` iterations of inverse and forward STFT (a periodic
Hann window of ``win_size`` centred in ``n_fft``, the signal centre-padded
with zeros) from a uniform phase drawn by a generator seeded 0 on the
device, then the inverse preemphasis on the host.

The reference reconstructs the batch a request was served in (its rows'
mels, the padding rows and frames as served), so that the transforms run
at the served shapes.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F
from scipy import signal


def hann(win_size: int, n_fft: int) -> np.ndarray:
    n = np.arange(win_size)
    w = (0.5 - 0.5 * np.cos(2.0 * np.pi * n / win_size)).astype(np.float32)
    out = np.zeros(n_fft, np.float32)
    left = (n_fft - win_size) // 2
    out[left: left + win_size] = w
    return out


def _hz_to_mel(f):
    f = np.asarray(f, np.float64)
    sp, lo_hz = 200.0 / 3, 1000.0
    step = np.log(6.4) / 27.0
    return np.where(f >= lo_hz, lo_hz / sp + np.log(np.maximum(f, 1e-10) / lo_hz) / step, f / sp)


def _mel_to_hz(m):
    m = np.asarray(m, np.float64)
    sp, lo_hz = 200.0 / 3, 1000.0
    step = np.log(6.4) / 27.0
    return np.where(m >= lo_hz / sp, lo_hz * np.exp(step * (m - lo_hz / sp)), m * sp)


def mel_filterbank(sr: int, n_fft: int, n_mels: int, fmin: float, fmax: float) -> np.ndarray:
    """Slaney-scale triangles with Slaney area normalisation, [n_mels, bins]."""
    freqs = np.linspace(0.0, sr / 2.0, 1 + n_fft // 2)
    hz = _mel_to_hz(np.linspace(_hz_to_mel(fmin), _hz_to_mel(fmax), n_mels + 2))
    fdiff = np.diff(hz)
    ramps = hz[:, None] - freqs[None, :]
    w = np.maximum(0.0, np.minimum(-ramps[:-2] / fdiff[:-1, None], ramps[2:] / fdiff[1:, None]))
    w *= (2.0 / (hz[2: n_mels + 2] - hz[:n_mels]))[:, None]
    return w.astype(np.float32)


def _ola(frames, hop):
    B, n, N = frames.shape
    total = N + hop * (n - 1)
    out = frames.new_zeros(B, total)
    for i in range(n):
        out[:, i * hop: i * hop + N] += frames[:, i]
    return out


def stft(y, n_fft, hop, win):
    pad = n_fft // 2
    frames = F.pad(y, (pad, pad)).unfold(-1, n_fft, hop) * win
    return torch.fft.rfft(frames, dim=-1)


def istft(spec, n_fft, hop, win, env):
    frames = torch.fft.irfft(spec, n=n_fft, dim=-1) * win
    y = _ola(frames, hop) / env
    pad = n_fft // 2
    return y[:, pad: y.shape[1] - pad]


def reconstruct(mels: list, ac: dict, dev, decode_frames: int, batch: int | None = None) -> list:
    """Served mels [T_i, 80], reconstructed as the batch they were served
    in: padded with silence to round_up(decode_frames + 1, 64) frames, and
    to ``batch`` rows by repeating the last -> their waveforms [T_i * hop]
    (float32, host)."""
    n_fft, hop, win_size = ac["n_fft"], ac["hop_size"], ac["win_size"]
    m = ac["max_abs_value"]
    T_pad = -(-max(decode_frames + 1, 64) // 64) * 64
    B = max(batch or len(mels), len(mels))
    x = np.full((B, T_pad, mels[0].shape[1]), -m, np.float32)
    for i in range(B):
        mel = mels[min(i, len(mels) - 1)]
        x[i, : mel.shape[0]] = mel
    x = torch.as_tensor(x, device=dev)
    db = (torch.clamp(x, -m, m) + m) * (-ac["min_level_db"]) / (2.0 * m) + ac["min_level_db"]
    amp = torch.pow(10.0, (db + ac["ref_level_db"]) * 0.05) ** (1.0 / ac["magnitude_power"])
    inv = torch.as_tensor(np.linalg.pinv(mel_filterbank(ac["sample_rate"], n_fft, ac["num_mels"], ac["fmin"],
                                                        ac["fmax"])), device=dev)
    S = torch.clamp_min(torch.matmul(amp, inv.T), 1e-10) ** ac["power"]
    win = torch.as_tensor(hann(win_size, n_fft), device=dev)
    env = torch.clamp_min(_ola((win * win).expand(1, T_pad, n_fft).contiguous(), hop)[0], 1e-10)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    phase = torch.rand((T_pad, n_fft // 2 + 1), generator=gen, device=dev) * (2.0 * math.pi)
    Sc = S.to(torch.complex64)
    y = istft(Sc * torch.polar(torch.ones_like(phase), phase), n_fft, hop, win, env)
    for _ in range(ac["griffin_lim_iters"]):
        D = stft(y, n_fft, hop, win)
        y = istft(Sc * (D / torch.clamp_min(torch.abs(D), 1e-8)), n_fft, hop, win, env)
    y = y.cpu().numpy().astype(np.float32)
    if ac["preemphasize"]:
        y = signal.lfilter([1], [1, -ac["preemphasis"]], y, axis=-1).astype(np.float32)
    return [y[i, : mel.shape[0] * hop] for i, mel in enumerate(mels)]
