"""Griffin-Lim phase reconstruction on torch tensors.

The 60-iteration loop runs where its magnitudes are, batched over a leading
axis: on the card each iteration is one cuFFT inverse, an overlap-add, one
cuFFT forward and elementwise work (no hand-written kernel: the JAX package
runs the same loop in XLA, outside any Pallas kernel).  The reference runs
it in numpy on the host (audio.py:176-189).

The inverse preemphasis (``y[t] = x[t] + k*y[t-1]``) is a serial IIR.  It
runs on the host with ``scipy.signal.lfilter`` after the wav has left the
device, as the reference's audio.py:55 does, whatever the device.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..config import AudioConfig
from .spectrogram import MelPipeline, istft, stft, window_envelope
from .wav import inv_preemphasis


def initial_phase(shape, device) -> torch.Tensor:
    """The default phase: uniform [0, 2*pi) over [frames, bins] from a
    generator on ``device`` seeded 0.  It is drawn once per call and shared
    by every row of a batch, as the JAX package's ``PRNGKey(0)`` draw is
    under ``vmap``, so a batched call and a single one at the same padded
    length start from the same phase."""
    gen = torch.Generator(device=device)
    gen.manual_seed(0)
    return torch.rand(tuple(shape), generator=gen, device=device) * (2.0 * math.pi)


def griffin_lim(S: torch.Tensor, n_fft: int, hop_size: int, win_size: int, iters: int = 60,
                phase: torch.Tensor | None = None) -> torch.Tensor:
    """Magnitude spectrogram [..., frames, bins] -> waveform [..., samples]
    (the librosa recipe of reference audio.py:176-182).  ``phase``
    [frames, bins] (or broadcastable to S) is the initial phase in radians;
    None draws ``initial_phase``."""
    S = torch.abs(S)
    if phase is None:
        phase = initial_phase(S.shape[-2:], S.device)
    phase = torch.as_tensor(phase, dtype=torch.float32, device=S.device)
    Sc = S.to(torch.complex64)
    env = window_envelope(S.shape[-2], n_fft, hop_size, win_size, S.device)
    y = istft(Sc * torch.polar(torch.ones_like(phase), phase), n_fft, hop_size, win_size, envelope=env)
    for _ in range(iters):
        D = stft(y, n_fft, hop_size, win_size)
        y = istft(Sc * (D / torch.clamp_min(torch.abs(D), 1e-8)), n_fft, hop_size, win_size, envelope=env)
    return y


def preemphasis_fir(wav: torch.Tensor, k: float) -> torch.Tensor:
    """FIR y[t] = x[t] - k*x[t-1] along the last axis (reference audio.py:50)."""
    prev = torch.nn.functional.pad(wav, (1, 0))[..., :-1]
    return wav - k * prev


def inv_preemphasis_scan(wav, k: float) -> np.ndarray:
    """IIR y[t] = x[t] + k*y[t-1] along the last axis, on the host
    (``scipy.signal.lfilter``, reference audio.py:55) -> float32 numpy."""
    if isinstance(wav, torch.Tensor):
        wav = wav.detach().cpu().numpy()
    return inv_preemphasis(np.asarray(wav, np.float32), k).astype(np.float32)


def _finish(y: torch.Tensor, c: AudioConfig) -> np.ndarray:
    if c.preemphasize:
        return inv_preemphasis_scan(y, c.preemphasis)
    return y.detach().cpu().numpy()


def inv_mel_spectrogram(mel_norm, pipeline: MelPipeline, phase: torch.Tensor | None = None) -> np.ndarray:
    """Normalized mel [..., frames, mels] -> waveform [..., samples] on the
    host: Griffin-Lim on the pipeline's device, then the inverse
    preemphasis (reference audio.py:123-137)."""
    c: AudioConfig = pipeline.cfg
    mag = pipeline.mel_to_linear_mag(mel_norm)
    y = griffin_lim(mag**c.power, c.n_fft, c.hop_size, c.win_size, c.griffin_lim_iters, phase)
    return _finish(y, c)


def inv_linear_spectrogram(lin_norm, pipeline: MelPipeline, phase: torch.Tensor | None = None) -> np.ndarray:
    c: AudioConfig = pipeline.cfg
    mag = pipeline.linear_to_mag(lin_norm)
    y = griffin_lim(mag**c.power, c.n_fft, c.hop_size, c.win_size, c.griffin_lim_iters, phase)
    return _finish(y, c)
