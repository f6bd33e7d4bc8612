"""The port's DSP (``dsp/spectrogram.py``, ``dsp/wav.py``, ``dsp/mulaw.py``)
against the JAX package's on the CPU, on the same numpy inputs.

Tolerances (measured on the CPU in brackets):
- the mel basis, windows and frame counts: equal (both numpy);
- stft 1e-5 of max|D| [1.9e-7]; istft 1e-5 of the max [3.0e-7];
- normalize/denormalize 1e-5 (1e-3 dB) [the same f32 formula];
- the mel spectrogram 1e-5 normalized units [1.4e-6], 1e-4 dB before
  normalization [1.1e-5];
- the linear spectrogram 1e-4 normalized units [6.2e-5]: bins of near-zero
  magnitude carry the two FFT libraries' f32 rounding through the log;
- mel_to_linear_mag / linear_to_mag 1e-5 of the max [1.3e-7, 7.5e-8];
- wav conditioning and mu-law labels: equal (the same numpy/scipy code
  and f32 formulas).
"""

from __future__ import annotations

import dataclasses
import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tacotronv2_wavernn_chinese_tpu.config import default_config

JS = importlib.import_module("tacotronv2_wavernn_chinese_tpu.dsp.spectrogram")
JW = importlib.import_module("tacotronv2_wavernn_chinese_tpu.dsp.wav")
JM = importlib.import_module("tacotronv2_wavernn_chinese_tpu.dsp.mulaw")
PS = importlib.import_module("tacotronv2_wavernn_chinese_tpu_torch.dsp.spectrogram")
PW = importlib.import_module("tacotronv2_wavernn_chinese_tpu_torch.dsp.wav")
PM = importlib.import_module("tacotronv2_wavernn_chinese_tpu_torch.dsp.mulaw")

AUDIO = default_config().audio
N_FFT, HOP, WIN = AUDIO.n_fft, AUDIO.hop_size, AUDIO.win_size


def _wavs(n=2, samples=HOP * 40 + 17, seed=0):
    """Noise plus two partials: a spread of bin magnitudes, none exactly 0."""
    rng = np.random.default_rng(seed)
    t = np.arange(samples) / AUDIO.sample_rate
    tone = 0.3 * np.sin(2 * np.pi * 220 * t) + 0.1 * np.sin(2 * np.pi * 1870 * t)
    return (tone + rng.uniform(-0.2, 0.2, (n, samples))).astype(np.float32)


def _rel(a, b):
    return float(np.abs(np.asarray(a) - np.asarray(b)).max() / max(np.abs(np.asarray(a)).max(), 1e-30))


@pytest.mark.parametrize("fmin,fmax,n_mels,n_fft", [(95.0, 7600.0, 80, 2048), (0.0, 8000.0, 40, 512),
                                                    (125.0, 11025.0, 80, 1024)])
def test_mel_basis_matches_jax(fmin, fmax, n_mels, n_fft):
    a = JS.mel_basis(22050, n_fft, n_mels, fmin, fmax)
    b = PS.mel_basis(22050, n_fft, n_mels, fmin, fmax)
    np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(JS.padded_window(WIN, N_FFT), PS.padded_window(WIN, N_FFT))
    for n in (0, 1, 2047, 2048, 12345):
        assert JS.num_frames(n, n_fft, HOP) == PS.num_frames(n, n_fft, HOP)


def test_stft_istft_match_jax():
    wavs = _wavs()
    D_p = PS.stft(torch.as_tensor(wavs), N_FFT, HOP, WIN).numpy()
    y_p = PS.istft(torch.as_tensor(D_p), N_FFT, HOP, WIN).numpy()
    y_len = PS.istft(torch.as_tensor(D_p), N_FFT, HOP, WIN, length=1000).numpy()
    assert D_p.shape == (2, PS.num_frames(wavs.shape[1], N_FFT, HOP), N_FFT // 2 + 1)
    for i in range(2):
        D_j = np.asarray(JS.stft(jnp.asarray(wavs[i]), N_FFT, HOP, WIN))
        assert _rel(D_j, D_p[i]) <= 1e-5
        y_j = np.asarray(JS.istft(jnp.asarray(D_j), N_FFT, HOP, WIN))
        assert y_j.shape == y_p[i].shape
        assert _rel(y_j, y_p[i]) <= 1e-5
        np.testing.assert_array_equal(y_len[i], y_p[i][:1000])


@pytest.mark.parametrize("symmetric,clip", [(True, True), (True, False), (False, True), (False, False)])
def test_normalize_denormalize_match_jax(symmetric, clip):
    cfg = dataclasses.replace(AUDIO, symmetric_mels=symmetric, allow_clipping_in_normalization=clip)
    S = np.random.default_rng(1).uniform(-130.0, 30.0, (50, 80)).astype(np.float32)
    n_j = np.asarray(JS.normalize(jnp.asarray(S), cfg))
    n_p = PS.normalize(torch.as_tensor(S), cfg).numpy()
    np.testing.assert_allclose(n_p, n_j, atol=1e-5)
    d_j = np.asarray(JS.denormalize(jnp.asarray(n_j), cfg))
    d_p = PS.denormalize(torch.as_tensor(n_j), cfg).numpy()
    np.testing.assert_allclose(d_p, d_j, atol=1e-5 * 100)  # dB units: 1e-5 of the 100 dB range
    a = np.abs(S) / 10
    np.testing.assert_allclose(PS.amp_to_db(torch.as_tensor(a), -100.0).numpy(),
                               np.asarray(JS.amp_to_db(jnp.asarray(a), -100.0)), atol=1e-4)
    np.testing.assert_allclose(PS.db_to_amp(torch.as_tensor(S / 10)).numpy(),
                               np.asarray(JS.db_to_amp(jnp.asarray(S / 10))), rtol=1e-5)


@pytest.mark.parametrize("method,tol", [("stft_mag", 1e-5), ("melspectrogram", 1e-5),
                                        ("linearspectrogram", 1e-4)])
def test_mel_pipeline_analysis_matches_jax(method, tol):
    wavs = _wavs(seed=2)
    jp, pp = JS.MelPipeline(AUDIO), PS.MelPipeline(AUDIO, "cpu")
    out_p = getattr(pp, method)(wavs).numpy()
    for i in range(len(wavs)):
        out_j = np.asarray(getattr(jp, method)(jnp.asarray(wavs[i])))
        assert out_j.shape == out_p[i].shape
        err = _rel(out_j, out_p[i]) if method == "stft_mag" else float(np.abs(out_j - out_p[i]).max())
        assert err <= tol, f"{method}: {err:.3e}"


def test_mel_db_before_normalization_matches_jax():
    """The mel in dB, before clipping: within 1e-4 dB."""
    wav = _wavs(1, seed=3)[0]
    jp, pp = JS.MelPipeline(AUDIO), PS.MelPipeline(AUDIO, "cpu")
    mel_j = np.asarray(jp.stft_mag(jnp.asarray(wav))) @ JS.mel_basis(22050, N_FFT, 80, 95.0, 7600.0).T
    db_j = 20 * np.log10(np.maximum(mel_j, 1e-5))
    mel_p = torch.matmul(pp.stft_mag(wav), pp._mel_w.T)
    db_p = PS.amp_to_db(mel_p, -100.0).numpy()
    assert np.abs(db_j - db_p).max() <= 1e-4


@pytest.mark.parametrize("method", ["mel_to_linear_mag", "linear_to_mag"])
def test_mel_pipeline_synthesis_matches_jax(method):
    bins = 80 if method == "mel_to_linear_mag" else N_FFT // 2 + 1
    x = np.random.default_rng(4).uniform(-4.0, 4.0, (2, 24, bins)).astype(np.float32)
    jp, pp = JS.MelPipeline(AUDIO), PS.MelPipeline(AUDIO, "cpu")
    out_p = getattr(pp, method)(x).numpy()
    for i in range(2):
        assert _rel(np.asarray(getattr(jp, method)(jnp.asarray(x[i]))), out_p[i]) <= 1e-5


def test_wav_conditioning_matches_jax(tmp_path):
    from scipy.io import wavfile

    rng = np.random.default_rng(5)
    body = (0.5 * np.sin(np.arange(30000) * 0.05) * rng.uniform(0.5, 1.0, 30000)).astype(np.float32)
    wav = np.concatenate([np.zeros(9000, np.float32), body, 1e-5 * np.ones(7000, np.float32)])
    for dtype, scale in ((np.int16, 32767), (np.float32, 1.0)):
        path = str(tmp_path / f"x-{np.dtype(dtype).name}.wav")
        wavfile.write(path, 16000, (wav * scale).astype(dtype))
        np.testing.assert_array_equal(PW.load_wav(path, 22050), JW.load_wav(path, 22050))
    np.testing.assert_array_equal(PW.trim_silence(wav, 25.0, 2048, 512), JW.trim_silence(wav, 25.0, 2048, 512))
    assert len(PW.trim_silence(wav)) < len(wav)
    np.testing.assert_array_equal(PW.preemphasis(wav, 0.97), JW.preemphasis(wav, 0.97))
    np.testing.assert_array_equal(PW.inv_preemphasis(wav, 0.97), JW.inv_preemphasis(wav, 0.97))
    np.testing.assert_array_equal(PW.rescale(wav, 0.999), JW.rescale(wav, 0.999))
    np.testing.assert_array_equal(PW.rescale(np.zeros(8, np.float32)), np.zeros(8, np.float32))


@pytest.mark.parametrize("bits", [8, 9, 10])
def test_mu_law_matches_jax(bits):
    mu = 2**bits
    x = np.concatenate([np.linspace(-1, 1, 4001), np.random.default_rng(bits).uniform(-1, 1, 999)]).astype(np.float32)
    lab_j = JM.encode_mu_law(x, mu=mu, xp=np)
    np.testing.assert_array_equal(PM.encode_mu_law(x, mu=mu), lab_j)
    dec_j = np.asarray(JM.decode_mu_law(jnp.asarray(lab_j), mu=mu))
    np.testing.assert_allclose(PM.decode_mu_law(lab_j, mu=mu), dec_j, atol=1e-6)
    expand = PM.mu_law_expand(torch.as_tensor(lab_j), bits).numpy()  # the sample loops' torch form
    np.testing.assert_allclose(expand, dec_j, atol=1e-6)
    loud = 1.7 * x
    for v in (x, loud):
        lab = np.asarray(JM.float_2_label(jnp.asarray(v), bits))
        np.testing.assert_array_equal(PM.float_2_label(v, bits), lab)
