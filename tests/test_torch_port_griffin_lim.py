"""The port's Griffin-Lim (``dsp/griffin_lim.py``) and the synthesizer's
Griffin-Lim branches against the JAX package's on the CPU.

Torch cannot draw JAX's ``PRNGKey(0)`` phase, so the JAX draw is injected:
as ``phase`` into ``griffin_lim``, or in place of the port's
``initial_phase`` for the synthesizer.  Tolerances (measured in brackets):
- ``griffin_lim``, 12 iterations: atol 2e-4 * max|y| [6e-7 relative], the
  bound ``tests/test_dsp.py`` holds the TPU's matmul variant to;
- ``inv_mel_spectrogram``, all 60 iterations, T=32: atol 2e-4 * max|y|
  [1.7e-6 relative];
- ``inv_preemphasis_scan`` (host lfilter in float64 against the JAX f32
  scan): atol 2e-4 [5e-6];
- the synthesizer's ``mel_to_wav``, ``mels_to_wavs_gl`` and the part of
  ``_synth_gl_batch`` after the decode: atol 2e-4 * max|y|.
"""

from __future__ import annotations

import dataclasses
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tacotronv2_wavernn_chinese_tpu.config import default_config
from tacotronv2_wavernn_chinese_tpu.infer import synthesizer as JSY
from tacotronv2_wavernn_chinese_tpu.models import tacotron as JT
from tacotronv2_wavernn_chinese_tpu_torch.config import _config_from_dict as port_config
from tacotronv2_wavernn_chinese_tpu_torch.infer import synthesizer as PSY
from tacotronv2_wavernn_chinese_tpu_torch.models import tacotron as PT

JS = importlib.import_module("tacotronv2_wavernn_chinese_tpu.dsp.spectrogram")
JG = importlib.import_module("tacotronv2_wavernn_chinese_tpu.dsp.griffin_lim")
PS = importlib.import_module("tacotronv2_wavernn_chinese_tpu_torch.dsp.spectrogram")
PG = importlib.import_module("tacotronv2_wavernn_chinese_tpu_torch.dsp.griffin_lim")

AUDIO = default_config().audio
ARGS = (AUDIO.n_fft, AUDIO.hop_size, AUDIO.win_size)
BINS = AUDIO.n_fft // 2 + 1


def jax_phase(shape) -> np.ndarray:
    return np.asarray(jax.random.uniform(jax.random.PRNGKey(0), tuple(shape), minval=0.0, maxval=2.0 * np.pi))


def _close(y_port, y_jax, what: str):
    y_port, y_jax = np.asarray(y_port), np.asarray(y_jax)
    assert y_port.shape == y_jax.shape, what
    scale = max(float(np.abs(y_jax).max()), 1e-9)
    np.testing.assert_allclose(y_port / scale, y_jax / scale, atol=2e-4, err_msg=what)


@pytest.mark.parametrize("frames", [24, 48])
def test_griffin_lim_matches_jax(frames):
    """Two rows in one batched call, each against the JAX loop with the
    same (shared) phase."""
    rng = np.random.RandomState(frames)
    S = rng.uniform(0.0, 2.0, (2, frames, BINS)).astype(np.float32)
    ph = jax_phase((frames, BINS))
    y_p = PG.griffin_lim(torch.as_tensor(S), *ARGS, iters=12, phase=torch.as_tensor(ph)).numpy()
    assert y_p.shape == (2, AUDIO.hop_size * (frames - 1))
    for i in range(2):
        y_j = JG.griffin_lim(jnp.asarray(S[i]), jax.random.PRNGKey(0), *ARGS, iters=12)
        _close(y_p[i], y_j, f"row {i}")


def test_inv_mel_spectrogram_matches_jax():
    mel = np.random.default_rng(7).uniform(-4.0, 4.0, (32, 80)).astype(np.float32)
    y_j = JG.inv_mel_spectrogram(jnp.asarray(mel), JS.MelPipeline(AUDIO))
    y_p = PG.inv_mel_spectrogram(mel, PS.MelPipeline(AUDIO, "cpu"), phase=torch.as_tensor(jax_phase((32, BINS))))
    assert isinstance(y_p, np.ndarray) and y_p.dtype == np.float32
    _close(y_p, y_j, "inv_mel_spectrogram")


def test_inv_linear_spectrogram_matches_jax():
    lin = np.random.default_rng(8).uniform(-4.0, 0.0, (16, BINS)).astype(np.float32)
    y_j = JG.inv_linear_spectrogram(jnp.asarray(lin), JS.MelPipeline(AUDIO))
    y_p = PG.inv_linear_spectrogram(lin, PS.MelPipeline(AUDIO, "cpu"),
                                    phase=torch.as_tensor(jax_phase((16, BINS))))
    _close(y_p, y_j, "inv_linear_spectrogram")


@pytest.mark.parametrize("n", [1, 7001])
def test_inv_preemphasis_matches_jax(n):
    x = np.random.RandomState(3).randn(2, n).astype(np.float32)
    y_p = PG.inv_preemphasis_scan(torch.as_tensor(x), 0.97)
    for i in range(2):
        y_j = np.asarray(JG.inv_preemphasis_scan(jnp.asarray(x[i]), 0.97))
        np.testing.assert_allclose(y_p[i], y_j, atol=2e-4, rtol=1e-5)
    z = PG.preemphasis_fir(torch.as_tensor(x), 0.97).numpy()
    np.testing.assert_allclose(z[0], np.asarray(JG.preemphasis_fir(jnp.asarray(x[0]), 0.97)), atol=1e-6)
    np.testing.assert_allclose(PG.inv_preemphasis_scan(z, 0.97), x, atol=1e-4)


def test_initial_phase_is_shared_and_seeded():
    a = PG.initial_phase((64, BINS), torch.device("cpu"))
    b = PG.initial_phase((64, BINS), torch.device("cpu"))
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert float(a.min()) >= 0.0 and float(a.max()) < 2.0 * np.pi


# ---------------------------------------------------------------------------
# the synthesizer's Griffin-Lim branches
# ---------------------------------------------------------------------------

TEXTS = ["你好。", "今天天气很好。", "这是第3个句子。"]


def _tiny():
    cfg = default_config()
    return dataclasses.replace(cfg, tacotron=dataclasses.replace(
        cfg.tacotron, embedding_dim=16, enc_conv_channels=16, enc_conv_layers=1, encoder_lstm_units=8,
        attention_dim=8, attention_filters=4, attention_kernel=5, prenet_layers=(8, 8),
        decoder_lstm_units=8, postnet_channels=8, postnet_layers=1, max_iters=40))


@pytest.fixture(scope="module")
def synths():
    cfg = _tiny()
    params = jax.jit(lambda k: JT.init_tacotron(k, cfg.tacotron))(jax.random.PRNGKey(0))
    jsy = JSY.Synthesizer(cfg, params)
    psy = PSY.Synthesizer(port_config(cfg.to_dict()), jax.device_get(params), device="cpu")
    return jsy, psy


@pytest.fixture
def jax_phase_in_port(monkeypatch):
    """The port's synthesizer draws JAX's phase for each padded length."""
    monkeypatch.setattr(PG, "initial_phase", lambda shape, device: torch.as_tensor(jax_phase(shape), device=device))


def _mels(lengths, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.uniform(-4.0, 4.0, (n, 80)).astype(np.float32) for n in lengths]


@pytest.mark.parametrize("T", [30, 64])
def test_mel_to_wav_matches_jax(synths, jax_phase_in_port, T):
    """One mel, padded with silence to its 64-frame bucket (T=64 takes the
    next bucket: the reconstruction is hop*(T_pad-1) samples)."""
    jsy, psy = synths
    mel = _mels([T])[0]
    w_p = psy.mel_to_wav(mel)
    assert w_p.shape == (T * AUDIO.hop_size,)
    _close(w_p, jsy.mel_to_wav(mel), "mel_to_wav")


def test_mels_to_wavs_gl_matches_jax(synths, jax_phase_in_port):
    jsy, psy = synths
    mels = _mels([20, 45, 33], seed=1)
    w_p = psy.mels_to_wavs_gl(mels)
    w_j = jsy.mels_to_wavs_gl(mels)
    for m, a, b in zip(mels, w_p, w_j):
        assert a.shape == (m.shape[0] * AUDIO.hop_size,)
        _close(a, b, "mels_to_wavs_gl")


def test_mels_to_wavs_gl_equals_mel_to_wav_in_one_bucket(synths):
    """With the port's own phase: rows of a batch in the same 64-frame
    bucket as their single calls start from the same phase."""
    _, psy = synths
    mels = _mels([50, 12, 63], seed=2)
    batch = psy.mels_to_wavs_gl(mels)
    for m, w in zip(mels, batch):
        np.testing.assert_allclose(w, psy.mel_to_wav(m), rtol=0, atol=1e-5 * np.abs(w).max())
    assert psy.mels_to_wavs(mels)[1].shape == (12 * AUDIO.hop_size,)


def test_synth_gl_batch_after_decode_matches_jax(synths, jax_phase_in_port, monkeypatch):
    """The decode stubbed in both packages to the same outputs (B=3, 40
    frames, stop lengths 17, 40, 1): the masked, padded, batched
    reconstruction and the per-row trims agree."""
    jsy, psy = synths
    B, T_max, T_in = 3, 40, 48
    rng = np.random.default_rng(3)
    mel = rng.uniform(-4.0, 4.0, (B, T_max, 80)).astype(np.float32)
    align = rng.uniform(0.0, 1.0, (B, T_max, T_in)).astype(np.float32)
    stops = np.asarray([17, 40, 1], np.int32)

    def jax_stub(params, cfg, inputs, lens, rng_, mi, use_pallas_decoder=False):
        return JT.TacotronOutput(jnp.asarray(mel), jnp.asarray(mel), jnp.zeros((B, T_max)),
                                 jnp.asarray(align[:, :, : inputs.shape[1]]), jnp.asarray(stops))

    def port_stub(params, cfg, inputs, lens, seeds, max_iters):
        return PT.TacotronOutput(torch.as_tensor(mel), torch.as_tensor(mel), torch.zeros(B, T_max),
                                 torch.as_tensor(align[:, :, : inputs.shape[1]]), torch.as_tensor(stops))

    monkeypatch.setattr(JT, "forward_inference", jax_stub)
    monkeypatch.setattr(PT, "forward_inference", port_stub)
    res_j = jsy.synthesize_batch(TEXTS, seed=[1, 2, 3])
    res_p = psy.synthesize_batch(TEXTS, seed=[1, 2, 3])
    for n, a, b in zip(stops, res_p, res_j):
        assert a["pyin"] == b["pyin"]
        assert a["wav"].shape == (n * AUDIO.hop_size,)
        np.testing.assert_array_equal(a["mel"], b["mel"])
        np.testing.assert_array_equal(a["alignment"], b["alignment"])
        _close(a["wav"], b["wav"], "_synth_gl_batch")
    one = psy.synthesize(TEXTS[0], seed=1)
    np.testing.assert_array_equal(one["mel"], res_p[0]["mel"])
