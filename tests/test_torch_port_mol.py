"""The port's MOL mode (ops/distribution.py, the MOL sample loop and MOL
vocoders in serving) against the JAX package, f32 on the CPU.

The JAX draws (the mixture's Gumbel noise and the logistic's uniform) are
made with JAX's own keys and injected into the port, so values compare
directly; the port's own generator is checked by its statistics."""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy import special, stats

from tacotronv2_wavernn_chinese_tpu.config import default_config as jax_default_config
from tacotronv2_wavernn_chinese_tpu.models import tacotron as JT
from tacotronv2_wavernn_chinese_tpu.models import wavernn as JW
from tacotronv2_wavernn_chinese_tpu.ops import distribution as JD
from tacotronv2_wavernn_chinese_tpu.serving.export import export_artifact
from tacotronv2_wavernn_chinese_tpu_torch.config import default_config
from tacotronv2_wavernn_chinese_tpu_torch.infer import wavernn_gen
from tacotronv2_wavernn_chinese_tpu_torch.models import wavernn as TW
from tacotronv2_wavernn_chinese_tpu_torch.ops import distribution as TD
from tacotronv2_wavernn_chinese_tpu_torch.ops import wavernn_kernel as TK
from tacotronv2_wavernn_chinese_tpu_torch.serving.export import load_exported
from tacotronv2_wavernn_chinese_tpu_torch.utils import tree_map
from tacotronv2_wavernn_chinese_tpu_torch.utils.checkpoints import (
    init_wavernn, save_params_npz, wavernn_from_numpy,
)

NR_MIX = 10


def _mol(cfg, **wavernn):
    w = dataclasses.replace(cfg.wavernn, mode="MOL", rnn_dims=32, fc_dims=32, compute_dims=16,
                            res_out_dims=16, res_blocks=2, **wavernn)
    return dataclasses.replace(cfg, wavernn=w)


def _loss_inputs():
    """y_hat [2, 12, 30] and targets that reach every branch: y = -1 (the
    left edge), y = 1 (the right edge), bins far from narrow mixtures
    (cdf_delta <= 1e-5: the pdf branch) and ordinary interior bins."""
    rng = np.random.default_rng(0)
    y_hat = rng.normal(0.0, 1.0, (2, 12, 3 * NR_MIX)).astype(np.float32)
    y_hat[..., NR_MIX:2 * NR_MIX] = rng.uniform(-0.8, 0.8, (2, 12, NR_MIX))
    y_hat[..., 2 * NR_MIX:] = rng.uniform(-7.0, -1.0, (2, 12, NR_MIX))
    y_hat[1, 6:, 2 * NR_MIX:] = rng.uniform(-12.0, -9.0, (6, NR_MIX))  # very narrow
    y_hat[0, 0, 2 * NR_MIX] = -40.0  # below log_scale_min: clamped
    y = rng.uniform(-0.9, 0.9, (2, 12)).astype(np.float32)
    y[0, :3] = -1.0
    y[0, 3:6] = 1.0
    return y_hat, y


def test_mol_loss_and_gradient_match_jax():
    """Value and d loss / d y_hat against jax.grad, every branch reached.

    Value: 1e-5 relative (measured 1.0e-7).  Gradient: an element's bin
    mass is cdf_plus - cdf_min over a bin 2/65535 wide, so f32 sigmoid
    rounding (~6e-8) is divided by a mass of ~1e-5 in the derivative of
    its log: both f32 gradients sit ~1e-3 (relative) from the float64
    gradient.  Held to 2e-3 relative + 2e-5 absolute element-wise against
    JAX (measured 1.22e-4 at |g| = 0.194, max|g| 1942), and the port's f32
    gradient must be no farther from the float64 one than JAX's f32
    gradient is (measured 1.14e-4 against 2.05e-4)."""
    y_hat, y = _loss_inputs()
    # which branch each (example, mixture) takes
    centered = y[..., None] - y_hat[..., NR_MIX:2 * NR_MIX]
    inv = np.exp(-np.maximum(y_hat[..., 2 * NR_MIX:], TD.LOG_SCALE_MIN).astype(np.float64))
    half = 1.0 / 65535
    delta = special.expit(inv * (centered + half)) - special.expit(inv * (centered - half))
    interior = (np.abs(y) <= 0.999)[..., None]
    assert (y < -0.999).any() and (y > 0.999).any()
    assert (interior & (delta <= 1e-5)).sum() >= 5 and (interior & (delta > 1e-5)).sum() >= 5

    jl, jg = jax.value_and_grad(lambda a: JD.discretized_mix_logistic_loss(a, jnp.asarray(y)))(jnp.asarray(y_hat))
    t = torch.tensor(y_hat, requires_grad=True)
    tl = TD.discretized_mix_logistic_loss(t, torch.as_tensor(y))
    tl.backward()
    np.testing.assert_allclose(float(tl.detach()), float(jl), rtol=1e-5)
    assert torch.isfinite(t.grad).all()
    np.testing.assert_allclose(t.grad.numpy(), np.asarray(jg), rtol=2e-3, atol=2e-5)
    t64 = torch.tensor(y_hat.astype(np.float64), requires_grad=True)
    TD.discretized_mix_logistic_loss(t64, torch.as_tensor(y.astype(np.float64))).backward()
    g64 = t64.grad.numpy()
    assert np.abs(t.grad.numpy() - g64).max() <= np.abs(np.asarray(jg) - g64).max()
    per = TD.discretized_mix_logistic_loss(t.detach(), torch.as_tensor(y), reduce=False)
    jper = JD.discretized_mix_logistic_loss(jnp.asarray(y_hat), jnp.asarray(y), reduce=False)
    np.testing.assert_allclose(per.numpy(), np.asarray(jper), rtol=1e-5, atol=1e-5)


def test_mol_loss_gradient_finite_where_bins_vanish():
    """A bin of zero mass (cdf_delta == 0) takes the pdf branch; the log
    branch it does not take must not put a NaN into the gradient."""
    y_hat = np.zeros((1, 1, 3 * NR_MIX), np.float32)
    y_hat[..., NR_MIX:2 * NR_MIX] = -0.9
    y_hat[..., 2 * NR_MIX:] = -30.0
    t = torch.tensor(y_hat, requires_grad=True)
    loss = TD.discretized_mix_logistic_loss(t, torch.tensor([[0.9]]))
    loss.backward()
    assert torch.isfinite(loss) and torch.isfinite(t.grad).all()
    jl = JD.discretized_mix_logistic_loss(jnp.asarray(y_hat), jnp.asarray([[0.9]]))
    np.testing.assert_allclose(float(loss.detach()), float(jl), rtol=1e-5)


def _jax_draws(key, shape, nr_mix):
    """The draws JAX's sampler makes from ``key`` for y_hat of ``shape[:-1]``."""
    k_sel, k_u = jax.random.split(key)
    g = jax.random.gumbel(k_sel, tuple(shape[:-1]) + (nr_mix,), jnp.float32)
    u = jax.random.uniform(k_u, tuple(shape[:-1]), minval=1e-5, maxval=1.0 - 1e-5)
    return np.asarray(g), np.asarray(u)


def test_sampler_with_jax_draws_matches_jax():
    """Injected draws: equal mixtures, samples within 1e-6 (measured 6.0e-8)."""
    y_hat, _ = _loss_inputs()
    y_hat = np.array(y_hat)
    y_hat[..., 2 * NR_MIX:] = np.clip(y_hat[..., 2 * NR_MIX:], -6.0, -1.0)
    key = jax.random.PRNGKey(3)
    want = np.asarray(JD.sample_from_discretized_mix_logistic(jnp.asarray(y_hat), key))
    g, u = (np.array(a) for a in _jax_draws(key, y_hat.shape, NR_MIX))
    got = TD.sample_from_discretized_mix_logistic(torch.as_tensor(y_hat), gumbel=torch.as_tensor(g),
                                                  u=torch.as_tensor(u))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)
    assert np.abs(want).max() <= 1.0


def test_port_sampler_statistics():
    """The port's own draws: mixture choice by a chi-square test against
    softmax(logits) (critical value at p = 1e-3), and the chosen logistic
    by a Kolmogorov-Smirnov test (p > 1e-3), over 20,000 draws."""
    n = 20000
    logits = np.array([1.0, 0.5, 0.0, -1.0] + [-30.0] * (NR_MIX - 4), np.float32)
    means = np.array([-0.6, -0.2, 0.2, 0.6] + [0.0] * (NR_MIX - 4), np.float32)
    log_s = np.full(NR_MIX, -6.0, np.float32)  # narrow: the mixtures do not overlap
    y_hat = torch.as_tensor(np.tile(np.concatenate([logits, means, log_s]), (n, 1)))
    gen = torch.Generator().manual_seed(7)
    x = TD.sample_from_discretized_mix_logistic(y_hat, generator=gen).numpy()
    which = np.argmin(np.abs(x[:, None] - means[None, :4]), axis=1)
    p = np.exp(logits[:4] - logits[:4].max())
    p /= p.sum()
    counts = np.bincount(which, minlength=4)
    stat = ((counts - n * p) ** 2 / (n * p)).sum()
    assert stat < stats.chi2.ppf(1 - 1e-3, 3), (counts, n * p)
    z = (x[which == 0] - means[0]) / np.exp(log_s[0])
    assert stats.kstest(z, stats.logistic.cdf).pvalue > 1e-3


def test_mol_sampling_statistics():
    """MOL generation with zeroed weights: one dominant mixture of known
    mean and scale (as the JAX package's test_mol_sampling_statistics), 16
    folds x 200 samples from the port's generator: mean within 5e-3, std
    within 10 % of the logistic's."""
    cfg = _mol(default_config(), upsample_factors=(2, 2, 5))
    params = tree_map(torch.zeros_like, init_wavernn(0, cfg.wavernn, 80, cfg.audio.bits))
    mean, log_scale = 0.3, -4.0
    params["fc3"]["b"] = torch.as_tensor(np.concatenate([
        np.r_[10.0, np.full(NR_MIX - 1, -10.0)], np.r_[mean, np.zeros(NR_MIX - 1)],
        np.r_[log_scale, np.zeros(NR_MIX - 1)]]).astype(np.float32))
    hop = cfg.wavernn.total_upsample
    mels = torch.zeros(16, 200 // hop + 2 * cfg.wavernn.pad, 80)
    out = TW.generate_mol(params, cfg.wavernn, mels, seed=5).numpy()
    assert out.shape == (16, 200)
    want_std = np.exp(log_scale) * np.pi / np.sqrt(3.0)
    assert abs(out.mean() - mean) < 5e-3, out.mean()
    assert abs(out.std() - want_std) / want_std < 0.1, (out.std(), want_std)


def test_mol_generate_matches_jax_generate_scan():
    """The MOL sample loop against JAX generate_scan (MOL) with JAX's
    per-step draws injected: 2 folds x 60 samples within 1e-5 (measured
    5.4e-7: the loop feeds its float samples back, so rounding carries)."""
    jcfg = _mol(jax_default_config(), upsample_factors=(2, 2, 5))
    tcfg = _mol(default_config(), upsample_factors=(2, 2, 5))
    params = jax.jit(lambda k: JW.init_wavernn(k, jcfg.wavernn, 80, jcfg.audio.bits))(jax.random.PRNGKey(1))
    rng = np.random.default_rng(2)
    mels = rng.uniform(0.0, 1.0, (2, 3 + 2 * jcfg.wavernn.pad, 80)).astype(np.float32)
    key = jax.random.PRNGKey(9)
    want = np.asarray(JW.generate_scan(params, jcfg.wavernn, jnp.asarray(mels), key))
    T = want.shape[1]
    draws = [_jax_draws(k, (2, 1, 3 * NR_MIX), NR_MIX) for k in jax.random.split(key, T)]
    g = torch.as_tensor(np.stack([d[0][:, 0] for d in draws]))
    u = torch.as_tensor(np.stack([d[1][:, 0] for d in draws]))
    tparams = wavernn_from_numpy(jax.device_get(params), tcfg.wavernn)
    got = TW.generate_mol(tparams, tcfg.wavernn, mels, gumbel=g, u=u).numpy()
    assert got.shape == want.shape == (2, 60)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_mol_routes_and_kernel_scope():
    """generate/generate_batch send MOL to the plain MOL loop on every
    device; the RAW kernel wrapper raises for MOL, naming that route; fc3
    must have 30 outputs in MOL mode."""
    cfg = _mol(default_config(), upsample_factors=(2, 2, 5))
    params = init_wavernn(0, cfg.wavernn, 80, cfg.audio.bits)
    assert params["fc3"]["w"].shape[1] == 30
    assert TW.default_generate_fn(cfg.wavernn) is TW.generate_mol
    with pytest.raises(NotImplementedError, match="generate_mol"):
        TK.check_supported(cfg.wavernn)
    with pytest.raises(NotImplementedError, match="generate_mol"):
        TW.generate_kernel(params, cfg.wavernn, torch.zeros(1, 5, 80))
    gen = dataclasses.replace(cfg.wavernn_gen, target=40, overlap=20)
    wav = TW.generate(params, cfg.wavernn, gen, np.random.default_rng(0).uniform(0, 1, (7, 80)), seed=1)
    # the folds' equal-power crossfade can sum two full-scale samples to sqrt(2)
    assert wav.shape == (7 * 20,) and np.isfinite(wav).all() and np.abs(wav).max() <= np.sqrt(2.0) + 1e-6
    raw = init_wavernn(0, dataclasses.replace(cfg.wavernn, mode="RAW"), 80, cfg.audio.bits)
    with pytest.raises(ValueError, match="MOL implies 30"):
        TW.generate_mol(raw, cfg.wavernn, torch.zeros(1, 5, 80))


def test_mol_tree_loads_and_checks_width():
    jcfg = _mol(jax_default_config())
    tcfg = _mol(default_config())
    params = jax.device_get(jax.jit(lambda k: JW.init_wavernn(k, jcfg.wavernn, 80))(jax.random.PRNGKey(0)))
    tp = wavernn_from_numpy(params, tcfg.wavernn)
    np.testing.assert_array_equal(tp["fc3"]["w"].numpy(), params["fc3"]["w"])
    with pytest.raises(ValueError, match="do not match"):
        wavernn_from_numpy(params, dataclasses.replace(tcfg.wavernn, mode="RAW"))


def _tiny_tacotron(cfg):
    tac = dataclasses.replace(
        cfg.tacotron, embedding_dim=32, enc_conv_channels=32, enc_conv_layers=2, encoder_lstm_units=32,
        attention_dim=16, attention_filters=8, attention_kernel=7, prenet_layers=(32, 32),
        decoder_lstm_units=32, postnet_channels=32, postnet_layers=2,
    )
    gen = dataclasses.replace(cfg.wavernn_gen, target=550, overlap=275)
    return dataclasses.replace(cfg, tacotron=tac, wavernn_gen=gen)


def test_mol_artifact_serves_through_synthesizer(tmp_path):
    """A MOL artifact written by the JAX exporter: the port's Synthesizer
    (CPU) gives a finite WAV of stop_len x 275 samples, within the
    crossfade's sqrt(2)."""
    jcfg = _tiny_tacotron(_mol(jax_default_config()))
    tp = jax.device_get(jax.jit(lambda k: JT.init_tacotron(k, jcfg.tacotron))(jax.random.PRNGKey(0)))
    tp["stop_projection"]["b"] = np.full_like(tp["stop_projection"]["b"], -30.0)
    wp = jax.device_get(jax.jit(lambda k: JW.init_wavernn(k, jcfg.wavernn, 80))(jax.random.PRNGKey(1)))
    art = export_artifact(jcfg, tp, str(tmp_path / "art"), wp)
    synth = load_exported(art, max_iters=8, device="cpu")
    assert synth.cfg.wavernn.mode == "MOL"
    res = synth.synthesize("你好", seed=3)
    assert res["wav"].shape == (8 * 275,)
    assert np.isfinite(res["wav"]).all() and np.abs(res["wav"]).max() <= np.sqrt(2.0) + 1e-6
    many = synth.synthesize_batch(["你好", "谢谢"], seed=[1, 2])
    assert [r["wav"].shape for r in many] == [(8 * 275,)] * 2


def test_wavernn_gen_cli_vocodes_mol(tmp_path):
    """``wavernn_gen.main`` with a MOL npz and ``--override
    wavernn.mode=MOL``: a 22050 Hz WAV of frames x 275 samples."""
    import wave

    cfg = _mol(default_config())
    npz = str(tmp_path / "voc.npz")
    save_params_npz(npz, init_wavernn(3, cfg.wavernn, 80, cfg.audio.bits))
    mel = str(tmp_path / "m.npy")
    np.save(mel, np.random.default_rng(0).uniform(0, 1, (6, 80)).astype(np.float32))
    out = str(tmp_path / "m.wav")
    w = cfg.wavernn
    wavernn_gen.main(["--file", mel, "--params-npz", npz, "--output", out, "--device", "cpu",
                      "--target", "550", "--overlap", "275", "--override",
                      f"wavernn.mode=MOL,wavernn.rnn_dims={w.rnn_dims},wavernn.fc_dims={w.fc_dims},"
                      f"wavernn.compute_dims={w.compute_dims},wavernn.res_out_dims={w.res_out_dims},"
                      f"wavernn.res_blocks={w.res_blocks}"])
    with wave.open(out) as wf:
        assert wf.getframerate() == 22050 and wf.getnframes() == 6 * 275
    assert os.path.getsize(out) > 44
