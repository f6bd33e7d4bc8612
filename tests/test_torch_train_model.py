"""The port's Tacotron-2 training forward and loss against the JAX package:
loss, the gradient of every params leaf and the updated BN statistics,
f32 on the CPU.

At dropout 0 and zoneout 0 both sides are deterministic; one case instead
rebuilds every train-mode mask JAX draws from its key (encoder dropout and
zoneout, prenet dropout, decoder zoneout, postnet dropout) and hands them
to the port.  The JAX side runs its XLA scan ("fused off") or its Pallas
trainer kernels in interpret mode with f32 weights; the port runs its
eager loop ("off") or the autograd Function over the kernels' plain
versions."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tacotronv2_wavernn_chinese_tpu.config import default_config
from tacotronv2_wavernn_chinese_tpu.models import layers as JL
from tacotronv2_wavernn_chinese_tpu.models import tacotron as JT
from tacotronv2_wavernn_chinese_tpu_torch.models import tacotron as TT
from tacotronv2_wavernn_chinese_tpu_torch.train import tacotron_task as TTask
from tacotronv2_wavernn_chinese_tpu_torch.utils import tree_leaves, tree_map
from tacotronv2_wavernn_chinese_tpu_torch.utils.checkpoints import tacotron_from_numpy

B, T_IN, T_OUT = 3, 16, 20
LENS = [16, 11, 6]
TARGET_LENS = [20, 14, 9]


def _cfg(dropout=0.0, zoneout=0.0, **train):
    cfg = default_config()
    tac = dataclasses.replace(
        cfg.tacotron, embedding_dim=32, enc_conv_channels=32, enc_conv_layers=2,
        encoder_lstm_units=32, attention_dim=16, attention_filters=8, attention_kernel=7,
        prenet_layers=(32, 32), decoder_lstm_units=32, postnet_channels=32, postnet_layers=2,
        dropout_rate=dropout, zoneout_rate=zoneout,
    )
    return dataclasses.replace(cfg, tacotron=tac,
                               tacotron_train=dataclasses.replace(cfg.tacotron_train, **train))


@pytest.fixture(scope="module")
def setup():
    cfg = _cfg()
    params = jax.jit(lambda k: JT.init_tacotron(k, cfg.tacotron))(jax.random.PRNGKey(0))
    rng = np.random.default_rng(0)
    # BN statistics away from their init, so the EMA update is visible
    params = jax.tree_util.tree_map_with_path(
        lambda p, a: jnp.asarray(rng.uniform(0.5, 1.5, a.shape), jnp.float32)
        if jax.tree_util.keystr(p).endswith("['var']") else a, params)
    batch = {
        "inputs": rng.integers(1, cfg.tacotron.vocab_size, (B, T_IN)).astype(np.int32),
        "input_lengths": np.asarray(LENS, np.int32),
        "mel_targets": rng.uniform(-4, 4, (B, T_OUT, 80)).astype(np.float32),
        "target_lengths": np.asarray(TARGET_LENS, np.int32),
        "loss_frames": np.full((B,), 18, np.int32),
    }
    stops = (np.arange(T_OUT)[None, :] >= np.asarray(TARGET_LENS)[:, None] - 1).astype(np.float32)
    batch["stop_targets"] = stops
    return params, batch


def _jax_loss(params, cfg, batch, rng, fused):
    """The JAX package's loss_fn with the fused core in interpret mode
    (its loss_fn has no interpret switch)."""
    tc = cfg.tacotron_train
    out, new_params = JT.forward_teacher_forced(
        params, cfg.tacotron, batch["inputs"], batch["input_lengths"], batch["mel_targets"], True, rng,
        fused_core=fused, fused_interpret=True, fused_dtype=jnp.float32, fused_wgrads="stream",
    )
    loss, aux = JT.tacotron_loss(
        out, batch["mel_targets"], batch["stop_targets"], batch["target_lengths"], params, cfg.tacotron,
        reg_weight=tc.reg_weight, mask_decoder=tc.mask_decoder, stop_pos_weight=tc.stop_pos_weight,
        loss_frames=batch.get("loss_frames"),
    )
    return loss, (aux, new_params)


def _jax_masks(params, cfg, rng):
    """Every mask JAX's train-mode forward draws from ``rng`` (its key
    derivation replayed), as a port TrainRand."""
    tac = cfg.tacotron
    rate, zr = tac.dropout_rate, tac.zoneout_rate
    k_enc, k_dec, k_post, _ = jax.random.split(rng, 4)
    k1, k2, k3 = jax.random.split(k_enc, 3)
    t = lambda a: torch.as_tensor(np.array(a))
    drop = lambda k, n, T, C: tuple(
        t(jax.random.bernoulli(jax.random.fold_in(k, i), 1.0 - rate, (B, T, C))) for i in range(n))
    zone = lambda k, T, U: tuple(t(m) for m in jax.vmap(
        lambda kk: JL.zoneout_masks(kk, zr, (B, U)))(jax.random.split(k, T)))

    def derive(k):
        k_step, _ = jax.random.split(k)
        return JT.step_rand_from_key(params, tac, k_step, B, True)

    rands = jax.vmap(derive)(jax.random.split(k_dec, T_OUT))
    return TT.TrainRand(
        drop(k1, tac.enc_conv_layers, T_IN, tac.enc_conv_channels),
        zone(k2, T_IN, tac.encoder_lstm_units), zone(k3, T_IN, tac.encoder_lstm_units),
        tuple(t(m) for m in rands.pre), tuple(t(m) for m in rands.z1), tuple(t(m) for m in rands.z2),
        drop(k_post, tac.postnet_layers, T_OUT, tac.postnet_channels),
    )


def _flat(tree):
    return jax.tree_util.tree_flatten_with_path(tree)[0]


def _at(tree, path):
    """The port tree's leaf at a JAX key path."""
    for k in path:
        tree = tree[k.key if hasattr(k, "key") else k.idx]
    return tree


@pytest.mark.parametrize("case", [
    ("off", {}), ("fused", {}), ("fused", {"mask_decoder": True}),
    ("off", {"mask_decoder": True, "stop_pos_weight": 20.0}),
], ids=["scan", "fused", "fused_mask_decoder", "scan_mask_decoder"])
def test_loss_grads_and_bn_stats_match_jax(setup, case):
    params, batch = setup
    path, train_kw = case
    cfg = _cfg(fused_decoder="off" if path == "off" else "auto", **train_kw)
    rng = jax.random.PRNGKey(5)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    (jloss, (jaux, jnew)), jgrads = jax.value_and_grad(_jax_loss, has_aux=True)(
        params, cfg, jb, rng, path == "fused")

    tp = tacotron_from_numpy(jax.device_get(params), cfg.tacotron)
    tb = {k: torch.as_tensor(v) for k, v in batch.items()}
    gen = torch.Generator().manual_seed(0)
    tloss, taux, tnew, tgrads = TTask.compute_grads(tp, cfg, tb, gen, 0)
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=2e-5)
    for k in ("before", "after", "stop", "reg"):
        np.testing.assert_allclose(float(taux[k]), float(jaux[k]), rtol=2e-5, atol=1e-7, err_msg=k)
    jflat = _flat(jgrads)
    assert len(jflat) == len(tree_leaves(tgrads))
    for p, a in jflat:
        a, b = np.asarray(a), _at(tgrads, p)
        scale = max(float(np.abs(a).max()), 1e-6)
        np.testing.assert_allclose(b.numpy(), a, atol=5e-4 * scale + 1e-7,
                                   err_msg=f"gradient {jax.tree_util.keystr(p)}")
    n_stats = 0
    for p, a in _flat(jnew):
        if jax.tree_util.keystr(p).endswith(("['mean']", "['var']")):
            n_stats += 1
            np.testing.assert_allclose(_at(tnew, p).numpy(), np.asarray(a), rtol=1e-5, atol=1e-6,
                                       err_msg=f"BN statistic {jax.tree_util.keystr(p)}")
    assert n_stats == 2 * (2 + 2)  # mean and var of 2 encoder convs and 2 postnet convs


@pytest.mark.parametrize("fused_decoder", ["off", "auto"])
def test_train_mode_with_jax_masks_injected(setup, fused_decoder):
    """dropout 0.5, zoneout 0.1: every mask JAX draws is rebuilt from its
    key and handed to the port, so outputs and gradients must agree."""
    params, batch = setup
    cfg = _cfg(dropout=0.5, zoneout=0.1, fused_decoder=fused_decoder)
    rng = jax.random.PRNGKey(9)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    (jloss, _), jgrads = jax.value_and_grad(_jax_loss, has_aux=True)(params, cfg, jb, rng, False)
    rand = _jax_masks(params, cfg, rng)
    tp = tacotron_from_numpy(jax.device_get(params), cfg.tacotron)
    tb = {k: torch.as_tensor(v) for k, v in batch.items()}
    leaves = tree_map(lambda a: a.clone().requires_grad_(True), tp)
    loss, _ = TTask.loss_fn(leaves, cfg, tb, None, True, 1.0, rand=rand)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=2e-5)
    flat = tree_leaves(leaves)
    gs = dict(zip(map(id, flat), torch.autograd.grad(loss, flat, allow_unused=True)))
    for p, a in _flat(jgrads):
        a, b = np.asarray(a), gs[id(_at(leaves, p))]
        b = np.zeros_like(a) if b is None else b.numpy()
        scale = max(float(np.abs(a).max()), 1e-6)
        np.testing.assert_allclose(b, a, atol=5e-4 * scale + 1e-7,
                                   err_msg=f"gradient {jax.tree_util.keystr(p)}")


def test_unported_options_raise(setup):
    params, batch = setup
    tp = tacotron_from_numpy(jax.device_get(params), _cfg().tacotron)
    tb = {k: torch.as_tensor(v) for k, v in batch.items()}
    gen = torch.Generator().manual_seed(0)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        TT.forward_teacher_forced(tp, _cfg().tacotron, tb["inputs"], tb["input_lengths"], tb["mel_targets"],
                                  True, generator=gen, teacher_forcing_ratio=0.9)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        TT.forward_teacher_forced(tp, dataclasses.replace(_cfg().tacotron, predict_linear=True),
                                  tb["inputs"], tb["input_lengths"], tb["mel_targets"], True, generator=gen)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        TTask.loss_fn(tp, _cfg(mixed_precision=True), tb, gen)
    # the eager core knows forward attention without smoothing only
    for over in ({"smoothing": True}, {"attention_mode": "lsa"}):
        with pytest.raises(NotImplementedError, match="queue item 6"):
            TT.forward_teacher_forced(tp, dataclasses.replace(_cfg().tacotron, **over), tb["inputs"],
                                      tb["input_lengths"], tb["mel_targets"], True, generator=gen)
