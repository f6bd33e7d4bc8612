"""Shared setup of the Tacotron training parity tests
(tests/test_torch_train_attention_modes.py, ..._scheduled.py,
..._mixed_precision.py): the small configuration of
tests/test_torch_train_model.py on both sides, the JAX params and batch,
every mask JAX's forward draws rebuilt from its key as a port
``TrainRand``, and one step's comparison.

The JAX side is its task's ``loss_fn`` differentiated by ``jax.grad``,
jitted (the suite clears JAX's caches per module, so op-by-op execution
would compile every primitive again in each file): on the CPU its
``_use_fused_decoder`` sends every decode to the XLA scan over
``decoder_step``.  The port runs its ``loss_fn`` with the rebuilt masks
injected, differentiated by autograd."""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch

from tacotronv2_wavernn_chinese_tpu.config import default_config as jax_default_config
from tacotronv2_wavernn_chinese_tpu.models import layers as JL
from tacotronv2_wavernn_chinese_tpu.models import tacotron as JT
from tacotronv2_wavernn_chinese_tpu.train import tacotron_task as JTask
from tacotronv2_wavernn_chinese_tpu_torch.config import default_config
from tacotronv2_wavernn_chinese_tpu_torch.models import tacotron as TT
from tacotronv2_wavernn_chinese_tpu_torch.train import tacotron_task as TTask
from tacotronv2_wavernn_chinese_tpu_torch.utils import tree_leaves, tree_map
from tacotronv2_wavernn_chinese_tpu_torch.utils.checkpoints import init_tacotron, tacotron_from_numpy

B, T_IN, T_OUT = 3, 16, 20
LENS = [16, 11, 6]
TARGET_LENS = [20, 14, 9]
SMALL = dict(
    embedding_dim=32, enc_conv_channels=32, enc_conv_layers=2, encoder_lstm_units=32, attention_dim=16,
    attention_filters=8, attention_kernel=7, prenet_layers=(32, 32), decoder_lstm_units=32,
    postnet_channels=32, postnet_layers=2,
)
# the tolerances of tests/test_torch_train_model.py
LOSS_RTOL, GRAD_ATOL, STAT_RTOL = 2e-5, 5e-4, 1e-5


def cfgs(dropout=0.5, zoneout=0.1, tacotron=None, **train):
    """(JAX config, port config) with the same fields.  JAX's scan runs
    unrolled once (``scan_unroll`` changes no value, only its compile
    time)."""
    out = []
    train = dict({"scan_unroll": 1}, **train)
    for cfg in (jax_default_config(), default_config()):
        tac = dataclasses.replace(cfg.tacotron, dropout_rate=dropout, zoneout_rate=zoneout,
                                  **SMALL, **(tacotron or {}))
        out.append(dataclasses.replace(cfg, tacotron=tac,
                                       tacotron_train=dataclasses.replace(cfg.tacotron_train, **train)))
    return out


def jax_params(jcfg, seed=0):
    """Params of ``jcfg``'s structure as numpy, from the port's init (the
    same tree as JAX ``init_tacotron``; no JAX program to compile), with BN
    variances away from 1."""
    params = tree_map(lambda t: t.numpy(), init_tacotron(seed, jcfg.tacotron))
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map_with_path(
        lambda p, a: rng.uniform(0.5, 1.5, a.shape).astype(np.float32)
        if jax.tree_util.keystr(p).endswith("['var']") else a, params)


def batch_np(t_out=T_OUT, seed=0, vocab=191):
    rng = np.random.default_rng(seed)
    batch = {
        "inputs": rng.integers(1, vocab, (B, T_IN)).astype(np.int32),
        "input_lengths": np.asarray(LENS, np.int32),
        "mel_targets": rng.uniform(-4, 4, (B, t_out, 80)).astype(np.float32),
        "target_lengths": np.asarray([min(n, t_out) for n in TARGET_LENS], np.int32),
        "loss_frames": np.full((B,), t_out - 2, np.int32),
    }
    batch["stop_targets"] = (np.arange(t_out)[None, :] >= batch["target_lengths"][:, None] - 1).astype(np.float32)
    return batch


@functools.partial(jax.jit, static_argnums=(1, 3, 4, 5, 6, 7))
def _jax_draws(params, tac, rng, Bn, T_in, t_out, train, ratio):
    """JAX's key derivation replayed, as one program."""
    t_dec = t_out // tac.outputs_per_step
    rate, zr = tac.dropout_rate, tac.zoneout_rate
    k_enc, k_dec, k_post, _ = jax.random.split(rng, 4)
    k1, k2, k3 = jax.random.split(k_enc, 3)
    drop = lambda k, n, T, C: tuple(
        jax.random.bernoulli(jax.random.fold_in(k, i), 1.0 - rate, (Bn, T, C)) for i in range(n))
    zone = lambda k, T, U: jax.vmap(lambda kk: JL.zoneout_masks(kk, zr, (Bn, U)))(jax.random.split(k, T))

    def derive(k):
        k_step, k_tf = jax.random.split(k)
        use_gt = jax.random.uniform(k_tf, (Bn, 1)) < jnp.asarray(ratio, jnp.float32)
        return JT.step_rand_from_key(params, tac, k_step, Bn, train), use_gt

    rands, use_gt = jax.vmap(derive)(jax.random.split(k_dec, t_dec))
    on, zon = train and rate > 0.0, train and zr > 0.0
    return (
        drop(k1, tac.enc_conv_layers, T_in, tac.enc_conv_channels) if on else None,
        zone(k2, T_in, tac.encoder_lstm_units) if zon else None,
        zone(k3, T_in, tac.encoder_lstm_units) if zon else None,
        rands.pre, rands.z1, rands.z2,
        drop(k_post, tac.postnet_layers, t_out, tac.postnet_channels) if on else None,
        rands.att, None if ratio >= 1.0 else use_gt,
    )


def jax_masks(params, jcfg, rng, batch, train=True, ratio=1.0):
    """Every mask JAX's forward draws from ``rng`` (its key derivation
    replayed: encoder dropout and zoneout, the per-step prenet, zoneout and
    GMM attention masks of ``step_rand_from_key``, the scheduled-sampling
    draws ``uniform(k_tf) < ratio``, postnet dropout), as a port
    ``TrainRand``; ``use_gt`` None at a ratio of 1 or more."""
    Bn, T_in = batch["inputs"].shape
    draws = _jax_draws(params, jcfg.tacotron, rng, Bn, T_in, batch["mel_targets"].shape[1], train, float(ratio))
    t = lambda a: torch.as_tensor(np.array(a))
    return TT.TrainRand(*(None if d is None else t(d) if not isinstance(d, tuple) else tuple(t(m) for m in d)
                          for d in draws))


def _at(tree, path):
    """The port tree's leaf at a JAX key path."""
    for k in path:
        tree = tree[k.key if hasattr(k, "key") else k.idx]
    return tree


def jax_grad_fn(**compiler_options):
    """JAX's ``loss_fn`` and its gradient, jitted with XLA ``compiler_options``."""
    return jax.jit(jax.value_and_grad(JTask.loss_fn, has_aux=True), static_argnums=(1, 4, 5),
                   compiler_options=compiler_options or None)


_jax_grad = jax_grad_fn()


def run_step(jcfg, tcfg, params, batch, key=9, train=True, ratio=1.0, jax_grad=_jax_grad):
    """One loss and gradient on each side, the port with JAX's masks ->
    dict of JAX and port loss, aux, new params, output and gradients (the
    port's as a {JAX key path: array} dict).  ``jax_grad`` is JAX's side
    (``jax_grad_fn``)."""
    rng = jax.random.PRNGKey(key)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    (jloss, (jaux, jnew, jout)), jgrads = jax_grad(params, jcfg, jb, rng, train, ratio)
    rand = jax_masks(params, jcfg, rng, batch, train, ratio)
    leaves = tree_map(lambda a: a.clone().requires_grad_(True), tacotron_from_numpy(params, tcfg.tacotron))
    tb = {k: torch.as_tensor(v) for k, v in batch.items()}
    loss, (aux, new, out) = TTask.loss_fn(leaves, tcfg, tb, None, train, ratio, rand=rand)
    flat = tree_leaves(leaves)
    gs = dict(zip(map(id, flat), torch.autograd.grad(loss, flat, allow_unused=True)))
    tgrads = {}
    for p, a in jax.tree_util.tree_flatten_with_path(jgrads)[0]:
        g = gs[id(_at(leaves, p))]
        tgrads[jax.tree_util.keystr(p)] = np.zeros_like(np.asarray(a)) if g is None else g.numpy()
    return {"params": params, "jloss": float(jloss), "loss": float(loss.detach()), "jaux": jaux, "aux": aux,
            "jnew": jnew, "new": new, "jout": jout, "out": out, "jgrads": jgrads, "grads": tgrads}


def grad_error(res) -> float:
    """The largest gradient difference over every leaf beyond the 1e-7
    floor ``assert_step_matches`` allows, relative to that leaf's max|g|
    (JAX's)."""
    worst = 0.0
    for p, a in jax.tree_util.tree_flatten_with_path(res["jgrads"])[0]:
        a = np.asarray(a)
        d = float(np.abs(res["grads"][jax.tree_util.keystr(p)] - a).max()) - 1e-7
        worst = max(worst, d / max(float(np.abs(a).max()), 1e-6))
    return worst


def assert_step_matches(res, loss_rtol=LOSS_RTOL, grad_atol=GRAD_ATOL, stat_rtol=STAT_RTOL, train=True,
                        stat_scale=0.0, n_bn=4):
    """Loss, aux terms (the linear term too where JAX has one), every
    gradient leaf (``grad_atol`` x its max|g|) and the BN statistics
    (``stat_rtol``, plus ``stat_scale`` x the vector's max) of ``n_bn``
    BatchNorm layers against JAX."""
    np.testing.assert_allclose(res["loss"], res["jloss"], rtol=loss_rtol)
    assert res["aux"].keys() == res["jaux"].keys()
    for k in sorted(res["jaux"].keys() - {"loss"}):
        np.testing.assert_allclose(float(res["aux"][k].detach()), float(res["jaux"][k]), rtol=loss_rtol, atol=1e-7,
                                   err_msg=k)
    for p, a in jax.tree_util.tree_flatten_with_path(res["jgrads"])[0]:
        a = np.asarray(a)
        scale = max(float(np.abs(a).max()), 1e-6)
        np.testing.assert_allclose(res["grads"][jax.tree_util.keystr(p)], a, rtol=0,
                                   atol=grad_atol * scale + 1e-7,
                                   err_msg=f"gradient {jax.tree_util.keystr(p)}")
    n_stats = 0
    for p, a in jax.tree_util.tree_flatten_with_path(res["jnew"])[0]:
        if jax.tree_util.keystr(p).endswith(("['mean']", "['var']")):
            n_stats += 1
            a = np.asarray(a)
            np.testing.assert_allclose(_at(res["new"], p).detach().numpy(), a, rtol=stat_rtol,
                                       atol=1e-6 + stat_scale * float(np.abs(a).max()),
                                       err_msg=f"BN statistic {jax.tree_util.keystr(p)}")
    assert n_stats == 2 * n_bn  # mean and var of 2 encoder convs, 2 postnet convs (and the head's)
    if train:  # the forward moved the statistics
        assert not np.allclose(res["new"]["postnet"]["layers"][0]["bn"]["var"].detach().numpy(),
                               res["params"]["postnet"]["layers"][0]["bn"]["var"])
