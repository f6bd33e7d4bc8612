"""The port's teacher-forced decoder core (the module that holds K3/K4)
against the JAX package's ``fused_core_apply``, on the same weights and
inputs, f32 on the CPU.

The JAX side runs its Pallas kernels in interpret mode with f32 weights,
as its own tests do; the port's CPU path runs the kernels' plain versions
inside the same autograd Function the card uses, and the eager loop
``fused_core_plain``.  Tolerances are the JAX trainer-kernel test's own:
values atol 2e-4 (alignments 1e-5), gradients atol 5e-4 * max|g|."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tacotronv2_wavernn_chinese_tpu.config import default_config
from tacotronv2_wavernn_chinese_tpu.models import tacotron as JT
from tacotronv2_wavernn_chinese_tpu.ops import tacotron_trainer_kernel as JTK
from tacotronv2_wavernn_chinese_tpu_torch import ops as OPS
from tacotronv2_wavernn_chinese_tpu_torch.ops import tacotron_trainer_kernel as TK
from tacotronv2_wavernn_chinese_tpu_torch.utils.checkpoints import tacotron_from_numpy

# the core's parameter leaves (everything else gets no gradient from it)
CORE_LEAVES = (
    ("dec_lstm1", "w"), ("dec_lstm1", "b"), ("dec_lstm2", "w"), ("dec_lstm2", "b"),
    ("attention", "query_layer", "w"), ("attention", "location_conv", "w"),
    ("attention", "location_conv", "b"), ("attention", "location_layer", "w"),
    ("attention", "v"), ("attention", "b"), ("attention", "mu_layer", "w"),
    ("attention", "mu_layer", "b"),
)


def _cfg():
    return dataclasses.replace(
        default_config().tacotron,
        embedding_dim=32, enc_conv_channels=32, enc_conv_layers=1,
        encoder_lstm_units=32, attention_dim=16, attention_filters=8,
        attention_kernel=7, prenet_layers=(32, 32), decoder_lstm_units=32,
        postnet_channels=32, postnet_layers=1,
    )


@pytest.fixture(scope="module")
def params():
    cfg = _cfg()
    p = jax.jit(lambda k: JT.init_tacotron(k, cfg))(jax.random.PRNGKey(0))
    # non-zero biases so every gradient path carries signal
    rng = np.random.default_rng(1)
    att = dict(p["attention"])
    att["b"] = jnp.asarray(rng.normal(0, 0.1, 16), jnp.float32)
    att["location_conv"] = dict(att["location_conv"], b=jnp.asarray(rng.normal(0, 0.1, 8), jnp.float32))
    return dict(p, attention=att)


def _get(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def _inputs(B, T, T_in, lens, seed, train):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.normal(0, 1, s).astype(np.float32)
    mask = (np.arange(T_in)[None, :] < np.asarray(lens)[:, None]).astype(np.float32)
    masks = None
    if train:
        masks = tuple((rng.uniform(size=(T, B, 32)) < 0.9).astype(np.float32) for _ in range(4))
    cots = (f(T, B, 32), f(T, B, 64), f(T, B, T_in))
    return np.abs(f(T, B, 32)), f(B, T_in, 16) * 0.5, f(B, T_in, 64) * 0.5, mask, masks, cots


def _jax_vjp(params, cfg, pre, keys, values, mask, masks, cots, wgrads):
    def fn(p, pre_, keys_, values_):
        return JTK.fused_core_apply(
            p, cfg, pre_, None if masks is None else tuple(jnp.asarray(m) for m in masks),
            keys_, values_, jnp.asarray(mask), interpret=True, dtype=jnp.float32, wgrads=wgrads,
        )

    outs, vjp = jax.vjp(fn, params, jnp.asarray(pre), jnp.asarray(keys), jnp.asarray(values))
    g_p, g_pre, g_keys, g_values = vjp(tuple(jnp.asarray(c) for c in cots))
    grads = {path: np.asarray(_get(g_p, path)) for path in CORE_LEAVES}
    grads.update(pre=np.asarray(g_pre), keys=np.asarray(g_keys), values=np.asarray(g_values))
    return [np.asarray(o) for o in outs], grads


def _torch_vjp(fn, params, cfg, pre, keys, values, mask, masks, cots):
    tp = tacotron_from_numpy(jax.device_get(params), cfg)
    leaves = {}
    for path in CORE_LEAVES:
        parent = _get(tp, path[:-1])
        parent[path[-1]] = leaves[path] = parent[path[-1]].clone().requires_grad_(True)
    xs = {k: torch.tensor(v, requires_grad=True) for k, v in (("pre", pre), ("keys", keys), ("values", values))}
    tmasks = None if masks is None else tuple(torch.as_tensor(m) for m in masks)
    outs = fn(tp, cfg, xs["pre"], tmasks, xs["keys"], xs["values"], torch.as_tensor(mask))
    loss = sum((o * torch.as_tensor(c)).sum() for o, c in zip(outs, cots))
    names = list(leaves) + list(xs)
    gs = torch.autograd.grad(loss, list(leaves.values()) + list(xs.values()))
    return [o.detach().numpy() for o in outs], {n: g.numpy() for n, g in zip(names, gs)}


def _assert_close(j, t):
    (jo, jg), (to, tg) = j, t
    for name, a, b, atol in zip(("out2", "ctx", "align"), jo, to, (2e-4, 2e-4, 1e-5)):
        np.testing.assert_allclose(b, a, atol=atol, err_msg=name)
    assert set(jg) == set(tg)
    for name, a in jg.items():
        scale = max(float(np.abs(a).max()), 1e-6)
        np.testing.assert_allclose(tg[name], a, atol=5e-4 * scale + 1e-7, err_msg=f"gradient {name}")


@pytest.mark.parametrize("wgrads", ["stream", "accum"])
@pytest.mark.parametrize("train", [True, False], ids=["train_masks", "eval_ema"])
def test_fused_core_value_and_vjp_match_jax(params, train, wgrads):
    """fused_core_apply (the autograd Function over K3/K4; on the CPU
    their plain versions; one weight-gradient layout) against the JAX
    custom VJP in both of its layouts: outputs, and the VJP for fixed
    random cotangents w.r.t. the prenet input, keys, values and every core
    weight."""
    cfg = _cfg()
    pre, keys, values, mask, masks, cots = _inputs(3, 10, 20, [20, 13, 7], 2, train)
    j = _jax_vjp(params, cfg, pre, keys, values, mask, masks, cots, wgrads)
    OPS.reset_launch_counts()
    t = _torch_vjp(TK.fused_core_apply, params, cfg, pre, keys, values, mask, masks, cots)
    assert OPS.LAUNCHES["tacotron_train_fwd"] == OPS.LAUNCHES["tacotron_train_bwd"] == 0
    _assert_close(j, t)


@pytest.mark.parametrize("train", [True, False], ids=["train_masks", "eval_ema"])
def test_fused_core_plain_matches_jax(params, train):
    """The eager loop differentiated by autograd (the kernels' reference on
    the card) against the JAX custom VJP."""
    cfg = _cfg()
    pre, keys, values, mask, masks, cots = _inputs(3, 8, 16, [16, 11, 4], 3, train)
    j = _jax_vjp(params, cfg, pre, keys, values, mask, masks, cots, "stream")
    t = _torch_vjp(TK.fused_core_plain, params, cfg, pre, keys, values, mask, masks, cots)
    _assert_close(j, t)


def test_batch_beyond_the_tpu_group(params):
    """B=10: the JAX package runs two Mosaic row groups and sums their
    weight cotangents; the port runs one call (one block per row on the
    card)."""
    cfg = _cfg()
    lens = [16, 9, 16, 12, 3, 16, 15, 8, 16, 1]
    pre, keys, values, mask, masks, cots = _inputs(10, 6, 16, lens, 4, True)
    j = _jax_vjp(params, cfg, pre, keys, values, mask, masks, cots, "accum")
    t = _torch_vjp(TK.fused_core_apply, params, cfg, pre, keys, values, mask, masks, cots)
    _assert_close(j, t)


def test_plain_adjoint_matches_autograd_per_output(params):
    """K4's plain version (the adjoint written out) against autograd of the
    forward loop, one cotangent at a time, so a fault in one branch of the
    adjoint (context, alignment, or out2) cannot hide behind another."""
    cfg = _cfg()
    pre, keys, values, mask, masks, cots = _inputs(2, 7, 12, [12, 6], 5, True)
    for i in range(3):
        one = tuple(c if k == i else np.zeros_like(c) for k, c in enumerate(cots))
        _, a = _torch_vjp(TK.fused_core_apply, params, cfg, pre, keys, values, mask, masks, one)
        _, b = _torch_vjp(TK.fused_core_plain, params, cfg, pre, keys, values, mask, masks, one)
        for name in a:
            scale = max(float(np.abs(b[name]).max()), 1e-6)
            np.testing.assert_allclose(a[name], b[name], atol=1e-5 * scale + 1e-7,
                                       err_msg=f"cotangent {i}, gradient {name}")


def test_envelope_and_scope():
    """The kernels' plan sets the envelope: at the default widths and the
    H100's 15 resident clusters (16 on a full die), every batch up to 64
    rows takes T_in of 1024 and more; one position or one row more than
    the plan holds is refused."""
    cfg = default_config().tacotron
    dims = TK.widths(cfg)
    for clusters in (16, 15):
        for batch in (1, 10, 32, 64):
            n = TK.max_t_in(batch, dims, clusters)
            assert n >= 1024
            assert TK.train_supported_shape(batch, n, cfg, clusters)
            assert not TK.train_supported_shape(batch, n + 1, cfg, clusters)
            plan = TK.k34_plan(batch, n, dims, clusters)
            assert max(plan.smem_bytes("fwd"), plan.smem_bytes("bwd")) <= TK.SMEM_LIMIT
    assert not TK.train_supported_shape(15 * TK.CLUSTER + 1, 16, cfg, 15)
    assert TK.train_supported(cfg)
    assert not TK.train_supported(dataclasses.replace(cfg, attention_mode="lsa"))
    assert not TK.train_supported(dataclasses.replace(cfg, smoothing=True))
    assert not TK.train_supported(dataclasses.replace(cfg, attention_dim=126))
