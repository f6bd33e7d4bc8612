"""The port's optimizer and train step against the JAX package's
``tacotron_task``: two full steps (parameters after each), the LR and
teacher-forcing schedules, TF-1 Adam, global-norm clipping and the
fine-tune freeze.

dropout 0 and zoneout 0 keep both sides deterministic.  The JAX step runs
its XLA scan on the CPU; the port's runs the autograd Function over the
trainer kernels' plain versions."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tacotronv2_wavernn_chinese_tpu.config import default_config
from tacotronv2_wavernn_chinese_tpu.train import tacotron_task as JTask
from tacotronv2_wavernn_chinese_tpu_torch.train import tacotron_task as TTask
from tacotronv2_wavernn_chinese_tpu_torch.utils import tree_map
from tacotronv2_wavernn_chinese_tpu_torch.utils.checkpoints import tacotron_from_numpy

B, T_IN, T_OUT = 2, 12, 16


def _cfg(**train):
    cfg = default_config()
    tac = dataclasses.replace(
        cfg.tacotron, embedding_dim=32, enc_conv_channels=32, enc_conv_layers=2,
        encoder_lstm_units=32, attention_dim=16, attention_filters=8, attention_kernel=7,
        prenet_layers=(32, 32), decoder_lstm_units=32, postnet_channels=32, postnet_layers=2,
        dropout_rate=0.0, zoneout_rate=0.0,
    )
    return dataclasses.replace(cfg, tacotron=tac,
                               tacotron_train=dataclasses.replace(cfg.tacotron_train, **train))


def _batches(seed):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(2):
        lens = np.asarray([T_OUT, T_OUT - 5], np.int32)
        out.append({
            "inputs": rng.integers(1, 191, (B, T_IN)).astype(np.int32),
            "input_lengths": np.asarray([T_IN, 7], np.int32),
            "mel_targets": rng.uniform(-4, 4, (B, T_OUT, 80)).astype(np.float32),
            "stop_targets": (np.arange(T_OUT)[None] >= lens[:, None] - 1).astype(np.float32),
            "target_lengths": lens,
            "loss_frames": np.full((B,), T_OUT, np.int32),
        })
    return out


def _compare_params(tparams, jparams, atol, what):
    flat = jax.tree_util.tree_flatten_with_path(jparams)[0]
    for path, a in flat:
        node = tparams
        for k in path:
            node = node[k.key if hasattr(k, "key") else k.idx]
        np.testing.assert_allclose(node.numpy(), np.asarray(a), rtol=0, atol=atol,
                                   err_msg=f"{what}: {jax.tree_util.keystr(path)}")


def _run_both(cfg, n_steps=2):
    jstate = JTask.init_state(jax.random.PRNGKey(0), cfg)
    tstate = TTask.TrainState(0, tacotron_from_numpy(jax.device_get(jstate.params), cfg.tacotron),
                              None)
    tstate.opt_state = TTask.adam_init(tstate.params)
    gen = torch.Generator().manual_seed(0)
    history = []
    for i, b in enumerate(_batches(1)[:n_steps]):
        jstate, jm = JTask.train_step(jstate, {k: jnp.asarray(v) for k, v in b.items()},
                                      jax.random.PRNGKey(i), cfg)
        tstate, tm = TTask.train_step(tstate, {k: torch.as_tensor(v) for k, v in b.items()}, gen, cfg)
        history.append((jax.device_get(jstate.params), tstate.params, jax.device_get(jm), tm))
    return jstate, tstate, history


@pytest.mark.parametrize("train_kw", [{}, {"grad_clip_norm": 0.05}, {"fine_tune": True}],
                         ids=["default", "clipped", "fine_tune"])
def test_two_train_steps_match_jax(train_kw):
    cfg = _cfg(**train_kw)
    jstate, tstate, history = _run_both(cfg)
    assert tstate.step == int(jstate.step) == 2
    for i, (jp, tp, jm, tm) in enumerate(history):
        for k in ("loss", "before", "after", "stop", "reg", "grad_norm", "lr"):
            np.testing.assert_allclose(tm[k], float(jm[k]), rtol=5e-5, err_msg=f"step {i + 1} {k}")
        # Adam moves each weight by ~lr per step; the two sides' gradients
        # differ by rounding only
        _compare_params(tp, jp, 2e-6, f"after step {i + 1}")
    if train_kw.get("grad_clip_norm"):
        assert history[0][3]["grad_norm"] > 0.05  # the clip was active
    if train_kw.get("fine_tune"):
        p0 = tacotron_from_numpy(jax.device_get(JTask.init_state(jax.random.PRNGKey(0), cfg).params),
                                 cfg.tacotron)
        tp = tstate.params
        assert torch.equal(tp["embedding"], p0["embedding"])
        assert torch.equal(tp["enc_lstm_fw"]["w"], p0["enc_lstm_fw"]["w"])
        assert torch.equal(tp["enc_convs"]["layers"][0]["conv"]["w"], p0["enc_convs"]["layers"][0]["conv"]["w"])
        # the frozen encoder's BN statistics still advance with the forward
        assert not torch.equal(tp["enc_convs"]["layers"][0]["bn"]["mean"],
                               p0["enc_convs"]["layers"][0]["bn"]["mean"])
        assert not torch.equal(tp["prenet"]["layers"][0]["w"], p0["prenet"]["layers"][0]["w"])


def test_lr_schedule_matches_jax():
    cfg = _cfg()
    jl, tl = JTask.lr_schedule(cfg), TTask.lr_schedule(cfg)
    for step in (0, 66000, 76000, 86000, 200000):
        assert tl(step) == float(jl(jnp.asarray(step))), step
    assert tl(0) == pytest.approx(1e-3) and tl(86000) == pytest.approx(5e-4)
    assert tl(200000) == pytest.approx(1e-5)


@pytest.mark.parametrize("train_kw", [
    {},
    {"teacher_forcing_mode": "scheduled"},
    {"teacher_forcing_mode": "scheduled", "teacher_forcing_final_ratio": None,
     "teacher_forcing_decay_alpha": 0.5},
], ids=["constant", "scheduled_final_ratio", "scheduled_decay_alpha"])
def test_teacher_forcing_schedule_matches_jax(train_kw):
    cfg = _cfg(**train_kw)
    for step in (0, 70000, 100000, 145000, 220000, 300000):
        want = float(JTask.teacher_forcing_schedule(cfg, jnp.asarray(step)))
        np.testing.assert_allclose(TTask.teacher_forcing_schedule(cfg, step), want, rtol=1e-6, err_msg=str(step))
    if train_kw:
        assert TTask.teacher_forcing_schedule(cfg, 300000) < 1.0  # scheduled sampling would start


def test_tf1_adam_semantics():
    """update = -lr*sqrt(1-b2^t)/(1-b1^t) * m/(sqrt(v)+eps), eps outside the
    bias correction, against a numpy TF-1 reference."""
    b1, b2, eps, lr = 0.9, 0.999, 1e-6, 1e-3
    theta = torch.tensor([1.0, -2.0, 3.0])
    state = TTask.adam_init({"w": theta})
    rng = np.random.RandomState(0)
    m = np.zeros(3)
    v = np.zeros(3)
    ref = theta.numpy().astype(np.float64)
    for t in range(1, 6):
        g = rng.randn(3).astype(np.float32)
        upd, state = TTask.tf1_adam({"w": torch.as_tensor(g)}, state, lr, b1, b2, eps)
        theta = theta + upd["w"]
        m = b1 * m + (1 - b1) * g
        v = b2 * v + (1 - b2) * g * g
        ref = ref - lr * np.sqrt(1 - b2**t) / (1 - b1**t) * m / (np.sqrt(v) + eps)
        np.testing.assert_allclose(theta.numpy(), ref, rtol=1e-6)
    assert state["count"] == 5


def test_clip_by_global_norm():
    g = {"a": torch.tensor([3.0, 0.0]), "b": [torch.tensor([4.0])]}
    same, n = TTask.clip_by_global_norm(g, 10.0)
    assert same is g and float(n) == 5.0
    clipped, _ = TTask.clip_by_global_norm(g, 1.0)
    np.testing.assert_allclose(clipped["a"].numpy(), [0.6, 0.0], rtol=1e-6)
    np.testing.assert_allclose(float(TTask.global_norm(clipped)), 1.0, rtol=1e-6)
    assert tree_map(lambda x: x.shape, clipped) == tree_map(lambda x: x.shape, g)


def test_train_step_many_is_steps_in_a_row():
    cfg = _cfg()
    b = [{k: torch.as_tensor(v) for k, v in x.items()} for x in _batches(2)]
    params = tacotron_from_numpy(jax.device_get(JTask.init_state(jax.random.PRNGKey(1), cfg).params),
                                 cfg.tacotron)
    s1 = TTask.TrainState(0, params, TTask.adam_init(params))
    s2 = TTask.TrainState(0, params, TTask.adam_init(params))
    gen = torch.Generator().manual_seed(0)
    s1, m = TTask.train_step_many(s1, b, gen, cfg)
    ms = []
    for x in b:
        s2, mm = TTask.train_step(s2, x, gen, cfg)
        ms.append(mm["loss"])
    assert s1.step == s2.step == 2 and m["loss"] == ms
    torch.testing.assert_close(s1.params["prenet"]["layers"][0]["w"], s2.params["prenet"]["layers"][0]["w"],
                               rtol=0, atol=0)
