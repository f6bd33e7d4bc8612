"""The port's optimizer and train step against the JAX package's
``tacotron_task``: two full steps (parameters after each), the LR and
teacher-forcing schedules, ``train/optim.py``'s Adam with the TF-1 rule,
global-norm clipping and the fine-tune freeze.

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
from tacotronv2_wavernn_chinese_tpu_torch.train import optim as O
from tacotronv2_wavernn_chinese_tpu_torch.train import tacotron_task as TTask
from tacotronv2_wavernn_chinese_tpu_torch.utils import tree_leaves, tree_map
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
    state = O.adam_init({"w": theta})
    rng = np.random.RandomState(0)
    m = np.zeros(3)
    v = np.zeros(3)
    ref = theta.numpy().astype(np.float64)
    for t in range(1, 6):
        g = rng.randn(3).astype(np.float32)
        upd, state = O.adam({"w": torch.as_tensor(g)}, state, O.tf1_rule, lr, b1, b2, eps)
        theta = theta + upd["w"]
        m = b1 * m + (1 - b1) * g
        v = b2 * v + (1 - b2) * g * g
        ref = ref - lr * np.sqrt(1 - b2**t) / (1 - b1**t) * m / (np.sqrt(v) + eps)
        np.testing.assert_allclose(theta.numpy(), ref, rtol=1e-6)
    assert state["count"] == 5


def test_clip_by_global_norm():
    g = {"a": torch.tensor([3.0, 0.0]), "b": [torch.tensor([4.0])]}
    same, n = O.clip_by_global_norm(g, 10.0)
    assert float(n) == 5.0
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(same), tree_leaves(g)))
    clipped, _ = O.clip_by_global_norm(g, 1.0)
    np.testing.assert_allclose(clipped["a"].numpy(), [0.6, 0.0], rtol=1e-6)
    np.testing.assert_allclose(float(O.global_norm(clipped)), 1.0, rtol=1e-6)
    assert tree_map(lambda x: x.shape, clipped) == tree_map(lambda x: x.shape, g)


@pytest.mark.parametrize("max_norm", [100.0, 0.5], ids=["below_limit", "above_limit"])
def test_clip_reads_nothing_back_and_matches_optax(max_norm, monkeypatch):
    """The clip decides on the device: no tensor reaches the host during
    the call, and the result is optax.clip_by_global_norm's within 1e-7."""
    import optax

    rng = np.random.default_rng(0)
    g = {"a": rng.normal(0, 1, (4, 3)).astype(np.float32), "b": [rng.normal(0, 1, 5).astype(np.float32)]}
    tg = tree_map(torch.as_tensor, g)

    def no_readback(*_a, **_k):
        raise AssertionError("the clip read a tensor back to the host")

    with monkeypatch.context() as m:
        for name in ("__float__", "__bool__", "item", "tolist"):
            m.setattr(torch.Tensor, name, no_readback)
        clipped, norm = O.clip_by_global_norm(tg, max_norm)
    want, _ = optax.clip_by_global_norm(max_norm).update(g, optax.EmptyState())
    assert (float(norm) < max_norm) == (max_norm == 100.0)
    for a, b in zip(tree_leaves(clipped), jax.tree_util.tree_leaves(want)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0, atol=1e-7)
