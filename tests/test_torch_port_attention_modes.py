"""The port's attention module (models/attention.py) against the JAX
package's, on the same weights and inputs, f32 on the CPU: the initial
states, the keys, the anti-repeat rule, the LSA synthesis window, and each
mode's step over a few consecutive steps.

Random trajectories are numpy-seeded; integer state (max_attention, the
dwell counter, window masks) must be equal, values within 1e-6 (the
anti-repeat rule) or 1e-5 (a step)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tacotronv2_wavernn_chinese_tpu.config import default_config
from tacotronv2_wavernn_chinese_tpu.models import attention as JA
from tacotronv2_wavernn_chinese_tpu_torch.models import attention as TA

B, T_IN, Q, V = 3, 16, 32, 64  # rows, encoder positions, query width, value width


def _cfg(**over):
    cfg = dataclasses.replace(
        default_config().tacotron, encoder_lstm_units=V // 2, attention_dim=16, attention_filters=8,
        attention_kernel=7, decoder_lstm_units=Q, num_attn_mixtures=4, graves_heads=3, dropout_rate=0.0,
    )
    return dataclasses.replace(cfg, **over)


def _t(x):
    return torch.as_tensor(np.array(x))


def _tree(tree):
    return jax.tree_util.tree_map(lambda a: torch.as_tensor(np.array(a, np.float32)), jax.device_get(tree))


def _state_close(ts, js, atol):
    for name in JA.AttentionState._fields:
        got, want = getattr(ts, name).numpy(), np.asarray(getattr(js, name))
        if name in ("max_attention", "pos_rec"):
            np.testing.assert_array_equal(got, want, err_msg=name)
        else:
            np.testing.assert_allclose(got, want, atol=atol, err_msg=name)


@pytest.mark.parametrize("mode", ["forward", "lsa", "gmm", "graves"])
def test_init_state_and_keys(mode):
    """Forward starts one-hot at position 0 with mu 0.5, the others at
    zeros; forward and LSA project the memory, GMM and Graves keep it."""
    cfg = _cfg(attention_mode=mode)
    _state_close(TA.init_state(cfg, B, T_IN, V), JA.init_state(cfg, B, T_IN, V), 0.0)
    params = JA.init_params(jax.random.PRNGKey(1), cfg, V, Q)
    memory = np.random.default_rng(2).uniform(-1, 1, (B, T_IN, V)).astype(np.float32)
    np.testing.assert_allclose(TA.precompute_keys(_tree(params), cfg, torch.as_tensor(memory)).numpy(),
                               np.asarray(JA.precompute_keys(params, cfg, jnp.asarray(memory))), atol=1e-6)


@pytest.mark.parametrize("dwell", [(5, 10), (2, 4)], ids=["default_dwell", "short_dwell"])
@pytest.mark.parametrize("seed", [0, 1])
def test_anti_repeat_constrain_matches(seed, dwell):
    """40 steps of a random trajectory (argmax candidates that jump back,
    stay and run ahead, rows starting anywhere up to past the last
    position), each step's outputs fed back as the next step's previous
    state: integer state equal, alignments within 1e-6; the dwell
    thresholds, the clip at the last position and the near-zero-sum guard
    are all reached."""
    cfg = _cfg(anti_repeat=True, dwell_limit_first=dwell[0], dwell_limit_rest=dwell[1])
    rng = np.random.default_rng(seed)
    prev_max = rng.integers(0, T_IN + 2, B).astype(np.int32)
    prev_pos = rng.integers(0, dwell[1], B).astype(np.int32)
    crossed, guarded, clipped = set(), False, False
    for step in range(40):
        align = rng.uniform(0, 1, (B, T_IN)).astype(np.float32) * (rng.uniform(size=(B, T_IN)) < 0.7)
        align[0] = 0.0 if step % 7 == 3 else align[0]  # an all-zero row: the sum guard
        cand = np.clip(prev_max + rng.integers(-2, 4, B), 0, T_IN + 6).astype(np.int32)
        ja, jm, jp = JA.anti_repeat_constrain(jnp.asarray(align), jnp.asarray(cand), jnp.asarray(prev_max),
                                              jnp.asarray(prev_pos), cfg)
        ta, tm, tp = TA.anti_repeat_constrain(_t(align), _t(cand), _t(prev_max), _t(prev_pos), cfg)
        np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
        np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
        np.testing.assert_allclose(ta.numpy(), np.asarray(ja), atol=1e-6)
        crossed |= {int(p) for p in np.asarray(jp)}
        guarded |= bool((align.sum(-1) == 0).any())
        clipped |= bool((np.asarray(jm) >= T_IN - 1).any())
        prev_max, prev_pos = np.array(jm), np.array(jp)
    assert max(crossed) >= dwell[0] and guarded and clipped


@pytest.mark.parametrize("window", [1, 3, 4, 7])
@pytest.mark.parametrize("monotonic", [True, False], ids=["monotonic", "symmetric"])
def test_lsa_window_valid_matches(monotonic, window):
    cfg = _cfg(attention_mode="lsa", synthesis_constraint=True, synthesis_window=window, anti_repeat=monotonic)
    prev = np.random.default_rng(window).integers(0, T_IN + 3, 8).astype(np.int32)
    got = TA.lsa_window_valid(_t(prev), T_IN, cfg).numpy()
    want = np.asarray(JA.lsa_window_valid(jnp.asarray(prev), T_IN, cfg))
    np.testing.assert_array_equal(got, want)
    assert got.sum(-1).max() <= window


STEP_CASES = {
    "forward_anti_repeat": dict(anti_repeat=True),
    "forward_smoothing": dict(smoothing=True),
    "forward_anti_repeat_smoothing": dict(anti_repeat=True, smoothing=True),
    "lsa": dict(attention_mode="lsa"),
    "lsa_not_cumulative": dict(attention_mode="lsa", cumulative_weights=False),
    "lsa_smoothing": dict(attention_mode="lsa", smoothing=True),
    "lsa_window_monotonic": dict(attention_mode="lsa", synthesis_constraint=True, anti_repeat=True),
    "lsa_window_symmetric": dict(attention_mode="lsa", synthesis_constraint=True, synthesis_window=4),
    "lsa_window_symmetric_not_cumulative": dict(attention_mode="lsa", synthesis_constraint=True,
                                                cumulative_weights=False),
    "gmm": dict(attention_mode="gmm"),
    "graves": dict(attention_mode="graves"),
}


@pytest.mark.parametrize("case", list(STEP_CASES))
def test_step_matches_jax(case):
    """12 consecutive steps of ``step`` from each mode's initial state with
    random queries (ragged mask): context, alignment and every state field
    within 1e-5 of the JAX step, integer state equal."""
    cfg = _cfg(**STEP_CASES[case])
    rng = np.random.default_rng(7)
    params = JA.init_params(jax.random.PRNGKey(3), cfg, V, Q)
    if cfg.attention_mode == "forward":  # a livelier mu, so the recursion moves
        params["mu_layer"] = dict(params["mu_layer"], b=params["mu_layer"]["b"] + 1.0)
    memory = rng.uniform(-1, 1, (B, T_IN, V)).astype(np.float32)
    lens = np.asarray([T_IN, 11, 5])
    mask = (np.arange(T_IN)[None, :] < lens[:, None]).astype(np.float32)
    memory *= mask[..., None]
    keys = np.asarray(JA.precompute_keys(params, cfg, jnp.asarray(memory)))
    jstep = jax.jit(lambda p, q, s, k, v, m: JA.step(p, cfg, q, s, k, v, m, False))
    tparams = _tree(params)
    js, ts = JA.init_state(cfg, B, T_IN, V), TA.init_state(cfg, B, T_IN, V)
    for _ in range(12):
        query = rng.uniform(-1, 1, (B, Q)).astype(np.float32)
        jc, ja, js = jstep(params, jnp.asarray(query), js, jnp.asarray(keys), jnp.asarray(memory), jnp.asarray(mask))
        tc, ta, ts = TA.step(tparams, cfg, torch.as_tensor(query), ts, torch.as_tensor(keys),
                             torch.as_tensor(memory), torch.as_tensor(mask))
        np.testing.assert_allclose(tc.numpy(), np.asarray(jc), atol=1e-5)
        np.testing.assert_allclose(ta.numpy(), np.asarray(ja), atol=1e-5)
        _state_close(ts, js, 1e-5)
    if cfg.attention_mode == "forward" and cfg.anti_repeat:
        assert int(np.asarray(js.pos_rec).max()) >= 2 and int(np.asarray(js.max_attention).max()) >= 1


@pytest.mark.parametrize("mode", ["forward", "lsa", "gmm", "graves"])
def test_init_params_tree_matches_jax(mode):
    """The port's init builds the JAX attention tree (Graves' (0, 10, 1)
    bias blocks included) for every mode."""
    from tacotronv2_wavernn_chinese_tpu.models import tacotron as JT
    from tacotronv2_wavernn_chinese_tpu_torch.utils.checkpoints import init_tacotron

    cfg = _cfg(attention_mode=mode)
    shapes = lambda t: jax.tree_util.tree_map(lambda a: tuple(a.shape), t)
    want = shapes(jax.eval_shape(lambda: JT.init_tacotron(jax.random.PRNGKey(0), cfg)))
    got = init_tacotron(0, cfg)
    assert shapes(got) == want
    if mode == "graves":
        H = cfg.graves_heads
        np.testing.assert_array_equal(got["attention"]["layer2"]["b"].numpy(),
                                      np.concatenate([np.zeros(H), np.full(H, 10.0), np.ones(H)]))
