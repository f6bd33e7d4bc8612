"""The port's DeepMind WaveRNN (``models/wavernn_deepmind.py``: the
coarse/fine dual-softmax 16-bit vocoder) against the JAX package's, f32 on
the CPU, at hidden 64, B=2, T=12: the 16-bit split and its inverse, one
step, the teacher-forced sequence, the loss and its gradients within 1e-5;
generation with JAX's own Gumbel draws injected gives equal samples (a
categorical draw is argmax(logits + Gumbel); the draws are rebuilt from
the keys ``generate`` splits)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tacotronv2_wavernn_chinese_tpu.models import wavernn_deepmind as JD
from tacotronv2_wavernn_chinese_tpu_torch.models import wavernn_deepmind as TD
from tacotronv2_wavernn_chinese_tpu_torch.utils import tree_leaves, tree_map
from tacotronv2_wavernn_chinese_tpu_torch.utils.checkpoints import _check_tree, _to_torch

HIDDEN, B, T = 64, 2, 12


@pytest.fixture(scope="module")
def params():
    """JAX's init with non-zero biases, as numpy; the port's tree of it."""
    p = jax.device_get(jax.jit(lambda k: JD.init_deepmind_wavernn(k, HIDDEN))(jax.random.PRNGKey(0)))
    rng = np.random.default_rng(0)
    p = dict(p, **{k: rng.uniform(-0.5, 0.5, HIDDEN).astype(np.float32) for k in ("bias_u", "bias_r", "bias_e")})
    _check_tree(p, TD.init_deepmind_wavernn(0, HIDDEN, device="meta"), "deepmind")
    return p, _to_torch(p, torch.device("cpu"))


def _streams(seed):
    rng = np.random.default_rng(seed)
    return tuple(rng.integers(0, 256, (B, T + 1)).astype(np.float32) for _ in range(2))


def test_init_has_the_jax_tree_shapes():
    jshapes = jax.tree_util.tree_map(lambda a: tuple(a.shape),
                                     jax.eval_shape(lambda: JD.init_deepmind_wavernn(jax.random.PRNGKey(0))))
    t = TD.init_deepmind_wavernn(0)
    assert jax.tree_util.tree_map(lambda a: tuple(a.shape), t) == jshapes
    assert float(t["R"].abs().max()) > 0.0


def test_split_and_combine_match_jax():
    x = np.random.default_rng(1).uniform(-1, 1, (B, 50)).astype(np.float32)
    jc, jf = JD.split_signal_16bit(jnp.asarray(x))
    tc, tf = TD.split_signal_16bit(torch.as_tensor(x))
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    np.testing.assert_allclose(tf.numpy(), np.asarray(jf), rtol=0, atol=1e-5)
    np.testing.assert_allclose(TD.combine_signal(tc, tf).numpy(), np.asarray(JD.combine_signal(jc, jf)), atol=1e-6)
    np.testing.assert_allclose(TD.combine_signal(tc, tf).numpy(), x, atol=1e-4)


def test_forward_step_matches_jax(params):
    jp, tp = params
    rng = np.random.default_rng(2)
    pc, pf, cc = (rng.uniform(0, 1, B).astype(np.float32) for _ in range(3))
    h = rng.uniform(-1, 1, (B, HIDDEN)).astype(np.float32)
    j = JD.forward(jp, *(jnp.asarray(a) for a in (pc, pf, cc, h)))
    t = TD.forward(tp, *(torch.as_tensor(a) for a in (pc, pf, cc, h)))
    for a, b in zip(t, j):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0, atol=1e-5)


def test_train_forward_loss_and_gradients_match_jax(params):
    jp, tp = params
    coarse, fine = _streams(3)
    joc, jof = JD.train_forward(jp, jnp.asarray(coarse / 255.0), jnp.asarray(fine / 255.0))
    toc, tof = TD.train_forward(tp, torch.as_tensor(coarse / 255.0), torch.as_tensor(fine / 255.0))
    assert toc.shape == (B, T, 256)
    np.testing.assert_allclose(toc.numpy(), np.asarray(joc), rtol=0, atol=1e-5)
    np.testing.assert_allclose(tof.numpy(), np.asarray(jof), rtol=0, atol=1e-5)
    jl, jg = jax.jit(jax.value_and_grad(JD.loss))(jp, jnp.asarray(coarse), jnp.asarray(fine))
    leaves = tree_map(lambda a: a.clone().requires_grad_(True), tp)
    tl = TD.loss(leaves, torch.as_tensor(coarse), torch.as_tensor(fine))
    np.testing.assert_allclose(float(tl.detach()), float(jl), rtol=1e-5)
    grads = torch.autograd.grad(tl, tree_leaves(leaves))
    for g, (path, a) in zip(grads, jax.tree_util.tree_flatten_with_path(jg)[0]):
        a = np.asarray(a)
        np.testing.assert_allclose(g.numpy(), a, rtol=0, atol=1e-5 * max(float(np.abs(a).max()), 1e-6) + 1e-8,
                                   err_msg=jax.tree_util.keystr(path))


def test_generate_with_jax_draws_is_equal(params):
    jp, tp = params
    n, rng = 40, jax.random.PRNGKey(5)
    j = np.asarray(JD.generate(jp, n, rng, batch=B))

    def draws(key):
        kc, kf = jax.random.split(key)
        return jnp.stack([jax.random.gumbel(kc, (B, 256)), jax.random.gumbel(kf, (B, 256))])

    gumbel = np.array(jax.vmap(draws)(jax.random.split(rng, n)))  # [n, 2, B, 256]
    t = TD.generate(tp, n, batch=B, gumbel=torch.as_tensor(gumbel)).numpy()
    assert t.shape == (B, n) and np.abs(t).max() <= 1.0
    np.testing.assert_array_equal(np.rint((t + 1.0) * 32767.5), np.rint((j + 1.0) * 32767.5))
    # from a generator: seeded, reproducible, a different seed another wav
    a = TD.generate(tp, n, torch.Generator().manual_seed(1), batch=B)
    assert torch.equal(a, TD.generate(tp, n, torch.Generator().manual_seed(1), batch=B))
    assert not torch.equal(a, TD.generate(tp, n, torch.Generator().manual_seed(2), batch=B))
