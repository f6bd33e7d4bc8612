"""The port's WaveRNN module (holds the sample-loop kernel K1) against the
JAX package, on the same weights and inputs, f32 on the CPU.

Geometry: 80 mels and aux 32 (the kernel's), narrow recurrent widths,
upsample (2, 2, 5) so the loops stay short."""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tacotronv2_wavernn_chinese_tpu.config import default_config
from tacotronv2_wavernn_chinese_tpu.models import wavernn as JW
from tacotronv2_wavernn_chinese_tpu.ops import wavernn_kernel as JK
from tacotronv2_wavernn_chinese_tpu_torch import ops as OPS
from tacotronv2_wavernn_chinese_tpu_torch.models import wavernn as TW
from tacotronv2_wavernn_chinese_tpu_torch.ops import wavernn_kernel as TK
from tacotronv2_wavernn_chinese_tpu_torch.utils.checkpoints import init_wavernn, wavernn_from_numpy

BITS = 8


@pytest.fixture(scope="module")
def setup():
    cfg = default_config()
    mcfg = dataclasses.replace(
        cfg.wavernn, upsample_factors=(2, 2, 5), rnn_dims=64, fc_dims=64,
        compute_dims=32, res_out_dims=128, res_blocks=2,
    )
    # jitted: one compile instead of one per eager op, same values
    params = jax.jit(lambda k: JW.init_wavernn(k, mcfg, num_mels=80, bits=BITS))(jax.random.PRNGKey(0))
    # non-trivial BatchNorm statistics, so eval-mode BN is really exercised
    rng = np.random.default_rng(1)
    res = params["resnet"]
    res["bn_in"] = dict(res["bn_in"], mean=jnp.asarray(rng.normal(0, 0.1, 32), jnp.float32),
                        var=jnp.asarray(rng.uniform(0.5, 1.5, 32), jnp.float32))
    mels = rng.uniform(0.0, 1.0, (2, 8, 80)).astype(np.float32)
    tparams = wavernn_from_numpy(jax.device_get(params), mcfg, bits=BITS)
    return mcfg, params, tparams, mels


def _labels(wav):
    return np.round((np.asarray(wav) + 1.0) * (2**BITS - 1) / 2.0).astype(int)


def test_upsample_matches(setup):
    mcfg, params, tparams, mels = setup
    jm, ja, _ = JW.upsample(params, mcfg, jnp.asarray(mels), train=False)
    tm, ta = TW.upsample(tparams, mcfg, torch.as_tensor(mels))
    np.testing.assert_allclose(tm.numpy(), np.asarray(jm), atol=1e-5)
    np.testing.assert_allclose(ta.numpy(), np.asarray(ja), atol=1e-5)


def test_greedy_labels_match_pallas_interpret(setup):
    mcfg, params, tparams, mels = setup
    j = JK.generate_pallas(params, mcfg, jnp.asarray(mels), jax.random.PRNGKey(2), bits=BITS,
                           apply_mu_law=False, greedy=True, chunk=16, interpret=True, dtype=jnp.float32)
    t = TW.generate_scan(tparams, mcfg, mels, seed=0, bits=BITS, apply_mu_law=False, greedy=True)
    assert t.shape == j.shape
    np.testing.assert_array_equal(_labels(t.numpy()), _labels(j))


def test_sampled_labels_with_injected_jax_noise(setup):
    """The Gumbel noise JAX generate_scan draws (split(rng, T), one
    gumbel per step) is injected into the port's loop."""
    mcfg, params, tparams, mels = setup
    rng = jax.random.PRNGKey(4)
    B = mels.shape[0]
    T = (mels.shape[1] - 2 * mcfg.pad) * mcfg.total_upsample
    noise = jax.vmap(lambda k: jax.random.gumbel(k, (B, 2**BITS), jnp.float32))(jax.random.split(rng, T))
    j = JW.generate_scan(params, mcfg, jnp.asarray(mels), rng, bits=BITS, apply_mu_law=False)
    t = TW.generate_scan(tparams, mcfg, mels, bits=BITS, apply_mu_law=False,
                         noise=torch.as_tensor(np.array(noise)))
    jl, tl = _labels(j), _labels(t.numpy())
    np.testing.assert_array_equal(tl, jl)
    assert len(np.unique(jl)) > 10  # really sampled, not collapsed onto one class


def test_generate_batch_matches(setup):
    mcfg, params, tparams, _ = setup
    gen_cfg = dataclasses.replace(default_config().wavernn_gen, target=60, overlap=20)
    rng = np.random.default_rng(3)
    mels = [rng.uniform(0.0, 1.0, (n, 80)).astype(np.float32) for n in (9, 4)]
    j = JW.generate_batch(params, mcfg, gen_cfg, mels, jax.random.PRNGKey(0), bits=BITS,
                          generate_fn=functools.partial(JW.generate_scan, greedy=True))
    t = TW.generate_batch(tparams, mcfg, gen_cfg, mels, 0, bits=BITS,
                          generate_fn=functools.partial(TW.generate_scan, greedy=True))
    assert [w.shape for w in t] == [w.shape for w in j] == [(9 * 20,), (4 * 20,)]
    for a, b in zip(t, j):
        np.testing.assert_allclose(a, np.asarray(b), atol=1e-6)


def test_wrapper_on_cpu_is_the_plain_version(setup):
    """Sampled decoding through the wrapper (CPU -> plain version, the
    shared generator) is deterministic per seed, counts no launch, and
    differs across seeds."""
    mcfg, _, tparams, mels = setup
    OPS.reset_launch_counts()
    a = TW.generate_kernel(tparams, mcfg, mels, seed=9, bits=BITS, apply_mu_law=False)
    b = TW.generate_scan(tparams, mcfg, mels, seed=9, bits=BITS, apply_mu_law=False)
    c = TW.generate_kernel(tparams, mcfg, mels, seed=10, bits=BITS, apply_mu_law=False)
    assert OPS.LAUNCHES["wavernn_sample"] == 0
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert not torch.equal(a, c)


def test_geometry_checks():
    cfg = default_config().wavernn
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        TK.check_supported(dataclasses.replace(cfg, mode="MOL"))
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        TK.check_supported(dataclasses.replace(cfg, res_out_dims=64))
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        TK.check_supported(cfg, num_mels=96)


def test_init_wavernn_has_the_jax_tree_shapes():
    cfg = default_config().wavernn
    jshapes = jax.tree_util.tree_map(lambda a: tuple(a.shape), jax.eval_shape(
        lambda: JW.init_wavernn(jax.random.PRNGKey(0), cfg)))
    tshapes = jax.tree_util.tree_map(lambda a: tuple(a.shape), init_wavernn(0, cfg, device="meta"))
    assert tshapes == jshapes


def test_fold_helpers_match():
    rng = np.random.default_rng(5)
    x = rng.normal(size=(37, 3)).astype(np.float32)
    jf, jn = JW.fold_with_overlap(x, 10, 2)
    tf, tn = TW.fold_with_overlap(x, 10, 2)
    assert tn == jn
    np.testing.assert_array_equal(tf, jf)
    y = rng.normal(size=(4, 50)).astype(np.float32)
    np.testing.assert_array_equal(TW.xfade_and_unfold(y, 10), JW.xfade_and_unfold(y, 10))
    np.testing.assert_array_equal(TW.bucket_folds(jf), JW.bucket_folds(jf))
    np.testing.assert_array_equal(TW.pad_mel_for_generation(x, 2), JW.pad_mel_for_generation(x, 2))
