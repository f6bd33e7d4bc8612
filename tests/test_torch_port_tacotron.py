"""The port's Tacotron module (holds the decode kernel K2) against the JAX
package, on the same weights and inputs, f32 on the CPU.

The port's CPU path is the kernel's plain version; the JAX references are
the interpret-mode Pallas decode and the XLA decode."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tacotronv2_wavernn_chinese_tpu.config import default_config
from tacotronv2_wavernn_chinese_tpu.models import tacotron as JT
from tacotronv2_wavernn_chinese_tpu.ops import tacotron_decoder_kernel as JDK
from tacotronv2_wavernn_chinese_tpu_torch import ops as OPS
from tacotronv2_wavernn_chinese_tpu_torch.models import tacotron as TT
from tacotronv2_wavernn_chinese_tpu_torch.ops import tacotron_decoder_kernel as TDK
from tacotronv2_wavernn_chinese_tpu_torch.utils.checkpoints import init_tacotron, tacotron_from_numpy

B, T_IN = 2, 16


def _cfg(dropout):
    cfg = default_config().tacotron
    return dataclasses.replace(
        cfg, embedding_dim=32, enc_conv_channels=32, enc_conv_layers=2,
        encoder_lstm_units=32, attention_dim=16, attention_filters=8,
        attention_kernel=7, prenet_layers=(32, 32), decoder_lstm_units=32,
        postnet_channels=32, postnet_layers=2, dropout_rate=dropout,
    )


def _with_stop_bias(params, b):
    return dict(params, stop_projection=dict(params["stop_projection"],
                                             b=jnp.full_like(params["stop_projection"]["b"], b)))


@pytest.fixture(scope="module")
def setup():
    cfg = _cfg(0.0)
    # jitted: one compile instead of one per eager op, same values
    params = jax.jit(lambda k: JT.init_tacotron(k, cfg))(jax.random.PRNGKey(0))
    rng = np.random.default_rng(0)
    inputs = rng.integers(1, cfg.vocab_size, (B, T_IN)).astype(np.int32)
    lens = np.asarray([16, 11], np.int32)
    return cfg, params, inputs, lens


def _port(params, cfg):
    return tacotron_from_numpy(jax.device_get(params), cfg)


def _encode_both(cfg, params, inputs, lens):
    jmem, _ = JT.encode(params, cfg, jnp.asarray(inputs), jnp.asarray(lens), False, jax.random.PRNGKey(1))
    tmem = TT.encode(_port(params, cfg), cfg, torch.as_tensor(inputs), torch.as_tensor(lens))
    return np.asarray(jmem), tmem


def test_encode_matches(setup):
    cfg, params, inputs, lens = setup
    jmem, tmem = _encode_both(cfg, params, inputs, lens)
    np.testing.assert_allclose(tmem.numpy(), jmem, atol=1e-5)


def _assert_decode_close(j, t, check_stops=True):
    jf, js, ja, jl = (np.asarray(x) for x in j)
    tf, ts, ta, tl = (x.numpy() for x in t)
    np.testing.assert_array_equal(tl, jl)
    n = int(jl.min())
    np.testing.assert_allclose(tf[:, :n], jf[:, :n], atol=1e-5)
    np.testing.assert_allclose(ta[:, :n], ja[:, :n], atol=1e-5)
    if check_stops:
        np.testing.assert_allclose(ts[:, :n], js[:, :n], atol=1e-5)
    return n


@pytest.mark.parametrize("stop_bias", [None, -30.0], ids=["normal_bias", "runs_to_max_iters"])
def test_plain_decode_matches_pallas_interpret_and_xla(setup, stop_bias):
    cfg, params, inputs, lens = setup
    if stop_bias is not None:
        params = _with_stop_bias(params, stop_bias)
    jmem, tmem = _encode_both(cfg, params, inputs, lens)
    mask = (np.arange(T_IN)[None, :] < lens[:, None]).astype(np.float32)
    rng = jax.random.PRNGKey(5)
    j_pallas = JDK.decode_autoregressive_pallas(
        params, cfg, jnp.asarray(jmem), jnp.asarray(mask), rng, 24, chunk=8, interpret=True,
        dtype=jnp.float32,
    )
    j_xla = JT.decode_autoregressive(params, cfg, jnp.asarray(jmem), jnp.asarray(mask), rng, 24)
    t = TDK.decode_autoregressive_plain(_port(params, cfg), cfg, tmem, torch.as_tensor(mask), [1, 2], 24)
    n1 = _assert_decode_close(j_pallas, t, check_stops=False)
    n2 = _assert_decode_close(j_xla, t)
    if stop_bias is not None:
        assert n1 == n2 == 24


def test_plain_decode_with_injected_jax_dropout(setup):
    """dropout 0.5: the prenet keep-masks JAX draws (fold_in(rng, t) per
    step, then step_rand_from_key) are injected into the port."""
    _, params, inputs, lens = setup
    cfg = _cfg(0.5)
    params = _with_stop_bias(params, -30.0)
    jmem, tmem = _encode_both(cfg, params, inputs, lens)
    mask = (np.arange(T_IN)[None, :] < lens[:, None]).astype(np.float32)
    rng = jax.random.PRNGKey(7)
    steps = 24
    keys = jax.vmap(lambda t: jax.random.fold_in(rng, t))(jnp.arange(steps))
    rands = jax.vmap(lambda k: JT.step_rand_from_key(params, cfg, k, B, False))(keys)
    masks = tuple(torch.as_tensor(np.array(m)) for m in rands.pre)
    assert masks[0].shape == (steps, B, 32) and 0.3 < float(masks[0].float().mean()) < 0.7
    j = JT.decode_autoregressive(params, cfg, jnp.asarray(jmem), jnp.asarray(mask), rng, steps)
    t = TDK.decode_autoregressive_plain(_port(params, cfg), cfg, tmem, torch.as_tensor(mask), [0, 0], steps,
                                        prenet_masks=masks)
    assert _assert_decode_close(j, t) == steps


@pytest.mark.parametrize("stop_bias", [None, -30.0], ids=["normal_bias", "runs_to_max_iters"])
def test_forward_inference_mel_matches(setup, stop_bias):
    cfg, params, inputs, lens = setup
    if stop_bias is not None:
        params = _with_stop_bias(params, stop_bias)
    j = JT.forward_inference(params, cfg, jnp.asarray(inputs), jnp.asarray(lens), jax.random.PRNGKey(3), 24)
    t = TT.forward_inference(_port(params, cfg), cfg, torch.as_tensor(inputs), torch.as_tensor(lens), [0, 0], 24)
    np.testing.assert_array_equal(t.stop_lengths.numpy(), np.asarray(j.stop_lengths))
    np.testing.assert_allclose(t.mel_outputs.numpy(), np.asarray(j.mel_outputs), atol=1e-4)
    np.testing.assert_allclose(t.decoder_output.numpy(), np.asarray(j.decoder_output), atol=1e-5)


def test_kernel_wrapper_on_cpu_is_the_plain_version(setup):
    """The wrapper sends CPU tensors to the plain version, with the shared
    generator's dropout (rate 0.5), and counts no launch."""
    _, params, inputs, lens = setup
    cfg = _cfg(0.5)
    tp = _port(_with_stop_bias(params, -30.0), cfg)
    tmem = TT.encode(tp, cfg, torch.as_tensor(inputs), torch.as_tensor(lens))
    mask = TT.input_mask(torch.as_tensor(lens), T_IN)
    OPS.reset_launch_counts()
    a = TDK.decode_autoregressive_kernel(tp, cfg, tmem, mask, [3, 4], 12)
    b = TDK.decode_autoregressive_plain(tp, cfg, tmem, mask, [3, 4], 12)
    assert OPS.LAUNCHES["tacotron_decode"] == 0
    for x, y in zip(a, b):
        torch.testing.assert_close(x, y, rtol=0, atol=0)
    # a different seed changes the dropout, hence the frames
    c = TDK.decode_autoregressive_plain(tp, cfg, tmem, mask, [3, 5], 12)
    torch.testing.assert_close(c[0][0], a[0][0], rtol=0, atol=1e-6)
    assert not torch.equal(c[0][1], a[0][1])


def test_row_independence_of_the_decode(setup):
    """A row decoded alone equals the same row decoded in a batch."""
    _, params, inputs, lens = setup
    cfg = _cfg(0.5)
    tp = _port(_with_stop_bias(params, -30.0), cfg)
    tmem = TT.encode(tp, cfg, torch.as_tensor(inputs), torch.as_tensor(lens))
    mask = TT.input_mask(torch.as_tensor(lens), T_IN)
    both = TDK.decode_autoregressive_plain(tp, cfg, tmem, mask, [11, 12], 10)
    alone = TDK.decode_autoregressive_plain(tp, cfg, tmem[1:], mask[1:], [12], 10)
    torch.testing.assert_close(alone[0][0], both[0][1], atol=1e-5, rtol=0)
    torch.testing.assert_close(alone[2][0], both[2][1], atol=1e-5, rtol=0)


def test_unported_options_raise():
    """On the card (device None or CUDA) GMM with more than 128 mixtures,
    Graves with more than 128 heads and r > 6 raise naming their ROADMAP
    item (the TPU kernel's envelope); the plain version (CPU) takes them;
    the kernel's scope takes GMM and Graves up to 128, anti-repeat, LSA and
    r up to 6."""
    for mode, field in (("gmm", "num_attn_mixtures"), ("graves", "graves_heads")):
        for n in (1, 5, 10, 128):
            cfg = dataclasses.replace(_cfg(0.0), attention_mode=mode, **{field: n})
            TDK.check_supported(cfg)
            TDK.check_supported(cfg, "cuda")
        cfg = dataclasses.replace(_cfg(0.0), attention_mode=mode, **{field: 129})
        with pytest.raises(NotImplementedError, match=f"{field}=129.*ROADMAP.md, queue item 15"):
            TDK.check_supported(cfg)
        with pytest.raises(NotImplementedError, match="ROADMAP.md, queue item 15"):
            TDK.check_supported(cfg, "cuda")
        TDK.check_supported(cfg, "cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        TDK.check_supported(dataclasses.replace(_cfg(0.0), outputs_per_step=7))
    TDK.check_supported(dataclasses.replace(_cfg(0.0), outputs_per_step=6, anti_repeat=True, smoothing=True))
    TDK.check_supported(dataclasses.replace(_cfg(0.0), attention_mode="lsa", synthesis_constraint=True))


@pytest.mark.parametrize("predict_linear", [False, True], ids=["mel", "cbhg_head"])
def test_init_tacotron_has_the_jax_tree_shapes(predict_linear):
    cfg = dataclasses.replace(default_config().tacotron, predict_linear=predict_linear)
    jshapes = jax.tree_util.tree_map(lambda a: tuple(a.shape), jax.eval_shape(
        lambda: JT.init_tacotron(jax.random.PRNGKey(0), cfg)))
    t = init_tacotron(0, cfg, device="meta")
    tshapes = jax.tree_util.tree_map(lambda a: tuple(a.shape), t)
    assert tshapes == jshapes


def test_generator_bits():
    """hash_bits: deterministic, distinct across lanes, ~uniform; keep rate
    and Gumbel noise have the right moments."""
    lanes = torch.arange(4096, dtype=torch.int64)
    a = OPS.hash_bits(torch.tensor(7), 3, 11, lanes)
    assert torch.equal(a, OPS.hash_bits(torch.tensor(7), 3, 11, lanes))
    assert len(set(a.tolist())) == 4096
    assert int(a.min()) >= 0 and int(a.max()) <= 0xFFFFFFFF
    keep = (a < OPS.keep_threshold(0.5)).float().mean()
    assert abs(float(keep) - 0.5) < 0.03
    g = OPS.gumbel_from_bits(OPS.hash_bits(torch.tensor(1), torch.arange(64)[:, None], 0, lanes))
    assert abs(float(g.mean()) - 0.5772) < 0.02 and abs(float(g.var()) - 1.6449) < 0.05
