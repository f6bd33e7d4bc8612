"""The port's decode in the configurations beyond the default (anti-repeat,
smoothing, LSA with and without its synthesis window, GMM, Graves, r = 2,
3 and 6, the all-frames stop policy) against the JAX package, on JAX
weights carried across by ``tacotron_from_numpy``, f32 on the CPU.

The port's CPU path is the decode kernel's plain version; the JAX
references are the XLA decode (every configuration) and the interpret-mode
Pallas decode (LSA with the window, r = 2, GMM and Graves).  Stop lengths
must be equal; frames, stops and alignments within 1e-5."""

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
from tacotronv2_wavernn_chinese_tpu_torch.utils.checkpoints import tacotron_from_numpy

B = 2


def _cfg(**over):
    """The widths of the JAX decoder-kernel tests, dropout 0 (deterministic
    prenet)."""
    cfg = dataclasses.replace(
        default_config().tacotron,
        embedding_dim=32, enc_conv_channels=32, enc_conv_layers=1,
        encoder_lstm_units=32, attention_dim=16, attention_filters=8,
        attention_kernel=7, prenet_layers=(32, 32), decoder_lstm_units=32,
        postnet_channels=32, postnet_layers=1, dropout_rate=0.0,
    )
    return dataclasses.replace(cfg, **over)


def _setup(cfg, seed: int, T_in: int, lens, stop_shift: float):
    """JAX params from ``seed`` with the stop bias shifted by ``stop_shift``
    (-8: no row stops within the run, so the anti-repeat and window
    thresholds are crossed on full buffers), the JAX-encoded memory of
    numpy-seeded ids, and the mask."""
    params = jax.jit(lambda k: JT.init_tacotron(k, cfg))(jax.random.PRNGKey(seed))
    params["stop_projection"] = dict(params["stop_projection"], b=params["stop_projection"]["b"] + stop_shift)
    inputs = np.random.default_rng(seed).integers(1, cfg.vocab_size, (B, T_in)).astype(np.int32)
    lens = np.asarray(lens, np.int32)
    memory, _ = JT.encode(params, cfg, jnp.asarray(inputs), jnp.asarray(lens), False, jax.random.PRNGKey(1))
    mask = (np.arange(T_in)[None, :] < lens[:, None]).astype(np.float32)
    return params, np.array(memory), mask


def _port_decode(params, cfg, memory, mask, steps):
    tp = tacotron_from_numpy(jax.device_get(params), cfg)
    return TDK.decode_autoregressive_plain(tp, cfg, torch.as_tensor(memory), torch.as_tensor(mask), [0] * B, steps)


def _assert_close(j, t, r: int, check_stops: bool = True):
    """Equal stop lengths; frames, stops (frames up to the shortest stop)
    and alignments (its decoder steps) within 1e-5.  Returns that stop."""
    jf, js, ja, jl = (np.asarray(x) for x in j)
    tf, ts, ta, tl = (x.numpy() for x in t)
    assert tf.shape == jf.shape and ta.shape == ja.shape
    np.testing.assert_array_equal(tl, jl)
    n = int(jl.min())
    np.testing.assert_allclose(tf[:, :n], jf[:, :n], atol=1e-5)
    np.testing.assert_allclose(ta[:, : -(-n // r)], ja[:, : -(-n // r)], atol=1e-5)
    if check_stops:
        np.testing.assert_allclose(ts[:, :n], js[:, :n], atol=1e-5)
    return n


# name: (config overrides, params seed, T_in, lengths, stop-bias shift, steps)
XLA_CASES = {
    "anti_repeat": (dict(anti_repeat=True), 0, 16, (16, 11), -8.0, 40),
    "smoothing": (dict(smoothing=True), 41, 32, (32, 21), 0.0, 24),
    "lsa": (dict(attention_mode="lsa"), 21, 48, (48, 31), 0.0, 24),
    "lsa_window_monotonic": (dict(attention_mode="lsa", synthesis_constraint=True, synthesis_window=4,
                                  anti_repeat=True), 23, 40, (40, 29), -8.0, 30),
    "lsa_window_symmetric_not_cumulative": (dict(attention_mode="lsa", synthesis_constraint=True,
                                                 cumulative_weights=False), 24, 40, (40, 29), -8.0, 30),
    "gmm": (dict(attention_mode="gmm"), 31, 40, (40, 27), 0.0, 24),
    "graves": (dict(attention_mode="graves"), 32, 40, (40, 27), 0.0, 24),
    "r2": (dict(outputs_per_step=2), 53, 24, (24, 17), 0.0, 24),
    "r3": (dict(outputs_per_step=3), 54, 24, (24, 17), 0.0, 24),
    "r6": (dict(outputs_per_step=6), 57, 24, (24, 17), -8.0, 24),
    "r2_stop_all": (dict(outputs_per_step=2, stop_at_any=False), 61, 16, (16, 11), -2.0, 24),
}


@pytest.mark.parametrize("case", list(XLA_CASES))
def test_plain_decode_matches_xla(case):
    over, seed, T_in, lens, shift, steps = XLA_CASES[case]
    cfg = _cfg(**over)
    params, memory, mask = _setup(cfg, seed, T_in, lens, shift)
    j = JT.decode_autoregressive(params, cfg, jnp.asarray(memory), jnp.asarray(mask), jax.random.PRNGKey(5), steps)
    t = _port_decode(params, cfg, memory, mask, steps)
    n = _assert_close(j, t, cfg.outputs_per_step)
    if shift <= -8.0:  # nothing stops: every step compared, the constraints exercised
        assert n == steps * cfg.outputs_per_step
    if cfg.anti_repeat and cfg.attention_mode == "forward":
        nz = (t[2].numpy()[0] > 1e-9).sum(-1)
        assert nz.max() <= 6  # the window [m-2, m+3) and the clipped bin
    if cfg.synthesis_constraint:
        assert (t[2].numpy()[:, 1:] > 1e-6).sum(-1).max() <= cfg.synthesis_window


# name: (config overrides, params seed, T_in, lengths, stop-bias shift, steps)
PALLAS_CASES = {
    "lsa_window_symmetric": (dict(attention_mode="lsa", synthesis_constraint=True, synthesis_window=4), 23, 40,
                             (40, 29), -8.0, 20),
    "r2": (dict(outputs_per_step=2), 53, 24, (24, 17), 0.0, 12),
    "gmm": (dict(attention_mode="gmm"), 31, 40, (40, 27), 0.0, 20),
    "graves": (dict(attention_mode="graves"), 32, 40, (40, 27), 0.0, 20),
}


@pytest.mark.parametrize("case", list(PALLAS_CASES))
def test_plain_decode_matches_pallas_interpret(case):
    """The interpret-mode Pallas decode (the TPU kernel itself, f32) for LSA
    with the synthesis window, r = 2, and the TPU kernel's GMM and Graves
    branches (_kernel's else branch)."""
    over, seed, T_in, lens, shift, steps = PALLAS_CASES[case]
    cfg = _cfg(**over)
    params, memory, mask = _setup(cfg, seed, T_in, lens, shift)
    j = JDK.decode_autoregressive_pallas(params, cfg, jnp.asarray(memory), jnp.asarray(mask),
                                         jax.random.PRNGKey(5), steps, chunk=steps // 2, interpret=True,
                                         dtype=jnp.float32)
    t = _port_decode(params, cfg, memory, mask, steps)
    _assert_close(j, t, cfg.outputs_per_step, check_stops=False)


def test_stop_lengths_follow_the_step_rule():
    """r = 3: a row is done at the first step with any (or all) of its
    three flags; the length is that step's first flagged frame."""
    neg, pos = -5.0, 5.0
    stops = torch.full((3, 4 * 3), neg)
    stops[0, 4] = pos  # step 1, frame 1 -> 4 under any; never all
    stops[1, 6:9] = pos  # step 2 all set -> 6 under both
    stops[1, 2] = pos  # step 0, frame 2 -> 2 under any
    got_any = TDK.stop_lengths(stops, 4, 3, True).tolist()
    got_all = TDK.stop_lengths(stops, 4, 3, False).tolist()
    assert got_any == [4, 2, 12] and got_all == [12, 6, 12]


def test_forward_inference_r3_matches_jax_synthesizer():
    """r = 3 end to end: the port's Synthesizer.mel_from_ids (encoder, the
    plain decode, postnet, trimming) against the JAX Synthesizer's, on the
    same weights: stop lengths equal, mels within 1e-4, alignments 1e-5."""
    from tacotronv2_wavernn_chinese_tpu.infer.synthesizer import Synthesizer as JSynth
    from tacotronv2_wavernn_chinese_tpu_torch.config import _config_from_dict as port_config
    from tacotronv2_wavernn_chinese_tpu_torch.infer.synthesizer import Synthesizer as TSynth

    jcfg = dataclasses.replace(default_config(), tacotron=_cfg(outputs_per_step=3))
    params = jax.jit(lambda k: JT.init_tacotron(k, jcfg.tacotron))(jax.random.PRNGKey(54))
    ids = [list(np.random.default_rng(1).integers(1, 60, n)) for n in (21, 9, 14)]
    j = JSynth(jcfg, params, max_iters=10).mel_from_ids(ids, seed=[1, 2, 3])
    t = TSynth(port_config(jcfg.to_dict()), jax.device_get(params), max_iters=10, device="cpu").mel_from_ids(
        ids, seed=[1, 2, 3])
    assert t[2] == j[2] and min(j[2]) < 30  # some row stops before the cap
    for tm, jm, ta, ja in zip(t[0], j[0], t[1], j[1]):
        np.testing.assert_allclose(tm, jm, atol=1e-4)
        np.testing.assert_allclose(ta, ja, atol=1e-5)


@pytest.mark.parametrize("over", [dict(attention_mode="lsa"), dict(attention_mode="gmm"),
                                  dict(attention_mode="graves"), dict(outputs_per_step=3)],
                         ids=["lsa", "gmm", "graves", "r3"])
def test_jax_artifact_loads_and_decodes(over, tmp_path):
    """An artifact written by the JAX exporter with another attention mode
    or r = 3 loads into the port and decodes on the CPU, with no launch, and
    its configuration is in the card's kernel's scope."""
    from tacotronv2_wavernn_chinese_tpu.serving.export import export_artifact
    from tacotronv2_wavernn_chinese_tpu_torch.serving.export import load_exported

    jcfg = dataclasses.replace(default_config(), tacotron=_cfg(**over))
    params = jax.jit(lambda k: JT.init_tacotron(k, jcfg.tacotron))(jax.random.PRNGKey(3))
    export_artifact(jcfg, params, str(tmp_path))
    synth = load_exported(str(tmp_path), max_iters=6, device="cpu")
    OPS.reset_launch_counts()
    mels, aligns, stops = synth.mel_from_ids([[5, 9, 14, 3]], seed=0)
    r = jcfg.tacotron.outputs_per_step
    assert mels[0].shape == (stops[0], 80) and np.isfinite(mels[0]).all() and stops[0] <= 6 * r
    assert aligns[0].shape == (-(-stops[0] // r), 4)
    assert OPS.LAUNCHES["tacotron_decode"] == 0
    TDK.check_supported(synth.cfg.tacotron, "cuda")  # the card's kernel takes every mode


def test_decoder_step_shapes_r6():
    """decoder_step gives [B, 80r] frames and [B, r] stops; the plain decode
    feeds back the last frame and returns [B, T*r, 80]."""
    from tacotronv2_wavernn_chinese_tpu_torch.utils.checkpoints import init_tacotron

    cfg = _cfg(outputs_per_step=6)
    tp = init_tacotron(57, cfg)
    mem = torch.rand(B, 24, 2 * cfg.encoder_lstm_units, generator=torch.Generator().manual_seed(0))
    mask = torch.ones(B, 24)
    keys = TT.ATT.precompute_keys(tp["attention"], cfg, mem)
    carry = TT.init_decoder_carry(cfg, B, 24, mem.shape[-1])
    frames, stops, align, _ = TT.decoder_step(tp, cfg, torch.zeros(B, 80), carry, keys, mem, mask)
    assert frames.shape == (B, 480) and stops.shape == (B, 6) and align.shape == (B, 24)
    out = TDK.decode_autoregressive_plain(tp, cfg, mem, mask, [0, 1], 3)
    assert out[0].shape == (B, 18, 80) and out[1].shape == (B, 18) and out[2].shape == (B, 3, 24)
    torch.testing.assert_close(out[0][:, :6].reshape(B, 480), frames, rtol=0, atol=1e-6)
