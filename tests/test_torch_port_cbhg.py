"""The CBHG mel->linear head (``tacotron.predict_linear``) of the port
against the JAX package's, f32 on the CPU, on the same weights and inputs.

Small widths: the Tacotron of tests/torch_train_parity.py with a bank of
K=8 convolutions (even widths and the max-pool exercised), conv 16,
projection 32, highway 16, GRU 16; B=2, T=24 frames with ragged lengths
for the head alone.  Tolerances: the head's output and BN statistics 1e-5,
the three branches of the linear loss and the L2 term 1e-6 relative, one
f32 train step with JAX's masks injected at the trainer's gates (loss
2e-5 relative, gradients 5e-4 of max|g|, BN statistics 1e-5; forward
attention takes the kernel route, its plain version here), the
mixed-precision step at tests/test_torch_train_mixed_precision.py's bf16
gates (gradients 5e-2 of max|g|)."""

import base64
import dataclasses
import io
import json
import threading
import urllib.request
import wave

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_train_parity as P
from tacotronv2_wavernn_chinese_tpu.models import layers as JL
from tacotronv2_wavernn_chinese_tpu.models import tacotron as JT
from tacotronv2_wavernn_chinese_tpu.models import wavernn as JW
from tacotronv2_wavernn_chinese_tpu.serving.export import export_artifact
from tacotronv2_wavernn_chinese_tpu_torch.models import layers as TL
from tacotronv2_wavernn_chinese_tpu_torch.models import tacotron as TT
from tacotronv2_wavernn_chinese_tpu_torch.serving import server as TS
from tacotronv2_wavernn_chinese_tpu_torch.serving.export import load_exported, write_artifact
from tacotronv2_wavernn_chinese_tpu_torch.utils import tree_leaves, tree_map
from tacotronv2_wavernn_chinese_tpu_torch.utils.checkpoints import load_params_npz, tacotron_from_numpy

HEAD = dict(predict_linear=True, cbhg_kernels=8, cbhg_conv_channels=16, cbhg_projection=32,
            cbhg_highway_units=16, cbhg_rnn_units=16)
N_BN = 4 + 8 + 2  # encoder and postnet convs, then the head's bank and both projections
B, T = 2, 24
LENS = [24, 15]


@pytest.fixture(scope="module")
def setup():
    jcfg, tcfg = P.cfgs(tacotron=HEAD)
    params = P.jax_params(jcfg)
    rng = np.random.default_rng(3)
    # a padded postnet output: zero past each length
    x = rng.uniform(-4, 4, (B, T, 80)).astype(np.float32)
    x *= (np.arange(T)[None, :] < np.asarray(LENS)[:, None])[..., None]
    return jcfg, tcfg, params, x


def _bn_stats(tree, prefix=""):
    """{path: array} of every BN mean/var under ``tree``."""
    if isinstance(tree, dict):
        return {k2: v2 for k, v in tree.items() for k2, v2 in _bn_stats(v, f"{prefix}/{k}").items()}
    if isinstance(tree, (list, tuple)):
        return {k2: v2 for i, v in enumerate(tree) for k2, v2 in _bn_stats(v, f"{prefix}/{i}").items()}
    if prefix.endswith(("/bn/mean", "/bn/var")):
        return {prefix: np.asarray(tree.detach() if isinstance(tree, torch.Tensor) else tree)}
    return {}


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
def test_apply_cbhg_matches_jax(setup, train):
    """The head alone, eval (moving statistics) and train mode (batch
    statistics over every frame; the updated statistics of the bank's 8
    BNs and both projections')."""
    jcfg, tcfg, params, x = setup
    jl, jnew = JT.apply_cbhg(params, jcfg.tacotron, jnp.asarray(x), train, jax.random.PRNGKey(0))
    tp = tacotron_from_numpy(params, tcfg.tacotron)
    if train:
        tl, tnew = TT.apply_cbhg_train(tp, tcfg.tacotron, torch.as_tensor(x))
        js, ts = _bn_stats(jnew), _bn_stats(tnew)
        assert js.keys() == ts.keys() and len(js) == 2 * 10
        for k in js:
            np.testing.assert_allclose(ts[k], js[k], rtol=1e-5, atol=1e-6, err_msg=k)
        assert not np.allclose(ts["/bank/7/bn/var"], params["cbhg"]["bank"][7]["bn"]["var"])
    else:
        tl = TT.apply_cbhg(tp, tcfg.tacotron, torch.as_tensor(x))
    assert tl.shape == (B, T, 1025)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0, atol=1e-5)


@pytest.mark.parametrize("width", [2, 3, 4])
def test_max_pool_same_matches_reduce_window(width):
    """XLA's SAME window: the extra pad on the right, -inf."""
    x = np.random.default_rng(width).standard_normal((2, 9, 3)).astype(np.float32)
    want = jax.lax.reduce_window(jnp.asarray(x), -jnp.inf, jax.lax.max, (1, width, 1), (1, 1, 1), "SAME")
    got = TL.max_pool_same(torch.as_tensor(x), width)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("h0", [False, True], ids=["zero_state", "given_state"])
def test_gru_scan_matches_jax(setup, h0):
    """The fused GRU shared by WaveRNN and the head, from a zero or a given state."""
    _, _, params, x = setup
    p = params["cbhg"]["gru_fw"]
    xs = x[:, :, :16]
    h = np.random.default_rng(7).uniform(-1, 1, (B, 16)).astype(np.float32) if h0 else None
    want = JL.gru_scan(p, jnp.asarray(xs), None if h is None else jnp.asarray(h))
    got = TL.gru_scan(tree_map(torch.as_tensor, p), torch.as_tensor(xs), None if h is None else torch.as_tensor(h))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-5)


@pytest.mark.parametrize("stop_bias", [None, -30.0], ids=["normal_bias", "runs_to_max_iters"])
def test_forward_inference_linear_matches(setup, stop_bias):
    """The head on the clipped postnet output of a decode, dropout 0."""
    jcfg, tcfg, params, _ = setup
    jtac = dataclasses.replace(jcfg.tacotron, dropout_rate=0.0)
    ttac = dataclasses.replace(tcfg.tacotron, dropout_rate=0.0)
    if stop_bias is not None:
        params = dict(params, stop_projection=dict(params["stop_projection"],
                                                   b=np.full_like(params["stop_projection"]["b"], stop_bias)))
    inputs = np.random.default_rng(4).integers(1, 191, (B, 16)).astype(np.int32)
    lens = np.asarray([16, 11], np.int32)
    j = JT.forward_inference(params, jtac, jnp.asarray(inputs), jnp.asarray(lens), jax.random.PRNGKey(3), 24)
    t = TT.forward_inference(tacotron_from_numpy(params, ttac), ttac, torch.as_tensor(inputs),
                             torch.as_tensor(lens), [0, 0], 24)
    np.testing.assert_array_equal(t.stop_lengths.numpy(), np.asarray(j.stop_lengths))
    np.testing.assert_allclose(t.mel_outputs.numpy(), np.asarray(j.mel_outputs), atol=1e-4)
    assert t.linear_outputs.shape == (B, t.mel_outputs.shape[1], 1025)
    np.testing.assert_allclose(t.linear_outputs.numpy(), np.asarray(j.linear_outputs), rtol=0, atol=1e-5)


def _outputs(rng, jax_side: bool):
    shapes = {"decoder_output": (B, T, 80), "mel_outputs": (B, T, 80), "stop_logits": (B, T),
              "alignments": (B, T, 16), "linear_outputs": (B, T, 1025)}
    vals = {k: rng.standard_normal(s).astype(np.float32) for k, s in shapes.items()}
    cls, conv = (JT.TacotronOutput, jnp.asarray) if jax_side else (TT.TacotronOutput, torch.as_tensor)
    return cls(**{k: conv(v) for k, v in vals.items()})


@pytest.mark.parametrize("branch", ["mean", "mask_decoder", "loss_frames"])
def test_linear_loss_branches_match_jax(setup, branch):
    """Each branch of the linear L1 term, with its quirks (under
    mask_decoder both halves divide by the full-band mask sum, under
    loss_frames the low band by n * n_priority), and the L2 term over a
    tree with the head."""
    jcfg, tcfg, params, _ = setup
    jo, to = _outputs(np.random.default_rng(5), True), _outputs(np.random.default_rng(5), False)
    rng = np.random.default_rng(6)
    mel = rng.uniform(-4, 4, (B, T, 80)).astype(np.float32)
    lin = rng.uniform(0, 1, (B, T, 1025)).astype(np.float32)
    tl = np.asarray([T, 17], np.int32)
    stop = (np.arange(T)[None, :] >= tl[:, None] - 1).astype(np.float32)
    kw = {"mask_decoder": branch == "mask_decoder"}
    lf = np.asarray([20, 20], np.int32) if branch == "loss_frames" else None
    jl, jaux = JT.tacotron_loss(jo, jnp.asarray(mel), jnp.asarray(stop), jnp.asarray(tl), params, jcfg.tacotron,
                                linear_targets=jnp.asarray(lin), sample_rate=22050,
                                loss_frames=None if lf is None else jnp.asarray(lf), **kw)
    tp = tacotron_from_numpy(params, tcfg.tacotron)
    t_l, taux = TT.tacotron_loss(to, torch.as_tensor(mel), torch.as_tensor(stop), torch.as_tensor(tl), tp,
                                 tcfg.tacotron, linear_targets=torch.as_tensor(lin), sample_rate=22050,
                                 loss_frames=None if lf is None else torch.as_tensor(lf), **kw)
    assert taux.keys() == jaux.keys() and "linear" in taux
    for k in jaux:
        np.testing.assert_allclose(float(taux[k]), float(jaux[k]), rtol=1e-6, err_msg=k)
    np.testing.assert_allclose(float(t_l), float(jl), rtol=1e-6)
    # without the head's output the term is left out
    _, aux = TT.tacotron_loss(to._replace(linear_outputs=None), torch.as_tensor(mel), torch.as_tensor(stop),
                              torch.as_tensor(tl), tp, tcfg.tacotron, linear_targets=torch.as_tensor(lin))
    assert "linear" not in aux


def test_l2_regularizables_counts_the_head_like_jax(setup):
    """The head adds its convolutions, BN scales and biases and highway
    weights; its GRUs, biases and linear projection stay out."""
    jcfg, tcfg, params, _ = setup
    tp = tacotron_from_numpy(params, tcfg.tacotron)
    got, want = float(TT.l2_regularizables(tp)), float(JT.l2_regularizables(params))
    np.testing.assert_allclose(got, want, rtol=1e-6)
    c = params["cbhg"]
    sq = lambda a: 0.5 * float(np.sum(np.asarray(a, np.float64) ** 2))
    convs = c["bank"] + [c["proj1"], c["proj2"]]
    head = (sum(sq(lp["conv"]["w"]) + sq(lp["bn"]["scale"]) + sq(lp["bn"]["bias"]) for lp in convs)
            + sq(c["highway_in"]["w"]) + sum(sq(h["h"]["w"]) + sq(h["t"]["w"]) for h in c["highways"]))
    without = {k: v for k, v in tp.items() if k not in ("cbhg", "linear_projection")}
    np.testing.assert_allclose(got - float(TT.l2_regularizables(without)), head, rtol=1e-5)


def _head_batch(seed=0):
    batch = P.batch_np(seed=seed)
    batch["linear_targets"] = np.random.default_rng(seed + 1).uniform(0, 1, (3, 20, 1025)).astype(np.float32)
    return batch


def test_train_step_matches_jax():
    """One f32 step with the head and linear targets, JAX's masks injected:
    forward attention takes the kernel route (its plain version on the
    CPU); loss, the linear term, every gradient and 14 BNs' statistics."""
    jcfg, tcfg = P.cfgs(tacotron=HEAD)
    assert TT.core_route(tcfg.tacotron, True, 1.0) == "kernel"
    res = P.run_step(jcfg, tcfg, P.jax_params(jcfg), _head_batch())
    P.assert_step_matches(res, n_bn=N_BN)
    assert float(res["aux"]["linear"].detach()) > 0.0
    assert not np.allclose(res["new"]["cbhg"]["proj2"]["bn"]["mean"].detach().numpy(),
                           res["params"]["cbhg"]["proj2"]["bn"]["mean"])
    assert float(np.abs(res["grads"]["['cbhg']['gru_bw']['wh']"]).max()) > 0.0


def test_mixed_precision_step_matches_jax():
    """The head under mixed precision: its BN subtrees stay f32 and come
    back from the computed tree; the bf16 gates.  JAX's step is compiled
    with XLA's excess precision off, so that it rounds to bf16 where its
    program says (measured: gradients 2.1e-2 of max|g|, loss 1.5e-7).  By
    default XLA keeps f32 between the first encoder convolution's bf16
    operations (tests/test_torch_train_mixed_precision.py): the postnet mel
    the head reads moves by ~1e-4, a few of the bank's ReLUs change side,
    and each moves its convolution's gradient by one of B x T = 60
    positions' terms, 0.17 of that leaf's max|g| on this batch."""
    jcfg, tcfg = P.cfgs(tacotron=HEAD, mixed_precision=True)
    res = P.run_step(jcfg, tcfg, P.jax_params(jcfg), _head_batch(),
                     jax_grad=P.jax_grad_fn(xla_allow_excess_precision=False))
    P.assert_step_matches(res, 1e-3, 5e-2, 1e-2, stat_scale=1e-2, n_bn=N_BN)
    assert all(t.dtype == torch.float32 for t in tree_leaves(res["new"]))
    assert res["out"].linear_outputs.dtype == torch.float32


def _wav_frames(b64):
    with wave.open(io.BytesIO(base64.b64decode(b64))) as w:
        return w.getnframes()


def test_artifact_with_the_head_serves(setup, tmp_path):
    """A JAX-exported predict_linear artifact (with WaveRNN weights) loads
    in the port, round-trips through the port's exporter, and answers
    /generate_tts with a WAV of stop_len x hop samples; the teacher-forced
    eval forward (the GTA path) runs the head."""
    jcfg, tcfg, params, _ = setup
    jcfg = jcfg.override("tacotron.dropout_rate=0.0,wavernn.upsample_factors=(2,2,5),wavernn.rnn_dims=32,"
                         "wavernn.fc_dims=32,wavernn.compute_dims=16,wavernn.res_out_dims=128,wavernn.res_blocks=1,"
                         "wavernn_gen.target=200,wavernn_gen.overlap=40,audio.hop_size=20,audio.bits=8")
    params = dict(params, stop_projection=dict(params["stop_projection"],
                                               b=np.full_like(params["stop_projection"]["b"], -30.0)))
    voc = jax.jit(lambda k: JW.init_wavernn(k, jcfg.wavernn, num_mels=80, bits=8))(jax.random.PRNGKey(1))
    export_artifact(jcfg, params, str(tmp_path / "jax"), voc)
    synth = load_exported(str(tmp_path / "jax"), max_iters=12, device="cpu")
    assert synth.cfg.tacotron.predict_linear and synth.params["linear_projection"]["w"].shape == (32, 1025)
    write_artifact(synth.cfg, synth.params, str(tmp_path / "port"), synth.vocoder_params)
    again = load_params_npz(str(tmp_path / "port" / "tacotron_params.npz"))
    for a, b in zip(tree_leaves(again["cbhg"]), tree_leaves(tree_map(np.asarray, params["cbhg"]))):
        np.testing.assert_array_equal(a, b)
    httpd = TS.serve(synth.cfg, synth, "127.0.0.1", 0)
    th = threading.Thread(target=httpd.serve_forever, daemon=True)
    th.start()
    try:
        req = urllib.request.Request(f"http://127.0.0.1:{httpd.server_address[1]}/generate_tts",
                                     data=json.dumps({"text": "你好。", "seed": 1}).encode(),
                                     headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=120) as r:
            body = json.loads(r.read())
        assert body["status"] == 0 and _wav_frames(body["wav_b64"]) == 12 * 20
    finally:
        httpd.shutdown()
        httpd.server_close()
        th.join(timeout=30)
    # the eval forward of GTA and eval_step: the head in eval mode, BN statistics unchanged
    batch = {k: torch.as_tensor(v) for k, v in P.batch_np().items()}
    out, new = TT.forward_teacher_forced(synth.params, synth.cfg.tacotron, batch["inputs"], batch["input_lengths"],
                                         batch["mel_targets"], False, generator=torch.Generator().manual_seed(0))
    assert out.linear_outputs.shape == (3, 20, 1025) and new["cbhg"] is synth.params["cbhg"]
