"""The port's WaveRNN training (models/wavernn.py forward and loss,
train/wavernn_task.py, train/wavernn_train.py, data/loader.py's vocoder
windows, data/native_loader.py) against the JAX package, f32 on the CPU.

Narrow widths, 80 mels; the JAX steps are jitted XLA on the CPU (their GRU
scans in ``lax.scan``), the port's run torch's fused GRU."""

import dataclasses
import os
import shutil
import subprocess
import sys
import wave

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tacotronv2_wavernn_chinese_tpu.config import default_config as jax_default_config
from tacotronv2_wavernn_chinese_tpu.data import loader as JL
from tacotronv2_wavernn_chinese_tpu.data import native_loader as JNL
from tacotronv2_wavernn_chinese_tpu.models import layers as JLayers
from tacotronv2_wavernn_chinese_tpu.models import wavernn as JW
from tacotronv2_wavernn_chinese_tpu.train import wavernn_task as JTask
from tacotronv2_wavernn_chinese_tpu_torch.config import default_config
from tacotronv2_wavernn_chinese_tpu_torch.data import loader as TL
from tacotronv2_wavernn_chinese_tpu_torch.data import native_loader as TNL
from tacotronv2_wavernn_chinese_tpu_torch.models import layers as TLayers
from tacotronv2_wavernn_chinese_tpu_torch.models import wavernn as TW
from tacotronv2_wavernn_chinese_tpu_torch.train import optim as O
from tacotronv2_wavernn_chinese_tpu_torch.train import wavernn_task as TTask
from tacotronv2_wavernn_chinese_tpu_torch.train import wavernn_train as TTrain
from tacotronv2_wavernn_chinese_tpu_torch.utils.checkpoints import CheckpointManager, wavernn_from_numpy
from tacotronv2_wavernn_chinese_tpu_torch.utils.metrics import read_scalars

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WAVERNN = dict(rnn_dims=32, fc_dims=32, compute_dims=16, res_out_dims=16, res_blocks=2)
TRAIN = dict(batch_size=3, seq_len_hops=3, test_samples=1)


def _cfgs(mode="RAW", upsample=(2, 2, 5), hop=20, wavernn=None, train=None):
    """(JAX config, port config) with the same fields."""
    out = []
    for cfg in (jax_default_config(), default_config()):
        w = dataclasses.replace(cfg.wavernn, mode=mode, upsample_factors=upsample, **(wavernn or WAVERNN))
        t = dataclasses.replace(cfg.wavernn_train, **(train or TRAIN))
        a = dataclasses.replace(cfg.audio, hop_size=hop)
        out.append(dataclasses.replace(cfg, wavernn=w, wavernn_train=t, audio=a))
    return out


def _init(jcfg, seed=0):
    """JAX init (jitted), with non-trivial BN running statistics, as numpy."""
    p = jax.device_get(jax.jit(lambda k: JW.init_wavernn(k, jcfg.wavernn, 80, jcfg.audio.bits))(
        jax.random.PRNGKey(seed)))
    rng = np.random.default_rng(seed + 1)
    for bn in [p["resnet"]["bn_in"]] + [b[k] for b in p["resnet"]["blocks"] for k in ("bn1", "bn2")]:
        bn["mean"] = rng.normal(0, 0.1, bn["mean"].shape).astype(np.float32)
        bn["var"] = rng.uniform(0.5, 1.5, bn["var"].shape).astype(np.float32)
    return p


def _batch(jcfg, seed, B=None):
    wc = jcfg.wavernn_train
    B = B or wc.batch_size
    T = wc.seq_len_hops * jcfg.audio.hop_size
    rng = np.random.default_rng(seed)
    y = rng.integers(0, 2 ** jcfg.audio.bits, (B, T)).astype(np.int32)
    return {"x": rng.uniform(-1, 1, (B, T)).astype(np.float32), "y": y,
            "mels": rng.uniform(0, 1, (B, wc.seq_len_hops + 2 * jcfg.wavernn.pad, 80)).astype(np.float32)}


def _t(batch):
    return {"x": torch.as_tensor(batch["x"]), "y": torch.as_tensor(batch["y"]).long(),
            "mels": torch.as_tensor(batch["mels"])}


def _compare_tree(tp, jp, atol, what, rtol=0.0):
    for path, a in jax.tree_util.tree_flatten_with_path(jp)[0]:
        node = tp
        for k in path:
            node = node[k.key if hasattr(k, "key") else k.idx]
        np.testing.assert_allclose(node.detach().numpy(), np.asarray(a), rtol=rtol, atol=atol,
                                   err_msg=f"{what}: {jax.tree_util.keystr(path)}")


@pytest.mark.parametrize("train", [True, False], ids=["train", "eval"])
def test_forward_matches_jax(train):
    """Logits and (train mode) the new BN running statistics against JAX
    ``W.forward``: within 1e-5 (measured: logits 1.3e-6 train, 2.4e-7
    eval; statistics 1.2e-7)."""
    jcfg, tcfg = _cfgs()
    jp = _init(jcfg)
    b = _batch(jcfg, 1)
    jl, jnew = JW.forward(jp, jcfg.wavernn, jnp.asarray(b["x"]), jnp.asarray(b["mels"]), train)
    tl, tnew = TW.forward(wavernn_from_numpy(jp, tcfg.wavernn), tcfg.wavernn, torch.as_tensor(b["x"]),
                          torch.as_tensor(b["mels"]), train)
    assert tl.shape == (3, 60, 2 ** jcfg.audio.bits)
    np.testing.assert_allclose(tl.detach().numpy(), np.asarray(jl), rtol=0, atol=1e-5)
    _compare_tree(tnew, jax.device_get(jnew), 1e-5, "new params")
    if train:
        assert not np.allclose(tnew["resnet"]["bn_in"]["var"].numpy(), jp["resnet"]["bn_in"]["var"])


def test_batchnorm_unbiased_ema_matches_jax():
    """The vocoder's BN tracks the unbiased variance, the Tacotron default
    the biased one: both against JAX ``layers.batchnorm`` within 1e-6."""
    rng = np.random.default_rng(0)
    x = rng.normal(1.0, 2.0, (3, 7, 5)).astype(np.float32)
    p = {"scale": rng.uniform(0.5, 1.5, 5).astype(np.float32), "bias": rng.normal(0, 1, 5).astype(np.float32),
         "mean": rng.normal(0, 1, 5).astype(np.float32), "var": rng.uniform(0.5, 1.5, 5).astype(np.float32)}
    tp = {k: torch.as_tensor(v) for k, v in p.items()}
    for kw in ({"momentum": 0.9, "eps": 1e-5, "unbiased_ema": True}, {}):
        jy, jn = JLayers.batchnorm({k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x), True, **kw)
        ty, tn = TLayers.batchnorm_train(tp, torch.as_tensor(x), **kw)
        np.testing.assert_allclose(ty.numpy(), np.asarray(jy), atol=1e-6)
        for k in ("mean", "var"):
            np.testing.assert_allclose(tn[k].numpy(), np.asarray(jn[k]), rtol=1e-6, err_msg=f"{kw} {k}")
    _, tn_b = TLayers.batchnorm_train(tp, torch.as_tensor(x))
    _, tn_u = TLayers.batchnorm_train(tp, torch.as_tensor(x), unbiased_ema=True)
    n = 21
    np.testing.assert_allclose((tn_u["var"] - 0.99 * tp["var"]).numpy(),
                               ((tn_b["var"] - 0.99 * tp["var"]) * n / (n - 1)).numpy(), rtol=1e-5)


@pytest.mark.parametrize("mode", ["RAW", "MOL"])
def test_wavernn_loss_matches_jax(mode):
    """RAW cross-entropy and MOL NLL (integer labels mapped by
    label_2_float) and their gradients: value within 1e-5 relative
    (measured 1.3e-7 / 1.4e-7).  RAW gradient within 1e-6 (measured 2.3e-10).
    The MOL gradient carries f32 cancellation (test_torch_port_mol.py):
    the port's must be no farther from its float64 gradient than JAX's f32
    gradient is, and within twice JAX's own error of JAX element-wise
    (measured 1.2e-4)."""
    jcfg, _ = _cfgs(mode)
    rng = np.random.default_rng(3)
    width = 2 ** jcfg.audio.bits if mode == "RAW" else 30
    logits = rng.normal(0, 1, (2, 9, width)).astype(np.float32)
    if mode == "MOL":
        logits[..., 20:] = rng.uniform(-5, -2, (2, 9, 10))  # log scales
    y = rng.integers(0, 2 ** jcfg.audio.bits, (2, 9)).astype(np.int32)
    y[0, :2] = [0, 2 ** jcfg.audio.bits - 1]  # the two edge bins
    jl, jg = jax.value_and_grad(lambda a: JW.wavernn_loss(a, jnp.asarray(y), mode, jcfg.audio.bits))(
        jnp.asarray(logits))
    t = torch.tensor(logits, requires_grad=True)
    tl = TW.wavernn_loss(t, torch.as_tensor(y), mode, jcfg.audio.bits)
    tl.backward()
    np.testing.assert_allclose(float(tl.detach()), float(jl), rtol=1e-5)
    if mode == "RAW":
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(jg), rtol=0, atol=1e-6)
        return
    t64 = torch.tensor(logits.astype(np.float64), requires_grad=True)
    TW.wavernn_loss(t64, torch.as_tensor(y), mode, jcfg.audio.bits).backward()
    jax_err = np.abs(np.asarray(jg) - t64.grad.numpy()).max()
    assert np.abs(t.grad.numpy() - t64.grad.numpy()).max() <= jax_err
    np.testing.assert_allclose(t.grad.numpy(), np.asarray(jg), rtol=0, atol=2 * jax_err)


def test_optax_adam_matches_optax():
    """``optim.adam`` with the optax rule against optax.adam over 4
    updates: within 1e-7 of 1e-4-sized updates (measured 0: the same f32
    operations)."""
    import optax

    rng = np.random.default_rng(0)
    theta = {"a": rng.normal(0, 1, (4, 3)).astype(np.float32), "b": rng.normal(0, 1, 5).astype(np.float32)}
    opt = optax.adam(1e-4)
    js = opt.init(theta)
    tstate = O.adam_init({k: torch.as_tensor(v) for k, v in theta.items()})
    for i in range(4):
        g = {k: rng.normal(0, 10.0 ** -i, v.shape).astype(np.float32) for k, v in theta.items()}
        ju, js = opt.update(g, js)
        tu, tstate = O.adam({k: torch.as_tensor(v) for k, v in g.items()}, tstate, O.optax_rule, 1e-4)
        for k in theta:
            np.testing.assert_allclose(tu[k].numpy(), np.asarray(ju[k]), rtol=0, atol=1e-7)


_jax_grads = jax.jit(jax.grad(lambda p, cfg, b: JTask.loss_fn(p, cfg, b, True)[0]), static_argnums=1)

LR = 1e-4


def _flat(tree):
    return {jax.tree_util.keystr(path): np.asarray(a) for path, a in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _flat_torch(tree, like):
    out = {}
    for path, _ in jax.tree_util.tree_flatten_with_path(like)[0]:
        node = tree
        for k in path:
            node = node[k.key if hasattr(k, "key") else k.idx]
        out[jax.tree_util.keystr(path)] = node.detach().numpy()
    return out


def _run_both(mode, n_steps, seed=0):
    """Both steps from the same weights and batches -> per step (JAX
    params, port params, JAX metrics, port metrics, the largest gradient
    difference, the Adam-sensitive elements so far: where the two sides'
    gradients differ by more than 1 % or JAX's is below 1e-6)."""
    jcfg, tcfg = _cfgs(mode)
    jstate = JTask.init_state(jax.random.PRNGKey(seed), jcfg)
    jstate = jstate._replace(params=jax.tree_util.tree_map(jnp.asarray, _init(jcfg, seed)))
    p0 = wavernn_from_numpy(jax.device_get(jstate.params), tcfg.wavernn)
    tstate = TTask.TrainState(0, p0, TTask.adam_init(p0))
    sensitive = {k: np.zeros(v.shape, bool) for k, v in _flat(jax.device_get(jstate.params)).items()}
    history = []
    for i in range(n_steps):
        b = _batch(jcfg, 10 + i)
        jb = {k: jnp.asarray(v) for k, v in b.items()}
        jg = jax.device_get(_jax_grads(jstate.params, jcfg, jb))
        tg = _flat_torch(TTask.compute_grads(tstate.params, tcfg, _t(b))[2], jg)
        jg = _flat(jg)
        dg = max(float(np.abs(tg[k] - jg[k]).max()) for k in jg)
        sensitive = {k: m | (np.abs(tg[k] - jg[k]) > 0.01 * np.abs(jg[k])) | (np.abs(jg[k]) < 1e-6)
                     for k, m in sensitive.items()}
        jstate, jm = JTask.train_step(jstate, jb, jcfg)
        tstate, tm = TTask.train_step(tstate, _t(b), tcfg)
        history.append((jax.device_get(jstate.params), tstate.params, jax.device_get(jm), tm, dg, sensitive))
    return jstate, tstate, history


def _compare_after_adam(tp, jp, sensitive, steps, what, loose_share):
    """Params within 2e-6, except Adam-sensitive elements: at Adam's first
    steps an element moves by ~lr * g / (|g| + 1e-8), so a gradient whose
    sign or size the two sides' f32 rounding leaves uncertain moves by up
    to 2 lr a step.  Those are held to 2 lr per step so far, and at most
    ``loose_share`` of the elements may use it.  Returns the count that did."""
    jf, n_loose, n_all = _flat(jp), 0, 0
    tf = _flat_torch(tp, jp)
    for k, a in jf.items():
        d, m = np.abs(tf[k] - a), sensitive[k]
        assert (d[~m] <= 2e-6).all(), f"{what}: {k} max|d| {d[~m].max():.3e} on Adam-insensitive elements"
        assert (d[m] <= 2 * LR * steps).all(), f"{what}: {k}"
        n_loose += int((d[m] > 2e-6).sum())
        n_all += d.size
    assert n_loose <= loose_share * n_all, f"{what}: {n_loose} of {n_all} elements beyond 2e-6"
    return n_loose


@pytest.mark.parametrize("mode,n_steps", [("RAW", 3), ("MOL", 2)])
def test_train_steps_match_jax(mode, n_steps):
    """Steps of the port's ``train_step`` against JAX
    ``wavernn_task.train_step`` from the same carried-over weights and
    batches.  Loss within 5e-5 relative.  RAW: gradients within 1e-6
    (measured 4e-8), grad norm 5e-5 relative.  MOL: the NLL's gradient
    carries the f32 cancellation of cdf_plus - cdf_min on both sides
    (~1e-5..7e-5 from the float64 gradient, test_torch_port_mol.py), so its
    grad norm is held to 1e-3 relative (measured 9.2e-5).  Params and BN
    statistics within 2e-6, the Tacotron optimizer tests' tolerance, on
    every Adam-insensitive element (``_compare_after_adam``; measured 3.0e-8
    RAW, 7.6e-7 MOL).  Sensitive elements beyond 2e-6: RAW at most 1e-4 of
    them (measured 2 of 60,005), MOL at most 2 % (measured 10, then 225 of
    27,203: after the first step the two sides' params differ by up to 2 lr
    on those, and the second step's gradients by up to 1.5e-3)."""
    jstate, tstate, history = _run_both(mode, n_steps)
    assert tstate.step == int(jstate.step) == n_steps
    for i, (jp, tp, jm, tm, dg, sensitive) in enumerate(history):
        np.testing.assert_allclose(tm["loss"], float(jm["loss"]), rtol=5e-5, err_msg=f"step {i + 1} loss")
        np.testing.assert_allclose(tm["grad_norm"], float(jm["grad_norm"]), rtol=5e-5 if mode == "RAW" else 1e-3,
                                   err_msg=f"step {i + 1} grad_norm")
        if mode == "RAW":
            assert dg <= 1e-6, f"step {i + 1}: gradients differ by {dg:.3e}"
        _compare_after_adam(tp, jp, sensitive, i + 1, f"{mode} after step {i + 1}",
                            1e-4 if mode == "RAW" else 2e-2)
    assert history[0][3]["grad_norm"] > 0.0
    # the BN running statistics advanced with the forward
    assert not torch.equal(history[-1][1]["resnet"]["bn_in"]["mean"], history[0][1]["resnet"]["bn_in"]["mean"])


def _write_vocoder_corpus(root, n=6, frames=(14, 24), hop=275, seed=0):
    """GTA-layout rows ``wav|gt_mel|pred_mel|text``: mu-law labels of
    frames x hop samples (some shorter than their mel implies) and unit mels."""
    rng = np.random.default_rng(seed)
    os.makedirs(root, exist_ok=True)
    rows = []
    for i in range(n):
        f = int(rng.integers(*frames))
        n_lab = f * hop - (hop // 2 if i % 3 == 0 else 0)
        np.save(os.path.join(root, f"wav-{i}.npy"), rng.integers(0, 1024, n_lab).astype(np.int32))
        for kind in ("gt", "pred"):
            np.save(os.path.join(root, f"{kind}-{i}.npy"), rng.uniform(0, 1, (f, 80)).astype(np.float32))
        rows.append([f"wav-{i}.npy", f"gt-{i}.npy", f"pred-{i}.npy", f"utt {i}"])
    # one utterance shorter than a window: filtered out
    np.save(os.path.join(root, "wav-short.npy"), np.zeros(4 * hop, np.int32))
    for kind in ("gt", "pred"):
        np.save(os.path.join(root, f"{kind}-short.npy"), np.zeros((4, 80), np.float32))
    rows.append(["wav-short.npy", "gt-short.npy", "pred-short.npy", "short"])
    meta = os.path.join(root, "wavernn_training_data.txt")
    with open(meta, "w", encoding="utf-8") as f:
        f.write("\n".join("|".join(r) for r in rows) + "\n")
    return meta, rows


def test_vocoder_dataset_bit_equal_to_jax(tmp_path):
    """The short-utterance filter, the held-out split and two epochs of
    windows (start bounded by both streams, silence pad, label_2_float)
    equal the JAX loader's bit for bit."""
    _, rows = _write_vocoder_corpus(str(tmp_path))
    jcfg, tcfg = _cfgs(hop=275, upsample=(5, 5, 11), train=dict(batch_size=2, seq_len_hops=5, test_samples=2))
    jd = JL.VocoderDataset(rows, str(tmp_path), jcfg)
    td = TL.VocoderDataset(rows, str(tmp_path), tcfg)
    assert len(td.rows) == len(rows) - 1
    assert (td.train_indices, td.test_indices) == (jd.train_indices, jd.test_indices)
    n = 0
    for epoch in range(2):
        for jb, tb in zip(jd.batches(100 + epoch), td.batches(100 + epoch), strict=True):
            for k in ("x", "y", "mels"):
                a, b = getattr(tb, k), getattr(jb, k)
                assert a.dtype == b.dtype and np.array_equal(a, b), k
            n += 1
    assert n == 4
    # a labels stream shorter than its mel: the window stays inside it
    short = JL.VocoderDataset(rows, str(tmp_path), jcfg).collate([0, 3], np.random.RandomState(5))
    tshort = td.collate([0, 3], np.random.RandomState(5))
    assert np.array_equal(short.x, tshort.x) and np.array_equal(short.y, tshort.y)


def test_native_loader_matches_jax(tmp_path):
    """One worker (a single random stream) and one seed: the port's build of
    its copy of the C++ window sampler (``csrc/vocoder_loader.cc``) yields
    the JAX binding's batches, bit-equal."""
    if shutil.which("g++") is None:
        pytest.skip("g++ is not installed: the native loader cannot be built")
    assert JNL.NativeVocoderLoader.available() and TNL.NativeVocoderLoader.available()
    assert TNL.library_path().startswith(os.path.join(REPO, "build", "native_loader"))
    _, rows = _write_vocoder_corpus(str(tmp_path))
    rows = rows[:-1]
    jcfg, tcfg = _cfgs(hop=275, upsample=(5, 5, 11), train=dict(batch_size=2, seq_len_hops=5))
    jl = JNL.NativeVocoderLoader(rows, str(tmp_path), jcfg, n_workers=1, ring_size=2, seed=77)
    tl = TNL.NativeVocoderLoader(rows, str(tmp_path), tcfg, n_workers=1, ring_size=2, seed=77)
    try:
        assert tl.num_utts == jl.num_utts == len(rows)
        for _ in range(4):
            jb, tb = jl.next_batch(), tl.next_batch()
            for k in ("x", "y", "mels"):
                assert np.array_equal(getattr(tb, k), getattr(jb, k)), k
    finally:
        jl.close()
        tl.close()


def test_native_dsp_helpers_match_jax():
    if shutil.which("g++") is None:
        pytest.skip("g++ is not installed: the native loader cannot be built")
    x = np.random.default_rng(0).uniform(-1, 1, 5000).astype(np.float32)
    assert np.array_equal(TNL.preemphasis_native(x, 0.97), JNL.preemphasis_native(x, 0.97))
    assert np.array_equal(TNL.mulaw_encode_native(x, 1024), JNL.mulaw_encode_native(x, 1024))


def _train_cfg(tcfg):
    """The port config for run_training on the CPU: hop 275 (the corpus),
    aux 32 (the sample loop's), narrow recurrent widths, short folds."""
    w = dataclasses.replace(tcfg.wavernn, upsample_factors=(5, 5, 11), res_out_dims=128)
    t = dataclasses.replace(tcfg.wavernn_train, batch_size=2, seq_len_hops=2, test_samples=1, checkpoint_every=2,
                            gen_at_checkpoint=1, summary_interval=1)
    g = dataclasses.replace(tcfg.wavernn_gen, target=550, overlap=275)
    return dataclasses.replace(tcfg, wavernn=w, wavernn_train=t, wavernn_gen=g,
                               audio=dataclasses.replace(tcfg.audio, hop_size=275))


def test_run_training_checkpoints_resumes_and_listens(tmp_path):
    """4 steps with checkpoints at 2 and 4 (Adam state and BN statistics
    saved), a listening-test WAV of the test mel's frames x 275 samples at
    each, then a restart that resumes at step 4 and runs to 5."""
    meta, rows = _write_vocoder_corpus(str(tmp_path / "data"))
    cfg = _train_cfg(_cfgs()[1])
    logs = []
    log_dir = str(tmp_path / "logs")
    state = TTrain.run_training(cfg, meta, str(tmp_path / "data"), log_dir, total_steps=4, log=logs.append,
                                device="cpu")
    assert state.step == 4
    assert any(m.startswith("warm step done") for m in logs)
    assert not any("failed" in m for m in logs), logs
    mgr = CheckpointManager(os.path.join(log_dir, "checkpoints"))
    assert mgr.all_steps() == [2, 4]
    ck = mgr.restore("cpu")
    assert ck["opt_state"]["count"] == 4
    torch.testing.assert_close(ck["params"]["resnet"]["bn_in"]["var"], state.params["resnet"]["bn_in"]["var"])
    torch.testing.assert_close(ck["opt_state"]["mu"]["gru1"]["wh"], state.opt_state["mu"]["gru1"]["wh"])
    ds = TL.VocoderDataset(rows, str(tmp_path / "data"), cfg)
    frames = np.load(os.path.join(str(tmp_path / "data"), ds.rows[ds.test_indices[0]][2])).shape[0]
    for step in (2, 4):
        with wave.open(os.path.join(log_dir, "model_outputs", f"step{step}_batched_sample0.wav")) as wf:
            assert wf.getnframes() == frames * 275 and wf.getframerate() == 22050
    scalars = read_scalars(os.path.join(log_dir, "scalars.jsonl"))
    assert [r["step"] for r in scalars] == [1, 2, 3, 4] and all(np.isfinite(r["loss"]) for r in scalars)

    logs.clear()
    state2 = TTrain.run_training(cfg, meta, str(tmp_path / "data"), log_dir, total_steps=5, log=logs.append,
                                 device="cpu", gen_at_checkpoint=False)
    assert "restored checkpoint at step 4" in logs and state2.step == 5
    assert mgr.all_steps() == [2, 4, 5]


@pytest.mark.parametrize("every,total", [(3, 5), (2, 4)])
def test_run_training_checkpoints_on_every_interval(tmp_path, every, total):
    """One step per batch: a checkpoint at every multiple of
    ``checkpoint_every`` and at the end, across epochs, and at no other
    step."""
    meta, _ = _write_vocoder_corpus(str(tmp_path / "data"))
    cfg = _train_cfg(_cfgs()[1])
    cfg = dataclasses.replace(cfg, wavernn_train=dataclasses.replace(cfg.wavernn_train, checkpoint_every=every))
    logs = []
    log_dir = str(tmp_path / "logs")
    state = TTrain.run_training(cfg, meta, str(tmp_path / "data"), log_dir, total_steps=total, log=logs.append,
                                device="cpu", gen_at_checkpoint=False)
    assert state.step == state.opt_state["count"] == total
    multiples = list(range(every, total + 1, every))
    assert [m for m in logs if m.startswith("saved checkpoint")] == [f"saved checkpoint at step {s}"
                                                                      for s in multiples]
    assert CheckpointManager(os.path.join(log_dir, "checkpoints")).all_steps() == sorted(set(multiples) | {total})
    assert [r["step"] for r in read_scalars(os.path.join(log_dir, "scalars.jsonl"))] == list(range(1, total + 1))


def test_run_training_native_loader_and_empty_epoch(tmp_path):
    """``use_native_loader`` logs the C++ loader active (or, without g++,
    the fallback); a train split smaller than a batch raises ValueError."""
    meta, _ = _write_vocoder_corpus(str(tmp_path / "data"), n=3)
    cfg = _train_cfg(_cfgs()[1])
    logs = []
    state = TTrain.run_training(cfg, meta, str(tmp_path / "data"), str(tmp_path / "l1"), total_steps=2,
                                log=logs.append, device="cpu", use_native_loader=True, gen_at_checkpoint=False)
    assert state.step == 2
    want = "native C++ loader active" if shutil.which("g++") else "native loader requested but unavailable"
    assert any(m.startswith(want) for m in logs), logs
    big = dataclasses.replace(cfg, wavernn_train=dataclasses.replace(cfg.wavernn_train, batch_size=8))
    with pytest.raises(ValueError, match="no batches"):
        TTrain.run_training(big, meta, str(tmp_path / "data"), str(tmp_path / "l2"), total_steps=1,
                            log=logs.append, device="cpu")


def test_wavernn_train_cli_exits_zero(tmp_path):
    meta, _ = _write_vocoder_corpus(str(tmp_path / "data"))
    override = ("wavernn.rnn_dims=32,wavernn.fc_dims=32,wavernn.compute_dims=16,wavernn.res_blocks=1,"
                "wavernn_train.batch_size=2,wavernn_train.seq_len_hops=2,wavernn_train.test_samples=1,"
                "wavernn_train.checkpoint_every=1,wavernn.mode=MOL")
    log_dir = str(tmp_path / "logs")
    out = subprocess.run(
        [sys.executable, "-m", "tacotronv2_wavernn_chinese_tpu_torch.train.wavernn_train", "--metadata", meta,
         "--data-dir", str(tmp_path / "data"), "--log-dir", log_dir, "--steps", "1", "--no-gen",
         "--override", override, "--device", "cpu"],
        cwd=REPO, env=dict(os.environ, PYTHONPATH=REPO), capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert os.path.exists(os.path.join(log_dir, "checkpoints", "ckpt-1.pt"))
    assert os.path.exists(os.path.join(log_dir, "train.log"))
