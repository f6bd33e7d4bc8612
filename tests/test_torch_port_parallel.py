"""The port's ``parallel/`` (a data-parallel step of each model, fold-sharded
WaveRNN generation, the sharded crossfade, WaveRNN DP x TP) in a gloo world
of two ranks on the CPU, against the JAX package's ``parallel/`` on a
2-device mesh of the suite's virtual CPU devices.

One world runs every check (``torch_dist_worker.run``; a spawn costs a few
seconds): the module fixture writes the inputs, starts the ranks, computes
the JAX side here while they run (each JAX program jitted once) and reads
back what each rank wrote.  Tolerances:

* the Tacotron step with JAX's masks injected (each rank its rows of the
  global masks), lengths uneven across the two ranks, under the three
  loss branches (``loss_frames``, ``mask_decoder``, the plain means): loss
  and aux terms 2e-5 relative, every gradient 5e-4 of its leaf's max|g|,
  BN statistics 1e-5 relative (``tests/torch_train_parity.py``).  The
  plain means' JAX reference is JAX's ``loss_frames`` program with every
  row's ``loss_frames`` at the full length, which takes the same means,
  so the two cases share one compiled program;
* the WaveRNN step: loss 5e-5 relative, gradients 1e-6, BN statistics
  1e-5 (``tests/test_torch_port_wavernn_train.py``'s RAW gates);
* a whole data-parallel step against the one-process step on the global
  batch: the metrics as above, the params within 2e-6 where the gradient
  is not Adam-sensitive (``_assert_params_after_adam``);
* the sharded crossfade 1e-5, greedy sharded generation 1e-5, the device
  crossfade against the host's 1e-4 (the JAX package's own gates);
* TP dp=1 x tp=2 against JAX's unsharded step: the first step's loss 1e-4
  relative and its gathered gradients 1e-6; the losses of two steps 1e-4
  relative to the port's one-process steps (the placement survives the
  update).
"""

import dataclasses
import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_dist_worker as WK
import torch_train_parity as TPar

from tacotronv2_wavernn_chinese_tpu.config import default_config as jax_default_config
from tacotronv2_wavernn_chinese_tpu.models import wavernn as JW
from tacotronv2_wavernn_chinese_tpu.parallel import generate as JG
from tacotronv2_wavernn_chinese_tpu.parallel import mesh as JM
from tacotronv2_wavernn_chinese_tpu.parallel import tp as JTP
from tacotronv2_wavernn_chinese_tpu.train import wavernn_task as JWTask
from tacotronv2_wavernn_chinese_tpu_torch import utils as U
from tacotronv2_wavernn_chinese_tpu_torch.data.loader import write_synthetic_corpus
from tacotronv2_wavernn_chinese_tpu_torch.models import wavernn as TW
from tacotronv2_wavernn_chinese_tpu_torch.ops import tacotron_trainer_kernel as TK
from tacotronv2_wavernn_chinese_tpu_torch.parallel import distributed as D
from tacotronv2_wavernn_chinese_tpu_torch.parallel import generate as G
from tacotronv2_wavernn_chinese_tpu_torch.parallel import mesh as PM
from tacotronv2_wavernn_chinese_tpu_torch.parallel import tp as TP
from tacotronv2_wavernn_chinese_tpu_torch.train import tacotron_task as TTask
from tacotronv2_wavernn_chinese_tpu_torch.train import wavernn_task as WTask
from tacotronv2_wavernn_chinese_tpu_torch.utils import tree_map
from tacotronv2_wavernn_chinese_tpu_torch.utils.checkpoints import CheckpointManager, init_wavernn, wavernn_from_numpy
from tacotronv2_wavernn_chinese_tpu_torch.utils.metrics import read_scalars

B, T_IN, T_OUT = 4, 16, 20
# rank 0 holds the long rows, rank 1 the short ones
LENS, TARGET_LENS, LOSS_FRAMES = [16, 14, 7, 5], [20, 17, 9, 6], [20, 18, 9, 7]


def _taco_batch(with_loss_frames: bool) -> dict:
    rng = np.random.default_rng(0)
    batch = {
        "inputs": rng.integers(1, 191, (B, T_IN)).astype(np.int32),
        "input_lengths": np.asarray(LENS, np.int32),
        "mel_targets": rng.uniform(-4, 4, (B, T_OUT, 80)).astype(np.float32),
        "target_lengths": np.asarray(TARGET_LENS, np.int32),
    }
    batch["stop_targets"] = (np.arange(T_OUT)[None, :] >= batch["target_lengths"][:, None] - 1).astype(np.float32)
    if with_loss_frames:
        batch["loss_frames"] = np.asarray(LOSS_FRAMES, np.int32)
    return batch


def _rand_np(rand) -> dict:
    """A ``TrainRand`` in the worker's npz form."""
    conv = lambda v: [m.numpy() for m in v] if isinstance(v, tuple) else v.numpy()
    return {f: conv(getattr(rand, f)) for f in rand._fields if getattr(rand, f) is not None}


def _jax_wavernn_cfg(widths, **audio):
    cfg = jax_default_config()
    w = dataclasses.replace(cfg.wavernn, upsample_factors=(2, 2, 5), **widths)
    return dataclasses.replace(cfg, wavernn=w, audio=dataclasses.replace(cfg.audio, hop_size=20, **audio))


def _wavernn_params(jcfg, seed):
    """Params of ``jcfg``'s structure as numpy, from the port's init (the
    JAX init's tree and shapes; no JAX program to compile), with BN running
    statistics away from 0 and 1."""
    p = tree_map(lambda t: t.numpy(), init_wavernn(seed, jcfg.wavernn, 80, jcfg.audio.bits))
    rng = np.random.default_rng(seed + 1)
    for bn in [p["resnet"]["bn_in"]] + [b[k] for b in p["resnet"]["blocks"] for k in ("bn1", "bn2")]:
        bn["mean"] = rng.normal(0, 0.1, bn["mean"].shape).astype(np.float32)
        bn["var"] = rng.uniform(0.5, 1.5, bn["var"].shape).astype(np.float32)
    return p


def _wavernn_batch(jcfg, seed, rows=B, hops=3):
    rng = np.random.default_rng(seed)
    T = hops * jcfg.audio.hop_size
    return {"x": rng.uniform(-1, 1, (rows, T)).astype(np.float32),
            "y": rng.integers(0, 2 ** jcfg.audio.bits, (rows, T)).astype(np.int32),
            "mels": rng.uniform(0, 1, (rows, hops + 2 * jcfg.wavernn.pad, 80)).astype(np.float32)}


_jax_wavernn_grad = jax.jit(jax.value_and_grad(JWTask.loss_fn, has_aux=True), static_argnums=(1, 3))


def _tacotron_inputs() -> dict:
    """The worker's Tacotron inputs: params, and each case's batch with
    JAX's masks for it."""
    jcfg0, _ = TPar.cfgs()
    params = TPar.jax_params(jcfg0)
    inputs = {"params": params, "cases": {}}
    for name, train in WK.TACO_CASES.items():
        jcfg, _ = TPar.cfgs(**train)
        batch = _taco_batch(name != "mean")
        rand = TPar.jax_masks(params, jcfg, jax.random.PRNGKey(9), batch)
        inputs["cases"][name] = {"batch": batch, "rand": _rand_np(rand)}
    return inputs


def _tacotron_refs(mesh2, inputs) -> dict:
    """JAX's 2-device mesh step of each case (the plain means on the
    ``loss_frames`` program at full length, module docstring)."""
    jax_grad = TPar.jax_grad_fn()
    params, ref = inputs["params"], {}
    for name, train in WK.TACO_CASES.items():
        jcfg, _ = TPar.cfgs(**train)
        batch = dict(inputs["cases"][name]["batch"])
        if name == "mean":
            batch["loss_frames"] = np.full((B,), T_OUT, np.int32)
        jb = JM.shard_batch(mesh2, {k: jnp.asarray(v) for k, v in batch.items()})
        with mesh2:
            (jloss, (jaux, jnew, _)), jgrads = jax_grad(JM.replicate_tree(mesh2, params), jcfg, jb,
                                                        jax.random.PRNGKey(9), True, 1.0)
        ref[name] = {"jloss": float(jloss), "jaux": jax.device_get(jaux), "jnew": jax.device_get(jnew),
                     "jgrads": jax.device_get(jgrads)}
    return ref


def _wavernn_inputs() -> tuple[dict, dict]:
    """(the DP step's inputs, the TP steps' inputs)."""
    jcfg = _jax_wavernn_cfg(WK.WAVERNN_TRAIN)
    return ({"params": _wavernn_params(jcfg, 0), "batch": _wavernn_batch(jcfg, 1)},
            {"params": _wavernn_params(jcfg, 3), "batches": [_wavernn_batch(jcfg, 10 + i) for i in range(2)]})


def _wavernn_refs(mesh2, dp_in, tp_in) -> tuple[dict, dict]:
    """(JAX's DP-mesh step, JAX's unsharded first TP step with the port's
    one-process losses of both TP steps)."""
    jcfg = _jax_wavernn_cfg(WK.WAVERNN_TRAIN)
    with mesh2:
        (jloss, (jnew, _)), jgrads = _jax_wavernn_grad(
            JM.replicate_tree(mesh2, dp_in["params"]), jcfg,
            JM.shard_batch(mesh2, {k: jnp.asarray(v) for k, v in dp_in["batch"].items()}), True)
    dp_ref = {"loss": float(jloss), "new": jax.device_get(jnew), "grads": jax.device_get(jgrads)}
    (jloss1, _), g1 = _jax_wavernn_grad(tp_in["params"], jcfg,
                                        {k: jnp.asarray(v) for k, v in tp_in["batches"][0].items()}, True)
    cfg, params = WK.wavernn_cfg(), _torch_tree(tp_in["params"])
    state, losses = WTask.TrainState(0, params, WTask.adam_init(params)), []
    for b in tp_in["batches"]:
        tb = _torch_tree(b)
        state, m = WTask.train_step(state, dict(tb, y=tb["y"].long()), cfg)
        losses.append(m["loss"])
    return dp_ref, {"loss": float(jloss1), "grads": jax.device_get(g1), "losses": losses}


def _generation_inputs() -> dict:
    jcfg = _jax_wavernn_cfg(WK.WAVERNN_GEN, bits=WK.GEN_BITS)
    rng = np.random.default_rng(5)
    half = rng.uniform(0.0, 1.0, (8, 7, 80)).astype(np.float32)
    return {"params": _wavernn_params(jcfg, 4),
            "folds": np.concatenate([half, half]),  # both ranks get the same folds: only the seeds differ
            "xfade_y": rng.standard_normal((16, 120 + 2 * 40)).astype(np.float32), "xfade_overlap": np.asarray(40),
            "mel": rng.uniform(0.0, 1.0, (60, 80)).astype(np.float32)}


def _generation_refs(mesh2, inp) -> dict:
    """JAX's greedy sharded generation (jitted) and sharded crossfade."""
    jcfg = _jax_wavernn_cfg(WK.WAVERNN_GEN, bits=WK.GEN_BITS)
    greedy = jax.jit(lambda p, f: JG.generate_folds_sharded(
        p, jcfg.wavernn, mesh2, f, jax.random.PRNGKey(2), bits=WK.GEN_BITS, apply_mu_law=False,
        generate_fn=functools.partial(JW.generate_scan, greedy=True)))(inp["params"], jnp.asarray(inp["folds"]))
    y, overlap = inp["xfade_y"], int(inp["xfade_overlap"])
    xfade = {n: JG.xfade_and_unfold_sharded(jnp.asarray(y), overlap, n, mesh2) for n in (13, 16)}
    return {"greedy": np.asarray(greedy), "xfade": xfade, "params": inp["params"], "y": y, "overlap": overlap}


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    assert WK.TACO_SMALL == TPar.SMALL
    taco_in = _tacotron_inputs()
    dp_in, tp_in = _wavernn_inputs()
    gen_in = _generation_inputs()
    tmp = str(tmp_path_factory.mktemp("world"))
    corpus = os.path.join(tmp, "corpus")
    write_synthetic_corpus(corpus, 9, (5, 20), (20, 50), seed=4)
    run_in = {"corpus": np.asarray(corpus), "log_dir": np.asarray(os.path.join(tmp, "logs"))}
    ctx = WK.start(tmp, {"tacotron": taco_in, "wavernn": dp_in, "tp": tp_in, "gen": gen_in, "run_training": run_in})
    mesh2 = JM.make_mesh(jax.devices()[:2])
    taco_ref = _tacotron_refs(mesh2, taco_in)
    dp_ref, tp_ref = _wavernn_refs(mesh2, dp_in, tp_in)
    gen_ref = _generation_refs(mesh2, gen_in)
    ranks = WK.join(ctx, tmp)
    return {"ranks": ranks, "taco_in": taco_in, "taco": taco_ref, "wavernn_in": dp_in, "wavernn": dp_ref,
            "tp_in": tp_in, "tp": tp_ref, "gen": gen_ref, "gen_in": gen_in, "run": run_in}


def _torch_tree(tree):
    return tree_map(lambda a: torch.as_tensor(np.asarray(a)), tree)


@pytest.mark.parametrize("case", list(WK.TACO_CASES))
def test_tacotron_dp_step_matches_jax_mesh(world, case):
    """Loss, aux terms, every gradient and the BN statistics of the 2-rank
    step (rank 0's; rank 1 holds the same) against JAX's 2-device mesh
    (the plain means against JAX's ``loss_frames`` program at full length,
    module docstring)."""
    got = world["ranks"][0]["tacotron"][case]
    ref = world["taco"][case]
    grads = _torch_tree(got["grads"])
    res = dict(ref, params=world["taco_in"]["params"], loss=float(got["loss"]), aux=_torch_tree(got["aux"]),
               new=_torch_tree(got["new"]),
               grads={jax.tree_util.keystr(p): TPar._at(grads, p).numpy()
                      for p, _ in jax.tree_util.tree_flatten_with_path(ref["jgrads"])[0]})
    TPar.assert_step_matches(res)
    other = world["ranks"][1]["tacotron"][case]
    np.testing.assert_array_equal(other["loss"], got["loss"])
    for a, b in zip(U.tree_leaves(other["new"]), U.tree_leaves(got["new"])):
        np.testing.assert_array_equal(a, b)


def _flat(tree) -> list:
    return [np.asarray(x) for x in U.tree_leaves(tree)]


def _assert_params_after_adam(got, want, g_got, g_want, lr, what):
    """After one Adam step the params agree within 2e-6 except where the
    gradient is Adam-sensitive (below 1e-4, or the two sides' gradients 1 %
    apart: the update is ~lr * g / (|g| + eps), so there rounding moves it
    by up to 2 lr); at most 1 % of the elements may use that allowance."""
    n_loose = n_all = 0
    for p, w, ga, gw in zip(_flat(got), _flat(want), _flat(g_got), _flat(g_want), strict=True):
        d = np.abs(p - w)
        sensitive = (np.abs(gw) < 1e-4) | (np.abs(ga - gw) > 0.01 * np.abs(gw))
        assert (d[~sensitive] <= 2e-6).all(), f"{what}: max|d| {d[~sensitive].max():.3e}"
        assert (d <= 2 * lr + 2e-6).all(), what
        n_loose += int((d > 2e-6).sum())
        n_all += d.size
    assert n_loose <= 0.01 * n_all, f"{what}: {n_loose} of {n_all}"


def test_tacotron_dp_train_step_equals_one_process_step(world):
    """The whole step with masks drawn from the generator on each rank (the
    global batch's, cut to its rows) against ``train_step`` on the global
    batch in one process with the same seed: metrics and updated params."""
    cfg = WK.taco_cfg(**WK.TACO_CASES["loss_frames"])
    params = _torch_tree(world["taco_in"]["params"])
    batch = _torch_tree(world["taco_in"]["cases"]["loss_frames"]["batch"])
    batch["inputs"] = batch["inputs"].long()
    gen = torch.Generator().manual_seed(5)
    _, _, _, g_one = TTask.compute_grads(params, cfg, batch, gen, 0)
    gen.manual_seed(5)
    state, metrics = TTask.train_step(TTask.TrainState(0, params, TTask.adam_init(params)), batch, gen, cfg)
    got = world["ranks"][0]["tacotron"]["step"]
    for k, v in metrics.items():
        np.testing.assert_allclose(float(got["metrics"][k]), v, rtol=2e-5, err_msg=k)
    np.testing.assert_allclose(float(got["metrics"]["grad_norm"]), metrics["grad_norm"], rtol=1e-5)
    _assert_params_after_adam(got["params"], state.params, g_one, g_one, cfg.tacotron_train.initial_lr,
                              "tacotron params")
    for a, b in zip(_flat(world["ranks"][1]["tacotron"]["step"]["params"]), _flat(got["params"])):
        np.testing.assert_array_equal(a, b)  # the ranks stay identical


def test_wavernn_dp_step_matches_jax_mesh(world):
    got, ref = world["ranks"][0]["wavernn"], world["wavernn"]
    np.testing.assert_allclose(float(got["loss"]), ref["loss"], rtol=5e-5)
    for path, a in jax.tree_util.tree_flatten_with_path(ref["grads"])[0]:
        np.testing.assert_allclose(TPar._at(got["grads"], path), a, rtol=0, atol=1e-6,
                                   err_msg=jax.tree_util.keystr(path))
    for path, a in jax.tree_util.tree_flatten_with_path(ref["new"])[0]:
        if jax.tree_util.keystr(path).endswith(("['mean']", "['var']")):
            np.testing.assert_allclose(TPar._at(got["new"], path), a, rtol=1e-5, atol=1e-7,
                                       err_msg=jax.tree_util.keystr(path))


def test_wavernn_dp_train_step_equals_one_process_step(world):
    cfg = WK.wavernn_cfg()
    params = _torch_tree(world["wavernn_in"]["params"])
    batch = _torch_tree(world["wavernn_in"]["batch"])
    batch["y"] = batch["y"].long()
    _, _, g_one = WTask.compute_grads(params, cfg, batch)
    state, metrics = WTask.train_step(WTask.TrainState(0, params, WTask.adam_init(params)), batch, cfg)
    got = world["ranks"][0]["wavernn"]
    np.testing.assert_allclose(float(got["step"]["loss"]), metrics["loss"], rtol=5e-5)
    np.testing.assert_allclose(float(got["step"]["grad_norm"]), metrics["grad_norm"], rtol=5e-5)
    _assert_params_after_adam(got["step"]["params"], state.params, got["grads"], g_one, cfg.wavernn_train.lr,
                              "wavernn params")
    for a, b in zip(_flat(world["ranks"][1]["wavernn"]["step"]["params"]), _flat(got["step"]["params"])):
        np.testing.assert_array_equal(a, b)


def test_tp_step_matches_jax_unsharded(world):
    """dp=1 x tp=2 against JAX's unsharded step: the first step's loss and
    its gradients (the column blocks gathered); both steps' losses against
    the port's one-process steps."""
    got, ref = world["ranks"][0]["tp"], world["tp"]
    np.testing.assert_allclose(float(got["loss"]), ref["loss"], rtol=1e-4)
    np.testing.assert_allclose(got["losses"], ref["losses"], rtol=1e-4)
    for path, a in jax.tree_util.tree_flatten_with_path(ref["grads"])[0]:
        np.testing.assert_allclose(TPar._at(got["grads"], path), a, rtol=0, atol=1e-6,
                                   err_msg=jax.tree_util.keystr(path))
    for a, b in zip(_flat(world["ranks"][1]["tp"]["params"]), _flat(got["params"])):
        np.testing.assert_array_equal(a, b)


def test_tp_placement_survives_the_update(world):
    s = {k: tuple(int(x) for x in v) for k, v in world["ranks"][0]["tp"]["shapes"].items()}
    rnn, fc, n_cls = WK.WAVERNN_TRAIN["rnn_dims"], WK.WAVERNN_TRAIN["fc_dims"], 2 ** 10
    assert s["placed_fc3_w"] == s["fc3_w"] == s["mu_fc3_w"] == (fc, n_cls // 2)
    assert s["placed_gru1_wi"] == s["gru1_wi"] == (rnn, 3 * rnn // 2)
    assert s["nu_gru2_wh"] == (rnn, 3 * rnn // 2)
    assert s["fc3_b"] == (n_cls,)  # biases stay whole


def test_tp_divisibility_and_its_error(world):
    cfg = WK.wavernn_cfg()
    assert TP.tp_divisible(cfg, 2) and TP.tp_divisible(cfg, 4)
    odd = WK.wavernn_cfg(dict(WK.WAVERNN_TRAIN, rnn_dims=30))
    assert not TP.tp_divisible(odd, 4)
    assert TP.tp_divisible(odd, 2) == JTP.tp_divisible(_jax_wavernn_cfg(dict(WK.WAVERNN_TRAIN, rnn_dims=30)), 2)
    err = str(world["ranks"][0]["tp"]["odd_error"])
    assert "does not divide" in err and "I/w" in err


def test_tp_state_shardings_describe_the_blocks():
    """Params and Adam's moments of the TP modules shard their last axis
    over ``model``; biases, the conditioning network and the counters
    replicate; the placed blocks are the whole leaves' column blocks."""
    cfg = WK.wavernn_cfg()
    mesh = PM.Mesh(("data", "model"), {"data": 1, "model": 2}, {"data": 0, "model": 1},
                   {"data": None, "model": None})
    state = WTask.init_state(0, cfg, "cpu")
    specs = TP.wavernn_state_shardings(mesh, state)
    assert specs.params["fc3"]["w"] == specs.opt_state["mu"]["gru1"]["wi"] == (None, "model")
    assert specs.params["fc3"]["b"] == specs.params["resnet"]["conv_in"]["w"] == specs.opt_state["count"] == ()
    placed = TP.place_wavernn_state(mesh, state)
    torch.testing.assert_close(placed.params["gru2"]["wh"], state.params["gru2"]["wh"][:, 48:], rtol=0, atol=0)
    assert placed.opt_state["nu"]["I"]["w"].shape == (1 + 80 + cfg.wavernn.res_out_dims // 4, 16)
    assert placed.params["I"]["b"] is state.params["I"]["b"]


@pytest.mark.parametrize("n_folds", [13, 16], ids=["13_of_16_real", "none_padded"])
def test_xfade_sharded_matches_jax(world, n_folds):
    g = world["gen"]
    for r in range(2):
        got = world["ranks"][r]["gen"][f"xfade_{n_folds}"]
        np.testing.assert_allclose(got, np.asarray(g["xfade"][n_folds]), rtol=0, atol=1e-5)
    ref = TW.xfade_and_unfold(g["y"][:n_folds], g["overlap"])
    np.testing.assert_allclose(got[: ref.shape[0]], ref, atol=1e-5)
    np.testing.assert_array_equal(got[ref.shape[0]:], 0.0)


def test_greedy_sharded_generation_matches_jax(world):
    got = world["ranks"][0]["gen"]["greedy"]
    assert got.shape == world["gen"]["greedy"].shape == (16, 3 * 20)
    np.testing.assert_allclose(got, world["gen"]["greedy"], rtol=0, atol=1e-5)
    np.testing.assert_array_equal(got[:8], got[8:])  # the same folds on both ranks, no noise


def test_sampled_sharded_generation_uses_the_rank_folded_seed(world):
    """Rank r's folds equal the one-process generation of those folds at
    ``fold_seed(7, r)``; the two ranks' identical folds draw different noise."""
    got = world["ranks"][0]["gen"]["sampled"]
    np.testing.assert_array_equal(world["ranks"][1]["gen"]["sampled"], got)
    cfg = WK.wavernn_cfg(WK.WAVERNN_GEN, bits=WK.GEN_BITS)
    params = wavernn_from_numpy(world["gen"]["params"], cfg.wavernn, bits=WK.GEN_BITS)
    folds = world["gen_in"]["folds"]
    for r in range(2):
        one = TW.generate_kernel(params, cfg.wavernn, folds[8 * r: 8 * (r + 1)], seed=G.fold_seed(7, r),
                                 bits=WK.GEN_BITS, apply_mu_law=False)
        np.testing.assert_array_equal(got[8 * r: 8 * (r + 1)], one.numpy())
    assert not np.array_equal(got[:8], got[8:])
    assert G.fold_seed(7, 0) != G.fold_seed(7, 1) != 7


def test_generate_distributed_device_crossfade_matches_host(world):
    a, b = (world["ranks"][0]["gen"][f"dist_{k}"] for k in ("device", "host"))
    assert a.shape == b.shape == (60 * 20,)
    np.testing.assert_allclose(a, b, rtol=0, atol=1e-4)
    np.testing.assert_array_equal(world["ranks"][1]["gen"]["dist_device"], a)
    assert np.isfinite(a).all() and np.abs(a).max() > 0


def test_pad_folds_to_multiple_matches_jax():
    folds = np.random.default_rng(0).random((5, 4, 3)).astype(np.float32)
    got, n = G.pad_folds_to_multiple(folds, 8)
    want, jn = JG.pad_folds_to_multiple(folds, 8)
    assert n == jn == 5 and got.shape == (8, 4, 3)
    np.testing.assert_array_equal(got, want)


def test_run_training_writes_on_rank_0_only_and_resumes(world):
    """Two data-parallel steps with a checkpoint each, then a resume to step
    3: one checkpoint per step and one scalars row per step (written once,
    by rank 0), rank 0's log only, identical final params on both ranks."""
    r0, r1 = (world["ranks"][r]["run_training"] for r in range(2))
    assert r0["steps"].tolist() == r1["steps"].tolist() == [2, 3]
    logs = str(r0["logs"])
    assert "restored checkpoint at step 2" in logs and str(r1["logs"]) == ""
    log_dir = str(world["run"]["log_dir"])
    assert CheckpointManager(os.path.join(log_dir, "taco_pretrained")).all_steps() == [1, 2, 3]
    rows = read_scalars(os.path.join(log_dir, "scalars.jsonl"))
    assert [r["step"] for r in rows] == [1, 2, 3] and all(np.isfinite(r["loss"]) for r in rows)
    for a, b in zip(_flat(r0["params"]), _flat(r1["params"])):
        np.testing.assert_array_equal(a, b)


def test_uneven_batch_raises(world):
    assert "does not divide over 2 ranks" in str(world["ranks"][0]["uneven_error"])
    mesh = PM.Mesh(("data",), {"data": 2}, {"data": 1}, {"data": None})
    with pytest.raises(ValueError, match="does not divide"):
        PM.shard_batch(mesh, {"x": np.zeros((5, 3))})
    got = PM.shard_batch(mesh, {"x": np.arange(8).reshape(4, 2), "n": 3})
    np.testing.assert_array_equal(got["x"], [[4, 5], [6, 7]])
    assert got["n"] == 3
    stacked = PM.shard_stacked_batch(mesh, {"x": torch.arange(12).reshape(2, 6)})
    assert stacked["x"].tolist() == [[3, 4, 5], [9, 10, 11]]


def test_one_process_runtime():
    """Without a process group every helper answers as rank 0 of 1, a
    one-process mesh leaves the step alone, and joining a CUDA world
    without a card raises instead of running on the CPU."""
    assert D.host_shard() == (0, 1) and D.is_primary()
    D.initialize(num_processes=1)
    D.initialize()  # no launcher in the environment: one process
    assert not D.initialized()
    mesh = PM.make_mesh()
    assert mesh.size == 1 and mesh.groups["data"] is None
    assert PM.mesh_or_refuse(True) is PM.mesh_or_refuse(False) is None
    with PM.data_parallel(mesh):
        assert not PM.batch_sharded() and PM.batch_shards() == 1 and PM.batch_index() == 0
        x = torch.ones(3)
        assert PM.batch_sum(x) is x and PM.batch_sum_grad(x) is x
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            D.initialize("127.0.0.1:1", 2, 0)


def test_cuda_world_without_nccl_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(torch.cuda, "set_device", lambda i: None)
    monkeypatch.setattr(torch.distributed, "is_nccl_available", lambda: False)
    with pytest.raises(RuntimeError, match="NCCL"):
        D.initialize("127.0.0.1:1", 2, 0)
    assert not D.initialized()


def test_indexless_cuda_device_is_the_current_card(monkeypatch):
    """"cuda" without an index means the current card (a rank's
    LOCAL_RANK), in ``resolve_device`` and in the kernels' per-card cluster
    cache, not card 0."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 3)
    assert U.resolve_device(None) == U.resolve_device("cuda") == torch.device("cuda", 3)
    assert U.resolve_device("cuda:1") == torch.device("cuda", 1)
    assert U.device_index("cuda") == 3 and U.device_index("cuda:1") == 1
    entered = []

    class _Card:
        def __init__(self, i):
            entered.append(i)

        def __enter__(self):
            return self

        def __exit__(self, *a):
            return False

    class _Lib:
        tacotron_train_fwd_clusters = tacotron_train_bwd_clusters = staticmethod(lambda: 15)

    monkeypatch.setattr(torch.cuda, "device", _Card)
    monkeypatch.setattr(TK, "load", lambda source: _Lib)
    monkeypatch.setattr(TK, "_CLUSTERS", {})
    assert TK.card_clusters(torch.device("cuda")) == 15
    assert entered == [3] and list(TK._CLUSTERS) == [3]


def test_run_training_refuses_use_mesh_false_under_two_ranks(world):
    """``use_mesh=False`` asks for the JAX loop's one-device step; under two
    ranks each would train the whole batch alone into one log directory,
    so both ranks refuse before reading or writing anything."""
    for r in range(2):
        got = world["ranks"][r]["run_training"]
        assert "use_mesh=False under a process group of 2 ranks" in str(got["no_mesh_error"])
        assert not bool(got["no_mesh_dir"])


def test_world_of_one_runs_the_data_parallel_step(tmp_path, monkeypatch):
    """A world of one keeps its process group, so each model's
    ``compute_grads`` on its mesh takes the data-parallel branch (the global
    mask draw cut to one shard, the summed denominators, the BatchNorm sums,
    the flat gradient all-reduce), every collective over that one rank, and
    agrees with the one-process step at the trainer tolerances."""
    calls = []
    all_reduce = torch.distributed.all_reduce

    def counted(t, *args, **kwargs):
        calls.append(t.numel())
        return all_reduce(t, *args, **kwargs)

    monkeypatch.setattr(torch.distributed, "all_reduce", counted)
    torch.distributed.init_process_group("gloo", store=torch.distributed.FileStore(str(tmp_path / "store"), 1),
                                         rank=0, world_size=1)
    try:
        mesh = PM.make_mesh()
        assert mesh.size == 1 and mesh.groups["data"] is not None
        cfg = WK.taco_cfg(**WK.TACO_CASES["mask_decoder"])
        jcfg0, _ = TPar.cfgs()
        params = _torch_tree(TPar.jax_params(jcfg0))
        batch = WK._taco_batch(_taco_batch(True))
        out = {}
        for name, m in (("plain", None), ("dp", mesh)):
            calls.clear()
            gen = torch.Generator().manual_seed(3)
            out[name] = TTask.compute_grads(params, cfg, batch, gen, 0, mesh=m), len(calls)
        (loss, aux, new, grads), n_dp = out["dp"]
        (loss1, aux1, new1, grads1), n_plain = out["plain"]
        # BN sums and their cotangents (encoder convs, postnet), the loss's
        # counts, the aux terms, the flat gradients
        assert n_plain == 0 and n_dp >= 4 * 2 + 3
        np.testing.assert_allclose(float(loss), float(loss1), rtol=TPar.LOSS_RTOL)
        for k in aux1:
            np.testing.assert_allclose(float(aux[k].detach()), float(aux1[k].detach()), rtol=TPar.LOSS_RTOL, atol=1e-7,
                                       err_msg=k)
        for a, b in zip(U.tree_leaves(grads), U.tree_leaves(grads1), strict=True):
            np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0,
                                       atol=TPar.GRAD_ATOL * max(float(b.abs().max()), 1e-6) + 1e-7)
        for a, b in zip(U.tree_leaves(new), U.tree_leaves(new1), strict=True):
            np.testing.assert_allclose(a.detach().numpy(), b.detach().numpy(), rtol=TPar.STAT_RTOL, atol=1e-6)
        wcfg = WK.wavernn_cfg()
        jw = _jax_wavernn_cfg(WK.WAVERNN_TRAIN)
        wp = _torch_tree(_wavernn_params(jw, 0))
        wb = _torch_tree(_wavernn_batch(jw, 1))
        wb["y"] = wb["y"].long()
        calls.clear()
        wl, wnew, wg = WTask.compute_grads(wp, wcfg, wb, mesh)
        assert len(calls) >= 2 * (1 + 2 * WK.WAVERNN_TRAIN["res_blocks"]) + 2
        wl1, wnew1, wg1 = WTask.compute_grads(wp, wcfg, wb)
        np.testing.assert_allclose(float(wl), float(wl1), rtol=5e-5)
        for a, b in zip(U.tree_leaves(wg), U.tree_leaves(wg1), strict=True):
            np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0, atol=1e-6)
    finally:
        torch.distributed.destroy_process_group()
