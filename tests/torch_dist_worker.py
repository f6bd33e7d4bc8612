"""The ranks of tests/test_torch_port_parallel.py: a gloo world on the CPU,
started by ``torch.multiprocessing.spawn``.  This module imports only
numpy, torch and the port (a spawned child must not load JAX); the test
process computes the JAX side and compares.

``run`` joins the world through a ``file://`` rendezvous, reads the inputs
the test wrote (a flat ``.npz``, ``utils.checkpoints.save_params_npz``'s
format), runs every check's ranks' side in this one world and writes
``rank<r>.npz`` with what the test compares.
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch

from tacotronv2_wavernn_chinese_tpu_torch.config import default_config
from tacotronv2_wavernn_chinese_tpu_torch.models import tacotron as TT
from tacotronv2_wavernn_chinese_tpu_torch.parallel import distributed as D
from tacotronv2_wavernn_chinese_tpu_torch.parallel import generate as G
from tacotronv2_wavernn_chinese_tpu_torch.parallel import mesh as PM
from tacotronv2_wavernn_chinese_tpu_torch.parallel import tp as TP
from tacotronv2_wavernn_chinese_tpu_torch.train import tacotron_task as TTask
from tacotronv2_wavernn_chinese_tpu_torch.train import tacotron_train as TTrain
from tacotronv2_wavernn_chinese_tpu_torch.train import wavernn_task as WTask
from tacotronv2_wavernn_chinese_tpu_torch.utils import tree_map
from tacotronv2_wavernn_chinese_tpu_torch.utils.checkpoints import load_params_npz, save_params_npz

WORLD = 2
# tests/torch_train_parity.py's Tacotron widths
TACO_SMALL = dict(
    embedding_dim=32, enc_conv_channels=32, enc_conv_layers=2, encoder_lstm_units=32, attention_dim=16,
    attention_filters=8, attention_kernel=7, prenet_layers=(32, 32), decoder_lstm_units=32,
    postnet_channels=32, postnet_layers=2,
)
# the Tacotron data-parallel cases: the loss branch each takes
TACO_CASES = {
    "loss_frames": dict(mask_decoder=False),
    "mask_decoder": dict(mask_decoder=True),
    "mean": dict(mask_decoder=False),  # its batch has no loss_frames
}
WAVERNN_TRAIN = dict(rnn_dims=32, fc_dims=32, compute_dims=16, res_out_dims=16, res_blocks=2)
WAVERNN_GEN = dict(rnn_dims=64, fc_dims=64, compute_dims=32, res_out_dims=128, res_blocks=2)  # K1's 80 mels, aux 32
GEN_BITS = 8
RUN_OVERRIDE = "tacotron_train.batch_size=4,tacotron_train.batches_per_group=2,tacotron_train.checkpoint_interval=1"


def taco_cfg(dropout=0.5, zoneout=0.1, **train):
    cfg = default_config()
    tac = dataclasses.replace(cfg.tacotron, dropout_rate=dropout, zoneout_rate=zoneout, **TACO_SMALL)
    return dataclasses.replace(cfg, tacotron=tac, tacotron_train=dataclasses.replace(cfg.tacotron_train, **train))


def wavernn_cfg(widths=WAVERNN_TRAIN, **audio):
    cfg = default_config()
    w = dataclasses.replace(cfg.wavernn, upsample_factors=(2, 2, 5), **widths)
    return dataclasses.replace(cfg, wavernn=w, audio=dataclasses.replace(cfg.audio, hop_size=20, **audio))


def run_cfg():
    """The data-parallel ``run_training`` check's config (global batch 4)."""
    cfg = default_config().override(RUN_OVERRIDE)
    tac = dataclasses.replace(cfg.tacotron, **dict(TACO_SMALL, encoder_lstm_units=16))
    return dataclasses.replace(cfg, tacotron=tac)


def _t(tree):
    return tree_map(lambda a: torch.as_tensor(np.asarray(a)), tree)


def _rand(tree) -> TT.TrainRand:
    """A ``TrainRand`` from its npz form (tuples came back as lists, None
    fields are absent)."""
    conv = lambda v: tuple(torch.as_tensor(m) for m in v) if isinstance(v, list) else torch.as_tensor(v)
    return TT.TrainRand(**{f: conv(tree[f]) if f in tree else None for f in TT.TrainRand._fields})


def _taco_batch(b):
    out = _t(b)
    for k in ("inputs", "input_lengths", "target_lengths", "loss_frames"):
        if k in out:
            out[k] = out[k].long() if k == "inputs" else out[k].int()
    return out


def tacotron_checks(mesh, inp) -> dict:
    """Each case's data-parallel loss, aux terms, gradients and new BN
    statistics with the test's (JAX's) global masks; then one whole
    data-parallel ``train_step`` with masks drawn from the generator."""
    out = {}
    params = _t(inp["params"])
    for name, train in TACO_CASES.items():
        case = inp["cases"][name]
        cfg = taco_cfg(**train)
        batch = PM.shard_batch(mesh, _taco_batch(case["batch"]))
        loss, aux, new, grads = TTask.compute_grads(params, cfg, batch, None, 0, rand=_rand(case["rand"]), mesh=mesh)
        out[name] = {"loss": loss, "aux": {k: v.reshape(()) for k, v in aux.items()}, "grads": grads,
                     "new": new}
    cfg = taco_cfg(**TACO_CASES["loss_frames"])
    gen = torch.Generator().manual_seed(5)
    state = TTask.TrainState(0, params, TTask.adam_init(params))
    batch = PM.shard_batch(mesh, _taco_batch(inp["cases"]["loss_frames"]["batch"]))
    state, metrics = TTask.train_step(state, batch, gen, cfg, mesh)
    out["step"] = {"params": state.params, "metrics": {k: np.float64(v) for k, v in metrics.items()}}
    return out


def wavernn_checks(mesh, inp) -> dict:
    """The data-parallel loss and gradients, then one whole step."""
    cfg = wavernn_cfg()
    params = _t(inp["params"])
    batch = PM.shard_batch(mesh, {k: v.long() if k == "y" else v for k, v in _t(inp["batch"]).items()})
    loss, new, grads = WTask.compute_grads(params, cfg, batch, mesh)
    state = WTask.TrainState(0, params, WTask.adam_init(params))
    state, metrics = WTask.train_step(state, batch, cfg, mesh)
    return {"loss": loss, "grads": grads, "new": new, "step": {"params": state.params, "loss": np.float64(
        metrics["loss"]), "grad_norm": np.float64(metrics["grad_norm"])}}


def tp_checks(inp) -> dict:
    """dp=1 x tp=2: the whole loss and gradients of the first step, the
    loss of two steps, and the placement after them."""
    mesh = TP.make_mesh_2d(dp=1, tp=WORLD)
    cfg = wavernn_cfg()
    params = _t(inp["params"])
    state = TP.place_wavernn_state(mesh, WTask.TrainState(0, params, WTask.adam_init(params)))
    placed = {"fc3": tuple(state.params["fc3"]["w"].shape), "gru1": tuple(state.params["gru1"]["wi"].shape)}
    batches = [{k: v.long() if k == "y" else v for k, v in _t(b).items()} for b in inp["batches"]]
    loss, _, grads = WTask.compute_grads(state.params, cfg, batches[0], mesh)
    losses = []
    for b in batches:
        state, m = WTask.train_step(state, b, cfg, mesh)
        losses.append(m["loss"])
    shapes = {"fc3_w": state.params["fc3"]["w"].shape, "gru1_wi": state.params["gru1"]["wi"].shape,
              "mu_fc3_w": state.opt_state["mu"]["fc3"]["w"].shape, "nu_gru2_wh": state.opt_state["nu"]["gru2"]["wh"].shape,
              "fc3_b": state.params["fc3"]["b"].shape, "placed_fc3_w": placed["fc3"], "placed_gru1_wi": placed["gru1"]}
    odd = wavernn_cfg(dict(WAVERNN_TRAIN, rnn_dims=31))
    try:
        TP.place_wavernn_state(mesh, WTask.init_state(0, odd, "cpu"))
        err = ""
    except ValueError as e:
        err = str(e)
    return {"loss": loss, "grads": TP.gather_params(mesh, grads), "losses": np.asarray(losses),
            "params": TP.gather_params(mesh, state.params), "shapes": {k: np.asarray(v) for k, v in shapes.items()},
            "odd_error": np.asarray(err)}


def generation_checks(mesh, inp) -> dict:
    """Greedy and sampled fold-sharded generation, the sharded crossfade
    with and without pads, and ``generate_distributed`` with the crossfade
    on the ranks and on the host."""
    cfg = wavernn_cfg(WAVERNN_GEN, bits=GEN_BITS)
    params = _t(inp["params"])
    folds = torch.as_tensor(inp["folds"])
    run = lambda **kw: PM.gather_rows(
        G.generate_folds_sharded(params, cfg.wavernn, mesh, folds, bits=GEN_BITS, **kw), mesh, "data")
    out = {"greedy": run(greedy=True, apply_mu_law=False), "sampled": run(seed=7, apply_mu_law=False)}
    y = torch.as_tensor(inp["xfade_y"])
    local = PM.shard_rows(y, WORLD, mesh.coords["data"])
    overlap = int(inp["xfade_overlap"])
    for n_folds in (13, y.shape[0]):
        out[f"xfade_{n_folds}"] = G.xfade_and_unfold_sharded(local, overlap, n_folds, mesh)
    gen_cfg = dataclasses.replace(cfg.wavernn_gen, target=100, overlap=20)
    for dev_xfade in (True, False):
        out[f"dist_{'device' if dev_xfade else 'host'}"] = G.generate_distributed(
            params, cfg.wavernn, gen_cfg, mesh, inp["mel"], seed=1, bits=GEN_BITS, device_crossfade=dev_xfade)
    return out


def run_training_check(inp, rank) -> dict:
    """Two data-parallel Tacotron steps with a checkpoint each, then a
    resume to step 3; this rank's log lines and final params; and the
    refusal of ``use_mesh=False`` under two ranks, before anything is read
    or written."""
    cfg = run_cfg()
    logs = []
    log_dir, corpus = str(inp["log_dir"]), str(inp["corpus"])
    meta = os.path.join(corpus, "train.txt")
    try:
        TTrain.run_training(cfg, meta, corpus, log_dir + "_no_mesh", total_steps=1, device="cpu", use_mesh=False)
        refused = ""
    except ValueError as e:
        refused = str(e)
    s1 = TTrain.run_training(cfg, meta, corpus, log_dir, total_steps=2, device="cpu", render_eval=False,
                             log=logs.append)
    s2 = TTrain.run_training(cfg, meta, corpus, log_dir, total_steps=3, device="cpu", render_eval=False,
                             log=logs.append)
    return {"steps": np.asarray([s1.step, s2.step]), "logs": np.asarray("\n".join(logs)), "params": s2.params,
            "no_mesh_error": np.asarray(refused), "no_mesh_dir": np.asarray(os.path.exists(log_dir + "_no_mesh"))}


def run(rank: int, world: int, init_file: str, in_path: str, out_dir: str) -> None:
    D.initialize(f"file://{init_file}", world, rank, backend="gloo", device="cpu")
    torch.set_num_threads(1)
    inp = load_params_npz(in_path)
    mesh = PM.make_mesh()
    out = {"tacotron": tacotron_checks(mesh, inp["tacotron"]), "wavernn": wavernn_checks(mesh, inp["wavernn"]),
           "tp": tp_checks(inp["tp"]), "gen": generation_checks(mesh, inp["gen"]),
           "run_training": run_training_check(inp["run_training"], rank)}
    try:
        PM.shard_batch(mesh, {"x": torch.zeros(3, 2)})
        out["uneven_error"] = np.asarray("")
    except ValueError as e:
        out["uneven_error"] = np.asarray(str(e))
    save_params_npz(os.path.join(out_dir, f"rank{rank}.npz"), out)
    D.shutdown()


def start(tmp_dir: str, inputs: dict):
    """Write ``inputs`` and start a world of ``WORLD`` ranks over them;
    the caller goes on while they run and collects them with ``join``."""
    in_path = os.path.join(tmp_dir, "in.npz")
    save_params_npz(in_path, inputs)
    return torch.multiprocessing.start_processes(
        run, args=(WORLD, os.path.join(tmp_dir, "rendezvous"), in_path, tmp_dir), nprocs=WORLD, join=False,
        start_method="spawn")


def join(ctx, tmp_dir: str) -> list:
    """Wait for the world ``start`` began (a rank's exception is raised
    here) -> each rank's results (nested numpy trees)."""
    while not ctx.join():
        pass
    return [load_params_npz(os.path.join(tmp_dir, f"rank{r}.npz")) for r in range(WORLD)]

