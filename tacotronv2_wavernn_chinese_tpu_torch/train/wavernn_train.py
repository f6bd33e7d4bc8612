"""WaveRNN training loop + CLI.

Keeps the JAX training loop's operational behaviour (reference
wavernn_train.py:20-153): restore-or-init from the latest checkpoint under
``<log_dir>/checkpoints``, the NaN-gradient warning and the NaN-loss error,
the step log, ``scalars.jsonl``, a checkpoint every ``checkpoint_every``
steps with a held-out listening test (a few full generations to wav under
``<log_dir>/model_outputs``; on the card a RAW vocoder generates through
the sample-loop kernel), the empty-epoch error and the final save.

``wavernn_train.precompile`` is honoured as one warm step on a deep copy of
the state before the first real step (the JAX loop's ``_prewarm_shapes``
compiles the step program there; eagerly, the warm step moves the first
call's CUDA and cuDNN set-up out of the timed loop).  Every step runs in
full f32 (``utils.precision.fp32_precision``).

Data parallel (``use_mesh``, the default, as in the JAX loop): under a
launcher each rank runs on its own card (``cuda:LOCAL_RANK``), draws the
same global batch of ``batch_size`` windows (the same loader seed), keeps
its rows and takes the data-parallel step of ``wavernn_task.train_step``;
only rank 0 writes checkpoints, ``scalars.jsonl``, logs and listening
tests, and every rank waits at a barrier before reading a checkpoint.
One process (no launcher) trains as before, on the card unless
``--device cpu`` is asked for.

Usage:
    python -m tacotronv2_wavernn_chinese_tpu_torch.train.wavernn_train \\
        --metadata <gta_dir>/wavernn_training_data.txt --data-dir <gta_dir> \\
        --log-dir logs-wavernn [--steps N] [--override a.b=c,...] [--no-gen] \\
        [--native-loader] [--device cpu]
    torchrun --nproc-per-node N -m tacotronv2_wavernn_chinese_tpu_torch.train.wavernn_train ...
"""

from __future__ import annotations

import argparse
import copy
import os
import time

import numpy as np
import torch

from ..config import Config, default_config
from ..data.loader import VocoderBatch, VocoderDataset, read_metadata
from ..dsp.wav import save_wav
from ..models import wavernn as W
from ..parallel import distributed as D
from ..parallel import mesh as PM
from ..utils import logging as infolog
from ..utils import resolve_device
from ..utils.checkpoints import CheckpointManager
from ..utils.metrics import MetricsWriter
from . import wavernn_task as task
from .grouping import fused_groups


def run_training(
    cfg: Config,
    metadata_path: str,
    data_dir: str,
    log_dir: str,
    total_steps: int | None = None,
    gen_at_checkpoint: bool = True,
    use_native_loader: bool = False,
    log=infolog.log,
    device=None,
    use_mesh: bool = True,
) -> task.TrainState:
    """Train to ``total_steps`` (default ``wavernn_train.total_steps``) on
    the GTA metadata ``metadata_path`` (rows ``wav|gt_mel|pred_mel|text``
    under ``data_dir``).  ``device`` None means the CUDA card (raises
    without one).  ``use_native_loader`` takes the C++ loader when it
    builds, else logs and uses the Python loader.  Under a process group
    of several ranks each rank trains on its rows of every global batch
    (module docstring); ``use_mesh=False``, the JAX loop's one-device
    step, is refused there (``parallel.mesh.mesh_or_refuse``)."""
    mesh = PM.mesh_or_refuse(use_mesh)
    dev = resolve_device(device)
    primary = D.is_primary()
    log = D.primary_log(log)
    if mesh is not None:
        D.build_kernels(dev)
    wc = cfg.wavernn_train
    total_steps = total_steps or wc.total_steps
    ckpt_dir = os.path.join(log_dir, "checkpoints")
    out_dir = os.path.join(log_dir, "model_outputs")
    os.makedirs(out_dir, exist_ok=True)

    dataset = VocoderDataset(read_metadata(metadata_path), data_dir, cfg)
    log(f"vocoder dataset: {len(dataset.train_indices)} train / "
        f"{len(dataset.test_indices)} test utterances")

    mgr = CheckpointManager(ckpt_dir, max_to_keep=wc.max_checkpoints_to_keep)
    D.barrier()  # rank 0 has finished any save before a rank reads
    restored = mgr.restore(dev)
    if restored is not None:
        state = task.TrainState(restored["step"], restored["params"], restored["opt_state"])
        log(f"restored checkpoint at step {state.step}")
    else:
        state = task.init_state(wc.seed, cfg, dev)
    if mesh is not None:
        params, mu, nu = PM.replicate_tree(mesh, (state.params, state.opt_state["mu"], state.opt_state["nu"]))
        state = task.TrainState(state.step, params, dict(state.opt_state, mu=mu, nu=nu))

    native = None
    if use_native_loader:
        from ..data.native_loader import NativeVocoderLoader

        if NativeVocoderLoader.available():
            native = NativeVocoderLoader(dataset.rows, data_dir, cfg, seed=wc.seed,
                                         indices=dataset.train_indices)
            log(f"native C++ loader active ({native.num_utts} utterances)")
        else:
            log("native loader requested but unavailable; using Python loader")

    def batch_stream(epoch):
        if native is not None:
            return iter(native)
        return dataset.batches(epoch_seed=wc.seed + epoch)

    metrics_writer = MetricsWriter(log_dir) if primary else None
    time_win, loss_win = infolog.ValueWindow(100), infolog.ValueWindow(100)
    step = state.step
    epoch = 0
    spd = max(1, int(wc.steps_per_dispatch))

    def dispatch(group):
        """Run len(group) steps back to back, then apply the per-step
        guards and logging to every sub-step."""
        nonlocal state, step
        t0 = time.time()
        k = len(group)
        arrays = [task.batch_to_device(b, dev) for b in group]
        if mesh is not None:
            arrays = [PM.shard_batch(mesh, a) for a in arrays]
        state, mhost = task.train_step_many(state, arrays, cfg, mesh)
        dt = (time.time() - t0) / k
        ckpt_due = False
        for i in range(k):
            sub = step + i + 1
            loss = float(mhost["loss"][i])
            gnorm = float(mhost["grad_norm"][i])
            time_win.append(dt)
            loss_win.append(loss)
            if np.isnan(gnorm):
                log(f"WARNING: NaN grad norm at step {sub}")  # wavernn_train.py:126-128
            if np.isnan(loss):
                raise RuntimeError(f"loss is NaN at step {sub}")
            if sub % 10 == 0 or sub < 10:
                log(f"Step {sub:7d} [{time_win.average:.3f} sec/step, "
                    f"loss={loss:.5f}, avg={loss_win.average:.5f}]")
            if metrics_writer is not None and (sub % wc.summary_interval == 0 or sub < 5):
                metrics_writer.write(sub, {"loss": loss, "grad_norm": gnorm})
            if sub % wc.checkpoint_every == 0:
                ckpt_due = True
        step = state.step
        if ckpt_due and primary:
            mgr.save(step, state.params, state.opt_state)
            log(f"saved checkpoint at step {step}")
            if gen_at_checkpoint:
                _gen_testset(cfg, state.params, dataset, out_dir, step, log)

    try:
        if wc.precompile and step < total_steps:
            _warm_step(cfg, state, dev, log, 1 if mesh is None else mesh.size)
        while step < total_steps:
            step_at_epoch_start = step
            for group in fused_groups(batch_stream(epoch), spd, lambda: step, total_steps):
                dispatch(group)
            if step == step_at_epoch_start:
                # zero batches this epoch (train split smaller than batch size):
                # fail loudly instead of spinning epochs forever
                raise ValueError(
                    f"vocoder epoch produced no batches: {len(dataset.train_indices)}"
                    f" train utterances < batch_size {wc.batch_size}"
                    " (lower wavernn_train.batch_size or wavernn_train.test_samples)"
                )
            epoch += 1
        if primary:
            mgr.save(step, state.params, state.opt_state)
    finally:
        if metrics_writer is not None:
            metrics_writer.close()
        if native is not None:
            native.close()
    D.barrier()
    return state


def _warm_step(cfg: Config, state: task.TrainState, dev, log, shards: int = 1) -> None:
    """One train step on a deep copy of the state and a zero batch of the
    training shape (vocoder windows are fixed-size; a rank's rows of it
    under ``shards`` ranks, stepped alone), so the first real step's time
    holds no one-off set-up; the real state is untouched."""
    wc = cfg.wavernn_train
    seq_len = wc.seq_len_hops * cfg.audio.hop_size
    frames = wc.seq_len_hops + 2 * cfg.wavernn.pad
    rows = wc.batch_size // shards
    zeros = VocoderBatch(np.zeros((rows, seq_len), np.float32), np.zeros((rows, seq_len), np.int32),
                         np.zeros((rows, frames, cfg.audio.num_mels), np.float32))
    t0 = time.time()
    task.train_step(copy.deepcopy(state), task.batch_to_device(zeros, dev), cfg)
    log(f"warm step done in {time.time() - t0:.1f}s")


def _gen_testset(cfg: Config, params, dataset: VocoderDataset, out_dir: str, step: int, log) -> None:
    """Held-out listening test (reference gen_testset, dataset.py:18-42):
    fully generate a few test utterances to wav, seeds step + i."""
    try:
        n = min(cfg.wavernn_train.gen_at_checkpoint, len(dataset.test_indices))
        kind = "batched" if cfg.wavernn_gen.batched else "unbatched"
        for i in range(n):
            _, mel = dataset.example(dataset.test_indices[i])
            with torch.no_grad():
                wav = W.generate(params, cfg.wavernn, cfg.wavernn_gen, mel, step + i,
                                 bits=cfg.audio.bits, apply_mu_law=cfg.audio.mu_law)
            save_wav(wav, os.path.join(out_dir, f"step{step}_{kind}_sample{i}.wav"), cfg.audio.sample_rate)
    except Exception as e:  # listening tests must never kill training (the JAX loop's rule)
        log(f"gen_testset failed: {type(e).__name__}: {e}")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--metadata", required=True, help="GTA metadata (wavernn_training_data.txt)")
    ap.add_argument("--data-dir", required=True, help="directory of the GTA .npy files")
    ap.add_argument("--log-dir", default="logs-wavernn")
    ap.add_argument("--steps", type=int, default=None)
    ap.add_argument("--override", default="", help="comma-separated a.b=c overrides")
    ap.add_argument("--no-gen", action="store_true", help="no listening test at checkpoints")
    ap.add_argument("--native-loader", action="store_true",
                    help="use the C++ prefetch loader (native/vocoder_loader.cc)")
    ap.add_argument("--device", default=None,
                    help="torch device; default the CUDA card (cpu runs the plain versions)")
    args = ap.parse_args(argv)

    D.initialize(device=args.device)  # a no-op without a launcher
    cfg = default_config()
    if args.override:
        cfg = cfg.override(args.override)
    if D.is_primary():
        infolog.init(os.path.join(args.log_dir, "train.log"), "wavernn")
    run_training(
        cfg, args.metadata, args.data_dir, args.log_dir, total_steps=args.steps,
        gen_at_checkpoint=not args.no_gen, use_native_loader=args.native_loader, device=args.device,
    )
    D.shutdown()


if __name__ == "__main__":
    main()
