"""Tacotron training loop + CLI.

Keeps the JAX training loop's operational guards (reference tacotron/train.py:
80-238): loss-explosion/NaN abort, restore-or-init from the latest
checkpoint, rolling time/loss windows, a checkpoint every
``checkpoint_interval`` steps with eval artifacts of training sample 0:
its Griffin-Lim wav (on the training device) and alignment and mel PNGs.

The JAX training loop's ``_prewarm_bucket_shapes`` compiles every bucketed batch
shape before the first step; eager PyTorch has nothing to compile, so it has
no counterpart here and ``tacotron_train.precompile_buckets`` is not read.

Data parallel (``use_mesh``, the default, as in the JAX loop): under a
launcher each rank runs on its own card (``cuda:LOCAL_RANK``), builds the
same global batch of ``batch_size`` rows (the same loader seed), keeps its
rows (``parallel.mesh.shard_batch``) and takes the data-parallel step of
``tacotron_task.train_step``; only rank 0 writes checkpoints,
``scalars.jsonl``, logs and eval renders, and every rank waits at a
barrier before reading a checkpoint.  One process (no launcher) trains as
before, on the card unless ``--device cpu`` is asked for.

Usage:
    python -m tacotronv2_wavernn_chinese_tpu_torch.train.tacotron_train \\
        --metadata training_data/train.txt --mel-dir training_data \\
        --log-dir logs-tacotron [--steps N] [--override a.b=c,...] [--device cpu]
    torchrun --nproc-per-node N -m tacotronv2_wavernn_chinese_tpu_torch.train.tacotron_train ...
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np
import torch

from ..config import Config, default_config
from ..data.loader import TacotronDataset, read_metadata
from ..dsp.griffin_lim import inv_mel_spectrogram
from ..dsp.spectrogram import MelPipeline
from ..dsp.wav import save_wav
from ..parallel import distributed as D
from ..parallel import mesh as PM
from ..utils import logging as infolog
from ..utils import resolve_device
from ..utils.checkpoints import CheckpointManager
from ..utils.metrics import MetricsWriter, Profiler, dump_embedding_projector, span
from ..utils.plot import plot_alignment, plot_spectrogram
from . import tacotron_task as task


class LossExplosion(Exception):
    pass


BATCH_FIELDS = ("inputs", "input_lengths", "mel_targets", "stop_targets", "target_lengths", "loss_frames")


def batch_to_device(batch, device) -> dict:
    """The batch's arrays on ``device``.  Pinned arrays (the loader's
    read-ahead on a CUDA machine) are copied without blocking the host;
    the batch keeps their tensors, so PyTorch's caching host allocator
    reuses no block before its copy has ended.  Pageable arrays are copied
    as they come."""
    with span("data.to_device"):
        if batch.pinned is not None:
            return {k: batch.pinned[k].to(device, non_blocking=True) for k in BATCH_FIELDS}
        return {k: torch.as_tensor(getattr(batch, k)).to(device) for k in BATCH_FIELDS}


def step_seed(cfg: Config, step: int) -> int:
    """Seed of the masks drawn from ``step`` on: it depends only on the
    config's seed and the step, so a resumed run draws what an
    uninterrupted one would."""
    return (cfg.tacotron_train.shuffle_seed + 1) * 1_000_003 + step


def run_training(
    cfg: Config,
    metadata_path: str,
    mel_dir: str,
    log_dir: str,
    total_steps: int | None = None,
    render_eval: bool = True,
    profile_dir: str | None = None,
    log=infolog.log,
    device=None,
    use_mesh: bool = True,
) -> task.TrainState:
    """Train to ``total_steps`` (default ``tacotron_train.train_steps``),
    resuming from the latest checkpoint under ``log_dir/taco_pretrained``.
    ``device`` None means the CUDA card (raises without one).  Under a
    process group of several ranks each rank trains on its rows of every
    global batch (module docstring); ``use_mesh=False``, the JAX loop's
    one-device step, is refused there (``parallel.mesh.mesh_or_refuse``)."""
    mesh = PM.mesh_or_refuse(use_mesh)
    dev = resolve_device(device)
    primary = D.is_primary()
    log = D.primary_log(log)
    tc = cfg.tacotron_train
    total_steps = total_steps or tc.train_steps
    os.makedirs(log_dir, exist_ok=True)
    ckpt_dir = os.path.join(log_dir, "taco_pretrained")
    eval_dir = os.path.join(log_dir, "eval")
    os.makedirs(eval_dir, exist_ok=True)
    metrics_writer = MetricsWriter(log_dir) if primary else None
    profiler = Profiler(profile_dir if primary else None)
    if mesh is not None:
        D.build_kernels(dev)

    dataset = TacotronDataset(read_metadata(metadata_path), mel_dir, cfg)
    pad_stats = dataset.padding_stats([tc.data_seed])
    if pad_stats.get("n_batches"):
        log(f"bucket padding waste (epoch 0): mel {pad_stats['frac_pad_mel']:.1%}"
            f" of frames ({pad_stats['frac_pad_mel_bucket']:.1%} from shape"
            f" multiples), inputs {pad_stats['frac_pad_inputs']:.1%}")

    mgr = CheckpointManager(ckpt_dir, max_to_keep=tc.max_checkpoints_to_keep)
    D.barrier()  # rank 0 has finished any save before a rank reads
    restored = mgr.restore(dev)
    if restored is not None:
        state = task.TrainState(restored["step"], restored["params"], restored["opt_state"])
        log(f"restored checkpoint at step {state.step}")
    else:
        state = task.init_state(tc.shuffle_seed, cfg, dev)
    if mesh is not None:
        params, mu, nu = PM.replicate_tree(mesh, (state.params, state.opt_state["mu"], state.opt_state["nu"]))
        state = task.TrainState(state.step, params, dict(state.opt_state, mu=mu, nu=nu))

    gen = torch.Generator(device=dev)
    time_win, loss_win = infolog.ValueWindow(100), infolog.ValueWindow(100)
    epoch = 0

    def dispatch(batch):
        """One step on ``batch``, then its guards, logging and checkpoint."""
        nonlocal state
        t0 = time.time()
        arrays = batch_to_device(batch, dev)
        if mesh is not None:
            arrays = PM.shard_batch(mesh, arrays)
        gen.manual_seed(step_seed(cfg, state.step))
        state, metrics = task.train_step(state, arrays, gen, cfg, mesh)
        step, loss = state.step, metrics["loss"]
        time_win.append(time.time() - t0)
        loss_win.append(loss)
        profiler.step(step)
        if np.isnan(loss) or loss > tc.loss_explosion_threshold:
            log(f"Loss exploded to {loss:.5f} at step {step}")
            raise LossExplosion("loss exploded, aborting")
        if metrics_writer is not None and (step % tc.summary_interval == 0 or step < 5):
            metrics_writer.write(step, metrics)
        if step % 10 == 0 or step < 10:
            log(
                f"Step {step:7d} [{time_win.average:.3f} sec/step, "
                f"loss={loss:.5f}, avg_loss={loss_win.average:.5f}, "
                f"lr={metrics['lr']:.2e}]"
            )
        if step % tc.checkpoint_interval == 0 and primary:
            mgr.save(step, state.params, state.opt_state)
            log(f"saved checkpoint at step {step}")
            if render_eval:
                _render_eval(cfg, state.params, batch, arrays, eval_dir, step, log, dev)
                _dump_embedding(state.params, eval_dir, log)

    while state.step < total_steps:
        step_at_epoch_start = state.step
        for batch in dataset.batches(epoch_seed=tc.data_seed + epoch):
            dispatch(batch)
            if state.step >= total_steps:
                break
        if state.step == step_at_epoch_start:
            # zero batches this epoch (fewer utterances than batch_size with
            # drop_remainder): fail loudly instead of spinning
            raise ValueError(
                f"epoch produced no batches: {len(dataset.rows)} utterances"
                f" < batch_size {tc.batch_size} (lower tacotron_train.batch_size)"
            )
        epoch += 1
    if primary:
        mgr.save(state.step, state.params, state.opt_state)
        metrics_writer.close()
    profiler.close()
    D.barrier()
    return state


def _render_eval(cfg, params, batch, arrays, eval_dir, step, log, device):
    """Griffin-Lim wav + alignment/mel PNGs from training sample 0
    (reference tacotron/train.py:189-218)."""
    try:
        gen = torch.Generator(device=device)
        gen.manual_seed(0)
        aux, out = task.eval_step(params, arrays, cfg, gen)
        T = int(batch.target_lengths[0])
        with torch.no_grad():
            wav = inv_mel_spectrogram(out.mel_outputs[0, :T], MelPipeline(cfg.audio, device))
        save_wav(wav, os.path.join(eval_dir, f"step-{step}-wave-from-mel.wav"), cfg.audio.sample_rate)
        mel = out.mel_outputs[0].cpu().numpy()[:T]
        align = out.alignments[0].cpu().numpy()[:T]
        wrote = plot_alignment(align, os.path.join(eval_dir, f"step-{step}-align.png"),
                               title=f"step {step}, eval loss {float(aux['loss']):.4f}")
        wrote &= plot_spectrogram(mel, os.path.join(eval_dir, f"step-{step}-mel.png"), title=f"step {step}")
        log(f"eval render at step {step}: eval loss {float(aux['loss']):.5f}, Griffin-Lim wav and "
            + ("alignment and mel PNGs written" if wrote else "no PNGs (matplotlib is missing)"))
    except Exception as e:  # eval artifacts must never kill training
        log(f"eval render failed: {type(e).__name__}: {e}")


def _dump_embedding(params, eval_dir, log):
    """Character-embedding projector TSVs (reference train.py:26-39)."""
    try:
        from ..frontend import default_symbols

        dump_embedding_projector(params["embedding"], list(default_symbols().symbols), eval_dir)
    except Exception as e:
        log(f"embedding dump failed: {e}")


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--metadata", required=True)
    ap.add_argument("--mel-dir", required=True)
    ap.add_argument("--log-dir", default="logs-tacotron")
    ap.add_argument("--steps", type=int, default=None)
    ap.add_argument("--override", default="", help="comma-separated a.b=c overrides")
    ap.add_argument("--no-render", action="store_true")
    ap.add_argument("--profile-dir", default=None,
                    help="write a torch.profiler trace of steps 10-15 here (CUDA activity, with the program's spans)")
    ap.add_argument("--fine-tune", action="store_true",
                    help="speaker adaptation: freeze embedding + encoder "
                         "(reference tacotron.py:167-169)")
    ap.add_argument("--device", default=None,
                    help="torch device; default the CUDA card (cpu runs the plain versions)")
    args = ap.parse_args()

    D.initialize(device=args.device)  # a no-op without a launcher
    cfg = default_config()
    if args.override:
        cfg = cfg.override(args.override)
    if args.fine_tune:
        cfg = cfg.override("tacotron_train.fine_tune=true")
    if D.is_primary():
        infolog.init(os.path.join(args.log_dir, "train.log"), "tacotron")
        infolog.log(cfg.debug_string())
    run_training(
        cfg, args.metadata, args.mel_dir, args.log_dir, total_steps=args.steps,
        render_eval=not args.no_render, profile_dir=args.profile_dir, device=args.device,
    )
    D.shutdown()


if __name__ == "__main__":
    main()
