"""Tacotron training loop + CLI.

Keeps the JAX training loop's operational guards (reference tacotron/train.py:
80-238): loss-explosion/NaN abort, restore-or-init from the latest
checkpoint, rolling time/loss windows, a checkpoint every
``checkpoint_interval`` steps with eval artifacts (alignment and mel PNGs
of training sample 0).  The Griffin-Lim eval wav waits for Griffin-Lim
(ROADMAP.md, queue item 7) and is logged as not yet ported.

The JAX training loop's ``_prewarm_bucket_shapes`` compiles every bucketed batch
shape before the first step; eager PyTorch has nothing to compile, so it has
no counterpart here and ``tacotron_train.precompile_buckets`` is not read.
The data-parallel mesh is not ported (ROADMAP.md, queue item 12): training
runs on one device, the card unless ``--device cpu`` is asked for.

Usage:
    python -m tacotronv2_wavernn_chinese_tpu_torch.train.tacotron_train \\
        --metadata training_data/train.txt --mel-dir training_data \\
        --log-dir logs-tacotron [--steps N] [--override a.b=c,...] [--device cpu]
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np
import torch

from ..config import Config, default_config
from ..data.loader import TacotronDataset, read_metadata
from ..utils import logging as infolog
from ..utils import resolve_device
from ..utils.checkpoints import CheckpointManager
from ..utils.metrics import MetricsWriter, Profiler, dump_embedding_projector
from ..utils.plot import plot_alignment, plot_spectrogram
from . import tacotron_task as task
from .grouping import fused_groups


class LossExplosion(Exception):
    pass


def batch_to_device(batch, device) -> dict:
    t = lambda a: torch.as_tensor(a).to(device)
    return {
        "inputs": t(batch.inputs),
        "input_lengths": t(batch.input_lengths),
        "mel_targets": t(batch.mel_targets),
        "stop_targets": t(batch.stop_targets),
        "target_lengths": t(batch.target_lengths),
        "loss_frames": t(batch.loss_frames),
    }


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
) -> task.TrainState:
    """Train to ``total_steps`` (default ``tacotron_train.train_steps``),
    resuming from the latest checkpoint under ``log_dir/taco_pretrained``.
    ``device`` None means the CUDA card (raises without one)."""
    dev = resolve_device(device)
    tc = cfg.tacotron_train
    total_steps = total_steps or tc.train_steps
    os.makedirs(log_dir, exist_ok=True)
    ckpt_dir = os.path.join(log_dir, "taco_pretrained")
    eval_dir = os.path.join(log_dir, "eval")
    os.makedirs(eval_dir, exist_ok=True)
    metrics_writer = MetricsWriter(log_dir)
    profiler = Profiler(profile_dir)

    dataset = TacotronDataset(read_metadata(metadata_path), mel_dir, cfg)
    pad_stats = dataset.padding_stats([tc.data_seed])
    if pad_stats.get("n_batches"):
        log(f"bucket padding waste (epoch 0): mel {pad_stats['frac_pad_mel']:.1%}"
            f" of frames ({pad_stats['frac_pad_mel_bucket']:.1%} from shape"
            f" multiples), inputs {pad_stats['frac_pad_inputs']:.1%}")

    mgr = CheckpointManager(ckpt_dir, max_to_keep=tc.max_checkpoints_to_keep)
    restored = mgr.restore(dev)
    if restored is not None:
        state = task.TrainState(restored["step"], restored["params"], restored["opt_state"])
        log(f"restored checkpoint at step {state.step}")
    else:
        state = task.init_state(tc.shuffle_seed, cfg, dev)

    gen = torch.Generator(device=dev)
    time_win, loss_win = infolog.ValueWindow(100), infolog.ValueWindow(100)
    step = state.step
    epoch = 0
    spd = max(1, int(tc.steps_per_dispatch))

    def dispatch(group):
        """Run len(group) steps back to back, then apply the per-step
        guards/logging to every sub-step."""
        nonlocal state, step
        t0 = time.time()
        k = len(group)
        arrays = [batch_to_device(b, dev) for b in group]
        gen.manual_seed(step_seed(cfg, step))
        if k == 1:
            state, metrics = task.train_step(state, arrays[0], gen, cfg)
            mhost = {kk: [v] for kk, v in metrics.items()}
        else:
            state, mhost = task.train_step_many(state, arrays, gen, cfg)
        dt = (time.time() - t0) / k
        ckpt_due = False
        for i in range(k):
            sub = step + i + 1
            loss = float(mhost["loss"][i])
            time_win.append(dt)
            loss_win.append(loss)
            profiler.step(sub)
            if np.isnan(loss) or loss > tc.loss_explosion_threshold:
                log(f"Loss exploded to {loss:.5f} at step {sub}")
                raise LossExplosion("loss exploded, aborting")
            if sub % tc.summary_interval == 0 or sub < 5:
                metrics_writer.write(sub, {kk: v[i] for kk, v in mhost.items()})
            if sub % 10 == 0 or sub < 10:
                log(
                    f"Step {sub:7d} [{time_win.average:.3f} sec/step, "
                    f"loss={loss:.5f}, avg_loss={loss_win.average:.5f}, "
                    f"lr={float(mhost['lr'][i]):.2e}]"
                )
            if sub % tc.checkpoint_interval == 0:
                ckpt_due = True
        step = state.step
        if ckpt_due:
            # with K>1 the save lands at the end of the group — at most K-1
            # steps past the exact boundary (exact when spd == 1)
            mgr.save(step, state.params, state.opt_state)
            log(f"saved checkpoint at step {step}")
            if render_eval:
                _render_eval(cfg, state.params, group[-1], arrays[-1], eval_dir, step, log, dev)
                _dump_embedding(state.params, eval_dir, log)

    while step < total_steps:
        stream = dataset.batches(epoch_seed=tc.data_seed + epoch)
        step_at_epoch_start = step
        for group in fused_groups(
            stream, spd, lambda: step, total_steps,
            key_fn=lambda b: (b.inputs.shape, b.mel_targets.shape),
        ):
            dispatch(group)
        if step == step_at_epoch_start:
            # zero batches this epoch (fewer utterances than batch_size with
            # drop_remainder): fail loudly instead of spinning
            raise ValueError(
                f"epoch produced no batches: {len(dataset.rows)} utterances"
                f" < batch_size {tc.batch_size} (lower tacotron_train.batch_size)"
            )
        epoch += 1
    mgr.save(step, state.params, state.opt_state)
    metrics_writer.close()
    profiler.close()
    return state


def _render_eval(cfg, params, batch, arrays, eval_dir, step, log, device):
    """Alignment/mel PNGs from training sample 0 (reference
    tacotron/train.py:189-218); the Griffin-Lim wav is not ported yet."""
    try:
        gen = torch.Generator(device=device)
        gen.manual_seed(0)
        aux, out = task.eval_step(params, arrays, cfg, gen)
        T = int(batch.target_lengths[0])
        mel = out.mel_outputs[0].cpu().numpy()[:T]
        align = out.alignments[0].cpu().numpy()[:T]
        wrote = plot_alignment(align, os.path.join(eval_dir, f"step-{step}-align.png"),
                               title=f"step {step}, eval loss {float(aux['loss']):.4f}")
        wrote &= plot_spectrogram(mel, os.path.join(eval_dir, f"step-{step}-mel.png"), title=f"step {step}")
        log(f"eval render at step {step}: eval loss {float(aux['loss']):.5f}, "
            + ("alignment and mel PNGs written" if wrote else "no PNGs (matplotlib is missing)")
            + "; the Griffin-Lim wav is not ported yet (ROADMAP.md, queue item 7)")
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
                    help="write a torch.profiler trace of steps 10-15 here")
    ap.add_argument("--fine-tune", action="store_true",
                    help="speaker adaptation: freeze embedding + encoder "
                         "(reference tacotron.py:167-169)")
    ap.add_argument("--device", default=None,
                    help="torch device; default the CUDA card (cpu runs the plain versions)")
    args = ap.parse_args()

    cfg = default_config()
    if args.override:
        cfg = cfg.override(args.override)
    if args.fine_tune:
        cfg = cfg.override("tacotron_train.fine_tune=true")
    infolog.init(os.path.join(args.log_dir, "train.log"), "tacotron")
    infolog.log(cfg.debug_string())
    run_training(
        cfg, args.metadata, args.mel_dir, args.log_dir, total_steps=args.steps,
        render_eval=not args.no_render, profile_dir=args.profile_dir, device=args.device,
    )


if __name__ == "__main__":
    main()
