"""HiFi-GAN training loop + CLI.

The loop of jik876/hifi-gan ``train.py`` on the port's step
(``hifigan_task.train_step``): restore-or-init from the latest checkpoint
under ``<log_dir>/checkpoints``, segments from the C++ window sampler
(``data.native_loader.NativeSegmentLoader``: ``segment_size`` samples at
random offsets of each utterance's 16-bit PCM, peak-normalised to 0.95,
every utterance once an epoch), the learning rate decayed each epoch of
``utterances // batch_size`` steps, the NaN-loss error, the step log,
``scalars.jsonl``, a checkpoint every ``checkpoint_every`` steps and the
final save.  Every step runs in full f32.

The corpus is a metadata file whose rows name, in their first column, a
16-bit mono PCM ``.wav`` at ``hifigan.sample_rate``, relative to
``--data-dir``.

Usage:
    python -m tacotronv2_wavernn_chinese_tpu_torch.train.hifigan_train \\
        --metadata <dir>/train.txt --data-dir <dir> --log-dir logs-hifigan \\
        [--steps N] [--override a.b=c,...] [--device cpu]
"""

from __future__ import annotations

import argparse
import os
import time
import wave

import numpy as np

from ..config import Config, default_config
from ..data.loader import read_metadata
from ..data.native_loader import NativeSegmentLoader
from ..utils import logging as infolog
from ..utils import resolve_device
from ..utils.checkpoints import CheckpointManager
from ..utils.metrics import MetricsWriter
from . import hifigan_task as task


def read_pcm(path: str, sample_rate: int) -> np.ndarray:
    """An utterance's int16 samples from a 16-bit mono ``.wav`` at
    ``sample_rate``."""
    with wave.open(path, "rb") as w:
        if (w.getnchannels(), w.getsampwidth(), w.getframerate()) != (1, 2, sample_rate):
            raise ValueError(f"{path}: want 16-bit mono PCM at {sample_rate} Hz, got {w.getnchannels()} channels, "
                             f"{8 * w.getsampwidth()} bits at {w.getframerate()} Hz")
        return np.frombuffer(w.readframes(w.getnframes()), "<i2").copy()


def run_training(cfg: Config, metadata_path: str, data_dir: str, log_dir: str, total_steps: int | None = None,
                 log=infolog.log, device=None) -> task.HiFiGANState:
    """Train to ``total_steps`` (default ``hifigan_train.total_steps``) on
    the utterances ``metadata_path`` names.  ``device`` None means the CUDA
    card (raises without one)."""
    dev = resolve_device(device)
    ht = cfg.hifigan_train
    total_steps = total_steps or ht.total_steps
    audio = [read_pcm(os.path.join(data_dir, r[0]), cfg.hifigan.sample_rate) for r in read_metadata(metadata_path)]
    loader = NativeSegmentLoader(audio, ht.segment_size, ht.batch_size, seed=ht.seed)
    steps_per_epoch = loader.num_utts // ht.batch_size
    if steps_per_epoch == 0:
        loader.close()
        raise ValueError(f"{loader.num_utts} utterances of at least {ht.segment_size + 1} samples "
                         f"< batch_size {ht.batch_size}")
    log(f"HiFi-GAN corpus: {loader.num_utts} utterances, {steps_per_epoch} steps an epoch")

    mgr = CheckpointManager(os.path.join(log_dir, "checkpoints"), max_to_keep=ht.max_checkpoints_to_keep)
    restored = mgr.restore(dev)
    if restored is not None:
        p, o, step = restored["params"], restored["opt_state"], restored["step"]
        state = task.HiFiGANState(step, task.TrainState(step, p["gen"], o["gen"]),
                                  task.TrainState(step, {"mpd": p["mpd"], "msd": p["msd"]}, o["disc"]), p["sn"])
        log(f"restored checkpoint at step {step}")
    else:
        state = task.init_state(ht.seed, cfg, dev)

    def save():
        mgr.save(state.step, {"gen": state.gen.params, **state.disc.params, "sn": state.sn},
                 {"gen": state.gen.opt_state, "disc": state.disc.opt_state})
        log(f"saved checkpoint at step {state.step}")

    writer = MetricsWriter(log_dir)
    times = infolog.ValueWindow(100)
    try:
        while state.step < total_steps:
            t0 = time.time()
            state, metrics = task.train_step(state, task.batch_to_device(loader.next_batch(), dev), cfg,
                                             steps_per_epoch)
            times.append(time.time() - t0)
            if not all(np.isfinite(v) for v in metrics.values()):
                raise RuntimeError(f"a loss is not finite at step {state.step}: {metrics}")
            if state.step % 10 == 0 or state.step < 10:
                log(f"Step {state.step:7d} [{times.average:.3f} sec/step, disc={metrics['loss_disc']:.4f}, "
                    f"gen={metrics['loss_gen']:.4f}, mel={metrics['mel_error']:.4f}]")
            if state.step % ht.summary_interval == 0 or state.step < 5:
                writer.write(state.step, metrics)
            if state.step % ht.checkpoint_every == 0:
                save()
        save()
    finally:
        writer.close()
        loader.close()
    return state


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="Train HiFi-GAN V1 on the port.")
    ap.add_argument("--metadata", required=True, help="rows whose first column is a 16-bit mono .wav")
    ap.add_argument("--data-dir", required=True)
    ap.add_argument("--log-dir", default="logs-hifigan")
    ap.add_argument("--steps", type=int, default=None)
    ap.add_argument("--override", default="", help="comma-separated a.b=c config overrides")
    ap.add_argument("--device", default=None, help="cpu, or a CUDA device (default: the card)")
    args = ap.parse_args(argv)
    cfg = default_config().override(args.override) if args.override else default_config()
    os.makedirs(args.log_dir, exist_ok=True)
    infolog.init(os.path.join(args.log_dir, "train.log"), "hifigan")
    run_training(cfg, args.metadata, args.data_dir, args.log_dir, args.steps, device=args.device)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
