"""GTA (ground-truth-aligned) bridge: Tacotron -> WaveRNN training data.

Replaces the reference's wavernn_preprocess.py:29-172: for every training
utterance, run the *teacher-forced* acoustic model (the reference's helper
is unconditionally teacher-forced, helpers.py:136-142, which is what makes
GTA work) and emit the triplet WaveRNN trains on:

  wav-XXXX.npy       mu-law labels of the (preemphasized) audio
  gt_mel-XXXX.npy    ground-truth mel rescaled to [0, 1]
  pred_mel-XXXX.npy  teacher-forced predicted mel rescaled to [0, 1]

plus ``wavernn_training_data.txt`` rows ``wav|gt_mel|pred_mel|text``.

Each batch is one ``tacotron_task.eval_step``.  With forward attention
(without smoothing or anti-repeat) the decoder core runs through the
trainer's forward kernel in its eval (EMA zoneout) mode on the card; every
other configuration (LSA, GMM, Graves, smoothing, anti-repeat) takes the
eager step loop on every device (``models.tacotron.core_route``).
The utterance list is sharded by (shard_index, num_shards), so N processes
each write 1/N of the corpus and ``merge_shards`` joins their metadata.

Usage:
    python -m tacotronv2_wavernn_chinese_tpu_torch.infer.gta \\
        --metadata training_data/train.txt --data-dir training_data \\
        (--ckpt-dir logs-tacotron/taco_pretrained | --params-npz taco.npz) [--device cpu]
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np
import torch

from ..config import Config, default_config
from ..data.loader import TacotronDataset, read_metadata
from ..dsp import mulaw
from ..dsp import spectrogram as S
from ..train import tacotron_task as task
from ..train.tacotron_train import batch_to_device
from ..utils import logging as infolog
from ..utils import resolve_device
from ..utils.checkpoints import load_params_npz, restore_params, tacotron_from_numpy


def generate_gta(
    cfg: Config,
    params,
    metadata_path: str,
    data_dir: str,
    out_dir: str,
    batch_size: int = 8,
    shard_index: int = 0,
    num_shards: int = 1,
    log=infolog.log,
    device=None,
) -> str:
    """Run teacher-forced synthesis over (a shard of) the corpus on
    ``device`` (None: the card); returns the path of this shard's metadata
    file.  Each batch's prenet dropout comes from a generator seeded 0."""
    dev = resolve_device(device)
    params = tacotron_from_numpy(params, cfg.tacotron, dev)
    os.makedirs(out_dir, exist_ok=True)
    dataset = TacotronDataset(read_metadata(metadata_path), data_dir, cfg)
    # index the dataset's own row list (it may filter by clip_mels_length)
    rows = dataset.rows
    shard_rows = list(range(shard_index, len(rows), num_shards))

    mu = 2 ** cfg.audio.bits
    suffix = f".{shard_index}" if num_shards > 1 else ""
    meta_path = os.path.join(out_dir, f"wavernn_training_data.txt{suffix}")
    gen = torch.Generator(device=dev)
    n_done = 0
    t0 = time.time()
    with open(meta_path, "w", encoding="utf-8") as meta:
        for batch in dataset.sequential_batches(batch_size, indices=shard_rows):
            gen.manual_seed(0)
            _, out = task.eval_step(params, batch_to_device(batch, dev), cfg, gen)
            pred = out.mel_outputs.cpu().numpy()
            for j, row_idx in enumerate(batch.indices):
                row = rows[row_idx]
                T = int(batch.target_lengths[j])
                base = os.path.splitext(os.path.basename(row[1]))[0].replace("mel-", "")
                audio = np.load(os.path.join(data_dir, row[0]))
                names = (f"wav-{base}.npy", f"gt_mel-{base}.npy", f"pred_mel-{base}.npy")
                np.save(os.path.join(out_dir, names[0]), mulaw.encode_mu_law(audio, mu=mu).astype(np.int16))
                np.save(os.path.join(out_dir, names[1]),
                        S.mel_to_unit(batch.mel_targets[j][:T], cfg.audio).astype(np.float32))
                np.save(os.path.join(out_dir, names[2]), S.mel_to_unit(pred[j][:T], cfg.audio).astype(np.float32))
                text = row[4] if len(row) > 4 else ""
                meta.write("|".join(names) + f"|{text}\n")
                n_done += 1
            if n_done % (batch_size * 8) < batch_size:
                rate = n_done / max(time.time() - t0, 1e-9)
                log(f"gta: {n_done}/{len(shard_rows)} utterances ({rate:.1f}/s)")
    log(f"gta shard {shard_index}/{num_shards}: wrote {n_done} utterances -> {meta_path}")
    return meta_path


def merge_shards(out_dir: str, num_shards: int) -> str:
    """Concatenate per-shard metadata into wavernn_training_data.txt."""
    final = os.path.join(out_dir, "wavernn_training_data.txt")
    with open(final, "w", encoding="utf-8") as out:
        for i in range(num_shards):
            with open(f"{final}.{i}", encoding="utf-8") as f:
                out.write(f.read())
    return final


def main(argv=None) -> str:
    ap = argparse.ArgumentParser()
    ap.add_argument("--metadata", required=True)
    ap.add_argument("--data-dir", required=True)
    ap.add_argument("--out-dir", default="wavernn_training_data")
    ap.add_argument("--ckpt-dir", default=None, help="Tacotron CheckpointManager directory")
    ap.add_argument("--params-npz", default=None, help="flat .npz Tacotron weights")
    ap.add_argument("--batch-size", type=int, default=8)
    ap.add_argument("--shard-index", type=int, default=0)
    ap.add_argument("--num-shards", type=int, default=1)
    ap.add_argument("--step", type=int, default=None,
                    help="checkpoint step to restore (default: latest); GTA should run from the best "
                         "checkpoint, which may come before the last")
    ap.add_argument("--override", default="")
    ap.add_argument("--device", default=None, help="default: the CUDA card; 'cpu' runs the plain path")
    args = ap.parse_args(argv)

    cfg = default_config()
    if args.override:
        cfg = cfg.override(args.override)
    if not args.ckpt_dir and not args.params_npz:
        ap.error("one of --ckpt-dir / --params-npz is required")
    if args.ckpt_dir and args.params_npz:
        ap.error("--ckpt-dir and --params-npz are mutually exclusive")
    params = load_params_npz(args.params_npz) if args.params_npz else restore_params(args.ckpt_dir, args.step)
    return generate_gta(cfg, params, args.metadata, args.data_dir, args.out_dir, batch_size=args.batch_size,
                        shard_index=args.shard_index, num_shards=args.num_shards, device=args.device)


if __name__ == "__main__":
    main()
