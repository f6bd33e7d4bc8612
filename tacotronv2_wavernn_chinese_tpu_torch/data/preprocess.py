"""Corpus preprocessing: Biaobei transcripts + wavs -> (audio, mel) features.

Replaces the reference's ProcessPoolExecutor-per-utterance librosa pipeline
(tacotron/datasets/preprocessor.py:11-121, tacotron_preprocess.py:10-113)
with host-side wav conditioning and batched mel extraction on the device:
wavs are sorted by length, padded to 64-hop buckets, and each chunk runs
through ``MelPipeline.melspectrogram`` as one batch (on the card, cuFFT and
one matmul).

Multi-host scaling is an utterance shard: pass ``shard_index``/``num_shards``
and each host processes its own slice of the corpus.

Usage:
    python -m tacotronv2_wavernn_chinese_tpu_torch.data.preprocess \\
        --transcript dataset/BZNSYP/ProsodyLabeling/000001-010000.txt \\
        --wav-dir dataset/BZNSYP/Wave --out-dir training_data [--device cpu]
"""

from __future__ import annotations

import argparse
import os
import re
from dataclasses import dataclass

import numpy as np
import torch

from ..config import Config, default_config
from ..dsp.spectrogram import MelPipeline, num_frames
from ..dsp.wav import load_wav, preemphasis, rescale, trim_silence
from ..frontend import get_pyin
from .loader import read_metadata

__all__ = ["Utterance", "condition_wav", "parse_biaobei", "process_corpus", "read_metadata", "write_metadata"]


def condition_wav(audio_cfg, wav_path: str):
    """The wav-conditioning chain (trim -> preemphasis -> rescale).
    Returns (wav, preemphasized), both float32, or None when the file is
    missing."""
    try:
        wav = load_wav(wav_path, audio_cfg.sample_rate)
    except FileNotFoundError:
        return None
    if audio_cfg.trim_silence:
        wav = trim_silence(wav, audio_cfg.trim_top_db, audio_cfg.trim_fft_size, audio_cfg.trim_hop_size)
    preem = preemphasis(wav, audio_cfg.preemphasis, audio_cfg.preemphasize).astype(np.float32)
    if audio_cfg.rescale:
        wav = rescale(wav, audio_cfg.rescaling_max)
        preem = rescale(preem, audio_cfg.rescaling_max).astype(np.float32)
    return wav.astype(np.float32), preem


@dataclass
class Utterance:
    index: str
    wav_path: str
    text: str
    pyin: str


def parse_biaobei(transcript_path: str, wav_dir: str) -> list[Utterance]:
    """Parse the Biaobei ``000001-010000.txt`` transcript (text line +
    pinyin line pairs; reference preprocessor.py:36-48).  The corpus pinyin
    line is skipped: G2P re-derives phonemes so frontend and training stay
    consistent."""
    utts = []
    with open(transcript_path, encoding="utf-8") as f:
        lines = [ln.rstrip("\n") for ln in f]
    i = 0
    while i < len(lines):
        m = re.match(r"^(\d{6})\s+(.*)$", lines[i].strip())
        if m:
            index, text = m.group(1), m.group(2).strip()
            pyin, norm_text = get_pyin(text)
            utts.append(Utterance(index, os.path.join(wav_dir, f"{index}.wav"), norm_text, pyin))
            i += 2  # skip the corpus pinyin line
        else:
            i += 1
    return utts


def process_corpus(
    cfg: Config,
    transcript_path: str,
    wav_dir: str,
    out_dir: str,
    shard_index: int = 0,
    num_shards: int = 1,
    bucket_batch: int = 16,
    log=print,
    device=None,
) -> list[tuple]:
    """Process a corpus shard on ``device`` (None: the card); returns
    metadata rows (audio.npy|mel.npy|time_steps|mel_frames|text|pyin)."""
    a = cfg.audio
    pipe = MelPipeline(a, device)
    os.makedirs(out_dir, exist_ok=True)
    utts = parse_biaobei(transcript_path, wav_dir)[shard_index::num_shards]

    # pass 1: conditioned lengths only, so the corpus shard is never resident
    lengths = []
    for u in utts:
        c = condition_wav(a, u.wav_path)
        if c is None:
            log(f"missing wav {u.wav_path}, skipping")
            continue
        lengths.append((len(c[1]), u))

    # pass 2: one batched mel extraction per chunk of similar lengths; each
    # chunk re-conditions its wavs (CPU time traded for constant memory)
    rows = []
    lengths.sort(key=lambda t: t[0])
    bucket = 64 * a.hop_size
    for start in range(0, len(lengths), bucket_batch):
        chunk = [
            (u, *c)
            for _, u in lengths[start : start + bucket_batch]
            if (c := condition_wav(a, u.wav_path)) is not None  # a wav may vanish mid-run
        ]
        if not chunk:
            continue
        # pad to a 64-hop bucket, as the JAX pipeline does to bound its
        # compiled shapes; the per-item num_frames trim removes the excess
        max_len = max(len(p) for _, _, p in chunk)
        pad_len = -(-max_len // bucket) * bucket
        batch = np.zeros((len(chunk), pad_len), np.float32)
        for i, (_, _, preem) in enumerate(chunk):
            batch[i, : len(preem)] = preem
        with torch.no_grad():
            mels = pipe.melspectrogram(batch).cpu().numpy()  # [b, F_pad, num_mels]
        for (u, wav, preem), mel_padded in zip(chunk, mels):
            mel_frames = num_frames(len(preem), a.n_fft, a.hop_size)
            mel = mel_padded[:mel_frames]
            out = np.pad(wav, (0, max(0, mel_frames * a.hop_size - len(wav))))[: mel_frames * a.hop_size]
            audio_name, mel_name = f"audio-{u.index}.npy", f"mel-{u.index}.npy"
            np.save(os.path.join(out_dir, audio_name), out, allow_pickle=False)
            np.save(os.path.join(out_dir, mel_name), mel, allow_pickle=False)
            rows.append((audio_name, mel_name, len(out), mel_frames, u.text, u.pyin))
    rows.sort(key=lambda r: r[0])
    return rows


def write_metadata(rows: list[tuple], path: str) -> None:
    with open(path, "w", encoding="utf-8") as f:
        for r in rows:
            f.write("|".join(str(x) for x in r) + "\n")


def main(argv=None) -> str:
    ap = argparse.ArgumentParser()
    ap.add_argument("--transcript", required=True)
    ap.add_argument("--wav-dir", required=True)
    ap.add_argument("--out-dir", default="training_data")
    ap.add_argument("--shard-index", type=int, default=0)
    ap.add_argument("--num-shards", type=int, default=1)
    ap.add_argument("--bucket-batch", type=int, default=16)
    ap.add_argument("--override", default="")
    ap.add_argument("--device", default=None, help="default: the CUDA card; 'cpu' runs on the CPU")
    args = ap.parse_args(argv)

    cfg = default_config()
    if args.override:
        cfg = cfg.override(args.override)
    rows = process_corpus(cfg, args.transcript, args.wav_dir, args.out_dir, shard_index=args.shard_index,
                          num_shards=args.num_shards, bucket_batch=args.bucket_batch, device=args.device)
    suffix = f".{args.shard_index}" if args.num_shards > 1 else ""
    meta = os.path.join(args.out_dir, f"train.txt{suffix}")
    write_metadata(rows, meta)
    hours = sum(int(r[2]) for r in rows) / cfg.audio.sample_rate / 3600
    print(f"wrote {len(rows)} utterances ({hours:.2f} h audio) -> {meta}")
    return meta


if __name__ == "__main__":
    main()
