"""Vocode a mel .npy (or re-vocode a wav) with a trained WaveRNN.

Replaces the reference wavernn_gen.py:13-135, with ``batched`` a real flag
instead of force-overridden (:77).  A RAW vocoder's sample loop runs
through its CUDA kernel on the card unless ``--device cpu`` is given; a MOL
vocoder (``--override wavernn.mode=MOL``) samples through the plain MOL
loop on the same device.

Usage:
    python -m tacotronv2_wavernn_chinese_tpu_torch.infer.wavernn_gen \\
        --file mel.npy (--params-npz voc.npz | --ckpt-dir DIR) [--unbatched] \\
        [--target N --overlap N] [--device cpu]
"""

from __future__ import annotations

import argparse
import dataclasses
import os

import numpy as np
import torch

from ..config import default_config
from ..dsp import spectrogram as S
from ..dsp.wav import load_wav, save_wav
from ..models import wavernn as W
from ..utils import logging as infolog
from ..utils import resolve_device
from ..utils.checkpoints import load_params_npz, restore_params, wavernn_from_numpy


def gen_from_mel(cfg, params, mel: np.ndarray, out_path: str, seed: int = 0, device=None) -> str:
    """Vocode ``mel`` [T, num_mels] in [0, 1] (reference range check
    wavernn_gen.py:25-28) with ``params`` (numpy or torch tree) on
    ``device`` (None: the card) and write the wav."""
    if mel.ndim != 2 or mel.shape[1] != cfg.audio.num_mels:
        raise ValueError(f"expected [T, {cfg.audio.num_mels}] mel, got {mel.shape}")
    if mel.min() < -0.01 or mel.max() > 1.01:
        raise ValueError(
            f"mel range [{mel.min():.3f}, {mel.max():.3f}] is not the unit "
            "vocoder contract; convert with dsp.spectrogram.mel_to_unit"
        )
    dev = resolve_device(device)
    W.check_vocoder_supported(cfg.wavernn, cfg.audio.num_mels)
    params = wavernn_from_numpy(params, cfg.wavernn, dev, cfg.audio.num_mels, cfg.audio.bits)
    with torch.no_grad():
        wav = W.generate(params, cfg.wavernn, cfg.wavernn_gen, mel.astype(np.float32), seed,
                         bits=cfg.audio.bits, apply_mu_law=cfg.audio.mu_law)
    save_wav(wav, out_path, cfg.audio.sample_rate)
    return out_path


def main(argv=None) -> str:
    ap = argparse.ArgumentParser()
    ap.add_argument("--file", required=True, help="mel .npy ([T,80] in [0,1]) or .wav")
    ap.add_argument("--ckpt-dir", default=None, help="WaveRNN CheckpointManager directory")
    ap.add_argument("--params-npz", default=None, help="flat .npz WaveRNN weights")
    ap.add_argument("--output", default=None)
    ap.add_argument("--unbatched", action="store_true")
    ap.add_argument("--target", type=int, default=None)
    ap.add_argument("--overlap", type=int, default=None)
    ap.add_argument("--override", default="")
    ap.add_argument("--device", default=None, help="default: the CUDA card; 'cpu' runs the plain path")
    args = ap.parse_args(argv)

    cfg = default_config()
    if args.override:
        cfg = cfg.override(args.override)
    gen = cfg.wavernn_gen
    if args.unbatched:
        gen = dataclasses.replace(gen, batched=False)
    if args.target is not None:
        gen = dataclasses.replace(gen, target=args.target)
    if args.overlap is not None:  # 0 is valid (disables crossfade)
        gen = dataclasses.replace(gen, overlap=args.overlap)
    cfg = dataclasses.replace(cfg, wavernn_gen=gen)

    if not args.ckpt_dir and not args.params_npz:
        ap.error("one of --ckpt-dir / --params-npz is required")
    if args.ckpt_dir and args.params_npz:
        ap.error("--ckpt-dir and --params-npz are mutually exclusive")
    params = load_params_npz(args.params_npz) if args.params_npz else restore_params(args.ckpt_dir)
    dev = resolve_device(args.device)

    if args.file.endswith(".npy"):
        mel = np.load(args.file)
    else:
        y = load_wav(args.file, cfg.audio.sample_rate)
        with torch.no_grad():
            mel_norm = S.MelPipeline(cfg.audio, dev).melspectrogram(y).cpu().numpy()
        mel = S.mel_to_unit(mel_norm, cfg.audio).astype(np.float32)

    base = os.path.splitext(os.path.basename(args.file))[0]
    kind = "unbatched" if not cfg.wavernn_gen.batched else (
        f"batched_t{cfg.wavernn_gen.target}_o{cfg.wavernn_gen.overlap}"
    )
    out = args.output or f"{base}_{kind}.wav"
    gen_from_mel(cfg, params, mel, out, device=dev)
    infolog.log(f"wrote {out}")
    return out


if __name__ == "__main__":
    main()
