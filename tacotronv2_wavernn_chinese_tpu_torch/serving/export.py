"""Serving artifacts: ``write_artifact`` and the export CLI write the same
directory as the JAX package's ``serving/export.py``; ``load_exported``
loads either.

  tacotron_params.npz      flat param arrays
  wavernn_params.npz       (optional) vocoder params
  config.json              the full Config
  symbols.txt              frozen vocabulary (checkpoint <-> vocab pinned)
  MANIFEST.json            format description

Usage:
    python -m tacotronv2_wavernn_chinese_tpu_torch.serving.export \
        (--params-npz taco.npz | --ckpt-dir logs-tacotron/taco_pretrained) \
        [--wavernn-params-npz voc.npz | --wavernn-ckpt-dir DIR] --out export/1
"""

from __future__ import annotations

import argparse
import json
import os
import shutil

from ..config import Config, _config_from_dict, default_config
from ..utils.checkpoints import load_params_npz, restore_params, save_params_npz

MANIFEST = {
    "format": "tacotronv2_wavernn_chinese_tpu.export.v1",
    "signature": {
        "name": "tacotron_fw",
        "inputs": {"input": "int32 [1, None] phoneme ids", "input_length": "int32 [1]"},
        "outputs": {"mel": "float32 [T, 80] in [-4, 4]", "alignment": "float32 [T_dec, T_in]"},
    },
}


def write_artifact(cfg: Config, tacotron_params, out_dir: str, wavernn_params=None) -> str:
    """Write an artifact in the same format (params may be numpy or torch)."""
    os.makedirs(out_dir, exist_ok=True)
    save_params_npz(os.path.join(out_dir, "tacotron_params.npz"), tacotron_params)
    if wavernn_params is not None:
        save_params_npz(os.path.join(out_dir, "wavernn_params.npz"), wavernn_params)
    with open(os.path.join(out_dir, "config.json"), "w", encoding="utf-8") as f:
        json.dump(cfg.to_dict(), f, indent=2, default=str)
    symbols_src = os.path.join(os.path.dirname(__file__), "..", "frontend", "data", "symbols.txt")
    shutil.copy(symbols_src, os.path.join(out_dir, "symbols.txt"))
    with open(os.path.join(out_dir, "MANIFEST.json"), "w", encoding="utf-8") as f:
        json.dump(MANIFEST, f, indent=2)
    return out_dir


def load_exported(path: str, max_iters: int | None = None, device=None, override: str = ""):
    """Artifact dir -> ready Synthesizer on ``device`` (None: the card),
    with ``override`` (``a.b=c,...``) applied over the artifact's
    config.json.  The vocabulary is the artifact's symbols.txt, not the
    package's table: the embedding rows must match the table the weights
    were trained with."""
    from ..frontend.symbols import SymbolTable
    from ..infer.synthesizer import Synthesizer
    from ..utils import resolve_device

    dev = resolve_device(device)
    with open(os.path.join(path, "config.json"), encoding="utf-8") as f:
        cfg = _config_from_dict(json.load(f))
    if override:
        cfg = cfg.override(override)
    params = load_params_npz(os.path.join(path, "tacotron_params.npz"))
    voc = None
    wav_path = os.path.join(path, "wavernn_params.npz")
    if os.path.exists(wav_path):
        voc = load_params_npz(wav_path)
    with open(os.path.join(path, "symbols.txt"), encoding="utf-8") as f:
        symbols = SymbolTable([line.rstrip("\n") for line in f if line.rstrip("\n")])
    return Synthesizer(cfg, params, vocoder_params=voc, max_iters=max_iters, symbols=symbols, device=dev)


def main(argv=None) -> None:
    """The export CLI: Tacotron weights from a flat npz or the port's
    checkpoint directory, optional WaveRNN weights likewise, into ``--out``."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--ckpt-dir", default=None, help="Tacotron CheckpointManager directory (latest step)")
    ap.add_argument("--params-npz", default=None, help="flat .npz Tacotron weights")
    ap.add_argument("--wavernn-ckpt-dir", default=None)
    ap.add_argument("--wavernn-params-npz", default=None, help="flat .npz WaveRNN weights")
    ap.add_argument("--out", default="export/1")
    ap.add_argument("--override", default="")
    args = ap.parse_args(argv)

    cfg = default_config()
    if args.override:
        cfg = cfg.override(args.override)
    if not args.ckpt_dir and not args.params_npz:
        ap.error("one of --ckpt-dir / --params-npz is required")
    if args.ckpt_dir and args.params_npz:
        ap.error("--ckpt-dir and --params-npz are mutually exclusive")
    if args.wavernn_ckpt_dir and args.wavernn_params_npz:
        ap.error("--wavernn-ckpt-dir and --wavernn-params-npz are mutually exclusive")
    params = load_params_npz(args.params_npz) if args.params_npz else restore_params(args.ckpt_dir)
    voc = None
    if args.wavernn_params_npz:
        voc = load_params_npz(args.wavernn_params_npz)
    elif args.wavernn_ckpt_dir:
        voc = restore_params(args.wavernn_ckpt_dir)
    out = write_artifact(cfg, params, args.out, voc)
    print(f"exported serving artifact -> {out}")


if __name__ == "__main__":
    main()
