"""Synthesis CLI: text -> wav (+ mel npy, alignment/mel PNGs).

Replaces the reference tacotron_synthesize.py CLI (:129-200) and the
eval/live modes of tacotron/synthesize.py:14-134.  Without WaveRNN weights
the wav comes from Griffin-Lim.  It runs on the CUDA card unless
``--device cpu`` is given.

Usage:
    python -m tacotronv2_wavernn_chinese_tpu_torch.infer.synthesize \\
        --text '你好世界。' (--ckpt-dir logs-tacotron/taco_pretrained | --params-npz taco.npz) \\
        [--wavernn-ckpt-dir DIR | --wavernn-params-npz voc.npz] [--live] [--device cpu]
"""

from __future__ import annotations

import argparse
import time

from ..config import default_config
from ..utils import logging as infolog
from ..utils.checkpoints import load_params_npz, restore_params
from .synthesizer import Synthesizer


def main(argv=None) -> dict | None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--text", default=None)
    ap.add_argument("--ckpt-dir", default=None, help="Tacotron CheckpointManager directory")
    ap.add_argument("--params-npz", default=None, help="flat .npz Tacotron weights")
    ap.add_argument("--wavernn-ckpt-dir", default=None,
                    help="if set, vocode with WaveRNN instead of Griffin-Lim")
    ap.add_argument("--wavernn-params-npz", default=None, help="flat .npz WaveRNN weights")
    ap.add_argument("--out-dir", default="tacotron_inference_output")
    ap.add_argument("--live", action="store_true", help="stdin REPL")
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
    if args.wavernn_ckpt_dir and args.wavernn_params_npz:
        ap.error("--wavernn-ckpt-dir and --wavernn-params-npz are mutually exclusive")
    params = load_params_npz(args.params_npz) if args.params_npz else restore_params(args.ckpt_dir)
    voc = None
    if args.wavernn_params_npz:
        voc = load_params_npz(args.wavernn_params_npz)
    elif args.wavernn_ckpt_dir:  # never silently fall back to Griffin-Lim
        voc = restore_params(args.wavernn_ckpt_dir)
    synth = Synthesizer(cfg, params, vocoder_params=voc, device=args.device)

    if args.live:
        synth.run_live()
        return None
    if not args.text:
        ap.error("--text is required unless --live")
    t0 = time.time()
    r = synth.synthesize(args.text, out_dir=args.out_dir)
    dur = r["wav"].shape[0] / cfg.audio.sample_rate
    infolog.log(
        f"synthesized {dur:.2f}s audio in {time.time() - t0:.2f}s "
        f"-> {r['paths']['wav']} (pyin: {r['pyin']})"
    )
    return r


if __name__ == "__main__":
    main()
