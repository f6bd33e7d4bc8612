"""How far a WaveRNN train step sits from float64, by device and
precision, and why.

    python3 tools/torch_wavernn_step_precision.py [--batch 4] [--seed 31]

Part 1, each operator of the step that cuDNN runs, at the step's shapes
(default width, ``--batch`` windows of 1,375 samples): the MelResNet's
input convolution and a residual block's 1x1 convolution, the three
stretch-and-smooth convolutions of the upsampler, and the first GRU.  For
each, max|d| / max|ref| of its output, its input gradient and its weight
gradient against the CPU in float64: on the CPU in f32, on the card in f32
(TF32 off, ``wavernn_task.fp32_precision("ieee")``), on the card with
cuDNN off, and on the card with TF32 on.

Part 2, one RAW step (``chip_smoke.step_on``) on random weights and a
random batch, its gradients against the CPU's in float64, whose ReLU
pattern is recorded.  For each variant: the ReLU units on the other side
of zero when it runs on its own, max|d| / max|g| on its own pattern, and
max|d| / max|g| with its ReLUs pinned to the reference's pattern.

Prints the card's name and power limit first.  Needs one CUDA card.
"""

from __future__ import annotations

import argparse
import contextlib
import os
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from chip_smoke import smi_line, step_on  # noqa: E402
from tacotronv2_wavernn_chinese_tpu_torch.config import default_config  # noqa: E402
from tacotronv2_wavernn_chinese_tpu_torch.models import layers as L  # noqa: E402
from tacotronv2_wavernn_chinese_tpu_torch.models import wavernn as W  # noqa: E402
from tacotronv2_wavernn_chinese_tpu_torch.train import wavernn_task as WT  # noqa: E402
from tacotronv2_wavernn_chinese_tpu_torch.utils.checkpoints import init_wavernn  # noqa: E402


@contextlib.contextmanager
def cudnn_enabled(on: bool):
    prev = torch.backends.cudnn.enabled
    torch.backends.cudnn.enabled = on
    try:
        yield
    finally:
        torch.backends.cudnn.enabled = prev


def operators(params, cfg, B: int, rng) -> list:
    """(name, fn(weights, x), weights, x, weight key) at the step's shapes."""
    wc, pad = cfg.wavernn_train, cfg.wavernn.pad
    frames = wc.seq_len_hops + 2 * pad
    f32 = lambda shape, lo=-1.0, hi=1.0: torch.as_tensor(rng.uniform(lo, hi, shape), dtype=torch.float32)
    res = params["resnet"]
    ops = [("MelResNet conv_in", L.conv1d_valid, res["conv_in"], f32((B, frames, 80), 0, 1), "w"),
           ("res block 1x1 conv", L.conv1d_valid, res["blocks"][0]["conv1"],
            f32((B, frames - 2 * pad, cfg.wavernn.compute_dims)), "w")]
    t = frames
    for taps, s in zip(params["upsample"]["kernels"], cfg.wavernn.upsample_factors):
        ops.append((f"smooth x{s}, {taps.shape[0]} taps, T={t}",
                    (lambda s: lambda p, x: W._stretch_smooth(x, p["taps"], s))(s),
                    {"taps": taps}, f32((B, t, 80), 0, 1), "taps"))
        t *= s
    T = wc.seq_len_hops * cfg.audio.hop_size
    ops.append(("GRU 1", W.gru_sequence, params["gru1"], f32((B, T, cfg.wavernn.rnn_dims)), "wi"))
    return ops


def op_outputs(fn, weights, x, key, dev, dtype) -> list:
    w = {k: v.to(dev, dtype).requires_grad_(k == key) for k, v in weights.items()}
    xin = x.to(dev, dtype).requires_grad_(True)
    y = fn(w, xin)
    gy = torch.as_tensor(np.random.default_rng(9).normal(0, 1, tuple(y.shape)), dtype=dtype, device=dev)
    gx, gw = torch.autograd.grad(y, [xin, w[key]], gy)
    return [t.detach().cpu().double() for t in (y, gx, gw)]


VARIANTS = (("CPU f32", "cpu", torch.float32, "ieee", True),
            ("card f32", "cuda", torch.float32, "ieee", True),
            ("card f32, cuDNN off", "cuda", torch.float32, "ieee", False),
            ("card TF32", "cuda", torch.float32, "tf32", True),
            ("card float64", "cuda", torch.float64, "ieee", True))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seed", type=int, default=31)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("no CUDA device is available", file=sys.stderr)
        return 2
    print(f"{smi_line()}; torch {torch.__version__} cuda {torch.version.cuda} cuDNN "
          f"{torch.backends.cudnn.version()}", flush=True)
    with WT.fp32_precision("ieee"):
        print("inside fp32_precision('ieee'): matmul/conv/rnn fp32_precision "
              + "/".join(f.fp32_precision for f in (torch.backends.cuda.matmul, torch.backends.cudnn.conv,
                                                    torch.backends.cudnn.rnn)), flush=True)
    cfg = default_config()
    params = init_wavernn(args.seed, cfg.wavernn, device="cpu")
    rng = np.random.default_rng(args.seed)

    print("part 1: operators, max|d|/max|ref| of output / input grad / weight grad against the CPU in float64")
    for name, fn, w, x, key in operators(params, cfg, args.batch, rng):
        ref = op_outputs(fn, w, x, key, "cpu", torch.float64)
        cells = []
        for vname, dev, dtype, mode, cudnn in VARIANTS[:4]:
            with WT.fp32_precision(mode), cudnn_enabled(cudnn):
                out = op_outputs(fn, w, x, key, dev, dtype)
            errs = [float((a - r).abs().max() / r.abs().max()) for a, r in zip(out, ref)]
            cells.append(f"{vname} " + "/".join(f"{e:.1e}" for e in errs))
        print(f"  {name}: " + "; ".join(cells), flush=True)

    wc = cfg.wavernn_train
    T = wc.seq_len_hops * cfg.audio.hop_size
    batch = {"x": torch.as_tensor(rng.uniform(-1, 1, (args.batch, T)), dtype=torch.float32),
             "y": torch.as_tensor(rng.integers(0, 2 ** cfg.audio.bits, (args.batch, T))).long(),
             "mels": torch.as_tensor(rng.uniform(0, 1, (args.batch, wc.seq_len_hops + 2 * cfg.wavernn.pad, 80)),
                                     dtype=torch.float32)}
    ref = step_on(cfg, params, batch, torch.device("cpu"), torch.float64)
    g_max = max(float(r.abs().max()) for r in ref["grads"])
    err = lambda run: max(float((a - r).abs().max()) for a, r in zip(run["grads"], ref["grads"])) / g_max
    print(f"part 2: one RAW step, B={args.batch} x {T} samples, against the CPU in float64 (max|g| {g_max:.3e}, "
          f"{ref['units']} ReLU units)")
    for vname, dev, dtype, mode, cudnn in VARIANTS:
        t0 = time.time()
        with cudnn_enabled(cudnn):
            own = step_on(cfg, params, batch, torch.device(dev), dtype, precision=mode)
            pinned = step_on(cfg, params, batch, torch.device(dev), dtype, ref["masks"], mode)
        flips = sum(int((a != b).sum()) for a, b in zip(own["masks"], ref["masks"]))
        print(f"  {vname}: {flips} ReLU units on the other side; max|d|/max|g| {err(own):.2e} on its own pattern, "
              f"{err(pinned):.2e} pinned to the reference's ({time.time() - t0:.1f} s)", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
