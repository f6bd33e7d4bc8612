"""Drive the PyTorch port on one CUDA card and hold its kernels against
their plain PyTorch versions.

    python3 chip_smoke.py

Phases, each printing its lines before the next starts:

  device   the card's name and power limit (nvidia-smi)
  build    nvcc builds every kernel source under csrc/ (sm_90a), in parallel
  wavernn  the sample-loop kernel (K1, one cooperative grid) against its
           plain version, full width, 16 folds x 2200 samples, greedy and
           sampled (shared generator), and 3 folds (a partly filled fold
           tile); then fold scaling: 16, 64 and 256 folds x 1000 samples,
           greedy, kernel ms and us/step
  decoder  the decode kernel (K2, one cluster grid) against its plain
           version, full width, dropout 0.5: B=3, T_in=64, a 200-step run
           with the stop bias at -30 (per-step error growth printed) and a
           run with normal weights; the serve buckets B=1, 2, 4, 8, 16 at
           T_in=64, 150 steps, stop bias -30; a ragged B=5, T_in=37 run; a
           batch beyond one grid's rows (8 x clusters + 3, row groups, 40
           steps); a long input (B=2, T_in=2048, the longest a 500-character
           text gives, 100 steps); then a scaling line, K2 us/step at B=1,
           4, 16 x T_in=32, 256, 1024
  k2 branches
           each other branch of the decode kernel (anti-repeat, smoothing,
           LSA with and without its synthesis window, r = 2, 3, 6, GMM and
           Graves attention, Graves at r = 3 under the all-frames stop) at
           full width against its plain version: B=4, T_in=32, 150 steps
           (timed), ragged B=5, T_in=37 and B=2, T_in=256 (40 steps), at
           stop bias -30 and at stop biases that stop rows; frames, stop
           logits and alignments within 1e-3 at every step, stop lengths
           equal, a row diverging only after a plain argmax near-tie (top-2
           gap < 1e-5); GMM's and Graves' plain alignment argmax moving at
           least 10 positions at T_in=256; GMM with 128 mixtures and Graves
           with 128 heads once at B=4, T_in=256; each branch's text->mel
           through a Synthesizer with the launch counter read around it;
           one /generate_tts request each through an r=2 anti-repeat and a
           Graves artifact that stop (WAV of stop_len x 275 samples)
  serve    full-width random weights written as an export artifact, served
           on localhost: three /generate_tts requests and one
           /generate_tts_batch, WAV headers and lengths checked, both
           kernels' launch counters read around the requests
  train    the trainer kernels (K3 forward, K4 backward, one cluster grid
           each) against the eager loop differentiated by autograd, full
           width, B=32, T_in=128 (ragged lengths), 400 steps, zoneout
           masks: max|d| of every output and gradient; the same at B=1, 10
           and 64 (100 steps); a batch-scaling line (K3/K4 us/step at B=1,
           8, 32, 64); then run_training at the default config,
           batch 32, on a synthetic corpus (64 utterances, 40-150
           symbols, 200-600 frames): 6 steps with a checkpoint every 3 and
           the eval render, the K3/K4 launch counters read around it, and a
           restart that must resume at the saved step; one step split by
           CUDA events
  kernels  each kernel against its plain version again at the shapes the
           serve and train paths gave it: times, bounds, errors; one JSON
           line

Any failed check exits non-zero.  The line before the last is the card's
name and power limit; the last line is {"ok": true, "device": {...}}.
Weights are random, made from fixed seeds.
"""

from __future__ import annotations

import base64
import io
import json
import os
import shutil
import subprocess
import sys
import threading
import time
import urllib.request
import wave

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)

# Published H100 SXM peaks (NVIDIA data sheet): the kernels run f32 FMA on
# the CUDA cores, so the operations bound uses the f32 non-tensor rate.
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOP_PER_S = 67e12

SENTENCES = ["你好，欢迎使用语音合成系统。", "今天天气很好，我们去公园散步吧。", "这是第3个测试句子。"]
SERVE_FRAMES = 150  # stop bias -30 and max_iters 150: every decode runs 150 frames


class SmokeFailure(RuntimeError):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def phase(name: str, msg: str) -> None:
    print(f"[{name}] {msg}", flush=True)


def ptxas_entries(log: str) -> list:
    """(mangled entry name, registers, spill store bytes, spill load bytes)
    of each entry function in an ``nvcc -Xptxas=-v`` log."""
    import re

    out, name, spill = [], None, (0, 0)
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            name, spill = m.group(1), (0, 0)
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m:
            spill = (int(m.group(1)), int(m.group(2)))
        m = re.search(r"Used (\d+) registers", line)
        if m and name is not None:
            out.append((name, int(m.group(1)), *spill))
            name = None
    return out


def smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    check(out.returncode == 0, f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int = 1, warmup: bool = False) -> float:
    """Mean milliseconds of ``fn`` on the card, by CUDA events; with
    ``warmup`` one untimed call first (module loading, first launch)."""
    import torch

    if warmup:
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


# ---------------------------------------------------------------------------
# bounds: the least time the card could take for the same work
# ---------------------------------------------------------------------------


def wavernn_work(cfg, T: int, B: int):
    """(flops, bytes) of the sample loop over T steps and B folds."""
    H, FC, NC, aux = cfg.rnn_dims, cfg.fc_dims, 1024, 32
    macs = ((1 + 80 + aux) * H          # I projection
            + 2 * H * 3 * H             # GRU1 input and hidden gates
            + (H + aux) * 3 * H + H * 3 * H  # GRU2
            + (H + aux) * FC + (FC + aux) * FC + FC * NC)  # fc1, fc2, fc3
    weights = macs + H + 12 * H + 2 * FC + NC  # matrices + biases, f32
    flops = 2.0 * macs * T * B
    nbytes = 4.0 * (weights + T * B * (80 + 4 * aux) + T * B)
    return flops, nbytes


def decoder_work(tcfg, B: int, T_in: int, V: int, steps: int, max_iters: int):
    """(flops, bytes) of ``steps`` decoder steps for B rows (outputs for
    all max_iters steps are written) at r frames a step: the projection has
    81r outputs, and forward attention's mu one more.  Forward and LSA
    attention: the query projection, the location conv and the energies
    against keys of width A at every position; anti-repeat's context reads
    at most six positions.  GMM: its dense, 3N x (u + V), and N terms a
    position of 6 operations (difference, square, quotient, exp, product,
    sum); Graves: layer1 u x u/4 and layer2 u/4 x 3N, and N terms at each
    of the T_in + 1 position edges of 9 operations (difference, quotient,
    the sigmoid's exp, sum and quotient, sum, reciprocal, product, sum); no
    keys."""
    u, A, taps = tcfg.decoder_lstm_units, tcfg.attention_dim, tcfg.attention_kernel
    p1, p2 = tcfg.prenet_layers
    mode, r = tcfg.attention_mode, tcfg.outputs_per_step
    nproj = 81 * r + int(mode == "forward")
    ctx_pos = min(T_in, 6) if mode == "forward" and tcfg.anti_repeat else T_in
    macs_row = (80 * p1 + p1 * p2 + (p2 + V + u) * 4 * u + 2 * u * 4 * u + ctx_pos * V + (u + V) * nproj)
    weights = 80 * p1 + p1 * p2 + (p2 + V + u) * 4 * u + 2 * u * 4 * u + (u + V) * nproj + p1 + p2 + 8 * u + nproj
    if mode in ("forward", "lsa"):
        att_macs, att_ops, att_w, key_w = u * A + T_in * (taps * A + A), 0, u * A + taps * A + 3 * A, A
    elif mode == "gmm":
        n = tcfg.num_attn_mixtures
        att_macs, att_ops, att_w, key_w = 3 * n * (u + V), 6 * n * T_in, 3 * n * (u + V + 1), 0
    else:
        n, h = tcfg.graves_heads, u // 4
        att_macs, att_ops, att_w, key_w = u * h + h * 3 * n, 9 * n * (T_in + 1), u * h + h + h * 3 * n + 3 * n, 0
    flops = (2.0 * (macs_row + att_macs) + att_ops) * B * steps
    nbytes = 4.0 * (weights + att_w + B * T_in * (key_w + V + 1) + max_iters * B * (81 * r + T_in))
    return flops, nbytes


def trainer_work(tcfg, B: int, T: int, T_in: int, backward: bool, blocks: int, masks: bool = True):
    """(flops, bytes) of the trainer core kernel, forward (K3) or backward
    (K4), over T steps and B rows on a grid of ``blocks`` blocks
    (ops/tacotron_trainer_kernel.py).  K3 saves the gate pre-activations
    g1, g2 and the query projection pq, and K4 reads them instead of
    recomputing them: their bytes count in both, their products in K3's
    work only."""
    from tacotronv2_wavernn_chinese_tpu_torch.ops import tacotron_trainer_kernel as TK

    P, U, V, A, F, taps = TK.widths(tcfg)
    small = taps * F + F * A + 2 * A + V + U + 1  # location, ball, v, mu
    keep = 4 * U if masks else 0
    memory = B * T_in * (A + V)  # keys, values
    if not backward:
        gates = (P + V + U) * 4 * U + 2 * U * 4 * U
        macs = gates + U * A + T_in * (taps * F + F * A + A + V) + V + U
        saves = T * B * (3 * T_in + 6 * U + 2 * V + 1 + 8 * U + A)  # out2, ctx, align + FWD_OUTS saves
        nbytes = T * B * (P + keep) + memory + B * T_in + gates + 8 * U + U * A + small + saves
    else:
        gates = (V + U) * 4 * U + 2 * U * 4 * U  # l1's [ctx | h] rows, l2
        macs = gates + U * A + V + U + T_in * (V + 3 * taps * F + 3 * F * A + 2 * A)
        saves = T * B * (3 * U + V + 3 * T_in + 1 + 8 * U + A)  # out2, ctx, align(_sm), c1p, c2p, alphap, mup, g1, g2, pq
        outs = T * B * (8 * U + A + 1 + V) + B * T_in * A + blocks * (taps * F + F * A + 2 * A)
        nbytes = (T * B * keep + memory + B * T_in + T * B * (U + V + T_in) + gates + U * A + small
                  + saves + outs)
    return 2.0 * macs * T * B, 4.0 * nbytes


def bound(flops: float, nbytes: float):
    t_ops, t_bytes = flops / PEAK_F32_FLOP_PER_S, nbytes / PEAK_BYTES_PER_S
    return (t_ops * 1e3, "operations") if t_ops >= t_bytes else (t_bytes * 1e3, "bytes")


# ---------------------------------------------------------------------------
# K1: the WaveRNN sample loop
# ---------------------------------------------------------------------------


def compare_labels(lk, lp, gaps, n_classes: int, tag: str) -> dict:
    """Labels must agree; a fold may diverge only where the plain
    version's top-2 gap was below 1e-4 (both then follow different but
    valid trajectories, so the fold is compared no further).

    Returns what was measured: ``max_abs_err``, the largest difference of
    the fed-back sample 2*l/(n-1) - 1 over the compared steps (a diverged
    fold's first mismatch included); ``compared`` and ``uncompared`` steps;
    ``diverged`` folds; ``near_ties``, compared steps whose plain top-2 gap
    was below 1e-4."""
    lk, lp, gaps = lk.cpu().numpy(), lp.cpu().numpy(), gaps.cpu().numpy()
    T, B = lk.shape
    upto = np.full(B, T)  # steps compared per fold
    for b in range(B):
        bad = np.nonzero(lk[:, b] != lp[:, b])[0]
        if bad.size == 0:
            continue
        t = int(bad[0])
        gap = float(gaps[t, b])
        phase("wavernn", f"{tag}: fold {b} first mismatch at step {t}: kernel {lk[t, b]} plain "
              f"{lp[t, b]}, plain top-2 gap {gap:.3e}")
        check(gap < 1e-4, f"{tag}: fold {b} label mismatch at step {t} with top-2 gap {gap:.3e} >= 1e-4")
        upto[b] = t + 1
    sel = np.arange(T)[:, None] < upto[None, :]
    to_x = lambda l: 2.0 * l.astype(np.float64) / (n_classes - 1) - 1.0
    err = np.abs(to_x(lk) - to_x(lp))[sel]
    return {"max_abs_err": float(err.max()) if err.size else 0.0, "compared": int(sel.sum()),
            "uncompared": int(T * B - sel.sum()), "diverged": int((upto < T).sum()),
            "near_ties": int((gaps[sel] < 1e-4).sum())}


def run_k1(params, wcfg, mels, seed: int, greedy: bool, tag: str, warmup: bool = True, steps: int | None = None):
    """K1 against its plain version on the conditioning of ``mels`` (its
    first ``steps`` samples when given): labels compared, times by CUDA
    events."""
    from tacotronv2_wavernn_chinese_tpu_torch.models import wavernn as W
    from tacotronv2_wavernn_chinese_tpu_torch.ops import wavernn_kernel as WK

    cond = W.precompute_conditioning(params, wcfg, mels)
    if steps is not None:
        cond = cond[:steps].contiguous()
    w = WK.pack_weights(params, wcfg)
    out = {}
    out["ms"] = cuda_ms(lambda: out.__setitem__("lk", WK.sample_labels(cond, w, seed, greedy)),
                        warmup=warmup)
    t0 = time.time()
    out["plain_ms"] = cuda_ms(
        lambda: out.__setitem__("lp", WK.sample_labels_plain(cond, w, seed, greedy, return_gaps=True))
    )
    lp, gaps = out["lp"]
    out.update(compare_labels(out["lk"], lp, gaps, w["wfc3"].shape[0], tag))
    T, B = out["lk"].shape
    phase("wavernn", f"{tag}: T={T} B={B}: {out['compared']}/{T * B} steps compared "
          f"({out['uncompared']} left after {out['diverged']} folds diverged at a near-tie), "
          f"max|d| of the fed-back sample {out['max_abs_err']:.3e}, {out['near_ties']} plain "
          f"near-ties (gap < 1e-4); kernel {out['ms']:.1f} ms ({out['ms'] / T * 1e3:.1f} us/step), "
          f"plain {out['plain_ms']:.1f} ms ({time.time() - t0:.1f} s host)")
    out["T"], out["B"] = T, B
    return out


# ---------------------------------------------------------------------------
# K2: the Tacotron decode
# ---------------------------------------------------------------------------


def run_k2(params, tcfg, memory, mask, seeds, max_iters: int, tag: str, per_step: bool):
    """K2 against its plain version (the kernel's time the mean of five
    launches after one untimed): stop lengths equal, frames and alignments
    compared up to the shortest stop."""
    import torch

    from tacotronv2_wavernn_chinese_tpu_torch.ops import tacotron_decoder_kernel as DK

    out = {}
    out["ms"] = cuda_ms(lambda: out.__setitem__(
        "k", DK.decode_autoregressive_kernel(params, tcfg, memory, mask, seeds, max_iters)), reps=5, warmup=True)
    out["plain_ms"] = cuda_ms(lambda: out.__setitem__(
        "p", DK.decode_autoregressive_plain(params, tcfg, memory, mask, seeds, max_iters)))
    fk, sk, ak, lk = out["k"]
    fp, sp, ap, lp = out["p"]
    lk, lp = lk.cpu().numpy(), lp.cpu().numpy()
    phase("decoder", f"{tag}: stop_len kernel {lk.tolist()} plain {lp.tolist()}; kernel "
          f"{out['ms']:.2f} ms, plain {out['plain_ms']:.2f} ms")
    check(np.array_equal(lk, lp), f"{tag}: stop lengths differ: kernel {lk} plain {lp}")
    n = int(lk.min())
    df = (fk[:, :n] - fp[:, :n]).abs().amax(dim=(0, 2)) if n else torch.zeros(0)
    da = (ak[:, :n] - ap[:, :n]).abs().amax(dim=(0, 2)) if n else torch.zeros(0)
    err = torch.maximum(df, da).cpu().numpy()
    if per_step and n:
        marks = sorted({1, 2, 5, 10, 20, 50, 100, 150, n} & set(range(1, n + 1)))
        growth = ", ".join(f"<={m}: {err[:m].max():.2e}" for m in marks)
        phase("decoder", f"{tag}: max|d| (frames, aligns) by step: {growth}")
    out["max_abs_err"] = float(err.max()) if n else 0.0
    # steps the kernel really ran: until every row was done
    out["steps"] = int(min(max_iters, lk.max() + 1))
    phase("decoder", f"{tag}: {out['steps']} steps run, kernel {out['ms'] / out['steps'] * 1e3:.1f} us/step")
    return out


def encode_batch(params, tcfg, ids_list, device):
    import torch

    from tacotronv2_wavernn_chinese_tpu_torch.models import tacotron as T

    lens = [len(x) for x in ids_list]
    T_in = max(lens)
    T_in += (-T_in) % 16
    inputs = np.zeros((len(ids_list), T_in), np.int64)
    for i, ids in enumerate(ids_list):
        inputs[i, : len(ids)] = ids
    inputs = torch.as_tensor(inputs, device=device)
    lens_t = torch.as_tensor(lens, device=device)
    memory = T.encode(params, tcfg, inputs, lens_t)
    return memory, T.input_mask(lens_t, T_in)


def k2_case(params, tcfg, dev, rng, B: int, T_in: int, steps: int, tag: str) -> dict:
    """K2 against its plain version on encoded random ids with ragged
    lengths (the longest row fills T_in): stop lengths equal, frames and
    alignments within 1e-3 up to the shortest stop."""
    import torch

    from tacotronv2_wavernn_chinese_tpu_torch.models import tacotron as T

    ids = torch.as_tensor(rng.integers(1, tcfg.vocab_size, (B, T_in)), device=dev)
    lens = torch.as_tensor(np.linspace(T_in, max(1, T_in // 3), B).astype(int), device=dev)
    memory = T.encode(params, tcfg, ids, lens)
    r = run_k2(params, tcfg, memory, T.input_mask(lens, T_in), [int(v) for v in rng.integers(0, 2**31, B)],
               steps, tag, per_step=False)
    check(r["max_abs_err"] <= 1e-3, f"decoder {tag}: max|d| {r['max_abs_err']:.3e} > 1e-3")
    return r


def k2_cases(params, tcfg, dev, rng) -> None:
    """The serve buckets, one batch beyond the grid's rows (row groups), a
    long input; then K2's us/step by batch and input length."""
    import torch

    from tacotronv2_wavernn_chinese_tpu_torch.ops import tacotron_decoder_kernel as DK

    V = 2 * tcfg.encoder_lstm_units
    clusters = DK.card_clusters(dev)
    for B in (1, 2, 4, 8, 16):
        k2_case(params, tcfg, dev, rng, B, 64, 150, f"serve bucket B={B} T_in=64")
    B = DK.CLUSTER * clusters + 3
    group = DK.rows_per_launch(64, DK.widths(tcfg, V), clusters)
    k2_case(params, tcfg, dev, rng, B, 64, 40, f"beyond the grid's rows B={B} T_in=64 ({len(DK.row_groups(B, group))} "
            f"launches of at most {group} rows)")
    k2_case(params, tcfg, dev, rng, 2, 2048, 100, "long input B=2 T_in=2048")
    parts = []
    for B in (1, 4, 16):
        for T_in in (32, 256, 1024):
            memory = torch.as_tensor(rng.uniform(-1, 1, (B, T_in, V)), dtype=torch.float32, device=dev)
            mask = torch.ones(B, T_in, device=dev)
            ms = cuda_ms(lambda: DK.decode_autoregressive_kernel(params, tcfg, memory, mask, list(range(B)), 150),
                         warmup=True)
            parts.append(f"B={B} T_in={T_in} {ms / 150 * 1e3:.1f}")
    phase("decoder", "K2 scaling (150 steps, stop bias -30, us/step): " + ", ".join(parts))


# ---------------------------------------------------------------------------
# K2's other branches: anti-repeat, smoothing, LSA and its window, r = 2-6,
# GMM and Graves
# ---------------------------------------------------------------------------

# (name, config overrides): together they launch every instantiation the
# wrapper picks (csrc/tacotron_decode.cu k2_kernel); the default branch is
# the decoder phase's
K2_BRANCHES = (
    ("anti_repeat", {"anti_repeat": True}),
    ("smoothing", {"smoothing": True}),
    ("anti_repeat_smoothing", {"anti_repeat": True, "smoothing": True}),
    ("lsa", {"attention_mode": "lsa"}),
    ("lsa_not_cumulative", {"attention_mode": "lsa", "cumulative_weights": False}),
    ("lsa_smoothing", {"attention_mode": "lsa", "smoothing": True}),
    ("lsa_window_monotonic", {"attention_mode": "lsa", "synthesis_constraint": True, "anti_repeat": True}),
    ("lsa_window_smoothing", {"attention_mode": "lsa", "synthesis_constraint": True, "smoothing": True,
                              "synthesis_window": 4}),
    ("r2", {"outputs_per_step": 2}),
    ("r3", {"outputs_per_step": 3}),
    ("r6_stop_all", {"outputs_per_step": 6, "stop_at_any": False}),
    ("r2_anti_repeat", {"outputs_per_step": 2, "anti_repeat": True}),
    ("gmm", {"attention_mode": "gmm"}),
    ("graves", {"attention_mode": "graves"}),
    ("graves_r3_stop_all", {"attention_mode": "graves", "outputs_per_step": 3, "stop_at_any": False}),
)
# GMM and Graves at the TPU kernel's widest mixture, once each (B=4, T_in=256)
K2_WIDE = (
    ("gmm_128_mixtures", {"attention_mode": "gmm", "num_attn_mixtures": 128}),
    ("graves_128_heads", {"attention_mode": "graves", "graves_heads": 128}),
)
MIN_TRAVEL = 10  # positions GMM's and Graves' plain alignment argmax must move at T_in=256
NEAR_TIE = 1e-5  # a plain argmax whose top-2 gap is below this share of the top may go the other way
MAX_DIVERGED = 2  # rows of one branch, over all its runs, that may use the near-tie allowance


def uses_argmax(tcfg) -> bool:
    """Whether the decode's trajectory follows an argmax of the alignment."""
    return (tcfg.attention_mode == "forward" and tcfg.anti_repeat) or (
        tcfg.attention_mode == "lsa" and tcfg.synthesis_constraint)


class ArgmaxGaps:
    """Records each row's top-2 gap relative to its top value at each call
    of the plain attention's argmax (once per decoder step)."""

    def __enter__(self):
        import torch

        from tacotronv2_wavernn_chinese_tpu_torch.models import attention as ATT

        self.gaps, self._orig = [], ATT.argmax_first

        def wrapped(x):
            top = torch.topk(x, 2, dim=-1).values
            self.gaps.append(((top[:, 0] - top[:, 1]) / top[:, 0].abs().clamp_min(1e-30)).cpu())
            return self._orig(x)

        ATT.argmax_first = wrapped
        return self

    def __exit__(self, *exc):
        from tacotronv2_wavernn_chinese_tpu_torch.models import attention as ATT

        ATT.argmax_first = self._orig


def run_k2_branch(params, tcfg, memory, mask, seeds, max_iters: int, tag: str) -> dict:
    """K2 against its plain version for one branch (the kernel's time the
    mean of five launches): every frame, stop logit and alignment of all
    max_iters steps within 1e-3, the fills after the grid's exit included,
    and stop lengths equal.  Where the trajectory follows an argmax
    (anti-repeat, the LSA window) a row may diverge at step t only when
    the plain decode's relative top-2 gap was below NEAR_TIE at step t
    (anti-repeat's argmax acts within its step) or t - 1 (the window's acts
    on the next); it is compared no further, and the other rows only up to
    the earlier of the two exits."""
    import torch

    from tacotronv2_wavernn_chinese_tpu_torch.ops import tacotron_decoder_kernel as DK

    r = tcfg.outputs_per_step
    out = {}
    out["ms"] = cuda_ms(lambda: out.__setitem__(
        "k", DK.decode_autoregressive_kernel(params, tcfg, memory, mask, seeds, max_iters)), reps=5, warmup=True)
    with ArgmaxGaps() as rec:
        out["plain_ms"] = cuda_ms(lambda: out.__setitem__(
            "p", DK.decode_autoregressive_plain(params, tcfg, memory, mask, seeds, max_iters)))
    gaps = torch.stack(rec.gaps).numpy() if rec.gaps and uses_argmax(tcfg) else None  # [steps run, B]
    fk, sk, ak, lk = out["k"]
    fp, sp, ap, lp = out["p"]
    B = fk.shape[0]
    step_err = lambda a, b: (a - b).abs().reshape(B, max_iters, -1).amax(-1)
    err = torch.maximum(torch.maximum(step_err(fk, fp), step_err(ak, ap)), step_err(sk, sp)).cpu().numpy()
    lk, lp = lk.cpu().numpy(), lp.cpu().numpy()
    run = lambda lens: int(min(max_iters, int(lens.max()) // r + 1))  # steps until every row was done
    diverged = []
    for b in range(B):
        bad = np.nonzero(err[b] > 1e-3)[0]
        if bad.size and gaps is not None:
            t = int(bad[0])
            ties = [s for s in (t, t - 1) if 0 <= s < gaps.shape[0] and gaps[s, b] < NEAR_TIE]
            if ties:
                diverged.append((b, ties[0], t))
    n = min(run(lk), run(lp)) if diverged else max_iters
    worst = 0.0
    for b in range(B):
        upto = next((t for row, _, t in diverged if row == b), n)
        bad = np.nonzero(err[b, :upto] > 1e-3)[0]
        check(bad.size == 0, f"{tag}: row {b} max|d| {err[b, bad[0]] if bad.size else 0:.3e} > 1e-3 at step "
              f"{bad[0] if bad.size else -1} with no plain near-tie (relative top-2 gap < {NEAR_TIE}) there or "
              "one step before")
        if upto == n:
            check(lk[b] == lp[b], f"{tag}: row {b} stop length kernel {lk[b]} plain {lp[b]}")
        if upto:
            worst = max(worst, float(err[b, :upto].max()))
    out["max_abs_err"] = worst
    out["steps"] = run(lk)
    out["diverged"] = diverged
    out["stop_len"] = lp
    n_ties = int((gaps < NEAR_TIE).sum()) if gaps is not None else 0
    phase("k2 branches", f"{tag}: stop_len kernel {lk.tolist()} plain {lp.tolist()}; max|d| {worst:.2e}; "
          f"diverged rows (row, near-tie step, first step > 1e-3) {diverged}; {n_ties} plain near-ties; kernel "
          f"{out['ms']:.2f} ms ({out['ms'] / out['steps'] * 1e3:.1f} us/step over {out['steps']} steps), "
          f"plain {out['plain_ms']:.1f} ms")
    return out


def stop_thresholds(z: np.ndarray, r: int, stop_at_any: bool, steps: int, margin: float = 1e-4) -> dict:
    """Thresholds c for raw stop logits ``z`` [B, steps*r] (the stop bias
    left out), none within ``margin`` of a logit; a stop bias of -c then
    stops rows where their logits cross c.  "spread": the rows' stop steps
    differ most (at r > 1 first: the other stop rule gives other lengths;
    then more rows stop, the last later).  "exit": every row stops before
    80% of ``steps``, the last as late as it can, so the grid leaves the
    loop early.  A kind no threshold meets is left out."""
    import torch

    from tacotronv2_wavernn_chinese_tpu_torch.ops import tacotron_decoder_kernel as DK

    B = z.shape[0]
    g = z.reshape(B, steps, r)
    g = g.max(-1) if stop_at_any else g.min(-1)  # [B, steps]: the step's stop rule
    vals = np.unique(z.astype(np.float64))
    mids = (vals[1:] + vals[:-1]) / 2
    cands = mids[(vals[1:] - vals[:-1]) >= 2 * margin]
    best = {}
    for c in cands:
        fired = g > c
        hit = fired.any(-1)
        if not hit.any():
            continue
        at = np.where(hit, fired.argmax(-1), steps)  # each row's stop step
        keys = {"spread": (len(np.unique(at)), int(hit.sum()), int(at[hit].max()))}
        if r > 1:
            this, other = (DK.stop_lengths(torch.as_tensor(z - c), steps, r, rule).numpy()
                           for rule in (stop_at_any, not stop_at_any))
            keys["spread"] = (not np.array_equal(this, other),) + keys["spread"]
        if at.max() < int(0.8 * steps):
            keys["exit"] = (int(at.max()),)
        for kind, key in keys.items():
            if kind not in best or key > best[kind][0]:
                best[kind] = (key, float(c))
    return {kind: c for kind, (_, c) in best.items()}


def with_stop_bias(params, bias: float):
    import torch

    sp = params["stop_projection"]
    return dict(params, stop_projection=dict(sp, b=torch.full_like(sp["b"], bias)))


def run_k2_stops(params, tcfg, memory, mask, seeds, max_iters: int, tag: str, plain_stops):
    """The branch again, compared as in run_k2_branch, at each stop bias
    of ``stop_thresholds`` on the stop logits ``plain_stops`` [B,
    max_iters*r] of its run at bias -30: rows stop at steps of their own,
    and in the "exit" run every row does, so the grid leaves the loop
    early and its fills are compared.  A row must stop in every run.
    Returns the runs and whether the other stop rule would have given other
    lengths in one of them."""
    import torch

    from tacotronv2_wavernn_chinese_tpu_torch.ops import tacotron_decoder_kernel as DK

    r = tcfg.outputs_per_step
    z = plain_stops.cpu().numpy() + 30.0
    cs = stop_thresholds(z, r, tcfg.stop_at_any, max_iters)
    check("spread" in cs, f"{tag}: no stop bias stops a row before {max_iters} steps")
    kinds = {}
    for kind, c in sorted(cs.items(), reverse=True):
        kinds.setdefault(c, []).append(kind)
    runs, told_apart = [], False
    for c, names in kinds.items():
        kind = " and ".join(names)
        out = run_k2_branch(with_stop_bias(params, -c), tcfg, memory, mask, seeds, max_iters,
                            f"{tag} stop bias {-c:.5f} ({kind})")
        lens = out["stop_len"]
        check(bool((lens < max_iters * r).any()), f"{tag} ({kind}): no row stopped: {lens.tolist()}")
        if "exit" in kind:
            check(out["steps"] < max_iters, f"{tag} ({kind}): the grid ran all {max_iters} steps")
        other = DK.stop_lengths(torch.as_tensor(z - c), max_iters, r, not tcfg.stop_at_any).numpy()
        told_apart |= not np.array_equal(other, lens)
        phase("k2 branches", f"{tag} ({kind}): rows stop at frames {lens.tolist()} ({int((lens % r != 0).sum())} "
              f"inside a step's r frames), the grid after {out['steps']} of {max_iters} steps; the "
              f"{'all' if tcfg.stop_at_any else 'any'} rule would give {other.tolist()}")
        runs.append(out)
    return runs, told_apart


def k2_branch_inputs(params, tcfg, dev, rng, B: int, T_in: int):
    """Encoded random ids with ragged lengths (the longest row fills T_in)
    and random seeds."""
    import torch

    from tacotronv2_wavernn_chinese_tpu_torch.models import tacotron as T

    ids = torch.as_tensor(rng.integers(1, tcfg.vocab_size, (B, T_in)), device=dev)
    lens = torch.as_tensor(np.linspace(T_in, max(1, T_in // 3), B).astype(int), device=dev)
    memory = T.encode(params, tcfg, ids, lens)
    return memory, T.input_mask(lens, T_in), [int(v) for v in rng.integers(0, 2**31, B)]


def argmax_travel(tag: str, aligns) -> list:
    """Positions the plain alignment's argmax [B, steps, T_in] spans in
    each row over the compared steps; each must be at least MIN_TRAVEL, or
    the comparison of a mixture branch says little (its mixture may have
    left the input and gone flat)."""
    am = aligns.argmax(-1).cpu().numpy()
    travel = (am.max(1) - am.min(1)).tolist()
    check(min(travel) >= MIN_TRAVEL, f"{tag}: the plain alignment's argmax moved {travel} positions, fewer "
          f"than {MIN_TRAVEL}")
    phase("k2 branches", f"{tag}: the plain alignment's argmax spans {travel} positions")
    return travel


def run_k2_branches(cfg, dev, rng, wp, steps: int = SERVE_FRAMES, shapes=((4, 32), (5, 37), (2, 256))) -> list:
    """Each branch of K2 at full width against the plain version, at the
    first of ``shapes`` for ``steps`` steps (timed) and at the others for
    40 (the ragged B=5, T_in=37 splits a row over two blocks, T_in=256 over
    eight), each at stop bias -30 (no row stops) and again at the stop
    biases of ``run_k2_stops`` (rows stop, the grid leaves the loop early);
    GMM's and Graves' alignments must travel at the last shape
    (``argmax_travel``); then each branch's text->mel through a Synthesizer
    with the launch counter read around it, one /generate_tts request each
    through an r=2 anti-repeat and a Graves artifact that stop, and GMM
    and Graves at 128 mixtures or heads (K2_WIDE) at B=4, T_in=256.
    Returns the kernels-line entries."""
    import dataclasses

    from tacotronv2_wavernn_chinese_tpu_torch import ops
    from tacotronv2_wavernn_chinese_tpu_torch.infer.synthesizer import Synthesizer
    from tacotronv2_wavernn_chinese_tpu_torch.ops import tacotron_decoder_kernel as DK
    from tacotronv2_wavernn_chinese_tpu_torch.utils.checkpoints import init_tacotron

    entries = []
    clusters = DK.card_clusters(dev)
    text = SENTENCES[0]
    for i, (name, over) in enumerate(K2_BRANCHES):
        bcfg = dataclasses.replace(cfg, tacotron=dataclasses.replace(cfg.tacotron, **over))
        tcfg, r = bcfg.tacotron, bcfg.tacotron.outputs_per_step
        tp = with_stop_bias(init_tacotron(20 + i, tcfg, device=dev), -30.0)
        runs, told_apart = [], False
        for j, (B, T_in) in enumerate(shapes):
            mem, mask, seeds = k2_branch_inputs(tp, tcfg, dev, rng, B, T_in)
            n_steps, tag = steps if j == 0 else 40, f"{name} B={B} T_in={T_in}"
            runs.append(run_k2_branch(tp, tcfg, mem, mask, seeds, n_steps, tag))
            if tcfg.attention_mode in ("gmm", "graves") and T_in == shapes[-1][1]:
                argmax_travel(tag, runs[-1]["p"][2])
            stop_runs, told = run_k2_stops(tp, tcfg, mem, mask, seeds, n_steps, tag, runs[-1]["p"][1])
            runs += stop_runs
            told_apart |= told
        # the stop runs must tell "all of the r flags" from "any"
        check(r == 1 or tcfg.stop_at_any or told_apart,
              f"k2 branches {name}: the any and all stop rules gave the same lengths in every stop run")
        n_div = sum(len(x["diverged"]) for x in runs)
        check(n_div <= MAX_DIVERGED, f"k2 branches {name}: {n_div} rows diverged at near-ties, more than "
              f"{MAX_DIVERGED}")
        main = runs[0]
        B, T_in = shapes[0]
        plan = DK.k2_plan(B, T_in, DK.widths(tcfg, 2 * tcfg.encoder_lstm_units), clusters, **DK.branch(tcfg))
        bms, by = bound(*decoder_work(tcfg, B, T_in, 2 * tcfg.encoder_lstm_units, main["steps"], steps))
        # the branch's main path: text -> mel through a Synthesizer, SERVE_FRAMES frames
        synth = Synthesizer(bcfg, tp, max_iters=SERVE_FRAMES // r, device=dev)
        ops.reset_launch_counts()
        mel, _, _ = synth.text_to_mel(text)
        launches = ops.LAUNCHES["tacotron_decode"]
        check(launches >= 1, f"k2 branches {name}: text->mel launched the decode kernel {launches} times")
        check(mel.shape == (SERVE_FRAMES // r * r, 80) and np.isfinite(mel).all(),
              f"k2 branches {name}: mel {mel.shape}, finite {np.isfinite(mel).all()}")
        phase("k2 branches", f"{name}: text->mel {mel.shape[0]} frames, {launches} decode launches; variant "
              f"{DK.k2_variant(tcfg)}, plan {plan.clusters} clusters, {plan.NP} projection outputs on chip, "
              f"{plan.NX} from L2, {plan.smem_bytes()} bytes of shared memory")
        entries.append({
            "name": f"tacotron_decode/{name}", "route": "cuda",
            "source": "tacotronv2_wavernn_chinese_tpu_torch/csrc/tacotron_decode.cu",
            "replaces": "tacotronv2_wavernn_chinese_tpu/ops/tacotron_decoder_kernel.py:627",
            "launches": launches, "max_abs_err": max(x["max_abs_err"] for x in runs),
            "ms": main["ms"], "plain_ms": main["plain_ms"], "bound_ms": bms, "bound_by": by, "library_ms": None,
            "shape": f"B={B} T_in={T_in} steps={main['steps']} r={r}", "variant": DK.k2_variant(tcfg),
            "diverged_rows": n_div, "stop_runs": len(runs) - len(shapes), "smem_bytes": plan.smem_bytes(),
        })
        if name in ("r2_anti_repeat", "graves"):
            entries[-1]["launches"] = serve_branch(bcfg, tp, wp, dev, text, name)
    # GMM and Graves at 128 mixtures or heads: once, against the plain version
    for i, (name, over) in enumerate(K2_WIDE):
        tcfg = dataclasses.replace(cfg.tacotron, **over)
        tp = with_stop_bias(init_tacotron(40 + i, tcfg, device=dev), -30.0)
        B, T_in = 4, 256
        mem, mask, seeds = k2_branch_inputs(tp, tcfg, dev, rng, B, T_in)
        out = run_k2_branch(tp, tcfg, mem, mask, seeds, 40, f"{name} B={B} T_in={T_in}")
        check(out["max_abs_err"] <= 1e-3 and not out["diverged"], f"k2 branches {name}: {out['max_abs_err']:.3e}")
        argmax_travel(f"{name} B={B} T_in={T_in}", out["p"][2])
        plan = DK.k2_plan(B, T_in, DK.widths(tcfg, 2 * tcfg.encoder_lstm_units), clusters, **DK.branch(tcfg))
        bms, _ = bound(*decoder_work(tcfg, B, T_in, 2 * tcfg.encoder_lstm_units, out["steps"], 40))
        dense = f", gmm_layer {'on chip' if plan.res else 'from L2'}" if tcfg.attention_mode == "gmm" else ""
        phase("k2 branches", f"{name}: variant {DK.k2_variant(tcfg)}, {plan.smem_bytes()} bytes of shared memory"
              f"{dense}; bound {bms:.4f} ms")
    return entries


def serve_branch(cfg, tp, wp, dev, text: str, name: str) -> int:
    """One /generate_tts request through an artifact of ``cfg`` (the
    branch ``name``) whose stop bias is set near the threshold of the
    sentence's stop logits, so that the decode stops before max_iters: the
    WAV must hold exactly stop_len x 275 samples, stop_len the plain
    decode's.  Returns the decode kernel's launches during the request."""
    import torch

    from tacotronv2_wavernn_chinese_tpu_torch import ops
    from tacotronv2_wavernn_chinese_tpu_torch.frontend import default_symbols, get_pyin
    from tacotronv2_wavernn_chinese_tpu_torch.ops import tacotron_decoder_kernel as DK
    from tacotronv2_wavernn_chinese_tpu_torch.serving import server as SRV
    from tacotronv2_wavernn_chinese_tpu_torch.serving.export import load_exported, write_artifact

    tcfg, seed = cfg.tacotron, 4
    r, steps = tcfg.outputs_per_step, SERVE_FRAMES // tcfg.outputs_per_step
    ids = default_symbols().encode(get_pyin(text)[0])
    mem, mask = encode_batch(tp, tcfg, [ids], dev)
    z = DK.decode_autoregressive_plain(tp, tcfg, mem, mask, [seed], steps)[1].cpu().numpy() + 30.0
    cs = stop_thresholds(z, r, tcfg.stop_at_any, steps)
    check("exit" in cs, f"k2 branches serve: no stop bias stops the sentence before {steps} steps")
    tp = with_stop_bias(tp, -cs["exit"])
    want = int(DK.decode_autoregressive_plain(tp, tcfg, mem, mask, [seed], steps)[3][0])
    check(0 < want < steps * r, f"k2 branches serve: the plain decode stopped at frame {want} of {steps * r}")
    art = os.path.join(HERE, "build", f"chip_smoke_artifact_{name}")
    write_artifact(cfg, tp, art, wp)
    synth = load_exported(art, max_iters=steps, device=dev)
    httpd = SRV.serve(synth.cfg, synth, "127.0.0.1", 0, max_batch=4, max_queue=8)
    th = threading.Thread(target=httpd.serve_forever, daemon=True)
    th.start()
    try:
        req = urllib.request.Request(
            f"http://127.0.0.1:{httpd.server_address[1]}/generate_tts",
            data=json.dumps({"text": text, "seed": seed}).encode("utf-8"),
            headers={"Content-Type": "application/json"})
        ops.reset_launch_counts()
        h0 = time.time()
        with urllib.request.urlopen(req, timeout=600) as resp:
            body = json.loads(resp.read())
        torch.cuda.synchronize()
        host_ms = (time.time() - h0) * 1e3
        launches = dict(ops.LAUNCHES)
    finally:
        httpd.shutdown()
        httpd.server_close()
        th.join(timeout=30)
    check(body.get("status") == 0, f"k2 branches serve: /generate_tts failed: {body.get('error')}")
    with wave.open(io.BytesIO(base64.b64decode(body["wav_b64"]))) as wf:
        n = wf.getnframes()
        check(wf.getframerate() == 22050 and wf.getsampwidth() == 2, "k2 branches serve: bad WAV header")
    check(n == want * 275, f"k2 branches serve: {n} samples, expected the plain stop_len {want} x 275")
    check(launches["tacotron_decode"] >= 1 and launches["wavernn_sample"] >= 1,
          f"k2 branches serve: launches {launches}")
    phase("k2 branches", f"/generate_tts through a {name} artifact (r={r}): {host_ms:.1f} ms host, stop_len "
          f"{want} of {steps * r} frames, {n} samples, launches {launches}")
    return launches["tacotron_decode"]


# ---------------------------------------------------------------------------
# K3/K4: the teacher-forced decoder core of training
# ---------------------------------------------------------------------------

# the core's parameter leaves, whose gradients K4 (with the products after
# it) must give
CORE_LEAVES = (
    ("dec_lstm1", "w"), ("dec_lstm1", "b"), ("dec_lstm2", "w"), ("dec_lstm2", "b"),
    ("attention", "query_layer", "w"), ("attention", "location_conv", "w"),
    ("attention", "location_conv", "b"), ("attention", "location_layer", "w"),
    ("attention", "v"), ("attention", "b"), ("attention", "mu_layer", "w"),
    ("attention", "mu_layer", "b"),
)


def core_inputs(params, tcfg, B: int, T: int, T_in: int, dev, seed: int) -> dict:
    """Inputs of the core at the given shape from a numpy seed: values in
    (-1, 1) like the encoder's LSTM outputs, keys projected from them,
    ragged lengths, non-negative prenet outputs, zoneout keep-masks
    (keep 0.9) and random cotangents."""
    import torch

    from tacotronv2_wavernn_chinese_tpu_torch.ops import tacotron_trainer_kernel as TK

    P, U, V, A, _, _ = TK.widths(tcfg)
    rng = np.random.default_rng(seed)
    f = lambda lo, hi, *s: torch.as_tensor(rng.uniform(lo, hi, s), dtype=torch.float32, device=dev)
    lens = np.linspace(T_in, max(1, T_in // 4), B).astype(int)
    mask = (np.arange(T_in)[None, :] < lens[:, None]).astype(np.float32)
    values = f(-1, 1, B, T_in, V) * torch.as_tensor(mask, device=dev)[..., None]
    return {
        "pre": f(0, 2, T, B, P), "values": values,
        "keys": (values @ params["attention"]["memory_layer"]["w"]).contiguous(),
        "mask": torch.as_tensor(mask, device=dev),
        "masks": tuple(torch.as_tensor((rng.uniform(size=(T, B, U)) < 0.9).astype(np.float32), device=dev)
                       for _ in range(4)),
        "cots": (f(-1, 1, T, B, U), f(-1, 1, T, B, V), f(-1, 1, T, B, T_in)),
    }


def _core_vjp(fn, params, tcfg, x):
    """Outputs of ``fn`` (fused_core_apply or fused_core_plain) and the
    gradients of sum(outputs * cotangents) w.r.t. the prenet input, keys,
    values and every core parameter leaf."""
    import torch

    ps = dict(params)
    leaves = {}
    for path in CORE_LEAVES:
        node = ps
        for k in path[:-1]:
            node[k] = dict(node[k])
            node = node[k]
        node[path[-1]] = leaves[path] = node[path[-1]].detach().clone().requires_grad_(True)
    xs = {k: x[k].detach().clone().requires_grad_(True) for k in ("pre", "keys", "values")}
    outs = fn(ps, tcfg, xs["pre"], x["masks"], xs["keys"], xs["values"], x["mask"])
    loss = sum((o * c).sum() for o, c in zip(outs, x["cots"]))
    names = ["pre", "keys", "values"] + ["/".join(p) for p in CORE_LEAVES]
    grads = torch.autograd.grad(loss, [xs["pre"], xs["keys"], xs["values"], *leaves.values()])
    return [o.detach() for o in outs], dict(zip(names, grads))


def run_k34(params, tcfg, x, tag: str) -> dict:
    """K3 and K4 against the eager loop differentiated by autograd, at the
    shape of ``x``: errors of every output and gradient, kernel and plain
    times by CUDA events."""
    import torch

    from tacotronv2_wavernn_chinese_tpu_torch.ops import tacotron_trainer_kernel as TK

    T, B, _ = x["pre"].shape
    T_in = x["keys"].shape[1]
    ok, gk = _core_vjp(TK.fused_core_apply, params, tcfg, x)
    op, gp = _core_vjp(TK.fused_core_plain, params, tcfg, x)
    out = {"T": T, "B": B, "T_in": T_in}
    d_out = {n: float((a - b).abs().max()) for n, a, b in zip(("out2", "ctx", "align"), ok, op)}
    phase("train", f"{tag}: K3 max|d| " + ", ".join(f"{n} {v:.2e}" for n, v in d_out.items()))
    check(max(d_out.values()) <= 1e-3, f"{tag}: K3 output max|d| {max(d_out.values()):.3e} > 1e-3")
    rel = {}
    for n in gk:
        d, scale = float((gk[n] - gp[n]).abs().max()), float(gp[n].abs().max())
        rel[n] = (d, scale)
    phase("train", f"{tag}: K4 gradient max|d| / max|g| " + ", ".join(
        f"{n} {d:.2e}/{g:.2e}" for n, (d, g) in rel.items()))
    for n, (d, g) in rel.items():
        check(d <= 1e-3 * max(g, 1e-6), f"{tag}: K4 gradient {n} max|d| {d:.3e} > 1e-3 * max|g| {g:.3e}")
    out["k3_err"] = max(d_out.values())
    out["k4_err"] = max(d for d, _ in rel.values())
    out["k4_rel"] = max(d / max(g, 1e-6) for d, g in rel.values())
    # times: each kernel alone, and its plain version (the eager loop's
    # forward; autograd's backward through it)
    w = TK.pack_core_weights(params, tcfg)
    args = (w, x["pre"], x["masks"], x["keys"], x["values"], x["mask"], float(tcfg.zoneout_rate))
    box = {}
    out["k3_ms"] = cuda_ms(lambda: box.__setitem__("f", TK.train_fwd(*args)), warmup=True)
    out["k4_ms"] = cuda_ms(lambda: TK.train_bwd(*args, box["f"], list(x["cots"])), warmup=True)
    with torch.no_grad():
        out["k3_plain_ms"] = cuda_ms(lambda: TK.fused_core_plain(
            params, tcfg, x["pre"], x["masks"], x["keys"], x["values"], x["mask"]))
    xs = {k: x[k].detach().clone().requires_grad_(True) for k in ("pre", "keys", "values")}
    outs = TK.fused_core_plain(params, tcfg, xs["pre"], x["masks"], xs["keys"], xs["values"], x["mask"])
    loss = sum((o * c).sum() for o, c in zip(outs, x["cots"]))
    out["k4_plain_ms"] = cuda_ms(lambda: torch.autograd.grad(loss, list(xs.values())))
    plan = TK.k34_plan(B, T_in, TK.widths(tcfg), TK.card_clusters(x["pre"].device))
    out["blocks"], out["clusters"] = plan.blocks, plan.clusters
    phase("train", f"{tag}: K3 {out['k3_ms']:.2f} ms ({out['k3_ms'] / T * 1e3:.1f} us/step), plain "
          f"{out['k3_plain_ms']:.1f} ms; K4 {out['k4_ms']:.2f} ms ({out['k4_ms'] / T * 1e3:.1f} us/step), "
          f"plain backward {out['k4_plain_ms']:.1f} ms; grid {plan.clusters} clusters x {TK.CLUSTER} blocks, "
          f"{plan.blocks_per_row} blocks per row, {plan.positions} positions per block, shared memory "
          f"{plan.smem_bytes('fwd')} / {plan.smem_bytes('bwd')} bytes")
    return out


def batch_scaling(params, tcfg, dev, batches, T: int, T_in: int) -> str:
    """K3 and K4 us/step at each batch size (kernels alone, CUDA events):
    every block holds its weight slices for all rows, so the products grow
    with B while the attention spreads over fewer blocks per row."""
    from tacotronv2_wavernn_chinese_tpu_torch.ops import tacotron_trainer_kernel as TK

    w = TK.pack_core_weights(params, tcfg)
    parts = []
    for B in batches:
        x = core_inputs(params, tcfg, B, T, T_in, dev, 40 + B)
        args = (w, x["pre"], x["masks"], x["keys"], x["values"], x["mask"], float(tcfg.zoneout_rate))
        box = {}
        k3 = cuda_ms(lambda: box.__setitem__("f", TK.train_fwd(*args)), warmup=True)
        k4 = cuda_ms(lambda: TK.train_bwd(*args, box["f"], list(x["cots"])), warmup=True)
        parts.append(f"B={B} K3 {k3 / T * 1e3:.1f} K4 {k4 / T * 1e3:.1f} us/step")
    return ", ".join(parts)


class EventHooks:
    """Wraps module functions so each call records CUDA events around
    itself (for one step's split); ``restore`` puts the originals back."""

    def __init__(self):
        self.marks: dict = {}
        self._orig: list = []

    def wrap(self, module, name: str):
        import torch

        orig = getattr(module, name)

        def wrapped(*a, **kw):
            e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            e0.record()
            r = orig(*a, **kw)
            e1.record()
            self.marks.setdefault(name, []).append((e0, e1))
            return r

        setattr(module, name, wrapped)
        self._orig.append((module, name, orig))

    def restore(self):
        for module, name, orig in reversed(self._orig):
            setattr(module, name, orig)
        self._orig.clear()


def step_split(cfg, state, batch, dev) -> dict:
    """One train step split by CUDA events: encoder + prenet, K3,
    projections + postnet + loss, K4, the weight-gradient products after
    K4, the rest of the backward, and the optimizer."""
    import torch

    from tacotronv2_wavernn_chinese_tpu_torch.ops import tacotron_trainer_kernel as TK
    from tacotronv2_wavernn_chinese_tpu_torch.train import tacotron_task as task

    hooks = EventHooks()
    for module, name in ((TK, "train_fwd"), (TK, "train_bwd"), (TK, "weight_grads"),
                         (task, "loss_fn"), (task, "apply_gradients")):
        hooks.wrap(module, name)
    try:
        gen = torch.Generator(device=dev)
        res = {}
        for _ in range(2):  # the second call is reported
            hooks.marks.clear()
            gen.manual_seed(0)
            s0, s1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            torch.cuda.synchronize()
            s0.record()
            task.train_step(state, batch, gen, cfg)
            s1.record()
            torch.cuda.synchronize()
            m = {k: v[0] for k, v in hooks.marks.items()}
            ms = lambda a, b: a.elapsed_time(b)
            lf, k3, k4, wg, opt = (m[k] for k in ("loss_fn", "train_fwd", "train_bwd", "weight_grads",
                                                  "apply_gradients"))
            res = {
                "encoder_prenet": ms(lf[0], k3[0]), "k3": ms(*k3), "proj_postnet_loss": ms(k3[1], lf[1]),
                "k4": ms(*k4), "weight_grad_matmuls": ms(*wg),
                "rest_of_backward": ms(lf[1], opt[0]) - ms(*k4) - ms(*wg),
                "optimizer": ms(*opt), "step": ms(s0, s1),
            }
    finally:
        hooks.restore()
    return res


def run_train_phase(cfg, dev, core_shape, corpus: dict, steps: int, ckpt_every: int,
                    extra_batches=(1, 10, 64), scaling_batches=(1, 8, 32, 64)) -> dict:
    """(1) K3/K4 against the plain version at ``core_shape``; (2) the real
    trainer on a synthetic corpus, with launch counters, restore and one
    step's split.  Returns what the kernels line needs."""
    import torch

    from tacotronv2_wavernn_chinese_tpu_torch import ops
    from tacotronv2_wavernn_chinese_tpu_torch.data.loader import (
        TacotronDataset, read_metadata, write_synthetic_corpus,
    )
    from tacotronv2_wavernn_chinese_tpu_torch.train import tacotron_task as task
    from tacotronv2_wavernn_chinese_tpu_torch.train import tacotron_train as TR
    from tacotronv2_wavernn_chinese_tpu_torch.utils.checkpoints import init_tacotron
    from tacotronv2_wavernn_chinese_tpu_torch.utils.metrics import read_scalars

    tcfg = cfg.tacotron
    B, T_in, T = core_shape
    tp = init_tacotron(4, tcfg, device=dev)
    r1 = run_k34(tp, tcfg, core_inputs(tp, tcfg, B, T, T_in, dev, 21),
                 f"core B={B} T_in={T_in} T={T} train masks")
    # other batch sizes: one row (an eval render), a ragged grid, the most
    # rows per cluster; T bounded to keep the plain versions short
    for b_extra in extra_batches:
        run_k34(tp, tcfg, core_inputs(tp, tcfg, b_extra, min(T, 100), T_in, dev, 22 + b_extra),
                f"core B={b_extra} T_in={T_in} T={min(T, 100)} train masks")
    phase("train", f"batch scaling (T_in={SCALING_SHAPE[0]}, T={SCALING_SHAPE[1]}): "
          + batch_scaling(tp, tcfg, dev, scaling_batches, SCALING_SHAPE[1], SCALING_SHAPE[0]))

    tcfg_run = cfg.override(f"tacotron_train.checkpoint_interval={ckpt_every},tacotron_train.summary_interval=1")
    corpus_dir = os.path.join(HERE, "build", "chip_smoke_corpus")
    log_dir = os.path.join(HERE, "build", "chip_smoke_train")
    for d in (corpus_dir, log_dir):
        if os.path.isdir(d):
            shutil.rmtree(d)
    meta = write_synthetic_corpus(corpus_dir, corpus["utts"], corpus["symbols"], corpus["frames"], seed=5)
    logs: list = []

    def log(msg):
        logs.append(msg)
        phase("train", f"  | {msg}")

    ops.reset_launch_counts()
    t0 = time.time()
    state = TR.run_training(tcfg_run, meta, corpus_dir, log_dir, total_steps=steps, log=log, device=dev)
    torch.cuda.synchronize()
    wall = time.time() - t0
    launches = {k: ops.LAUNCHES[k] for k in ("tacotron_train_fwd", "tacotron_train_bwd")}
    renders = sum("eval render at step" in m for m in logs)
    phase("train", f"run_training: {state.step} steps in {wall:.1f} s wall (build, checkpoints and "
          f"renders included); launches {launches}; {renders} eval renders")
    check(state.step == steps, f"train: ended at step {state.step}, expected {steps}")
    check(not any("failed" in m for m in logs), "train: the eval render or the embedding dump failed")
    check(renders == steps // ckpt_every, f"train: {renders} eval renders, expected {steps // ckpt_every}")
    losses = [r["loss"] for r in read_scalars(os.path.join(log_dir, "scalars.jsonl"))]
    check(len(losses) == steps and all(np.isfinite(losses)), f"train: losses {losses}")
    phase("train", "losses " + ", ".join(f"{v:.4f}" for v in losses))
    check(launches["tacotron_train_bwd"] == steps, f"train: K4 launched {launches['tacotron_train_bwd']} "
          f"times in {steps} steps")
    check(launches["tacotron_train_fwd"] == steps + renders,
          f"train: K3 launched {launches['tacotron_train_fwd']} times for {steps} steps + {renders} renders")
    sec_step = [float(m.split("[")[1].split(" sec/step")[0]) for m in logs if m.startswith("Step")]
    phase("train", f"sec/step (run_training's rolling window, host clock): {sec_step[-1]:.3f}")

    logs.clear()
    state2 = TR.run_training(tcfg_run, meta, corpus_dir, log_dir, total_steps=steps + 1, log=log,
                             device=dev, render_eval=False)
    check(f"restored checkpoint at step {steps}" in logs, "train: the restart did not restore the checkpoint")
    check(state2.step == steps + 1, f"train: the restart ended at step {state2.step}")

    # one step split, on the first batch of the corpus
    ds = TacotronDataset(read_metadata(meta), corpus_dir, tcfg_run)
    b0 = next(ds.batches(epoch_seed=tcfg_run.tacotron_train.data_seed))
    batch = TR.batch_to_device(b0, dev)
    split = step_split(tcfg_run, task.TrainState(state2.step, state2.params, state2.opt_state), batch, dev)
    B_, T_in_ = b0.inputs.shape
    T_ = b0.mel_targets.shape[1] // tcfg.outputs_per_step
    phase("train", f"step split (CUDA events, B={B_} T_in={T_in_} T={T_}): "
          + ", ".join(f"{k} {v:.2f} ms" for k, v in split.items()))
    return {"core": r1, "launches": launches, "sec_per_step": sec_step[-1], "split": split,
            "main_shape": (B_, T_, T_in_), "params": state2.params}


# ---------------------------------------------------------------------------
# main
# ---------------------------------------------------------------------------


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    from tacotronv2_wavernn_chinese_tpu_torch.config import default_config

    # f32 matmuls and convolutions in full f32 (cuDNN would take TF32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    run_all(default_config(), torch.device("cuda"), SERVE_FRAMES)
    print(smi_line(), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


TRAIN_CORE_SHAPE = (32, 128, 400)  # B, T_in, T of the K3/K4 check
SCALING_SHAPE = (160, 200)  # T_in, T of the batch-scaling line
TRAIN_CORPUS = {"utts": 64, "symbols": (40, 150), "frames": (200, 600)}
TRAIN_STEPS, TRAIN_CKPT_EVERY = 6, 3


def run_all(cfg, dev, serve_frames: int, core_shape=TRAIN_CORE_SHAPE, corpus=TRAIN_CORPUS) -> dict:
    """Every phase on ``dev`` at the widths of ``cfg``; returns the kernels
    record.  Raises SmokeFailure on a failed check."""
    import torch

    from tacotronv2_wavernn_chinese_tpu_torch import ops
    from tacotronv2_wavernn_chinese_tpu_torch.frontend import default_symbols, get_pyin
    from tacotronv2_wavernn_chinese_tpu_torch.serving import server as SRV
    from tacotronv2_wavernn_chinese_tpu_torch.serving.export import load_exported, write_artifact
    from tacotronv2_wavernn_chinese_tpu_torch.utils.checkpoints import init_tacotron, init_wavernn

    t_start = time.time()
    smi = smi_line()
    phase("device", f"{smi}; torch {torch.__version__} cuda {torch.version.cuda}")

    t0 = time.time()
    ops.build_all()
    phase("build", f"nvcc built {ops.BUILD_INFO.get('built')} in {time.time() - t0:.1f} s "
          f"into {ops.BUILD_INFO.get('dir')}")
    for src, log in ops.BUILD_INFO.get("logs", {}).items():
        for name, regs, stores, loads in ptxas_entries(log):
            phase("build", f"{src}: {name}: {regs} registers, {stores} bytes spill stores, {loads} bytes spill loads")
            # the decode kernel's branches are held to no spills (K2 sits at the register limit)
            check(src != "tacotron_decode.cu" or stores + loads == 0, f"{src}: {name} spills")

    # ---------------- wavernn ----------------
    wcfg = cfg.wavernn
    wp = init_wavernn(1, wcfg, device=dev)
    rng = np.random.default_rng(11)
    mels = torch.as_tensor(rng.uniform(0.0, 1.0, (16, 8 + 2 * wcfg.pad, 80)), dtype=torch.float32, device=dev)
    for greedy in (True, False):
        run_k1(wp, wcfg, mels, 1234, greedy, "greedy" if greedy else "sampled")
    # a fold count that is not a multiple of 4: the kernel stages a zero fold
    mels_r = torch.as_tensor(rng.uniform(0.0, 1.0, (3, 3 + 2 * wcfg.pad, 80)), dtype=torch.float32, device=dev)
    run_k1(wp, wcfg, mels_r, 99, False, "ragged 3 folds")
    # fold scaling: every block reads every fold's activations, so a step
    # grows with the fold count
    scaling = []
    for n_f in (16, 64, 256):
        mels_f = torch.as_tensor(rng.uniform(0.0, 1.0, (n_f, 4 + 2 * wcfg.pad, 80)), dtype=torch.float32, device=dev)
        r = run_k1(wp, wcfg, mels_f, 7, True, f"scaling {n_f} folds", steps=1000)
        scaling.append(f"{n_f} folds {r['ms']:.1f} ms ({r['ms'] / r['T'] * 1e3:.1f} us/step)")
    phase("wavernn", "fold scaling, T=1000, greedy: " + ", ".join(scaling))

    # ---------------- decoder ----------------
    tcfg = cfg.tacotron  # dropout 0.5, zoneout 0.1: the serving defaults
    tp = init_tacotron(2, tcfg, device=dev)
    ids = rng.integers(1, tcfg.vocab_size, (3, 64))
    lens = torch.as_tensor([64, 50, 37], device=dev)
    from tacotronv2_wavernn_chinese_tpu_torch.models import tacotron as T

    inputs = torch.as_tensor(ids, device=dev)
    memory = T.encode(tp, tcfg, inputs, lens)
    mask = T.input_mask(lens, 64)
    seeds = [7, 8, 9]
    tp_long = dict(tp, stop_projection=dict(tp["stop_projection"], b=torch.full_like(tp["stop_projection"]["b"], -30.0)))
    r = run_k2(tp_long, tcfg, memory, mask, seeds, 200, "stop bias -30, 200 steps", per_step=True)
    check(r["max_abs_err"] <= 1e-3, f"decoder: max|d| {r['max_abs_err']:.3e} > 1e-3")
    run_k2(tp, tcfg, memory, mask, seeds, 200, "normal weights", per_step=False)
    # ragged shapes: 5 rows (two matvec passes of 4), T_in not a multiple of 4 or 32
    ids_r = torch.as_tensor(rng.integers(1, tcfg.vocab_size, (5, 37)), device=dev)
    lens_r = torch.as_tensor([37, 30, 21, 9, 1], device=dev)
    mem_r = T.encode(tp, tcfg, ids_r, lens_r)
    r = run_k2(tp_long, tcfg, mem_r, T.input_mask(lens_r, 37), [1, 2, 3, 4, 5], 40,
               "ragged B=5 T_in=37", per_step=False)
    check(r["max_abs_err"] <= 1e-3, f"decoder ragged: max|d| {r['max_abs_err']:.3e} > 1e-3")
    t_k2 = time.time()
    k2_cases(tp_long, tcfg, dev, rng)
    phase("decoder", f"K2 cases and scaling took {time.time() - t_k2:.1f} s")

    # ---------------- K2 branches ----------------
    t_br = time.time()
    branch_entries = run_k2_branches(cfg, dev, rng, wp)
    phase("k2 branches", f"took {time.time() - t_br:.1f} s")

    # ---------------- serve ----------------
    art = os.path.join(HERE, "build", "chip_smoke_artifact")
    write_artifact(cfg, tp_long, art, wp)
    synth = load_exported(art, max_iters=serve_frames, device=dev)
    httpd = SRV.serve(synth.cfg, synth, "127.0.0.1", 0, max_batch=4, max_queue=8)
    port = httpd.server_address[1]
    th = threading.Thread(target=httpd.serve_forever, daemon=True)
    th.start()
    try:
        t0 = time.time()
        SRV.warmup(synth, httpd.service.max_batch_hard)
        phase("serve", f"warmup (batch buckets up to {httpd.service.max_batch_hard}) "
              f"{time.time() - t0:.1f} s")
        res = synth.synthesize(SENTENCES[0], seed=3)
        check(np.isfinite(res["wav"]).all(), "serve: non-finite audio")
        check(res["wav"].shape[0] == serve_frames * 275, f"serve: wav length {res['wav'].shape[0]}")

        def post(path, payload):
            req = urllib.request.Request(
                f"http://127.0.0.1:{port}{path}", data=json.dumps(payload).encode("utf-8"),
                headers={"Content-Type": "application/json"},
            )
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            torch.cuda.synchronize()
            start.record()
            h0 = time.time()
            with urllib.request.urlopen(req, timeout=600) as resp:
                body = json.loads(resp.read())
            end.record()
            torch.cuda.synchronize()
            return body, (time.time() - h0) * 1e3, start.elapsed_time(end)

        def check_wav(b64: str, tag: str):
            with wave.open(io.BytesIO(base64.b64decode(b64))) as wf:
                check(wf.getnchannels() == 1 and wf.getsampwidth() == 2 and wf.getframerate() == 22050,
                      f"{tag}: bad WAV header")
                n = wf.getnframes()
                pcm = np.frombuffer(wf.readframes(n), "<i2")
            check(n == serve_frames * 275, f"{tag}: {n} samples, expected {serve_frames} x 275")
            check(np.abs(pcm).max() > 0, f"{tag}: silent audio")

        ops.reset_launch_counts()
        for i, text in enumerate(SENTENCES):
            body, host_ms, ev_ms = post("/generate_tts", {"text": text, "seed": i})
            check(body.get("status") == 0, f"serve: /generate_tts failed: {body.get('error')}")
            check_wav(body["wav_b64"], f"/generate_tts #{i}")
            phase("serve", f"/generate_tts #{i} ({body['pyin'][:40]}...): {host_ms:.1f} ms host, "
                  f"{ev_ms:.1f} ms CUDA events, {body['duration_s']:.2f} s audio")
        body, host_ms, ev_ms = post("/generate_tts_batch", {"texts": SENTENCES, "seed": 5})
        check(body.get("status") == 0, f"serve: /generate_tts_batch failed: {body.get('error')}")
        for j, r_ in enumerate(body["results"]):
            check_wav(r_["wav_b64"], f"/generate_tts_batch[{j}]")
        phase("serve", f"/generate_tts_batch x{len(SENTENCES)}: {host_ms:.1f} ms host, {ev_ms:.1f} ms CUDA events")
        launches = {k: ops.LAUNCHES[k] for k in ("wavernn_sample", "tacotron_decode")}
        phase("serve", f"kernel launches on the serve path: {launches}")
        # where one request's time goes: the acoustic decode vs the vocoder
        ids0 = synth.symbols.encode(get_pyin(SENTENCES[0])[0])
        box = {}
        from tacotronv2_wavernn_chinese_tpu_torch.ops import tacotron_decoder_kernel as DK

        hooks = EventHooks()
        for module, name in ((T, "encode"), (DK, "decode_autoregressive_kernel"), (T, "apply_postnet")):
            hooks.wrap(module, name)
        try:
            t_mel = cuda_ms(lambda: box.__setitem__("m", synth.mel_from_ids([ids0], seed=[0])))
            parts = {k: v[0][0].elapsed_time(v[0][1]) for k, v in hooks.marks.items()}
        finally:
            hooks.restore()
        t_voc = cuda_ms(lambda: synth.mels_to_wavs([box["m"][0][0]], seed=0))
        phase("serve", f"one request split (CUDA events): text->mel {t_mel:.1f} ms (encoder "
              f"{parts['encode']:.1f}, decode K2 {parts['decode_autoregressive_kernel']:.1f}, postnet "
              f"{parts['apply_postnet']:.1f}), mel->wav {t_voc:.1f} ms")
        for k, v in launches.items():
            check(v > 0, f"serve: kernel {k} was never launched on the serve path")
    finally:
        httpd.shutdown()
        httpd.server_close()
        th.join(timeout=30)

    # ---------------- train ----------------
    tr = run_train_phase(cfg, dev, core_shape, corpus, TRAIN_STEPS, TRAIN_CKPT_EVERY)

    # ---------------- kernels at the serve path's shapes ----------------
    from tacotronv2_wavernn_chinese_tpu_torch.models import wavernn as W

    sym = default_symbols()
    ids_list = [sym.encode(get_pyin(t)[0]) for t in SENTENCES]
    ids_list = ids_list + [ids_list[-1]]  # pad_batch: 3 rows -> 4
    mem_s, mask_s = encode_batch(synth.params, tcfg, ids_list, dev)
    k2 = run_k2(synth.params, tcfg, mem_s, mask_s, [5, 5, 5, 5], serve_frames,
                f"serve shape B={mem_s.shape[0]} T_in={mem_s.shape[1]}", per_step=False)
    check(k2["max_abs_err"] <= 1e-3, f"decoder at serve shape: max|d| {k2['max_abs_err']:.3e} > 1e-3")
    hop = wcfg.total_upsample
    gen = cfg.wavernn_gen
    mel = np.zeros((serve_frames, 80), np.float32)
    folds, n = W.fold_with_overlap(mel, gen.target // hop, gen.overlap // hop)
    n_folds = W.bucket_folds(np.concatenate([folds] * len(SENTENCES))).shape[0]
    mels_s = torch.as_tensor(
        rng.uniform(0.0, 1.0, (n_folds, folds.shape[1] + 2 * wcfg.pad, 80)), dtype=torch.float32, device=dev
    )
    # the serve phase already ran this kernel at this shape: no extra warmup
    k1 = run_k1(synth.vocoder_params, wcfg, mels_s, 5, False, f"serve shape {n_folds} folds", warmup=False)

    from tacotronv2_wavernn_chinese_tpu_torch.ops import wavernn_kernel as WK

    k1_plan = WK.choose_k1_plan(wcfg.rnn_dims, wcfg.fc_dims, synth.vocoder_params["fc3"]["w"].shape[1],
                                torch.cuda.get_device_properties(dev).multi_processor_count)
    f1, b1 = wavernn_work(wcfg, k1["T"], k1["B"])
    bms1, by1 = bound(f1, b1)
    k2_plan = DK.k2_plan(mem_s.shape[0], mem_s.shape[1], DK.widths(tcfg, mem_s.shape[2]), DK.card_clusters(dev))
    f2, b2 = decoder_work(tcfg, mem_s.shape[0], mem_s.shape[1], mem_s.shape[2], k2["steps"], serve_frames)
    bms2, by2 = bound(f2, b2)
    # K3/K4 at the train path's batch shape, on the trained weights
    Bm, Tm, Tim = tr["main_shape"]
    k34 = run_k34(tr["params"], tcfg, core_inputs(tr["params"], tcfg, Bm, Tm, Tim, dev, 33),
                  f"train shape B={Bm} T_in={Tim} T={Tm}")
    bms3, by3 = bound(*trainer_work(tcfg, Bm, Tm, Tim, backward=False, blocks=k34["blocks"]))
    bms4, by4 = bound(*trainer_work(tcfg, Bm, Tm, Tim, backward=True, blocks=k34["blocks"]))
    phase("kernels", f"K3 + K4 at the train shape: {k34['k3_ms'] + k34['k4_ms']:.2f} ms, bound "
          f"{bms3 + bms4:.3f} ms")
    kernels = {"kernels": [
        {"name": "wavernn_sample", "route": "cuda",
         "source": "tacotronv2_wavernn_chinese_tpu_torch/csrc/wavernn_sample.cu",
         "replaces": "tacotronv2_wavernn_chinese_tpu/ops/wavernn_kernel.py:234",
         "launches": launches["wavernn_sample"], "max_abs_err": k1["max_abs_err"],
         "ms": k1["ms"], "plain_ms": k1["plain_ms"], "bound_ms": bms1, "bound_by": by1,
         "library_ms": None, "compared_steps": k1["compared"], "uncompared_steps": k1["uncompared"],
         "diverged_folds": k1["diverged"], "grid_blocks": k1_plan.blocks, "fold_tile": k1_plan.fold_tile},
        {"name": "tacotron_decode", "route": "cuda",
         "source": "tacotronv2_wavernn_chinese_tpu_torch/csrc/tacotron_decode.cu",
         "replaces": "tacotronv2_wavernn_chinese_tpu/ops/tacotron_decoder_kernel.py:627",
         "launches": launches["tacotron_decode"], "max_abs_err": k2["max_abs_err"],
         "ms": k2["ms"], "plain_ms": k2["plain_ms"], "bound_ms": bms2, "bound_by": by2,
         "library_ms": None, "grid_blocks": k2_plan.blocks, "clusters": k2_plan.clusters},
        {"name": "tacotron_train_fwd", "route": "cuda",
         "source": "tacotronv2_wavernn_chinese_tpu_torch/csrc/tacotron_train_fwd.cu",
         "replaces": "tacotronv2_wavernn_chinese_tpu/ops/tacotron_trainer_kernel.py:689",
         "launches": tr["launches"]["tacotron_train_fwd"], "max_abs_err": k34["k3_err"],
         "ms": k34["k3_ms"], "plain_ms": k34["k3_plain_ms"], "bound_ms": bms3, "bound_by": by3,
         "library_ms": None, "grid_blocks": k34["blocks"], "clusters": k34["clusters"]},
        {"name": "tacotron_train_bwd", "route": "cuda",
         "source": "tacotronv2_wavernn_chinese_tpu_torch/csrc/tacotron_train_bwd.cu",
         "replaces": "tacotronv2_wavernn_chinese_tpu/ops/tacotron_trainer_kernel.py:761",
         "launches": tr["launches"]["tacotron_train_bwd"], "max_abs_err": k34["k4_err"],
         "max_rel_err": k34["k4_rel"],
         "ms": k34["k4_ms"], "plain_ms": k34["k4_plain_ms"], "bound_ms": bms4, "bound_by": by4,
         "library_ms": None, "grid_blocks": k34["blocks"], "clusters": k34["clusters"]},
        *branch_entries,
    ]}
    phase("kernels", f"shapes: K1 T={k1['T']} folds={k1['B']}; K2 B={mem_s.shape[0]} "
          f"T_in={mem_s.shape[1]} steps={k2['steps']}; K3/K4 B={Bm} T_in={Tim} T={Tm}; "
          f"total {time.time() - t_start:.1f} s")
    print(json.dumps(kernels), flush=True)
    return kernels


if __name__ == "__main__":
    try:
        code = main()
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr, flush=True)
        code = 1
    sys.exit(code)
