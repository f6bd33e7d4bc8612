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
  griffin-lim
           an artifact without WaveRNN weights served on localhost: warmup
           of every batch bucket, one /generate_tts and one 3-text
           /generate_tts_batch (WAVs of stop_len x 275 samples, /healthz
           "griffin_lim", K2 launched and K1 not); the card's Griffin-Lim
           (60 iterations) against the CPU's on the same mels and injected
           phase at B=1 and B=4; Griffin-Lim alone at B=1 x 192 and B=16 x
           1024 frames and one request's text->mel and mel->wav by CUDA
           events, the host inverse preemphasis by the host clock
  preprocess + gta
           a procedural corpus (32 formant-like utterances of 1-4 s, Biaobei
           layout) preprocessed on the card and on the CPU (equal rows and
           audio, mels within 1e-3); GTA at B=32 on the card (K3's eval
           branch, launch counter read around it) against the same GTA with
           the plain decoder core: equal labels, predicted mels within 1e-3;
           utterances per second of each
  cli      python -m ...infer.synthesize on the Griffin-Lim artifact's
           weights and ...infer.wavernn_gen on a .npy mel, each a subprocess
           on the card: exit code 0, WAV length, the kernel each launched
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
  wavernn train
           40 procedural utterances (seed 23) preprocessed and through GTA
           with the phase's Tacotron; run_training on that GTA output at the
           default width (RAW 10-bit, B=32, 1,375-sample windows) with the
           native loader, 6 steps with checkpoints and a listening test (K1)
           at 3 and 6, then a restart to step 7: native loader active,
           losses finite, each listening-test WAV of the test mel's frames x
           275 samples, K1 launched once per listening test; one RAW step on
           the card against the same step on the CPU (B=4, same weights and
           batch, the CPU's ReLUs pinned to the card's pattern), in float64
           (the same function: 1e-10) and in f32 (loss 1e-5, grad norm 1e-4,
           params 2e-6 where the gradients agree; the gradients within 4x
           the CPU's f32 distance from the float64 step on that pattern,
           at least 1e-5 of max|g|), and the card's step with TF32 on, which
           must miss that bound; the B=32 step
           split by CUDA events (forward, backward,
           optimizer) beside its operations bound; one MOL step at B=32
           (finite); MOL generation, 4 folds x 12100 samples timed, 2 folds x
           275 against the CPU with the same injected draws (1e-3), and a
           MOL WAV through the wavernn_gen CLI
  train configs
           Tacotron training in the configurations the trainer kernels do
           not take, on the eager step loop: LSA, GMM (5 mixtures), Graves
           (10 heads), forward attention with smoothing, scheduled sampling
           at a fixed ratio of 0.5; and the default configuration under
           mixed precision (K3/K4 on the bf16-rounded weights): two
           train_steps from one state each at the train phase's batch (B=32,
           T_in=160, T=608), losses finite, ms/step by CUDA events, K3/K4
           launches (0 on the eager route, one each a step under mixed
           precision); each step on the card against the CPU at B=4,
           T_in=32, T=64 with the same masks, the CPU's ReLUs pinned to
           the card's (loss 1e-5 relative, gradients 1e-3 of max|g|; mixed
           precision 1e-3 and 1e-2); GTA of 8
           utterances in one batch with an LSA model and with anti-repeat
           (the eager eval route, K3 not launched) against the CPU with the
           same prenet masks (1e-3);
           the server started with --ckpt-dir and --wavernn-ckpt-dir on the
           train phases' checkpoint directories answering one /generate_tts
           (WAV of stop_len x 275 samples)
  cbhg + variants
           the CBHG mel->linear head (tacotron.predict_linear): a full-width
           artifact with the head and WaveRNN weights served on localhost,
           one /generate_tts (WAV of stop_len x 275 samples, K2 and K1
           launched); the head on the request's postnet mel on the card in
           IEEE f32 against the CPU (1e-4 of max|linear|; TF32 must read
           farther) and alone by CUDA events at B=1 x the request's frames
           and B=16 x 1024; text->mel with and without the head; two
           train_steps with the head at the train phase's batch (B=32,
           T_in=160, T=608, seeded linear targets: losses and the linear
           term finite, K3/K4 one launch each a step) beside two without
           it; the head's step on the card against the CPU at B=4,
           T_in=32, T=64 with the same masks, the CPU's ReLUs pinned to the
           card's, in f32 and mixed precision (the train configs
           tolerances, the head's BN statistics 1e-5 / 1e-2); GTA of 8
           utterances with the head (K3 launched once); the DeepMind
           WaveRNN at hidden 896: loss and gradients at B=4, T=1,000 card
           against CPU (1e-5 relative, 1e-3 of max|g|), generation of 2 x
           2,000 samples with the same injected Gumbel draws (equal, a row
           diverging only after a CPU top-2 gap < 1e-5 of the top), us a
           sample
  parallel
           parallel/ at the default width: (i) a world of 1 over NCCL in
           this process, the data-parallel Tacotron step (B=32, T_in=160,
           T=608; K3/K4 once each) and WaveRNN step (B=32 x 1,375) against
           the plain steps, bit-equal where two plain steps are (else params
           2e-6, loss 1e-5 relative); (ii) two ranks spawned on the one card over
           gloo (NCCL takes one rank a card): the data-parallel Tacotron step
           at 16 + 16 rows with lengths uneven across the halves, at
           mask_decoder False and True, against the one-process step at 32
           rows with the same masks, the ranks' ReLUs pinned to its pattern
           (loss 1e-5 relative, gradients 1e-3 of max|g|, BN statistics
           1e-5 |x| + 1e-6; K3/K4 1/1 a rank); run_training over both ranks,
           two steps with a checkpoint each and a resume (rank 0 alone
           writes and logs); fold-sharded generation of a served mel (16
           folds, 8 a rank, K1 once a rank a call): greedy labels equal to
           one process but after a near-tie, sampled ones equal to one
           process at the rank-folded seed, the sharded crossfade within
           1e-4 of the host's; WaveRNN dp=1 x tp=2 at the default width on
           the unsharded step's ReLU pattern (loss 1e-4 relative, gradients
           within the wavernn train phase's f32 bound of the float64 step,
           the shards in place after two steps); each rank's ms by CUDA
           events (two ranks time-slice one card: no scaling figure)
  kernels  each kernel against its plain version again at the shapes the
           serve and train paths gave it: times, bounds, errors; one JSON
           line, with each kernel's launches on every path that ran it

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


def wavernn_train_work(cfg, B: int, seq_frames: int, n_out: int, num_mels: int = 80):
    """(flops, bytes) of one WaveRNN train step on B windows of
    ``seq_frames`` frames (seq_frames x hop samples): the forward's
    multiply-adds (MelResNet per frame, the upsample smoothing, then per
    sample I, both GRUs' input and hidden products, fc1-fc3), times 2 for
    flops and times 3 for forward + backward (the backward's two products
    per forward product); bytes: params, both Adam moments and the batch
    read, params and moments written (f32; activations are not counted)."""
    H, FC, C, pad = cfg.rnn_dims, cfg.fc_dims, cfg.compute_dims, cfg.pad
    aux, R = cfg.res_out_dims // 4, cfg.res_out_dims
    hop = cfg.total_upsample
    T = seq_frames * hop
    per_sample = ((1 + num_mels + aux) * H + 2 * H * 3 * H + (H + aux) * 3 * H + H * 3 * H
                  + (H + aux) * FC + (FC + aux) * FC + FC * n_out)
    per_frame = (2 * pad + 1) * num_mels * C + 2 * cfg.res_blocks * C * C + C * R
    smooth, length = 0, seq_frames + 2 * pad
    for s_ in cfg.upsample_factors:
        length *= s_
        smooth += length * num_mels * (2 * s_ + 1)
    macs = B * (T * per_sample + seq_frames * per_frame + smooth)
    n_params = ((1 + num_mels + aux) * H + H + 2 * (H * 3 * H + 3 * H) + (H + aux) * 3 * H + H * 3 * H
                + 6 * H + (H + aux) * FC + FC + (FC + aux) * FC + FC + FC * n_out + n_out
                + (2 * pad + 1) * num_mels * C + 2 * cfg.res_blocks * C * C + C * R + R
                + 4 * C * (2 * cfg.res_blocks + 1) + sum(2 * s_ + 1 for s_ in cfg.upsample_factors))
    nbytes = 4.0 * (6 * n_params + B * T * 2 + B * (seq_frames + 2 * pad) * num_mels)
    return 3 * 2.0 * macs, nbytes


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


def encoder_work(B: int, T_in: int, U: int, D: int, lengths, backward: bool):
    """(flops, bytes) of K5 (saving for a backward) or K6 at B rows padded to
    T_in, over the steps the rows' ``lengths`` need
    (ops/tacotron_encoder_kernel.py): the recurrent product h @ W_h (K5) or
    dz @ W_h^T (K6) of both directions; every input byte read once and every
    output byte written once (K5: zx, W_h, the keep-masks, the output and
    the saves; K6: the saves, the masks, the cotangent and dz)."""
    steps = float(sum(int(n) for n in lengths))
    macs = 2 * steps * U * 4 * U
    rows = B * T_in  # what the wrapper allocates and the kernels write or read
    masks = 4 * steps * U / 4.0  # bool keep-masks, in f32 words
    if not backward:
        nbytes = rows * 8 * U + 2 * U * 4 * U + masks + rows * 2 * U + rows * (8 * U + 6 * U)
    else:
        nbytes = 2 * U * 4 * U + masks + rows * (8 * U + 4 * U) + rows * 2 * U + rows * 8 * U
    return 2.0 * macs, 4.0 * nbytes


def encoder_inputs(dev, B: int, T_in: int, U: int, D: int, seed: int) -> dict:
    """K5/K6 inputs from a numpy seed: ragged lengths (the longest T_in),
    inputs in (-1, 1), weights at the init's scale, zoneout keep-masks
    (keep 0.9) and a random cotangent."""
    import torch

    rng = np.random.default_rng(seed)
    f = lambda *s, scale=1.0: torch.as_tensor(rng.uniform(-scale, scale, s), dtype=torch.float32, device=dev)
    lens = np.linspace(T_in, max(1, T_in // 3), B).astype(np.int64)
    layer = lambda: {"w": f(D + U, 4 * U, scale=1.0 / np.sqrt(D + U)), "b": f(4 * U, scale=0.1)}
    masks = [tuple(torch.as_tensor(rng.uniform(size=(T_in, B, U)) < 0.9, device=dev) for _ in range(2))
             for _ in range(2)]
    return {"x": f(B, T_in, D), "lengths": torch.as_tensor(lens, device=dev), "fw": layer(), "bw": layer(),
            "masks": masks, "cot": f(B, T_in, 2 * U)}


def _encoder_vjp(apply, x):
    import torch

    leaf = lambda t: t.detach().clone().requires_grad_(True)
    fw, bw, xs = {k: leaf(v) for k, v in x["fw"].items()}, {k: leaf(v) for k, v in x["bw"].items()}, leaf(x["x"])
    out = apply(fw, bw, xs, x["lengths"], 0.1, *x["masks"])
    grads = torch.autograd.grad((out * x["cot"]).sum(), [xs, fw["w"], fw["b"], bw["w"], bw["b"]])
    return out.detach(), dict(zip(("x", "fw/w", "fw/b", "bw/w", "bw/b"), grads))


def run_k56(dev, B: int, T_in: int, U: int, D: int, tag: str) -> dict:
    """K5 and K6 against the plain forward differentiated by autograd, at
    one shape in train mode: the output's and every gradient's error, each
    kernel's time alone, the products after K6, and the plain versions'
    times, by CUDA events."""
    import torch

    from tacotronv2_wavernn_chinese_tpu_torch.ops import tacotron_encoder_kernel as EK

    x = encoder_inputs(dev, B, T_in, U, D, 50 + B + T_in)
    ok, gk = _encoder_vjp(EK.bidirectional_lstm, x)
    op, gp = _encoder_vjp(EK.bidirectional_lstm_plain, x)
    out = {"B": B, "T_in": T_in, "k5_err": float((ok - op).abs().max())}
    rel = {n: (float((gk[n] - gp[n]).abs().max()), float(gp[n].abs().max())) for n in gp}
    out["k6_err"] = max(d for d, _ in rel.values())
    out["k6_rel"] = max(d / max(g, 1e-6) for d, g in rel.values())
    phase("encoder", f"{tag}: K5 output max|d| {out['k5_err']:.2e}; gradients max|d| / max|g| "
          + ", ".join(f"{n} {d:.2e}/{g:.2e}" for n, (d, g) in rel.items()))
    check(out["k5_err"] <= 1e-5, f"{tag}: K5 output max|d| {out['k5_err']:.3e} > 1e-5")
    for n, (d, g) in rel.items():
        check(d <= 1e-4 * max(g, 1e-6), f"{tag}: gradient {n} max|d| {d:.3e} > 1e-4 * max|g| {g:.3e}")
    D_ = x["x"].shape[-1]
    wx = torch.cat([x["fw"]["w"][:D_], x["bw"]["w"][:D_]], dim=1)
    wh = torch.stack([x["fw"]["w"][D_:], x["bw"]["w"][D_:]]).contiguous()
    zx = (x["x"] @ wx + torch.cat([x["fw"]["b"], x["bw"]["b"]])).contiguous()
    masks = tuple(m for pair in x["masks"] for m in pair)
    box = {}
    out["k5_ms"] = cuda_ms(lambda: box.__setitem__("f", EK.encoder_fwd(zx, wh, x["lengths"], masks, 0.1, True)),
                           reps=5, warmup=True)
    out["k5_eval_ms"] = cuda_ms(lambda: EK.encoder_fwd(zx, wh, x["lengths"], None, 0.1, False), reps=5, warmup=True)
    saves = box["f"][1]
    out["k6_ms"] = cuda_ms(lambda: box.__setitem__("dz", EK.encoder_bwd(wh, x["lengths"], masks, 0.1, saves,
                                                                         x["cot"])), reps=5, warmup=True)
    out["grads_ms"] = cuda_ms(lambda: EK.encoder_grads(x["x"], wx, wh, saves, box["dz"]), reps=5, warmup=True)
    with torch.no_grad():
        out["k5_plain_ms"] = cuda_ms(lambda: EK.encoder_fwd_plain(zx, wh, x["lengths"], masks, 0.1, True))
    out["k6_plain_ms"] = cuda_ms(lambda: EK.encoder_bwd_plain(wh, x["lengths"], masks, 0.1, saves, x["cot"]))
    plan = EK.enc_plan(B, U, EK.card_clusters(dev))
    out["clusters"], out["groups"], out["rows"] = 2 * plan.groups, plan.groups, plan.rows
    out["bound5"] = bound(*encoder_work(B, T_in, U, D, x["lengths"].tolist(), False))
    out["bound6"] = bound(*encoder_work(B, T_in, U, D, x["lengths"].tolist(), True))
    phase("encoder", f"{tag}: K5 {out['k5_ms']:.3f} ms ({out['k5_ms'] / T_in * 1e3:.2f} us/step; eval, no saves "
          f"{out['k5_eval_ms']:.3f}), bound {out['bound5'][0]:.4f} ms ({out['bound5'][1]}), plain "
          f"{out['k5_plain_ms']:.1f} ms; K6 {out['k6_ms']:.3f} ms ({out['k6_ms'] / T_in * 1e3:.2f} us/step), bound "
          f"{out['bound6'][0]:.4f} ms, plain {out['k6_plain_ms']:.1f} ms; products {out['grads_ms']:.3f} ms; "
          f"grid {2 * plan.groups} clusters x {EK.CLUSTER} blocks, {plan.rows} rows a group, shared memory "
          f"{plan.smem_bytes('fwd')} / {plan.smem_bytes('bwd')} bytes")
    return out


def encoder_entries(k56: list, ptxas_log: str, paths: dict) -> list:
    """The kernels line's K5 and K6 entries, one per ``run_k56`` shape:
    times, bounds, errors, each instantiation's registers and spill bytes
    (from ``ptxas_log``, keyed fwd1/fwd2/bwd1/bwd2 by rows / 4) and the
    launches of each path (``paths``: path -> launch counts, or for
    ``train_configs`` config -> launch counts)."""
    regs = {}
    for n, r, st, ld in ptxas_entries(ptxas_log):
        i = n.index("ILi") + 3
        regs[("bwd" if "bwd" in n else "fwd") + n[i]] = (r, st + ld)
    phase("kernels", "encoder kernels' registers / spill bytes by instantiation (rows / 4): "
          + ", ".join(f"{k} {r} / {sp}" for k, (r, sp) in sorted(regs.items())))
    out = []
    for key, kind in (("tacotron_encoder_fwd", "k5"), ("tacotron_encoder_bwd", "k6")):
        by_path = {}
        for path, counts in paths.items():
            if path == "train_configs":
                by_path[path] = sum(c[key] for c in counts.values())
            elif key in counts:
                by_path[path] = counts[key]
        for r in k56:
            b = r[f"bound{kind[1]}"]
            out.append({
                "name": key, "route": "cuda", "source": "tacotronv2_wavernn_chinese_tpu_torch/csrc/tacotron_encoder.cu",
                "replaces": None, "why": "the JAX encoder is a lax.scan; the eager loop launched ~20 ops a step",
                "shape": f"B={r['B']} T_in={r['T_in']}", "launches": by_path["train"],
                "max_abs_err": r[f"{kind}_err"], "ms": r[f"{kind}_ms"], "plain_ms": r[f"{kind}_plain_ms"],
                "bound_ms": b[0], "bound_by": b[1], "library_ms": None,
                "registers_spills": {k: v for k, v in regs.items() if k.startswith(key[-3:])},
                "launches_by_path": by_path, "clusters": r["clusters"], "rows": r["rows"],
                **({"products_ms": r["grads_ms"], "max_rel_err": r["k6_rel"]} if kind == "k6"
                   else {"eval_ms": r["k5_eval_ms"]})})
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


def traced_spans(fn) -> dict:
    """Run ``fn`` twice with the program's spans on (``utils.metrics``);
    the second run's spans by name (each name's first span)."""
    from tacotronv2_wavernn_chinese_tpu_torch.utils import metrics as M

    was = M.TRACER.on
    M.enable()
    try:
        for _ in range(2):  # the second run is reported
            M.drain()
            fn()
        spans = M.drain()
    finally:
        M.enable(was)
    out = {}
    for s in spans:
        out.setdefault(s["name"], s)
    return out


def span_ms(s: dict) -> float:
    """A span's device ms (its host ms in a rehearsal on the CPU, which has
    no device events)."""
    return s["dev_ms"] if "dev_ms" in s else (s["t1"] - s["t0"]) / 1e6


def dev_gap_ms(a: dict, b: dict, edge_a: str = "t0", edge_b: str = "t0") -> float:
    """Device-timeline ms between two span edges (host edges on the CPU)."""
    return (b.get("dev_" + edge_b, b[edge_b]) - a.get("dev_" + edge_a, a[edge_a])) / 1e6


def step_split(cfg, state, batch, dev) -> dict:
    """One train step split by the program's spans (CUDA events):
    encoder + prenet, K3, projections + postnet + loss, K4, the
    weight-gradient products after K4, the rest of the backward, and the
    optimizer."""
    import torch

    from tacotronv2_wavernn_chinese_tpu_torch.train import tacotron_task as task

    gen = torch.Generator(device=dev)

    def one():
        gen.manual_seed(0)
        task.train_step(state, batch, gen, cfg)

    s = traced_spans(one)
    fwd, k3, k4, wg, bwd, opt = (s[k] for k in ("train.forward", "k3", "k4", "train.weight_grads",
                                                "train.backward", "train.optimizer"))
    return {
        "encoder_prenet": dev_gap_ms(fwd, k3), "k3": span_ms(k3), "proj_postnet_loss": dev_gap_ms(k3, fwd, "t1", "t1"),
        "k4": span_ms(k4), "weight_grad_matmuls": span_ms(wg),
        "rest_of_backward": span_ms(bwd) - span_ms(k4) - span_ms(wg),
        "optimizer": span_ms(opt), "step": span_ms(s["train.step"]),
    }


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
    launches = {k: ops.LAUNCHES[k] for k in ("tacotron_train_fwd", "tacotron_train_bwd", *ENCODER_KEYS)}
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
    check(launches["tacotron_encoder_bwd"] == steps and launches["tacotron_encoder_fwd"] >= steps + renders,
          f"train: K5/K6 launched {launches['tacotron_encoder_fwd']}/{launches['tacotron_encoder_bwd']} times "
          f"for {steps} steps + {renders} renders")
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
            "main_shape": (B_, T_, T_in_), "params": state2.params, "batch": batch,
            "ckpt_dir": os.path.join(log_dir, "taco_pretrained")}


# ---------------------------------------------------------------------------
# HTTP helpers (the serve, k2 branches and griffin-lim phases)
# ---------------------------------------------------------------------------


def post(port: int, path: str, payload: dict):
    """POST JSON to the local server -> (body, host ms, CUDA-event ms)."""
    import torch

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


def check_wav(b64: str, tag: str, samples: int) -> None:
    """A mono 22050 Hz int16 WAV of exactly ``samples`` samples, not silent."""
    with wave.open(io.BytesIO(base64.b64decode(b64))) as wf:
        check(wf.getnchannels() == 1 and wf.getsampwidth() == 2 and wf.getframerate() == 22050,
              f"{tag}: bad WAV header")
        n = wf.getnframes()
        pcm = np.frombuffer(wf.readframes(n), "<i2")
    check(n == samples, f"{tag}: {n} samples, expected {samples}")
    check(np.abs(pcm).max() > 0, f"{tag}: silent audio")


def start_server(synth):
    from tacotronv2_wavernn_chinese_tpu_torch.serving import server as SRV

    httpd = SRV.serve(synth.cfg, synth, "127.0.0.1", 0, max_batch=4, max_queue=8)
    th = threading.Thread(target=httpd.serve_forever, daemon=True)
    th.start()
    return httpd, th


def stop_server(httpd, th) -> None:
    httpd.shutdown()
    httpd.server_close()
    th.join(timeout=30)


# ---------------------------------------------------------------------------
# Griffin-Lim serving
# ---------------------------------------------------------------------------


def griffin_lim_flops(B: int, T: int, n_fft: int, iters: int) -> float:
    """Operations of ``iters`` Griffin-Lim iterations over B x T frames: a
    real FFT and an inverse of n_fft points a frame and iteration, each
    taken as 2.5 n log2 n (the split-radix count for a real transform), one
    more inverse for the start, and ~20 operations a bin for the phase
    update, windowing and the normalized overlap-add."""
    import math

    bins = n_fft // 2 + 1
    per_frame = 2 * 2.5 * n_fft * math.log2(n_fft) + 20 * bins
    return float(B * T * ((iters + 0.5) * per_frame))


def run_griffin_lim(cfg, dev, tp, serve_frames: int, smi: str) -> dict:
    """An artifact without WaveRNN weights serves through Griffin-Lim on the
    card: warmup, one /generate_tts and one 3-text /generate_tts_batch with
    the launch counters read around them (K2 launched, K1 not); the card's
    Griffin-Lim against the CPU's on the same mels and injected phase at
    B=1 and at the 4-row bucket; times by CUDA events."""
    import importlib

    import torch

    from tacotronv2_wavernn_chinese_tpu_torch import ops
    from tacotronv2_wavernn_chinese_tpu_torch.dsp.spectrogram import MelPipeline
    from tacotronv2_wavernn_chinese_tpu_torch.frontend import get_pyin
    from tacotronv2_wavernn_chinese_tpu_torch.serving import server as SRV
    from tacotronv2_wavernn_chinese_tpu_torch.serving.export import load_exported, write_artifact
    from tacotronv2_wavernn_chinese_tpu_torch.utils import round_up

    GL = importlib.import_module("tacotronv2_wavernn_chinese_tpu_torch.dsp.griffin_lim")
    a = cfg.audio
    art = os.path.join(HERE, "build", "chip_smoke_gl_artifact")
    write_artifact(cfg, tp, art)
    synth = load_exported(art, max_iters=serve_frames, device=dev)
    check(synth.vocoder_params is None, "griffin-lim: the artifact loaded a vocoder")
    ids = [synth.symbols.encode(get_pyin(t)[0]) for t in SENTENCES]
    httpd, th = start_server(synth)
    port = httpd.server_address[1]
    try:
        t0 = time.time()
        SRV.warmup(synth, httpd.service.max_batch_hard)
        phase("griffin-lim", f"warmup (batch buckets up to {httpd.service.max_batch_hard}, Griffin-Lim "
              f"{a.griffin_lim_iters} iterations) {time.time() - t0:.1f} s")
        ops.reset_launch_counts()
        one, host1, ev1 = post(port, "/generate_tts", {"text": SENTENCES[0], "seed": 1})
        many, host3, ev3 = post(port, "/generate_tts_batch", {"texts": SENTENCES, "seed": 2})
        launches = dict(ops.LAUNCHES)
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/healthz", timeout=60) as r:
            health = json.loads(r.read())
    finally:
        stop_server(httpd, th)
    check(one.get("status") == 0, f"griffin-lim: /generate_tts failed: {one.get('error')}")
    check(many.get("status") == 0, f"griffin-lim: /generate_tts_batch failed: {many.get('error')}")
    check(health["vocoder"] == "griffin_lim", f"griffin-lim: /healthz says {health['vocoder']}")
    check(launches["tacotron_decode"] > 0, "griffin-lim: K2 was never launched on the Griffin-Lim path")
    check(launches["wavernn_sample"] == 0, "griffin-lim: K1 was launched on the Griffin-Lim path")
    # the stop lengths of the same rows, decoded again (the decode is
    # deterministic per seed)
    _, _, stop1 = synth.mel_from_ids(ids[:1], seed=[1])
    _, _, stops = synth.mel_from_ids(ids, seed=[2, 2, 2], pad_batch=True)
    check_wav(one["wav_b64"], "griffin-lim /generate_tts", stop1[0] * a.hop_size)
    for j, r_ in enumerate(many["results"]):
        check_wav(r_["wav_b64"], f"griffin-lim /generate_tts_batch[{j}]", stops[j] * a.hop_size)
    phase("griffin-lim", f"/generate_tts: {host1:.1f} ms host, {ev1:.1f} ms CUDA events, stop_len {stop1[0]}, "
          f"WAV {stop1[0]} x {a.hop_size} samples; /generate_tts_batch x3: {host3:.1f} ms host, {ev3:.1f} ms "
          f"CUDA events, stop_len {stops}; kernel launches {launches}; /healthz vocoder {health['vocoder']}")

    # the card against the CPU: same mels, same injected phase, 60 iterations
    mels, _, stops = synth.mel_from_ids(ids, seed=[0, 1, 2])
    T_pad = round_up(max(stops) + 1, 64)
    stacked = np.full((4, T_pad, a.num_mels), -a.max_abs_value, np.float32)
    for i, m in enumerate(mels + mels[-1:]):
        stacked[i, : m.shape[0]] = m
    rng = np.random.default_rng(5)
    ph = rng.uniform(0.0, 2.0 * np.pi, (T_pad, a.n_fft // 2 + 1)).astype(np.float32)
    pipe_cpu = MelPipeline(a, "cpu")
    errs = {}
    for B in (1, 4):
        with torch.no_grad():
            y_card = GL.inv_mel_spectrogram(stacked[:B], synth.pipe, phase=torch.as_tensor(ph, device=dev))
            y_cpu = GL.inv_mel_spectrogram(stacked[:B], pipe_cpu, phase=torch.as_tensor(ph))
        check(np.isfinite(y_card).all() and y_card.shape == y_cpu.shape, f"griffin-lim: card output B={B}")
        errs[B] = float(np.abs(y_card - y_cpu).max() / max(np.abs(y_cpu).max(), 1e-12))
        check(errs[B] <= 1e-3, f"griffin-lim: B={B} card vs CPU max|d|/max|y| {errs[B]:.3e} > 1e-3")
    phase("griffin-lim", f"card vs CPU, {a.griffin_lim_iters} iterations, same mels and phase, B=1 and B=4 x "
          f"{T_pad} frames: max|d| / max|y| {errs[1]:.2e}, {errs[4]:.2e} (bound 1e-3)")

    # times: Griffin-Lim alone, the host inverse preemphasis, one request's split
    times = {}
    for B, T in ((1, T_pad), (16, 1024)):
        with torch.no_grad():
            mag = synth.pipe.mel_to_linear_mag(
                torch.as_tensor(rng.uniform(-4.0, 0.0, (B, T, a.num_mels)), dtype=torch.float32, device=dev)) ** a.power
            box = {}
            ms = cuda_ms(lambda: box.__setitem__("y", GL.griffin_lim(mag, a.n_fft, a.hop_size, a.win_size,
                                                                     a.griffin_lim_iters)), reps=3, warmup=True)
            y = box["y"].cpu().numpy()
        t0 = time.time()
        GL.inv_preemphasis_scan(y, a.preemphasis)
        iir_ms = (time.time() - t0) * 1e3
        b_ms, b_by = bound(griffin_lim_flops(B, T, a.n_fft, a.griffin_lim_iters), 4.0 * B * T * (a.n_fft // 2 + 1 + a.hop_size))
        times[(B, T)] = (ms, iir_ms, b_ms)
        phase("griffin-lim", f"Griffin-Lim alone B={B} x {T} frames, {a.griffin_lim_iters} iterations: {ms:.2f} ms "
              f"(CUDA events, mean of 3), bound {b_ms:.3f} ms ({b_by}); host inverse preemphasis of its "
              f"{y.size} samples {iir_ms:.2f} ms (host clock); {smi}")
    with torch.no_grad():
        box = {}
        t_mel = cuda_ms(lambda: box.__setitem__("o", synth._decode(ids[:1], 0, False)), warmup=True)
        out = box["o"][0]
        t_wav = cuda_ms(lambda: synth._gl_from_decode(out.mel_outputs, out.stop_lengths), warmup=True)
    phase("griffin-lim", f"one request split (CUDA events): text->mel {t_mel:.1f} ms, mel->wav {t_wav:.1f} ms "
          f"(mask, pad to {round_up(out.mel_outputs.shape[1] + 1, 64)} frames, Griffin-Lim, copy, host inverse "
          f"preemphasis); {smi}")
    return {"launches": launches, "gl_err": max(errs.values()), "times": times, "t_mel": t_mel, "t_wav": t_wav}


# ---------------------------------------------------------------------------
# preprocessing and GTA
# ---------------------------------------------------------------------------

CORPUS_PHRASES = ["你好", "欢迎使用语音合成系统", "今天天气很好", "我们去公园散步吧", "这是第三个测试句子",
                  "请把窗户打开", "火车马上就要进站了", "他在图书馆看书", "明天早上八点开会", "谢谢你的帮助",
                  "小猫在沙发上睡觉", "春天的花开得很美"]


def formant_wav(seconds: float, sr: int, rng) -> np.ndarray:
    """A voiced-like utterance: harmonics of a gliding f0 shaped by three
    formant resonances that move per syllable, a syllable envelope, a breath
    of noise and silence at both ends."""
    from scipy import signal

    n = int(seconds * sr)
    t = np.arange(n) / sr
    f0 = rng.uniform(100, 220) * (1 + 0.15 * np.sin(2 * np.pi * rng.uniform(0.5, 2.0) * t))
    ph = 2 * np.pi * np.cumsum(f0) / sr
    syll = rng.uniform(3.0, 5.0)
    centers = [np.interp(t, np.linspace(0, seconds, 8), rng.uniform(lo, hi, 8))
               for lo, hi in ((300, 900), (900, 2300), (2300, 3200))]
    y = np.zeros(n)
    for k in range(1, int(4000 / f0.min())):
        amp = sum(np.exp(-(((k * f0) - c) / 120.0) ** 2) for c in centers)
        y += amp * np.sin(k * ph)
    y *= np.sin(np.pi * syll * t) ** 2
    y += 0.003 * signal.lfilter([1.0], [1.0, -0.9], rng.standard_normal(n))
    y = 0.6 * y / np.abs(y).max()
    pad = np.zeros(int(0.15 * sr))
    return np.concatenate([pad, y, pad]).astype(np.float32)


def write_procedural_corpus(root: str, n: int, seed: int, sr: int = 22050) -> tuple:
    """``n`` utterances of 1-4 s in the Biaobei layout (Wave/<index>.wav and
    a transcript of text + pinyin line pairs)."""
    from scipy.io import wavfile

    rng = np.random.default_rng(seed)
    wav_dir = os.path.join(root, "Wave")
    os.makedirs(wav_dir, exist_ok=True)
    lines = []
    for i in range(n):
        index = f"{i + 1:06d}"
        a, b = rng.choice(len(CORPUS_PHRASES), 2, replace=False)
        wav = formant_wav(rng.uniform(1.0, 4.0), sr, rng)
        wavfile.write(os.path.join(wav_dir, f"{index}.wav"), sr, (wav * 32767).astype(np.int16))
        lines += [f"{index}\t{CORPUS_PHRASES[a]}，{CORPUS_PHRASES[b]}。", "\tpinyin"]
    transcript = os.path.join(root, "000001-%06d.txt" % n)
    with open(transcript, "w", encoding="utf-8") as f:
        f.write("\n".join(lines) + "\n")
    return transcript, wav_dir


def run_preprocess_gta(cfg, dev, tp, n_utts: int = 32, batch: int = 32) -> dict:
    """A procedural corpus preprocessed on the card and on the CPU (equal
    rows and audio, mels within 1e-3), then GTA at B=``batch`` on the card
    with the launch counters read around it (K3 launched), against the same
    GTA with the decoder core swapped for its plain version (K3 not
    launched): equal labels and file names, predicted mels within 1e-3."""
    import torch

    from tacotronv2_wavernn_chinese_tpu_torch import ops
    from tacotronv2_wavernn_chinese_tpu_torch.data.preprocess import process_corpus, write_metadata
    from tacotronv2_wavernn_chinese_tpu_torch.infer.gta import generate_gta
    from tacotronv2_wavernn_chinese_tpu_torch.ops import tacotron_trainer_kernel as TK

    root = os.path.join(HERE, "build", "chip_smoke_corpus")
    shutil.rmtree(root, ignore_errors=True)
    t0 = time.time()
    transcript, wav_dir = write_procedural_corpus(root, n_utts, seed=17)
    phase("preprocess + gta", f"wrote {n_utts} procedural utterances in {time.time() - t0:.1f} s")
    quiet = lambda m: None
    res = {}
    for name, d in (("card", dev), ("cpu", torch.device("cpu"))):
        t0 = time.time()
        rows = process_corpus(cfg, transcript, wav_dir, os.path.join(root, name), bucket_batch=16, log=quiet,
                              device=d)
        res[name] = (rows, time.time() - t0)
    rows, rows_cpu = res["card"][0], res["cpu"][0]
    check(len(rows) == n_utts and rows == rows_cpu, "preprocess: the card's metadata rows differ from the CPU's")
    worst = 0.0
    for audio, mel, n_samples, n_frames, _, _ in rows:
        a_card, a_cpu = (np.load(os.path.join(root, k, audio)) for k in ("card", "cpu"))
        check(np.array_equal(a_card, a_cpu), f"preprocess: {audio} differs between the card and the CPU")
        m_card, m_cpu = (np.load(os.path.join(root, k, mel)) for k in ("card", "cpu"))
        check(m_card.shape == (n_frames, cfg.audio.num_mels) and np.isfinite(m_card).all(), f"preprocess: {mel}")
        worst = max(worst, float(np.abs(m_card - m_cpu).max()))
    check(worst <= 1e-3, f"preprocess: card vs CPU mel max|d| {worst:.3e} > 1e-3")
    frames = [int(r[3]) for r in rows]
    phase("preprocess + gta", f"process_corpus: {n_utts} utterances ({min(frames)}-{max(frames)} frames), card "
          f"{res['card'][1]:.2f} s ({n_utts / res['card'][1]:.1f} utt/s), CPU {res['cpu'][1]:.2f} s "
          f"({n_utts / res['cpu'][1]:.1f} utt/s) (host clock, wav conditioning included); rows and audio "
          f"equal, mel max|d| {worst:.2e} (bound 1e-3)")

    meta = os.path.join(root, "train.txt")
    write_metadata(rows, meta)
    runs = {}
    for name in ("kernel", "plain"):
        orig = TK.fused_core_apply
        if name == "plain":
            TK.fused_core_apply = TK.fused_core_plain
        try:
            ops.reset_launch_counts()
            torch.cuda.synchronize()
            t0 = time.time()
            path = generate_gta(cfg, tp, meta, os.path.join(root, "card"), os.path.join(root, f"gta_{name}"),
                                batch_size=batch, log=quiet, device=dev)
            torch.cuda.synchronize()
            runs[name] = (path, time.time() - t0, dict(ops.LAUNCHES))
        finally:
            TK.fused_core_apply = orig
    k3, k3_plain = runs["kernel"][2]["tacotron_train_fwd"], runs["plain"][2]["tacotron_train_fwd"]
    check(k3 > 0, "gta: K3 was never launched on the GTA path")
    check(k3_plain == 0, "gta: K3 was launched with the plain core swapped in")
    lines = {}
    for k, (path, _, _) in runs.items():
        with open(path, encoding="utf-8") as f:
            lines[k] = f.read().splitlines()
    check(lines["kernel"] == lines["plain"] and len(lines["kernel"]) == n_utts, "gta: metadata lines differ")
    worst_gta = 0.0
    for line in lines["kernel"]:
        wav, gt, pred, _ = line.split("|")
        d_k, d_p = (os.path.join(root, f"gta_{k}") for k in ("kernel", "plain"))
        check(np.array_equal(np.load(os.path.join(d_k, wav)), np.load(os.path.join(d_p, wav))), f"gta: {wav}")
        check(np.array_equal(np.load(os.path.join(d_k, gt)), np.load(os.path.join(d_p, gt))), f"gta: {gt}")
        p_k, p_p = np.load(os.path.join(d_k, pred)), np.load(os.path.join(d_p, pred))
        check(np.isfinite(p_k).all() and p_k.min() >= 0.0 and p_k.max() <= 1.0, f"gta: {pred} out of range")
        worst_gta = max(worst_gta, float(np.abs(p_k - p_p).max()))
    check(worst_gta <= 1e-3, f"gta: K3 eval vs plain core predicted mel max|d| {worst_gta:.3e} > 1e-3")
    phase("preprocess + gta", f"generate_gta B={batch}: K3 {runs['kernel'][1]:.2f} s ({n_utts / runs['kernel'][1]:.1f} "
          f"utt/s, host clock, first call, file writes included), plain core {runs['plain'][1]:.2f} s; K3 "
          f"launches {k3} (plain run {k3_plain}); predicted mel max|d| {worst_gta:.2e} (bound 1e-3, unit range)")
    return {"gta_launches": k3, "gta_k5": runs["kernel"][2]["tacotron_encoder_fwd"], "gta_err": worst_gta,
            "pre_err": worst}


# ---------------------------------------------------------------------------
# the command-line entry points, as subprocesses on the card
# ---------------------------------------------------------------------------


def run_module(module: str, args: list, tag: str) -> dict:
    """``python -m module args`` in a subprocess (through runpy, which is
    what ``-m`` does), then its launch counters; fails on a non-zero exit."""
    code = ("import json, runpy, sys\n"
            "from tacotronv2_wavernn_chinese_tpu_torch import ops\n"
            f"sys.argv = {json.dumps([module] + args)}\n"
            f"runpy.run_module({module!r}, run_name='__main__', alter_sys=True)\n"
            "print('LAUNCHES ' + json.dumps(ops.LAUNCHES))\n")
    t0 = time.time()
    out = subprocess.run([sys.executable, "-c", code], cwd=HERE, capture_output=True, text=True, timeout=600)
    check(out.returncode == 0, f"cli {tag}: exit code {out.returncode}:\n{out.stdout[-2000:]}\n{out.stderr[-4000:]}")
    line = [ln for ln in out.stdout.splitlines() if ln.startswith("LAUNCHES ")]
    check(len(line) == 1, f"cli {tag}: no launch counts printed")
    return {"launches": json.loads(line[0][len("LAUNCHES "):]), "s": time.time() - t0}


def run_cli(cfg, gl_artifact: str, wavernn_npz: str, serve_frames: int) -> dict:
    """infer.synthesize on the Griffin-Lim artifact's weights and
    infer.wavernn_gen on a .npy mel, each a subprocess on the card: exit
    codes, WAV lengths and the kernels each launched."""
    from scipy.io import wavfile

    hop = cfg.audio.hop_size
    out_dir = os.path.join(HERE, "build", "chip_smoke_cli")
    shutil.rmtree(out_dir, ignore_errors=True)
    os.makedirs(out_dir)
    syn = run_module("tacotronv2_wavernn_chinese_tpu_torch.infer.synthesize",
                     ["--params-npz", os.path.join(gl_artifact, "tacotron_params.npz"), "--text", SENTENCES[1],
                      "--out-dir", out_dir, "--override", f"tacotron.max_iters={serve_frames}"], "synthesize")
    wavs = [f for f in os.listdir(out_dir) if f.startswith("wav-") and f.endswith(".wav")]
    check(len(wavs) == 1, f"cli synthesize: wrote {wavs}")
    sr, pcm = wavfile.read(os.path.join(out_dir, wavs[0]))
    check(sr == 22050 and pcm.dtype == np.int16 and len(pcm) == serve_frames * hop,
          f"cli synthesize: {sr} Hz {pcm.dtype} {len(pcm)} samples, expected {serve_frames} x {hop}")
    check(syn["launches"]["tacotron_decode"] > 0, "cli synthesize: K2 was never launched")
    mel_frames = 40
    mel_path = os.path.join(out_dir, "utt.npy")
    np.save(mel_path, np.random.default_rng(9).uniform(0.0, 1.0, (mel_frames, cfg.audio.num_mels)).astype(np.float32))
    voc_wav = os.path.join(out_dir, "utt-wavernn.wav")
    gen = run_module("tacotronv2_wavernn_chinese_tpu_torch.infer.wavernn_gen",
                     ["--file", mel_path, "--params-npz", wavernn_npz, "--output", voc_wav], "wavernn_gen")
    sr, pcm = wavfile.read(voc_wav)
    check(sr == 22050 and pcm.dtype == np.int16 and len(pcm) == mel_frames * hop,
          f"cli wavernn_gen: {sr} Hz {len(pcm)} samples, expected {mel_frames} x {hop}")
    check(gen["launches"]["wavernn_sample"] > 0, "cli wavernn_gen: K1 was never launched")
    phase("cli", f"infer.synthesize (Griffin-Lim, {serve_frames} frames): exit 0 in {syn['s']:.1f} s, WAV "
          f"{serve_frames} x {hop} samples, launches {syn['launches']}; infer.wavernn_gen ({mel_frames} frames): "
          f"exit 0 in {gen['s']:.1f} s, WAV {mel_frames} x {hop} samples, launches {gen['launches']}")
    return {"synthesize": syn["launches"], "wavernn_gen": gen["launches"]}


# ---------------------------------------------------------------------------
# WaveRNN training (RAW and MOL) and MOL vocoding
# ---------------------------------------------------------------------------


def wavernn_step_split(cfg, state, batch) -> dict:
    """One WaveRNN train step split by the program's spans (CUDA events):
    forward + loss, backward (autograd, up to the optimizer) and the
    optimizer (clip and Adam)."""
    from tacotronv2_wavernn_chinese_tpu_torch.train import wavernn_task as WT

    s = traced_spans(lambda: WT.train_step(state, batch, cfg))
    fwd, opt = s["train.forward"], s["train.optimizer"]
    return {"forward": span_ms(fwd), "backward": dev_gap_ms(fwd, opt, "t1"),
            "optimizer": span_ms(opt), "step": span_ms(s["train.step"])}


def relu_pattern(masks=None):
    """A torch function mode: inside it every ``torch.relu`` records its
    sign pattern (``masks`` None), or applies the given patterns in call
    order as ``x * mask`` (relu's value and gradient on that pattern) and
    counts the units whose own sign differs.  The WaveRNN step's gradients
    jump where a ReLU changes side, so two f32 runs are compared on one
    pattern."""
    import torch
    from torch.overrides import TorchFunctionMode

    class ReluPattern(TorchFunctionMode):
        def __init__(self):
            super().__init__()
            self.masks, self.flips, self.units = [], 0, 0

        def __torch_function__(self, func, types, args=(), kwargs=None):
            if func is not torch.relu:
                return func(*args, **(kwargs or {}))
            x = args[0]
            own = x > 0
            self.units += own.numel()
            if masks is None:
                self.masks.append(own.cpu())
                return func(x)
            m = masks[len(self.masks)].to(x.device)
            self.masks.append(m)
            self.flips += int((own != m).sum())
            return x * m.to(x.dtype)

    return ReluPattern()


def step_on(cfg, params, batch, dev, dtype, masks=None, precision: str = "ieee") -> dict:
    """One RAW train step on ``dev`` in ``dtype`` from copies of
    ``params`` and ``batch``, TF32 off ("ieee") or on ("tf32"), its ReLUs
    recorded or pinned to ``masks``: loss, grad norm, the gradients and
    params after the step as float64 leaves on the CPU, the ReLU patterns
    and the units whose own sign differed from ``masks``."""
    from tacotronv2_wavernn_chinese_tpu_torch.train import wavernn_task as WT
    from tacotronv2_wavernn_chinese_tpu_torch.utils import tree_leaves, tree_map

    p = tree_map(lambda t: t.to(dev, dtype), params)
    b = {k: v.to(dev, dtype) if v.is_floating_point() else v.to(dev) for k, v in batch.items()}
    state = WT.TrainState(0, p, WT.adam_init(p))
    with WT.fp32_precision(precision), relu_pattern(masks) as relus:
        loss, new_p, grads = WT.compute_grads(state.params, cfg, b)
        new_state, norm = WT.apply_gradients(state, new_p, grads, cfg)
    host = lambda tree: [t.detach().cpu().double() for t in tree_leaves(tree)]
    return {"loss": float(loss), "grad_norm": float(norm), "grads": host(grads), "params": host(new_state.params),
            "masks": relus.masks, "flips": relus.flips, "units": relus.units}


# card vs CPU, one RAW step at B=4, the CPU's ReLUs pinned to the card's
# pattern (a unit within ~1e-6 of zero may land on either side in f32, and
# each moves its layers' weight gradients by one position's term, ~1e-3 of
# max|g|).  float64: the same function, to rounding.  float32: loss, grad
# norm and params against the CPU; the gradients against the float64 step
# on the same pattern, no farther than F32_GRAD_FACTOR times the CPU's f32
# gradients are (at least F32_GRAD_FLOOR of max|g|): what f32 allows on
# this batch, which the CPU measures (near-constant mels, as an untrained
# Tacotron's GTA output, make conv_in's weight gradient a small difference
# of large terms under BatchNorm).  The card's step with TF32 on must miss
# that bound (tools/torch_wavernn_step_precision.py).  Params are compared
# where the two gradients agree within 1 % and exceed 1e-6, elsewhere
# Adam's first step can move them by up to 2 lr.
CARD_CPU_TOL = {
    "float64": {"loss": 1e-12, "grad_norm": 1e-10, "grad": 1e-10, "params": 1e-12},
    "float32": {"loss": 1e-5, "grad_norm": 1e-4, "params": 2e-6},
}
F32_GRAD_FACTOR, F32_GRAD_FLOOR = 4.0, 1e-5


def grad_error(run: dict, ref: dict) -> float:
    """max|d| of the gradients over max|g| of ``ref``'s."""
    g_max = max(float(g.abs().max()) for g in ref["grads"])
    return max(float((a - b).abs().max()) for a, b in zip(run["grads"], ref["grads"])) / g_max


def step_errors(card: dict, host: dict) -> dict:
    """Loss and grad norm relative, the gradients' max|d| / max|g|, params
    after the step on the Adam-insensitive elements, and the share and
    max|d| of the others."""
    rel = lambda k: abs(card[k] - host[k]) / abs(host[k])
    p_err, n_sens, n_all, sens_err = 0.0, 0, 0, 0.0
    for a, b, ga, gb in zip(card["params"], host["params"], card["grads"], host["grads"]):
        d = (a - b).abs()
        sens = ((ga - gb).abs() > 0.01 * gb.abs()) | (gb.abs() < 1e-6)
        p_err = max(p_err, float(d[~sens].max()) if (~sens).any() else 0.0)
        sens_err = max(sens_err, float(d[sens].max()) if sens.any() else 0.0)
        n_sens += int(sens.sum())
        n_all += d.numel()
    return {"loss": rel("loss"), "grad_norm": rel("grad_norm"), "grad": grad_error(card, host), "params": p_err,
            "sensitive_share": n_sens / n_all, "sensitive_max": sens_err}


def compare_card_cpu(cfg, params, batch, dev, dtype) -> dict:
    """The same RAW step on the card and on the CPU in ``dtype``, the
    CPU's ReLUs pinned to the card's pattern: ``step_errors``, the units
    whose CPU sign differs, and in float32 the gradients' ``grad_error``
    against the float64 step on that pattern of the card (``card_exact``),
    the CPU (``cpu_exact``) and the card with TF32 on (``tf32_exact``)."""
    import torch

    card = step_on(cfg, params, batch, dev, dtype)
    host = step_on(cfg, params, batch, torch.device("cpu"), dtype, masks=card["masks"])
    out = dict(step_errors(card, host), flips=host["flips"], units=host["units"])
    if dtype == torch.float32:
        exact = step_on(cfg, params, batch, torch.device("cpu"), torch.float64, masks=card["masks"])
        tf32 = step_on(cfg, params, batch, dev, dtype, card["masks"], "tf32")
        out.update(card_exact=grad_error(card, exact), cpu_exact=grad_error(host, exact),
                   tf32_exact=grad_error(tf32, exact))
    return out


def run_wavernn_train(cfg, dev, tp, smi: str, n_utts: int = 40, steps: int = 6, ckpt_every: int = 3,
                      cmp_batch: int = 4, mol_folds: int = 4, mol_samples: int = 12100) -> dict:
    """WaveRNN training on the port's own GTA output (RAW, default width,
    native loader), a resumed step, one step on the card against the CPU,
    one MOL step, and MOL vocoding.  Returns what the kernels line needs."""
    import torch

    from tacotronv2_wavernn_chinese_tpu_torch import ops
    from tacotronv2_wavernn_chinese_tpu_torch.data.loader import VocoderDataset, read_metadata
    from tacotronv2_wavernn_chinese_tpu_torch.data.preprocess import process_corpus, write_metadata
    from tacotronv2_wavernn_chinese_tpu_torch.infer import wavernn_gen
    from tacotronv2_wavernn_chinese_tpu_torch.infer.gta import generate_gta
    from tacotronv2_wavernn_chinese_tpu_torch.models import wavernn as W
    from tacotronv2_wavernn_chinese_tpu_torch.train import wavernn_task as WT
    from tacotronv2_wavernn_chinese_tpu_torch.train import wavernn_train as WTR
    from tacotronv2_wavernn_chinese_tpu_torch.utils import tree_map
    from tacotronv2_wavernn_chinese_tpu_torch.utils.checkpoints import init_wavernn, save_params_npz
    from tacotronv2_wavernn_chinese_tpu_torch.utils.metrics import read_scalars

    tag = "wavernn train"
    root = os.path.join(HERE, "build", "chip_smoke_wavernn")
    shutil.rmtree(root, ignore_errors=True)
    t0 = time.time()
    transcript, wav_dir = write_procedural_corpus(os.path.join(root, "corpus"), n_utts, seed=23)
    quiet = lambda m: None
    rows = process_corpus(cfg, transcript, wav_dir, os.path.join(root, "pre"), bucket_batch=16, log=quiet,
                          device=dev)
    meta = os.path.join(root, "pre", "train.txt")
    write_metadata(rows, meta)
    gta_dir = os.path.join(root, "gta")
    gta_meta = generate_gta(cfg, tp, meta, os.path.join(root, "pre"), gta_dir, batch_size=32, log=quiet, device=dev)
    phase(tag, f"{n_utts} procedural utterances preprocessed and through GTA in {time.time() - t0:.1f} s -> "
          f"{os.path.relpath(gta_meta, HERE)}")

    wcfg = cfg.override(f"wavernn_train.test_samples=4,wavernn_train.checkpoint_every={ckpt_every},"
                        "wavernn_train.gen_at_checkpoint=1,wavernn_train.summary_interval=1")
    log_dir = os.path.join(root, "logs")
    logs: list = []

    def log(msg):
        logs.append(msg)
        phase(tag, f"  | {msg}")

    ops.reset_launch_counts()
    t0 = time.time()
    state = WTR.run_training(wcfg, gta_meta, gta_dir, log_dir, total_steps=steps, use_native_loader=True,
                             log=log, device=dev)
    torch.cuda.synchronize()
    wall = time.time() - t0
    sec_step = [float(m.split("[")[1].split(" sec/step")[0]) for m in logs if m.startswith("Step")]
    logs_first = list(logs)
    logs.clear()
    state2 = WTR.run_training(wcfg, gta_meta, gta_dir, log_dir, total_steps=steps + 1, use_native_loader=True,
                              log=log, device=dev)
    torch.cuda.synchronize()
    k1 = ops.LAUNCHES["wavernn_sample"]
    ckpt_steps = [s_ for s_ in range(1, steps + 2) if s_ % ckpt_every == 0]
    n_tests = len(ckpt_steps)
    phase(tag, f"run_training: {state.step} steps in {wall:.1f} s wall (warm step, native loader build, "
          f"checkpoints and listening tests included), then a restart to step {state2.step}; K1 launches "
          f"{k1} for {n_tests} listening tests")
    check(state.step == steps and state2.step == steps + 1, f"{tag}: ended at steps {state.step}, {state2.step}")
    check(any(m.startswith("native C++ loader active") for m in logs_first), f"{tag}: the native loader was not active")
    check(not any("failed" in m for m in logs_first + logs), f"{tag}: a listening test failed")
    check(f"restored checkpoint at step {steps}" in logs, f"{tag}: the restart did not restore step {steps}")
    scal = read_scalars(os.path.join(log_dir, "scalars.jsonl"))
    losses = [r["loss"] for r in scal]
    check(len(losses) == steps + 1 and all(np.isfinite(losses)) and all(np.isfinite(r["grad_norm"]) for r in scal),
          f"{tag}: losses {losses}")
    phase(tag, "losses " + ", ".join(f"{v:.4f}" for v in losses))
    ds = VocoderDataset(read_metadata(gta_meta), gta_dir, wcfg)
    check(len(ds.train_indices) >= wcfg.wavernn_train.batch_size, f"{tag}: {len(ds.train_indices)} train utterances")
    frames = np.load(os.path.join(gta_dir, ds.rows[ds.test_indices[0]][2])).shape[0]
    for s_ in ckpt_steps:
        path = os.path.join(log_dir, "model_outputs", f"step{s_}_batched_sample0.wav")
        check(os.path.exists(path), f"{tag}: no listening-test WAV at step {s_}")
        with wave.open(path) as wf:
            check(wf.getnframes() == frames * 275, f"{tag}: listening test at step {s_}: {wf.getnframes()} "
                  f"samples, expected {frames} x 275")
    check(k1 == n_tests, f"{tag}: K1 launched {k1} times for {n_tests} listening tests")
    phase(tag, f"sec/step (run_training's rolling window, host clock): {sec_step[-1]:.3f}; listening tests "
          f"{frames} x 275 samples at steps {ckpt_steps}")

    # one RAW step on the card against the same step on the CPU
    rs = np.random.RandomState(0)
    small = WT.batch_to_device(ds.collate(ds.train_indices[:cmp_batch], rs), "cpu")
    p0 = init_wavernn(31, cfg.wavernn, cfg.audio.num_mels, cfg.audio.bits, device="cpu")
    cmps = {}
    for dtype in (torch.float64, torch.float32):
        t0 = time.time()
        name = str(dtype).split(".")[1]
        cmp, tol = compare_card_cpu(wcfg, p0, small, dev, dtype), CARD_CPU_TOL[name]
        cmps[name] = cmp
        phase(tag, f"card vs CPU, one RAW step B={cmp_batch}, {name} (TF32 off), the CPU's ReLUs pinned to the "
              f"card's ({cmp['flips']} of {cmp['units']} units on the other side on their own): loss rel "
              f"{cmp['loss']:.2e} (tol {tol['loss']:.0e}), grad norm rel {cmp['grad_norm']:.2e} (tol "
              f"{tol['grad_norm']:.0e}), gradient max|d|/max|g| {cmp['grad']:.2e}"
              + (f" (tol {tol['grad']:.0e})" if "grad" in tol else "") + f", params after the step max|d| "
              f"{cmp['params']:.2e} (tol {tol['params']:.0e}) where the gradients agree within 1 % and exceed "
              f"1e-6; the other {cmp['sensitive_share']:.2%} of elements max|d| {cmp['sensitive_max']:.2e} (tol "
              f"2 lr = 2e-4); {time.time() - t0:.1f} s host")
        check(all(cmp[k] <= tol[k] for k in tol) and cmp["sensitive_max"] <= 2e-4 + 1e-7,
              f"{tag}: card vs CPU step in {name}: {cmp}")
        if "card_exact" in cmp:
            bound_f32 = max(F32_GRAD_FLOOR, F32_GRAD_FACTOR * cmp["cpu_exact"])
            phase(tag, f"gradients against the float64 step on the card's ReLU pattern, max|d|/max|g|: the card in "
                  f"f32 {cmp['card_exact']:.2e}, the CPU in f32 {cmp['cpu_exact']:.2e}, tol max({F32_GRAD_FLOOR:.0e}, "
                  f"{F32_GRAD_FACTOR:g} x the CPU's) = {bound_f32:.2e}; the card with TF32 on "
                  f"{cmp['tf32_exact']:.2e}, which must exceed it")
            check(cmp["card_exact"] <= bound_f32, f"{tag}: the card's f32 gradients: {cmp}")
            check(cmp["tf32_exact"] > bound_f32, f"{tag}: the f32 check cannot tell TF32 from f32: {cmp}")

    # the RAW step at B=32 split by CUDA events, and its bound
    b32 = WT.batch_to_device(ds.collate(ds.train_indices[:wcfg.wavernn_train.batch_size], rs), dev)
    split = wavernn_step_split(wcfg, WT.TrainState(state2.step, state2.params, state2.opt_state), b32)
    flops, nbytes = wavernn_train_work(cfg.wavernn, b32["x"].shape[0], wcfg.wavernn_train.seq_len_hops,
                                       2 ** cfg.audio.bits)
    bms, by = bound(flops, nbytes)
    phase(tag, f"{smi}: RAW step B={b32['x'].shape[0]} x {b32['x'].shape[1]} samples (CUDA events): "
          + ", ".join(f"{k} {v:.2f} ms" for k, v in split.items())
          + f"; bound {bms:.2f} ms ({by}: {flops / 1e12:.3f} TFLOP at 67 TFLOP/s f32)")

    # one MOL step at B=32
    mcfg = wcfg.override("wavernn.mode=MOL")
    mstate = WT.init_state(5, mcfg, dev)
    t0 = time.time()
    mstate, mm = WT.train_step(mstate, b32, mcfg)
    check(np.isfinite(mm["loss"]) and np.isfinite(mm["grad_norm"]) and mm["grad_norm"] > 0, f"{tag}: MOL step {mm}")
    phase(tag, f"MOL step B={b32['x'].shape[0]} on the card: loss {mm['loss']:.4f}, grad norm "
          f"{mm['grad_norm']:.4f}, {time.time() - t0:.2f} s host (first call)")

    # MOL vocoding on the card
    mp = mstate.params
    hop = cfg.wavernn.total_upsample
    rng = np.random.default_rng(29)
    mels = torch.as_tensor(rng.uniform(0, 1, (mol_folds, mol_samples // hop + 2 * cfg.wavernn.pad, 80)),
                           dtype=torch.float32, device=dev)
    box = {}
    with torch.no_grad():
        mol_ms = cuda_ms(lambda: box.__setitem__("w", W.generate_mol(mp, mcfg.wavernn, mels, seed=3)))
    wav = box["w"]
    check(tuple(wav.shape) == (mol_folds, mol_samples) and bool(torch.isfinite(wav).all())
          and float(wav.abs().max()) <= 1.0, f"{tag}: MOL generation {tuple(wav.shape)}")
    short = rng.uniform(0, 1, (2, 1 + 2 * cfg.wavernn.pad, 80)).astype(np.float32)
    nr_mix = mp["fc3"]["w"].shape[1] // 3
    g = torch.as_tensor(-np.log(-np.log(rng.uniform(1e-6, 1.0, (hop, 2, nr_mix)))), dtype=torch.float32)
    u = torch.as_tensor(rng.uniform(1e-5, 1 - 1e-5, (hop, 2)), dtype=torch.float32)
    with torch.no_grad():
        on_card = W.generate_mol(mp, mcfg.wavernn, short, gumbel=g.to(dev), u=u.to(dev)).cpu()
        on_cpu = W.generate_mol(tree_map(lambda t: t.cpu(), mp), mcfg.wavernn, short, gumbel=g, u=u)
    mol_err = float((on_card - on_cpu).abs().max())
    check(mol_err <= 1e-3, f"{tag}: MOL generation card vs CPU max|d| {mol_err:.3e} > 1e-3")
    npz = os.path.join(root, "mol_wavernn.npz")
    save_params_npz(npz, mp)
    mel_frames = 40
    mel_path = os.path.join(root, "mol_mel.npy")
    np.save(mel_path, rng.uniform(0, 1, (mel_frames, 80)).astype(np.float32))
    out_wav = os.path.join(root, "mol.wav")
    t0 = time.time()
    w_ = mcfg.wavernn
    override = (f"wavernn.mode=MOL,wavernn.rnn_dims={w_.rnn_dims},wavernn.fc_dims={w_.fc_dims},"
                f"wavernn.compute_dims={w_.compute_dims},wavernn.res_out_dims={w_.res_out_dims},"
                f"wavernn.res_blocks={w_.res_blocks}")
    wavernn_gen.main(["--file", mel_path, "--params-npz", npz, "--output", out_wav, "--override", override,
                      "--target", str(cfg.wavernn_gen.target), "--overlap", str(cfg.wavernn_gen.overlap),
                      "--device", str(dev)])
    with wave.open(out_wav) as wf:
        n_out = wf.getnframes()
        pcm = np.frombuffer(wf.readframes(n_out), "<i2")
    check(n_out == mel_frames * hop and np.abs(pcm).max() > 0, f"{tag}: MOL wavernn_gen wrote {n_out} samples")
    phase(tag, f"{smi}: MOL generation {mol_folds} folds x {mol_samples} samples {mol_ms:.1f} ms (CUDA events, "
          f"{mol_ms / mol_samples * 1e3:.1f} us/step, plain loop); card vs CPU 2 folds x {hop} samples with the "
          f"same injected draws max|d| {mol_err:.2e} (tol 1e-3); MOL wavernn_gen {mel_frames} frames -> "
          f"{n_out} samples in {time.time() - t0:.1f} s host")
    return {"k1_launches": k1, "sec_per_step": sec_step[-1], "split": split, "bound_ms": bms,
            "card_cpu": cmps, "mol_ms": mol_ms, "mol_err": mol_err, "meta": meta,
            "pre_dir": os.path.join(root, "pre"), "ckpt_dir": os.path.join(log_dir, "checkpoints")}


# ---------------------------------------------------------------------------
# Tacotron training in the other configurations (the eager route and mixed
# precision), GTA on the eager eval route, the server from checkpoint dirs
# ---------------------------------------------------------------------------

# name -> config override; every eager configuration runs neither K3 nor K4
TRAIN_CONFIGS = {
    "lsa": "tacotron.attention_mode=lsa",  # cumulative weights (the default)
    "gmm": "tacotron.attention_mode=gmm",  # 5 mixtures
    "graves": "tacotron.attention_mode=graves",  # 10 heads
    "forward_smoothing": "tacotron.smoothing=true",
    "scheduled_0.5": "tacotron_train.teacher_forcing_ratio=0.5",
    "mixed_precision": "tacotron_train.mixed_precision=true",
}
KERNEL_CONFIGS = ("mixed_precision",)  # forward attention at ratio 1: K3/K4, one launch each a step
# card vs CPU: f32 as the trainer's gates (PERF.md section 2); mixed
# precision rounds the first encoder convolution's activations to bf16,
# where cuDNN and the CPU accumulate in other orders, so an element may
# land one bf16 ulp apart and carry that through its BatchNorm
TRAIN_CFG_TOL = {"f32": (1e-5, 1e-3), "bf16": (1e-3, 1e-2)}  # (loss relative, gradient / max|g|)


def tc_small_batch(cfg, dev, seed: int, B: int = 4, T_in: int = 32, T: int = 64) -> dict:
    """A train batch from a numpy seed: ragged inputs and targets, mels in
    [-4, 4], stop targets from the lengths."""
    import torch

    rng = np.random.default_rng(seed)
    lens = np.linspace(T_in, T_in // 2, B).astype(np.int64)
    tl = np.linspace(T, T // 2, B).astype(np.int64)
    t = lambda a: torch.as_tensor(a, device=dev)
    return {"inputs": t(rng.integers(1, cfg.tacotron.vocab_size, (B, T_in))), "input_lengths": t(lens),
            "mel_targets": t(rng.uniform(-4, 4, (B, T, 80)).astype(np.float32)), "target_lengths": t(tl),
            "stop_targets": t((np.arange(T)[None, :] >= tl[:, None] - 1).astype(np.float32)),
            "loss_frames": t(np.full(B, T, np.int64))}


def leaf_names(tree, path=()) -> list:
    """'/'-joined key paths of a params tree, in ``tree_leaves`` order."""
    if isinstance(tree, dict):
        return [n for k, v in tree.items() for n in leaf_names(v, path + (k,))]
    if isinstance(tree, (list, tuple)):
        return [n for i, v in enumerate(tree) for n in leaf_names(v, path + (str(i),))]
    return ["/".join(path)]


def tc_loss_and_grads(cfg, params, batch, rand, ratio: float, dev, relus=None) -> dict:
    """One loss and its gradients on ``dev`` with the masks ``rand``, its
    ReLUs recorded (``relus`` None) or pinned to ``relus`` (``relu_pattern``:
    a prenet unit fed the model's own prediction, or any other, within
    ~1e-7 of zero may land on either side in f32 and move its layer's
    gradients by one position's term); also the aux terms and the BN
    statistics the forward returns."""
    import torch

    from tacotronv2_wavernn_chinese_tpu_torch.train import tacotron_task as task
    from tacotronv2_wavernn_chinese_tpu_torch.utils import tree_leaves, tree_map

    move = lambda x: None if x is None else (tuple(move(m) for m in x) if isinstance(x, tuple) else x.to(dev))
    leaves = tree_map(lambda p: p.detach().to(dev).requires_grad_(True), params)
    b = {k: v.to(dev) for k, v in batch.items()}
    with relu_pattern(relus) as pattern:
        loss, (aux, new, _) = task.loss_fn(leaves, cfg, b, None, True, ratio,
                                           rand=type(rand)(*(move(f) for f in rand)))
        grads = torch.autograd.grad(loss, tree_leaves(leaves), allow_unused=True)
    stats = {n: t.detach().cpu() for n, t in zip(leaf_names(new), tree_leaves(new))
             if n.endswith(("bn/mean", "bn/var"))}
    return {"loss": float(loss.detach()), "grads": [None if g is None else g.detach().cpu() for g in grads],
            "names": leaf_names(params), "relus": pattern.masks, "flips": pattern.flips, "units": pattern.units,
            "aux": {k: float(v.detach()) for k, v in aux.items()}, "stats": stats}


def tc_grad_error(card: dict, host: dict, zero_by_construction) -> tuple:
    """-> (the largest max|d| / max|g| over the leaves, that leaf's name).
    A leaf whose gradient is 0 in exact arithmetic (a bias straight before
    a train-mode BatchNorm, which subtracts it again) holds only rounding
    noise on each device: it is held to the largest gradient of all
    leaves instead of its own."""
    g_all = max(float(b.abs().max()) for b in host["grads"] if b is not None)
    worst, at = 0.0, ""
    for a, b, name in zip(card["grads"], host["grads"], host["names"]):
        if b is None or float(b.abs().max()) == 0.0:
            continue
        scale = g_all if name in zero_by_construction else float(b.abs().max())
        e = float((a - b).abs().max()) / scale
        if e > worst:
            worst, at = e, name
    return worst, at


def run_train_configs(cfg, dev, smi: str, batch: dict, taco_params, taco_ckpt: str, wavernn_ckpt: str,
                      corpus_meta: str, corpus_dir: str, steps: int = 2, gta_utts: int = 8,
                      server_override: str = "") -> dict:
    """Two train steps from one state in each of TRAIN_CONFIGS at the train
    phase's batch (CUDA events, losses, K3/K4 launches: 0 on the eager
    route, one each a step under mixed precision); each against the CPU at
    B=4, T_in=32, T=64 with the same masks; GTA with an LSA model and with
    anti-repeat on the card against the CPU (K3 not launched); the server
    started from the train phases' checkpoint directories answering one
    /generate_tts.  Returns what the kernels line needs."""
    import torch

    from tacotronv2_wavernn_chinese_tpu_torch import ops
    from tacotronv2_wavernn_chinese_tpu_torch.frontend import default_symbols, get_pyin
    from tacotronv2_wavernn_chinese_tpu_torch.infer.gta import generate_gta
    from tacotronv2_wavernn_chinese_tpu_torch.models import tacotron as T
    from tacotronv2_wavernn_chinese_tpu_torch.serving import server as SRV
    from tacotronv2_wavernn_chinese_tpu_torch.train import tacotron_task as task
    from tacotronv2_wavernn_chinese_tpu_torch.utils import tree_map

    tag = "train configs"
    cpu = torch.device("cpu")
    B, T_in = batch["inputs"].shape
    T_out = batch["mel_targets"].shape[1]
    out = {"launches": {}, "ms": {}}
    for i, (name, over) in enumerate(TRAIN_CONFIGS.items()):
        ccfg = cfg.override(over)
        ratio = task.teacher_forcing_schedule(ccfg, 0)
        route = T.core_route(ccfg.tacotron, True, ratio)
        check(route == ("kernel" if name in KERNEL_CONFIGS else "eager"), f"{tag}: {name} takes the {route} route")
        state = task.init_state(40 + i, ccfg, dev)
        gen = torch.Generator(device=dev)
        gen.manual_seed(0)
        ops.reset_launch_counts()
        losses, ms = [], []
        s = state
        for _ in range(steps):
            e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            torch.cuda.synchronize()
            e0.record()
            s, metrics = task.train_step(s, batch, gen, ccfg)
            e1.record()
            torch.cuda.synchronize()
            losses.append(metrics["loss"])
            ms.append(e0.elapsed_time(e1))
        launches = {k: ops.LAUNCHES[k] for k in ("tacotron_train_fwd", "tacotron_train_bwd", *ENCODER_KEYS)}
        check(all(np.isfinite(losses)), f"{tag}: {name} losses {losses}")
        check(launches["tacotron_encoder_bwd"] == steps,
              f"{tag}: {name} launched K6 {launches['tacotron_encoder_bwd']} times in {steps} steps")
        want = steps if name in KERNEL_CONFIGS else 0
        check(launches["tacotron_train_fwd"] == want and launches["tacotron_train_bwd"] == want,
              f"{tag}: {name} launched K3/K4 {launches} in {steps} steps, expected {want} each")
        out["launches"][name], out["ms"][name] = launches, ms

        # the same step on the card and on the CPU, with the same masks
        small = tc_small_batch(ccfg, cpu, 60 + i)
        p_cpu = tree_map(lambda t: t.detach().cpu(), state.params)
        g_cpu = torch.Generator().manual_seed(7)
        rand = T.draw_train_rand(p_cpu, ccfg.tacotron, 4, 32, 64, g_cpu, True, ratio)
        card = tc_loss_and_grads(ccfg, p_cpu, small, rand, ratio, dev)
        host = tc_loss_and_grads(ccfg, p_cpu, small, rand, ratio, cpu, relus=card["relus"])
        loss_rel = abs(card["loss"] - host["loss"]) / abs(host["loss"])
        # the last postnet convolution is linear, straight into BatchNorm
        g_err, g_at = tc_grad_error(card, host, {f"postnet/layers/{ccfg.tacotron.postnet_layers - 1}/conv/b"})
        kind = "bf16" if name == "mixed_precision" else "f32"
        tol_loss, tol_grad = TRAIN_CFG_TOL[kind]
        why = (" (bf16 gates: the first encoder convolution's bf16 activations round apart between cuDNN "
               "and the CPU)" if kind == "bf16" else "")
        phase(tag, f"{smi}: {name} ({route} route, ratio {ratio}): B={B} T_in={T_in} T={T_out} losses "
              + ", ".join(f"{v:.4f}" for v in losses) + " ; ms/step (CUDA events) "
              + ", ".join(f"{v:.1f}" for v in ms) + f"; K3/K4 launches {launches['tacotron_train_fwd']}/"
              f"{launches['tacotron_train_bwd']}; card vs CPU at B=4 T_in=32 T=64: loss {card['loss']!r} / "
              f"{host['loss']!r}, {loss_rel:.2e} relative (tol {tol_loss:g}), gradient max|d|/max|g| {g_err:.2e} "
              f"at {g_at} (tol {tol_grad:g}), the CPU's ReLUs pinned to the card's ({host['flips']} of "
              f"{host['units']} units on the other side){why}")
        check(loss_rel <= tol_loss, f"{tag}: {name} card vs CPU loss {loss_rel:.3e} > {tol_loss}")
        check(g_err <= tol_grad, f"{tag}: {name} card vs CPU gradient {g_err:.3e} > {tol_grad}")
        out.setdefault("card_cpu", {})[name] = {"loss": loss_rel, "grad": g_err}
        if name == "lsa":
            lsa_cfg, lsa_params = ccfg, s.params

    # GTA on the eager eval route: LSA, and forward attention with anti-repeat.
    # generate_gta draws its prenet dropout from a generator on its device;
    # here every draw comes from one CPU stream moved to the device, so the
    # card and the CPU decode with the same masks
    draw = T.draw_train_rand

    def draw_on_cpu(params, tcfg, *a, **kw):
        gen_dev = a[3]
        rand = draw(params, tcfg, *a[:3], torch.Generator().manual_seed(0), *a[4:], **kw)
        return type(rand)(*(None if f is None else tuple(m.to(gen_dev.device) for m in f)
                            if isinstance(f, tuple) else f.to(gen_dev.device) for f in rand))

    quiet = lambda m: None
    with open(corpus_meta, encoding="utf-8") as f:
        shards = max(1, len(f.read().splitlines()) // gta_utts)
    for name, gcfg, gparams in (("lsa", lsa_cfg, lsa_params),
                                ("anti_repeat", cfg.override("tacotron.anti_repeat=true"), taco_params)):
        check(T.core_route(gcfg.tacotron, False, 1.0) == "eager", f"{tag}: GTA {name} takes the kernel route")
        runs = {}
        for dname, d in (("card", dev), ("cpu", cpu)):
            out_dir = os.path.join(HERE, "build", f"chip_smoke_gta_{name}_{dname}")
            shutil.rmtree(out_dir, ignore_errors=True)
            ops.reset_launch_counts()
            t0 = time.time()
            T.draw_train_rand = draw_on_cpu
            try:
                path = generate_gta(gcfg, tree_map(lambda t: t.detach().cpu(), gparams), corpus_meta, corpus_dir,
                                    out_dir, batch_size=gta_utts, num_shards=shards, log=quiet, device=d)
            finally:
                T.draw_train_rand = draw
            with open(path, encoding="utf-8") as f:
                runs[dname] = (out_dir, f.read().splitlines(), ops.LAUNCHES["tacotron_train_fwd"], time.time() - t0)
        lines = runs["card"][1]
        check(0 < len(lines) <= gta_utts and lines == runs["cpu"][1], f"{tag}: GTA {name} metadata rows differ")
        worst = 0.0
        for line in lines:
            pred = line.split("|")[2]
            a, b = (np.load(os.path.join(runs[k][0], pred)) for k in ("card", "cpu"))
            check(np.isfinite(a).all(), f"{tag}: GTA {name} {pred} not finite")
            worst = max(worst, float(np.abs(a - b).max()))
        k3 = runs["card"][2]
        phase(tag, f"GTA ({name}, eager eval route) {len(lines)} utterances in one batch: card {runs['card'][3]:.2f} s, "
              f"CPU {runs['cpu'][3]:.2f} s (host clock); card vs CPU predicted mel max|d| {worst:.2e} (tol 1e-3, "
              f"unit range); K3 launches {k3}")
        check(worst <= 1e-3, f"{tag}: GTA {name}: card vs CPU max|d| {worst:.3e} > 1e-3")
        check(k3 == 0, f"{tag}: GTA {name} launched K3 {k3} times")
        out.setdefault("gta", {})[name] = {"err": worst, "k3": k3}

    # the server from the train phases' checkpoint directories: main's own
    # server is captured (its serve_forever returns at once and main closes
    # it); a server on the synthesizer main built answers the request
    seen = {}
    real_serve = SRV.serve

    def capture(*a, **kw):
        httpd = real_serve(*a, **kw)
        httpd.serve_forever = lambda: None
        seen["synth"] = httpd.service.synth
        return httpd

    SRV.serve = capture
    try:
        SRV.main(["--ckpt-dir", taco_ckpt, "--wavernn-ckpt-dir", wavernn_ckpt, "--host", "127.0.0.1",
                  "--port", "0", "--no-warmup", "--max-iters", str(SERVE_FRAMES), "--device", str(dev)]
                 + (["--override", server_override] if server_override else []))
    finally:
        SRV.serve = real_serve
    synth = seen["synth"]
    check(synth.vocoder_params is not None, f"{tag}: --wavernn-ckpt-dir restored no vocoder")
    httpd, th = start_server(synth)
    try:
        text, seed = SENTENCES[0], 3
        want = synth.mel_from_ids([default_symbols().encode(get_pyin(text)[0])], seed=[seed])[2][0]
        body, host_ms, _ = post(httpd.server_address[1], "/generate_tts", {"text": text, "seed": seed})
        check(body.get("status") == 0, f"{tag}: --ckpt-dir server /generate_tts failed: {body.get('error')}")
        check(want >= 1, f"{tag}: --ckpt-dir server decoded {want} frames")
        check_wav(body["wav_b64"], f"{tag}: --ckpt-dir /generate_tts", want * 275)
    finally:
        stop_server(httpd, th)
    phase(tag, f"server --ckpt-dir {os.path.relpath(taco_ckpt, HERE)} --wavernn-ckpt-dir "
          f"{os.path.relpath(wavernn_ckpt, HERE)}: /generate_tts {host_ms:.1f} ms host, {want} frames, "
          f"WAV of {want} x 275 samples")
    return out


# ---------------------------------------------------------------------------
# the CBHG mel->linear head and the DeepMind WaveRNN
# ---------------------------------------------------------------------------


def cbhg_work(tcfg, frames: int) -> float:
    """Operations (2 x multiply-adds) of the CBHG head's forward over
    ``frames`` frames: the bank, both projections, the highways, the BiGRU
    (input and recurrent products) and the linear projection."""
    M, K, C = 80, tcfg.cbhg_kernels, tcfg.cbhg_conv_channels
    Pj, H, G = tcfg.cbhg_projection, tcfg.cbhg_highway_units, tcfg.cbhg_rnn_units
    macs = (K * (K + 1) // 2 * M * C + 3 * K * C * Pj + 3 * Pj * M + M * H
            + 2 * tcfg.cbhg_highwaynet_layers * H * H + 2 * 3 * G * (H + G) + 2 * G * 1025)
    return 2.0 * macs * frames


def top2_gap(z) -> float:
    """(top - second) / |top| of a logit vector."""
    a, b = np.sort(np.asarray(z, np.float64))[-2:][::-1]
    return float((a - b) / max(abs(a), 1e-30))


# card vs CPU of the head's train step at B=4, T_in=32, T=64: as TRAIN_CFG_TOL,
# and the head's BN statistics as tests/torch_train_parity.py holds them:
# |d| <= tol x |x| + 1e-6, under mixed precision also + tol x max|x| of the
# vector (a batch mean of near-zero outputs is a small difference of sums)
CBHG_STAT_TOL = {"f32": 1e-5, "bf16": 1e-2}
CBHG_SERVE_TOL = 1e-4  # the head on the card vs the CPU, max|d linear| / max|linear|
DM_TOL = (1e-5, 1e-3)  # DeepMind loss relative, gradient / max|g| of each leaf


def run_cbhg_variants(cfg, dev, smi: str, batch: dict, wavernn_params, corpus_meta: str, corpus_dir: str,
                      serve_frames: int, steps: int = 2, gta_utts: int = 8, head_shapes=((16, 1024),),
                      dm_hidden: int = 896, dm_train=(4, 1000), dm_gen=(2, 2000)) -> dict:
    """The CBHG mel->linear head (``tacotron.predict_linear``) served,
    trained and through GTA, and the DeepMind WaveRNN, card against CPU.
    Returns what the kernels line needs."""
    import torch

    from tacotronv2_wavernn_chinese_tpu_torch import ops
    from tacotronv2_wavernn_chinese_tpu_torch.frontend import get_pyin
    from tacotronv2_wavernn_chinese_tpu_torch.infer.gta import generate_gta
    from tacotronv2_wavernn_chinese_tpu_torch.infer.synthesizer import Synthesizer
    from tacotronv2_wavernn_chinese_tpu_torch.models import tacotron as T
    from tacotronv2_wavernn_chinese_tpu_torch.models import wavernn_deepmind as DM
    from tacotronv2_wavernn_chinese_tpu_torch.serving.export import load_exported, write_artifact
    from tacotronv2_wavernn_chinese_tpu_torch.train import tacotron_task as task
    from tacotronv2_wavernn_chinese_tpu_torch.utils import precision as P
    from tacotronv2_wavernn_chinese_tpu_torch.utils import tree_leaves, tree_map
    from tacotronv2_wavernn_chinese_tpu_torch.utils.checkpoints import init_tacotron

    tag = "cbhg + variants"
    cpu = torch.device("cpu")
    to_cpu = lambda tree: tree_map(lambda t: t.detach().cpu(), tree)
    hcfg = cfg.override("tacotron.predict_linear=true")
    tcfg = hcfg.tacotron
    rng = np.random.default_rng(71)
    out = {}

    # -- serve: a predict_linear artifact with WaveRNN weights --------------
    tp = with_stop_bias(init_tacotron(70, tcfg, device=dev), -30.0)
    art = os.path.join(HERE, "build", "chip_smoke_cbhg_artifact")
    write_artifact(hcfg, tp, art, wavernn_params)
    synth = load_exported(art, max_iters=serve_frames, device=dev)
    check(synth.cfg.tacotron.predict_linear and synth.vocoder_params is not None,
          f"{tag}: the artifact lost the head or the vocoder")
    text, seed = SENTENCES[1], 4
    ids = synth.symbols.encode(get_pyin(text)[0])
    want = synth.mel_from_ids([ids], seed=[seed])[2][0]
    httpd, th = start_server(synth)
    try:
        ops.reset_launch_counts()
        body, host_ms, ev_ms = post(httpd.server_address[1], "/generate_tts", {"text": text, "seed": seed})
        launches = {k: ops.LAUNCHES[k] for k in ("wavernn_sample", "tacotron_decode")}
    finally:
        stop_server(httpd, th)
    check(body.get("status") == 0, f"{tag}: /generate_tts failed: {body.get('error')}")
    check_wav(body["wav_b64"], f"{tag}: /generate_tts", want * 275)
    check(launches["tacotron_decode"] >= 1 and launches["wavernn_sample"] >= 1,
          f"{tag}: the predict_linear request launched {launches}")
    out["serve_launches"] = launches
    phase(tag, f"{smi}: predict_linear /generate_tts {host_ms:.1f} ms host, {ev_ms:.1f} ms CUDA events, {want} "
          f"frames, WAV of {want} x 275 samples; launches {launches}")

    # the head alone, on the request's postnet mel: card (IEEE f32, and TF32
    # as a control) against the CPU, and times by CUDA events
    inputs = torch.as_tensor([ids], device=dev)
    lens = torch.as_tensor([len(ids)], device=dev)
    mel = T.forward_inference(synth.params, tcfg, inputs, lens, [seed], serve_frames).mel_outputs
    check(mel.shape[1] == want, f"{tag}: forward_inference gave {mel.shape[1]} frames, the request {want}")
    lin_cpu = T.apply_cbhg(to_cpu(synth.params), tcfg, mel.cpu())
    errs = {}
    for mode in ("ieee", "tf32"):
        with P.fp32_precision(mode):
            lin = T.apply_cbhg(synth.params, tcfg, mel)
        check(bool(torch.isfinite(lin).all()) and lin.shape == (1, want, 1025), f"{tag}: head output {lin.shape}")
        errs[mode] = float((lin.cpu() - lin_cpu).abs().max() / lin_cpu.abs().max())
    check(errs["ieee"] <= CBHG_SERVE_TOL, f"{tag}: head card vs CPU {errs['ieee']:.3e} > {CBHG_SERVE_TOL}")
    check(errs["tf32"] > errs["ieee"], f"{tag}: the head check cannot tell TF32 from IEEE f32: {errs}")
    times = {}
    w_bytes = 4 * sum(t.numel() for t in tree_leaves([synth.params["cbhg"], synth.params["linear_projection"]]))
    with P.fp32_precision():
        for Bh, Th in ((1, want),) + tuple(head_shapes):
            x = mel if Bh == 1 else torch.as_tensor(rng.uniform(-4, 4, (Bh, Th, 80)).astype(np.float32), device=dev)
            ms = cuda_ms(lambda: T.apply_cbhg(synth.params, tcfg, x), reps=5, warmup=True)
            times[f"{Bh}x{Th}"] = (ms, *bound(cbhg_work(tcfg, Bh * Th), w_bytes + 4 * Bh * Th * (80 + 1025)))
    # one request's text->mel with and without the head, same weights
    plain_params = {k: v for k, v in synth.params.items() if k not in ("cbhg", "linear_projection")}
    nohead = Synthesizer(cfg, plain_params, max_iters=serve_frames, device=dev)
    t2m = {name: cuda_ms(lambda s=s: s.mel_from_ids([ids], seed=[seed]), reps=3, warmup=True)
           for name, s in (("head", synth), ("no head", nohead))}
    out.update(serve_err=errs, head_ms=times, text_to_mel_ms=t2m)
    phase(tag, f"{smi}: head card vs CPU on the request's postnet mel max|d|/max|linear| {errs['ieee']:.2e} "
          f"(tol {CBHG_SERVE_TOL:g}; TF32 control {errs['tf32']:.2e}); head alone (CUDA events) "
          + ", ".join(f"B x T = {k}: {v[0]:.3f} ms (bound {v[1]:.3f}, {v[2]})" for k, v in times.items())
          + f"; text->mel {t2m['head']:.2f} ms with the head, {t2m['no head']:.2f} without")

    # -- train: two steps with the head, beside two without ----------------
    B, T_in = batch["inputs"].shape
    T_out = batch["mel_targets"].shape[1]
    lin_t = torch.as_tensor(rng.uniform(-4, 4, (B, T_out, 1025)).astype(np.float32), device=dev)
    step_ms = {}
    for name, ccfg, b in (("head", hcfg, dict(batch, linear_targets=lin_t)), ("no head", cfg, batch)):
        check(T.core_route(ccfg.tacotron, True, 1.0) == "kernel", f"{tag}: {name} left the kernel route")
        s = task.init_state(80, ccfg, dev)
        gen = torch.Generator(device=dev)
        gen.manual_seed(0)
        ops.reset_launch_counts()
        ms, metrics = [], []
        for _ in range(steps):
            e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            torch.cuda.synchronize()
            e0.record()
            s, m = task.train_step(s, b, gen, ccfg)
            e1.record()
            torch.cuda.synchronize()
            ms.append(e0.elapsed_time(e1))
            metrics.append(m)
        k34 = {k: ops.LAUNCHES[k] for k in ("tacotron_train_fwd", "tacotron_train_bwd", *ENCODER_KEYS)}
        step_ms[name] = ms
        if name == "head":
            head_params, out["train_launches"] = s.params, k34
            check(all(np.isfinite([m["loss"], m["linear"]]).all() for m in metrics),
                  f"{tag}: head step metrics {metrics}")
            check(k34["tacotron_train_fwd"] == steps and k34["tacotron_train_bwd"] == steps,
                  f"{tag}: {steps} head steps launched K3/K4 {k34}")
        phase(tag, f"{smi}: train_step {name} B={B} T_in={T_in} T={T_out}: losses "
              + ", ".join(f"{m['loss']:.4f}" for m in metrics)
              + ("; linear " + ", ".join(f"{m['linear']:.4f}" for m in metrics) if name == "head" else "")
              + " ; ms/step (CUDA events) " + ", ".join(f"{v:.1f}" for v in ms) + f"; K3/K4 launches {k34}")
    out["step_ms"] = step_ms

    # card vs CPU at B=4, f32 and mixed precision, the CPU's ReLUs pinned
    zero = {f"postnet/layers/{tcfg.postnet_layers - 1}/conv/b", "cbhg/proj2/conv/b"}  # linear into BatchNorm
    for kind, ccfg in (("f32", hcfg), ("bf16", hcfg.override("tacotron_train.mixed_precision=true"))):
        small = dict(tc_small_batch(ccfg, cpu, 90),
                     linear_targets=torch.as_tensor(rng.uniform(-4, 4, (4, 64, 1025)).astype(np.float32)))
        p_cpu = to_cpu(head_params)
        rand = T.draw_train_rand(p_cpu, ccfg.tacotron, 4, 32, 64, torch.Generator().manual_seed(7), True, 1.0)
        with P.fp32_precision():
            card = tc_loss_and_grads(ccfg, p_cpu, small, rand, 1.0, dev)
            host = tc_loss_and_grads(ccfg, p_cpu, small, rand, 1.0, cpu, relus=card["relus"])
        loss_rel = abs(card["loss"] - host["loss"]) / abs(host["loss"])
        g_err, g_at = tc_grad_error(card, host, zero)
        tol_loss, tol_grad = TRAIN_CFG_TOL[kind]
        st = CBHG_STAT_TOL[kind]
        # the largest |d| / (the gate's allowance) over the head's statistics: <= 1 passes
        s_err, s_at = max((float(((card["stats"][k] - v).abs() / (st * v.abs() + 1e-6 + (
            st * v.abs().max() if kind == "bf16" else 0.0))).max()), k)
            for k, v in host["stats"].items() if k.startswith("cbhg/"))
        s_rel = max(float((card["stats"][k] - v).abs().max() / v.abs().max()) for k, v in host["stats"].items()
                    if k.startswith("cbhg/"))
        phase(tag, f"{smi}: head step card vs CPU ({kind}) at B=4 T_in=32 T=64: loss {card['loss']!r} / "
              f"{host['loss']!r} (linear {card['aux']['linear']:.6f} / {host['aux']['linear']:.6f}), "
              f"{loss_rel:.2e} relative (tol {tol_loss:g}), gradient max|d|/max|g| {g_err:.2e} at {g_at} "
              f"(tol {tol_grad:g}), the head's BN statistics at {s_err:.2f} of their gate ({s_at}; |d| <= "
              f"{st:g} |x| + 1e-6{' + %g max|x|' % st if kind == 'bf16' else ''}; max|d| / max|x| of a vector "
              f"{s_rel:.2e}), "
              f"{host['flips']} of {host['units']} CPU ReLU units pinned to the card's side")
        check(loss_rel <= tol_loss, f"{tag}: {kind} card vs CPU loss {loss_rel:.3e} > {tol_loss}")
        check(g_err <= tol_grad, f"{tag}: {kind} card vs CPU gradient {g_err:.3e} > {tol_grad} at {g_at}")
        check(s_err <= 1.0, f"{tag}: {kind} card vs CPU BN statistic {s_at} at {s_err:.3f} of its gate")
        out.setdefault("card_cpu", {})[kind] = {"loss": loss_rel, "grad": g_err, "stats": s_err, "stats_rel": s_rel}

    # GTA of one batch with the head: K3's eval branch, then the head
    with open(corpus_meta, encoding="utf-8") as f:
        shards = max(1, len(f.read().splitlines()) // gta_utts)
    gta_dir = os.path.join(HERE, "build", "chip_smoke_gta_cbhg")
    shutil.rmtree(gta_dir, ignore_errors=True)
    ops.reset_launch_counts()
    t0 = time.time()
    path = generate_gta(hcfg, to_cpu(head_params), corpus_meta, corpus_dir, gta_dir, batch_size=gta_utts,
                        num_shards=shards, log=lambda m: None, device=dev)
    gta_s, k3 = time.time() - t0, ops.LAUNCHES["tacotron_train_fwd"]
    with open(path, encoding="utf-8") as f:
        lines = f.read().splitlines()
    check(0 < len(lines) <= gta_utts, f"{tag}: GTA wrote {len(lines)} rows")
    for line in lines:
        check(np.isfinite(np.load(os.path.join(gta_dir, line.split("|")[2]))).all(), f"{tag}: GTA {line}")
    check(k3 == 1, f"{tag}: GTA with the head launched K3 {k3} times, expected 1")
    out["gta_k3"] = k3
    phase(tag, f"GTA with the head: {len(lines)} utterances in one batch, {gta_s:.2f} s host, K3 launches {k3}")

    # -- the DeepMind WaveRNN ----------------------------------------------
    dmp = DM.init_deepmind_wavernn(91, dm_hidden)
    Bt, Tt = dm_train
    coarse, fine = DM.split_signal_16bit(torch.as_tensor(rng.uniform(-0.9, 0.9, (Bt, Tt + 1)).astype(np.float32)))

    def dm_loss_grads(d, relus=None):
        leaves = tree_map(lambda t: t.to(d).requires_grad_(True), dmp)
        with P.fp32_precision(), relu_pattern(relus) as pattern:
            loss = DM.loss(leaves, coarse.to(d), fine.to(d))
            grads = torch.autograd.grad(loss, tree_leaves(leaves))
        return float(loss.detach()), [g.cpu() for g in grads], pattern

    t0 = time.time()
    l_card, g_card, pat = dm_loss_grads(dev)
    card_s = time.time() - t0
    l_host, g_host, pat_host = dm_loss_grads(cpu, pat.masks)
    loss_rel = abs(l_card - l_host) / abs(l_host)
    g_err = max(float((a - b).abs().max() / b.abs().max()) for a, b in zip(g_card, g_host))
    check(loss_rel <= DM_TOL[0] and g_err <= DM_TOL[1],
          f"{tag}: DeepMind loss {loss_rel:.3e} / gradients {g_err:.3e} card vs CPU beyond {DM_TOL}")
    phase(tag, f"{smi}: DeepMind WaveRNN hidden {dm_hidden} loss and gradients at B={Bt} T={Tt}: card "
          f"{card_s:.2f} s host; card vs CPU loss {loss_rel:.2e} relative, gradients max|d|/max|g| {g_err:.2e} "
          f"(tol {DM_TOL[0]:g}, {DM_TOL[1]:g}), {pat_host.flips} of {pat_host.units} CPU ReLU units pinned")

    Bg, n = dm_gen
    gumbel = DM.draw_gumbel(n, Bg, torch.Generator().manual_seed(92), cpu)
    p_dev, g_dev = tree_map(lambda t: t.to(dev), dmp), gumbel.to(dev)
    with P.fp32_precision():
        DM.generate(p_dev, 8, batch=Bg, gumbel=g_dev[:8])
        box = {}
        dm_ms = cuda_ms(lambda: box.__setitem__("wav", DM.generate(p_dev, n, batch=Bg, gumbel=g_dev)))
    host = DM.generate(dmp, n, batch=Bg, gumbel=gumbel)
    to_u = lambda w: np.rint((w.cpu().numpy().astype(np.float64) + 1.0) * 32767.5).astype(np.int64)
    u_card, u_host = to_u(box["wav"]), to_u(host)
    diverged = 0
    for b in range(Bg):
        bad = np.nonzero(u_card[b] != u_host[b])[0]
        if bad.size == 0:
            continue
        t = int(bad[0])
        # the CPU's logits at step t, teacher-forced along the common prefix
        c, f = u_card[b] // 256, u_card[b] % 256
        seq = lambda v: torch.as_tensor(np.concatenate([[0], v]).astype(np.float32)[None] / 255.0)
        oc, of = DM.train_forward(dmp, seq(c), seq(f))
        coarse_off = c[t] != u_host[b, t] // 256
        z = (oc if coarse_off else of)[0, t] + gumbel[t, 0 if coarse_off else 1, b]
        gap = top2_gap(z.detach().numpy())
        phase(tag, f"DeepMind generate row {b}: first mismatch at step {t} ({'coarse' if coarse_off else 'fine'}), "
              f"CPU top-2 gap {gap:.3e} of the top")
        check(gap < NEAR_TIE, f"{tag}: DeepMind row {b} diverged at step {t} with top-2 gap {gap:.3e}")
        diverged += 1
    out["deepmind"] = {"loss": loss_rel, "grad": g_err, "us_per_sample": dm_ms / n * 1e3, "diverged": diverged}
    phase(tag, f"{smi}: DeepMind generate {Bg} x {n} samples (CUDA events) {dm_ms:.1f} ms, "
          f"{dm_ms / n * 1e3:.1f} us a sample; card vs CPU with the same Gumbel draws: "
          f"{Bg - diverged} of {Bg} rows equal, {diverged} diverged after a near-tie")
    return out


# ---------------------------------------------------------------------------
# parallel: data-parallel training, fold-sharded generation, WaveRNN DP x TP
# ---------------------------------------------------------------------------

PAR_WORLD = 2
PAR_SHAPE = (32, 160, 608)  # B, T_in, T of the data-parallel Tacotron step (16 rows a rank)
PAR_TP_BATCH = 4
PAR_SEED = 81
# (loss relative, gradient / max|g|, BN statistic |d| <= rel |x| + abs): the
# trainer gates of the train configs phase and the head's statistics gate
PAR_TOL = {"loss": 1e-5, "grad": 1e-3, "stat": (1e-5, 1e-6), "tp_loss": 1e-4, "xfade": 1e-4,
           "params": 2e-6}  # params after one step: the optimizer tests' tolerance


def par_taco_batch(cfg, dev, shape) -> dict:
    """The data-parallel step's batch (``shape`` B, T_in, T): rows ragged
    and longer in the first half (rank 0's), ``loss_frames`` at each row's
    target length, so every loss branch's denominators differ between the
    ranks."""
    B, T_in, T = shape
    b = tc_small_batch(cfg, dev, PAR_SEED, B=B, T_in=T_in, T=T)
    return dict(b, loss_frames=b["target_lengths"].clone())


def par_wavernn_batch(cfg, dev, seed: int, B: int) -> dict:
    """Vocoder windows of the training shape (1,375 samples at the default
    config) from a numpy seed."""
    import torch

    wc, a = cfg.wavernn_train, cfg.audio
    rng = np.random.default_rng(seed)
    T = wc.seq_len_hops * a.hop_size
    t = lambda x: torch.as_tensor(x, device=dev)
    return {"x": t(rng.uniform(-1, 1, (B, T)).astype(np.float32)),
            "y": t(rng.integers(0, 2 ** a.bits, (B, T))),
            "mels": t(rng.uniform(0, 1, (B, wc.seq_len_hops + 2 * cfg.wavernn.pad, a.num_mels)).astype(np.float32))}


def adam_step_error(got: dict, want: dict, lr: float) -> tuple:
    """Params after one Adam step from two computations of its gradients
    (``got``/``want``: "params", "grads"), by the rule of the port's step
    tests: (max|d| where the gradient is not Adam-sensitive, max|d|
    anywhere, the share of elements past ``PAR_TOL["params"]``).  Adam's
    first step moves an element by lr g / (|g| + e), e its epsilon in
    gradient units, so where |g| < 1e-4 or the two gradients are 1 % apart,
    rounding moves it by up to 2 lr; elsewhere a difference of up to 1 % in
    g moves it by up to lr / 400 (at |g| = e)."""
    from tacotronv2_wavernn_chinese_tpu_torch.utils import tree_leaves

    grads = {n: (a, b) for n, a, b in zip(leaf_names(got["grads"]), tree_leaves(got["grads"]),
                                           tree_leaves(want["grads"]), strict=True)}
    pw = dict(zip(leaf_names(want["params"]), tree_leaves(want["params"]), strict=True))
    firm = anywhere = 0.0
    n_past = n_all = 0
    for name, p in zip(leaf_names(got["params"]), tree_leaves(got["params"]), strict=True):
        d = (p - pw[name]).abs()
        ga, gw = grads[name]
        firm_part = d[(gw.abs() >= 1e-4) & ((ga - gw).abs() <= 0.01 * gw.abs())]
        firm = max(firm, float(firm_part.max()) if firm_part.numel() else 0.0)
        anywhere = max(anywhere, float(d.max()))
        n_past += int((d > PAR_TOL["params"]).sum())
        n_all += d.numel()
    return firm, anywhere, n_past / n_all


def rank_rows(mask, B: int, rank: int, world: int):
    """A rank's rows of a ReLU pattern recorded on the global batch: the
    block of its batch dim (the one dim of size ``B``)."""
    dims = [d for d, n in enumerate(mask.shape) if n == B]
    assert len(dims) == 1, (tuple(mask.shape), B)
    k = B // world
    return mask.narrow(dims[0], rank * k, k)


def _timed(fn, dev):
    """(fn(), ms by CUDA events; 0.0 on the CPU)."""
    import torch

    if dev.type != "cuda":
        return fn(), 0.0
    e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    e0.record()
    r = fn()
    e1.record()
    torch.cuda.synchronize()
    return r, e0.elapsed_time(e1)


def parallel_rank(rank: int, world: int, work: str) -> None:
    """One rank of the phase's two-rank world (gloo over the one card):
    the data-parallel Tacotron step at both ``mask_decoder`` settings, its
    ReLUs pinned to the one-process step's rows; ``run_training`` with a
    resume; fold-sharded generation; the TP step.  Writes ``rank<r>.pt``."""
    import torch

    from tacotronv2_wavernn_chinese_tpu_torch import ops
    from tacotronv2_wavernn_chinese_tpu_torch.parallel import distributed as D
    from tacotronv2_wavernn_chinese_tpu_torch.parallel import generate as G
    from tacotronv2_wavernn_chinese_tpu_torch.parallel import mesh as PM
    from tacotronv2_wavernn_chinese_tpu_torch.parallel import tp as TP
    from tacotronv2_wavernn_chinese_tpu_torch.train import tacotron_task as task
    from tacotronv2_wavernn_chinese_tpu_torch.train import tacotron_train as TR
    from tacotronv2_wavernn_chinese_tpu_torch.train import wavernn_task as WT
    from tacotronv2_wavernn_chinese_tpu_torch.utils import precision as P
    from tacotronv2_wavernn_chinese_tpu_torch.utils import tree_leaves
    from tacotronv2_wavernn_chinese_tpu_torch.utils.checkpoints import (
        init_tacotron, init_wavernn, load_params_npz, wavernn_from_numpy,
    )

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    spec = torch.load(os.path.join(work, "spec.pt"), weights_only=False)
    cfg, on_cpu = spec["cfg"], spec["device"] == "cpu"
    D.initialize(f"file://{os.path.join(work, 'rendezvous')}", world, rank, backend="gloo",
                 device="cpu" if on_cpu else None)
    dev = torch.device("cpu") if on_cpu else torch.device("cuda", torch.cuda.current_device())
    D.build_kernels(dev)
    mesh = PM.make_mesh()
    out = {"device": str(dev)}

    # the data-parallel Tacotron step, 16 of 32 rows a rank
    B = spec["shape"][0]
    params = init_tacotron(PAR_SEED, cfg.tacotron, device=dev)
    local = PM.shard_batch(mesh, par_taco_batch(cfg, dev, spec["shape"]))
    rows = [rank_rows(m, B, rank, world) for m in spec["taco_relus"]]
    for md in (False, True):
        ccfg = cfg.override(f"tacotron_train.mask_decoder={md}")
        gen = torch.Generator(device=dev)
        gen.manual_seed(PAR_SEED)
        ops.reset_launch_counts()
        with relu_pattern(rows) as pat, P.fp32_precision():
            (loss, aux, new, grads), ms = _timed(lambda: task.compute_grads(params, ccfg, local, gen, 0, mesh=mesh),
                                                 dev)
        out[f"taco_md{int(md)}"] = {
            "loss": float(loss), "aux": {k: float(v) for k, v in aux.items()}, "ms": ms, "flips": pat.flips,
            "grads": [g.detach().cpu() for g in tree_leaves(grads)],
            "stats": {n: t.detach().cpu() for n, t in zip(leaf_names(new), tree_leaves(new)) if n.endswith(("bn/mean", "bn/var"))},
            "launches": {k: ops.LAUNCHES[k] for k in ("tacotron_train_fwd", "tacotron_train_bwd")}}

    # run_training, data-parallel: two steps with a checkpoint each, then a resume
    logs: list = []
    run_cfg = cfg.override("tacotron_train.checkpoint_interval=1,tacotron_train.summary_interval=1")
    ops.reset_launch_counts()
    t0 = time.time()
    s1 = TR.run_training(run_cfg, spec["corpus_meta"], spec["corpus_dir"], spec["log_dir"], total_steps=2,
                         device=dev, render_eval=False, log=logs.append)
    s2 = TR.run_training(run_cfg, spec["corpus_meta"], spec["corpus_dir"], spec["log_dir"], total_steps=3,
                         device=dev, render_eval=False, log=logs.append)
    out["run"] = {"steps": [s1.step, s2.step], "logs": logs, "s": time.time() - t0,
                  "launches": {k: ops.LAUNCHES[k] for k in ("tacotron_train_fwd", "tacotron_train_bwd")},
                  "checksum": float(sum(float(t.double().sum()) for t in tree_leaves(s2.params)))}

    # fold-sharded generation of the served mel: 16 folds, 8 a rank
    wcfg, bits = cfg.wavernn, cfg.audio.bits
    wp = wavernn_from_numpy(load_params_npz(spec["vocoder_npz"]), wcfg, dev, cfg.audio.num_mels, bits)
    folds = torch.as_tensor(spec["folds"], device=dev)
    ops.reset_launch_counts()
    gen_out, gen_ms = {}, {}
    with torch.no_grad():
        for name, kw in (("greedy", dict(greedy=True)), ("sampled", dict(seed=spec["gen_seed"]))):
            y, gen_ms[name] = _timed(lambda: G.generate_folds_sharded(wp, wcfg, mesh, folds, bits=bits,
                                                                      apply_mu_law=False, **kw), dev)
            gen_out[name] = y.cpu()
        for xf in (True, False):
            gen_out[f"dist_{xf}"], gen_ms[f"dist_{xf}"] = _timed(lambda: G.generate_distributed(
                wp, wcfg, cfg.wavernn_gen, mesh, spec["mel"], seed=1, bits=bits, apply_mu_law=cfg.audio.mu_law,
                device_crossfade=xf), dev)
    out["gen"] = dict(gen_out, ms=gen_ms, launches=ops.LAUNCHES["wavernn_sample"])

    # WaveRNN dp=1 x tp=2 at the default width
    mesh2 = TP.make_mesh_2d(dp=1, tp=world)
    wpt = init_wavernn(PAR_SEED + 1, wcfg, cfg.audio.num_mels, bits, device=dev)
    state = TP.place_wavernn_state(mesh2, WT.TrainState(0, wpt, WT.adam_init(wpt)))
    batches = [par_wavernn_batch(cfg, dev, PAR_SEED + i, spec["tp_batch"]) for i in range(2)]
    with relu_pattern(spec["tp_relus"]) as pat, WT.fp32_precision():
        (loss, _, grads), tp_ms = _timed(lambda: WT.compute_grads(state.params, cfg, batches[0], mesh2), dev)
    full = [g.detach().cpu().double() for g in tree_leaves(TP.gather_params(mesh2, grads))]
    losses, step_ms = [], []
    for b in batches:
        (state, m), ms = _timed(lambda: WT.train_step(state, b, cfg, mesh2), dev)
        losses.append(m["loss"])
        step_ms.append(ms)
    sp, so = state.params, state.opt_state
    out["tp"] = {"loss": float(loss), "grads": full, "flips": pat.flips, "units": pat.units, "losses": losses,
                 "ms": tp_ms, "step_ms": step_ms,
                 "shapes": {"fc3/w": tuple(sp["fc3"]["w"].shape), "gru1/wi": tuple(sp["gru1"]["wi"].shape),
                            "I/w": tuple(sp["I"]["w"].shape), "mu/fc3/w": tuple(so["mu"]["fc3"]["w"].shape),
                            "nu/gru2/wh": tuple(so["nu"]["gru2"]["wh"].shape), "fc3/b": tuple(sp["fc3"]["b"].shape)}}
    torch.save(out, os.path.join(work, f"rank{rank}.pt"))
    D.shutdown()


def run_parallel(cfg, dev, smi: str, art: str, shape=PAR_SHAPE, w_batch: int = 32, tp_batch: int = PAR_TP_BATCH) -> dict:
    """(i) A world of 1 (NCCL on the card), in this process: its mesh keeps
    the world's group, so the data-parallel Tacotron and WaveRNN steps take
    their sharded branch (the global mask draw cut to one shard, the
    summed loss denominators and BatchNorm moments, the flat gradient
    all-reduce) with every collective over NCCL, counted; against the plain
    steps at the trainer gates (the BatchNorm moments come from sums, not
    mean and var, so not bit for bit).  (ii) Two ranks on the one card
    (gloo: NCCL takes one rank a card), spawned: ``parallel_rank``'s checks
    against one-process references computed here.  Returns what the
    kernels line needs."""
    import torch
    import torch.distributed as dist
    import torch.multiprocessing as mp

    from tacotronv2_wavernn_chinese_tpu_torch import ops
    from tacotronv2_wavernn_chinese_tpu_torch.dsp import spectrogram as S
    from tacotronv2_wavernn_chinese_tpu_torch.frontend import get_pyin
    from tacotronv2_wavernn_chinese_tpu_torch.models import tacotron as TT
    from tacotronv2_wavernn_chinese_tpu_torch.models import wavernn as W
    from tacotronv2_wavernn_chinese_tpu_torch.ops import wavernn_kernel as WK
    from tacotronv2_wavernn_chinese_tpu_torch.parallel import generate as G
    from tacotronv2_wavernn_chinese_tpu_torch.parallel import mesh as PM
    from tacotronv2_wavernn_chinese_tpu_torch.serving.export import load_exported
    from tacotronv2_wavernn_chinese_tpu_torch.train import tacotron_task as task
    from tacotronv2_wavernn_chinese_tpu_torch.train import wavernn_task as WT
    from tacotronv2_wavernn_chinese_tpu_torch.utils import tree_leaves
    from tacotronv2_wavernn_chinese_tpu_torch.utils.checkpoints import init_tacotron, init_wavernn

    tag = "parallel"
    work = os.path.join(HERE, "build", "chip_smoke_parallel")
    if os.path.isdir(work):
        shutil.rmtree(work)
    os.makedirs(work)
    B, T_in, T = shape
    k34 = ("tacotron_train_fwd", "tacotron_train_bwd")
    counts = lambda keys: {k: ops.LAUNCHES[k] for k in keys}
    summary = []  # the phase's key numbers, printed again at the end of the output
    tol_rel, tol_abs = PAR_TOL["stat"]
    # (i) a world of 1, in this process; every all-reduce of a step counted
    backend = "nccl" if dev.type == "cuda" else "gloo"
    dist.init_process_group(backend, store=dist.FileStore(os.path.join(work, "store1"), 1), rank=0, world_size=1)
    all_reduce, n_coll = dist.all_reduce, [0]

    def counted_all_reduce(*args, **kwargs):
        n_coll[0] += 1
        return all_reduce(*args, **kwargs)

    dist.all_reduce = counted_all_reduce
    try:
        mesh1 = PM.make_mesh()
        check(mesh1.size == 1 and mesh1.groups["data"] is not None,
              f"{tag}: a world of 1 made a mesh of {mesh1.size} without its group")
        tparams = init_tacotron(PAR_SEED, cfg.tacotron, device=dev)
        batch = par_taco_batch(cfg, dev, shape)
        wparams = init_wavernn(PAR_SEED, cfg.wavernn, cfg.audio.num_mels, cfg.audio.bits, device=dev)
        wbatch = par_wavernn_batch(cfg, dev, PAR_SEED, w_batch)
        # plain, data-parallel, plain again (the second plain step shows the
        # card's own run-to-run spread): each step's gradients, then the step.
        # The data-parallel runs take the plain runs' ReLU patterns, as the
        # two-rank check does: a unit within rounding of zero may land on
        # either side and move its layer's gradients by a position's term
        runs = {"Tacotron": {}, "WaveRNN": {}}
        zero_bias = {f"postnet/layers/{cfg.tacotron.postnet_layers - 1}/conv/b"}
        patterns = {}

        def pinned(key, pin, fn):
            with WT.fp32_precision(), relu_pattern(patterns[key] if pin else None) as pat:
                out = fn()
            patterns.setdefault(key, pat.masks)
            return out, pat.flips

        for name, m in (("plain", None), ("dp", mesh1), ("plain2", None)):
            pin = m is not None
            gen = torch.Generator(device=dev)
            gen.manual_seed(PAR_SEED)
            (_, _, new, g), flips = pinned("taco_grads", pin, lambda: task.compute_grads(tparams, cfg, batch, gen, 0,
                                                                                            mesh=m))
            gen.manual_seed(PAR_SEED)
            ops.reset_launch_counts()
            n0 = n_coll[0]
            (st, met), _ = pinned("taco_step", pin, lambda: task.train_step(
                task.TrainState(0, tparams, task.adam_init(tparams)), batch, gen, cfg, m))
            runs["Tacotron"][name] = {"params": st.params, "metrics": met, "grads": g, "new": new, "flips": flips,
                                      "all_reduces": n_coll[0] - n0, "launches": counts(k34)}
            (_, new, g), flips = pinned("wavernn_grads", pin, lambda: WT.compute_grads(wparams, cfg, wbatch, m))
            n0 = n_coll[0]
            (st, met), _ = pinned("wavernn_step", pin, lambda: WT.train_step(
                WT.TrainState(0, wparams, WT.adam_init(wparams)), wbatch, cfg, m))
            runs["WaveRNN"][name] = {"params": st.params, "metrics": met, "grads": g, "new": new, "flips": flips,
                                     "all_reduces": n_coll[0] - n0}
        for model, r in runs.items():
            lr = cfg.tacotron_train.initial_lr if model == "Tacotron" else cfg.wavernn_train.lr
            dp, plain = r["dp"], r["plain"]
            g_err, g_at = tc_grad_error(
                {"grads": tree_leaves(dp["grads"])},
                {"grads": tree_leaves(plain["grads"]), "names": leaf_names(plain["grads"])}, zero_bias)
            g_rep = tc_grad_error(
                {"grads": tree_leaves(r["plain2"]["grads"])},
                {"grads": tree_leaves(plain["grads"]), "names": leaf_names(plain["grads"])}, zero_bias)[0]
            stat = {n: (a, b) for n, a, b in zip(leaf_names(plain["new"]), tree_leaves(dp["new"]),
                                                 tree_leaves(plain["new"]), strict=True)
                    if n.rsplit("/", 1)[-1] in ("mean", "var")}
            s_err = max(float(((a - b).abs() - tol_rel * b.abs()).max()) for a, b in stat.values())
            firm, anywhere, share = adam_step_error(dp, plain, lr)
            firm_tol = PAR_TOL["params"] + lr / 400
            d_rep = adam_step_error(r["plain2"], plain, lr)[1]
            rel = {k: abs(dp["metrics"][k] - plain["metrics"][k]) / abs(plain["metrics"][k]) for k in ("loss", "grad_norm")}
            phase(tag, f"world of 1 over {backend.upper()}: {model} data-parallel step, {dp['all_reduces']} all-reduces "
                  f"over {backend.upper()} (the plain step {plain['all_reduces']}), vs the plain step: loss "
                  f"{dp['metrics']['loss']!r} / {plain['metrics']['loss']!r} ({rel['loss']:.2e} relative), grad norm "
                  f"{rel['grad_norm']:.2e} relative (tol {PAR_TOL['loss']}); gradients max|d|/max|g| {g_err:.2e} at "
                  f"{g_at} (tol {PAR_TOL['grad']}; two plain runs {g_rep:.2e}), on the plain step's ReLU pattern "
                  f"({dp['flips']} units of its own signs differ); {len(stat)} BN statistics max(|d| - {tol_rel}|x|) "
                  f"{s_err:.2e} (tol {tol_abs}); params after the step max|d| {firm:.3e} where the gradient is not "
                  f"Adam-sensitive (tol {firm_tol:.2e}), {anywhere:.3e} anywhere (tol 2 lr = {2 * lr:g}), "
                  f"{share:.2e} of the elements past {PAR_TOL['params']} (tol 0.01); two plain steps max|d| {d_rep:.3e}")
            summary.append(f"world of 1 {model}: {dp['all_reduces']} all-reduces over {backend.upper()}, loss "
                           f"{rel['loss']:.2e}, grads {g_err:.2e} (two plain runs {g_rep:.2e}), BN {s_err:.2e}, params "
                           f"{firm:.3e} firm / {anywhere:.3e} anywhere, two plain steps {d_rep:.3e}")
            check(dp["all_reduces"] > 0 and plain["all_reduces"] == 0, f"{tag}: the world-of-1 {model} steps ran "
                  f"{dp['all_reduces']} / {plain['all_reduces']} all-reduces (data-parallel / plain)")
            check(max(rel.values()) <= PAR_TOL["loss"] and g_err <= PAR_TOL["grad"] and s_err <= tol_abs,
                  f"{tag}: the world-of-1 data-parallel {model} step: metrics {rel}, gradients {g_err:.2e} at {g_at}, "
                  f"BN statistics {s_err:.2e}")
            check(firm <= firm_tol and anywhere <= 2 * lr + PAR_TOL["params"] and share <= 0.01,
                  f"{tag}: the world-of-1 data-parallel {model} step's params {firm:.3e} / {anywhere:.3e} / {share:.2e}")
        ld = runs["Tacotron"]["dp"]["launches"]
        phase(tag, f"world of 1: Tacotron B={B} T_in={T_in} T={T}, K3/K4 launches {ld['tacotron_train_fwd']}/"
              f"{ld['tacotron_train_bwd']}; WaveRNN B={w_batch} x {wbatch['x'].shape[1]}")
        check(ld == {k: 1 for k in k34}, f"{tag}: the world-of-1 step launched K3/K4 {ld}, expected 1/1")
    finally:
        dist.all_reduce = all_reduce
        dist.destroy_process_group()

    # (ii) references for the two-rank world, computed in one process
    refs = {}
    g_cpu = torch.Generator(device=dev)
    for md in (False, True):
        ccfg = cfg.override(f"tacotron_train.mask_decoder={md}")
        g_cpu.manual_seed(PAR_SEED)
        rand = TT.draw_train_rand(tparams, ccfg.tacotron, B, T_in, T, g_cpu, True, 1.0)
        refs[md] = tc_loss_and_grads(ccfg, tparams, batch, rand, 1.0, dev)
    wcfg, bits = cfg.wavernn, cfg.audio.bits
    hop = wcfg.total_upsample
    t_f, o_f = cfg.wavernn_gen.target // hop, cfg.wavernn_gen.overlap // hop
    gen_frames = 15 * (t_f + o_f) + o_f + t_f // 2  # a mel of 16 folds, the last one partly padded
    synth = load_exported(art, max_iters=gen_frames, device=dev)
    ids = synth.symbols.encode(get_pyin(SENTENCES[0])[0])
    mel = S.mel_to_unit(synth.mel_from_ids([ids], seed=[0])[0][0], cfg.audio).astype(np.float32)
    folds, _ = W.fold_with_overlap(mel, t_f, o_f)
    folds = np.stack([W.pad_mel_for_generation(f, wcfg.pad) for f in folds])
    check(folds.shape[0] == 16, f"{tag}: the served mel of {mel.shape[0]} frames gives {folds.shape[0]} folds, not 16")
    wp = synth.vocoder_params
    tp_params = init_wavernn(PAR_SEED + 1, wcfg, cfg.audio.num_mels, bits, device=dev)
    tb = [par_wavernn_batch(cfg, dev, PAR_SEED + i, tp_batch) for i in range(2)]
    tp_card = step_on(cfg, tp_params, tb[0], dev, torch.float32)
    tp_exact = step_on(cfg, tp_params, tb[0], dev, torch.float64, masks=tp_card["masks"])
    s = WT.TrainState(0, tp_params, WT.adam_init(tp_params))
    tp_losses = []
    for b in tb:
        s, m = WT.train_step(s, b, cfg)
        tp_losses.append(m["loss"])
    corpus_dir = os.path.join(HERE, "build", "chip_smoke_corpus")
    torch.save({"cfg": cfg, "device": dev.type, "shape": shape, "tp_batch": tp_batch, "taco_relus": refs[False]["relus"], "tp_relus": tp_card["masks"],
                "folds": folds, "mel": mel, "gen_seed": 7, "vocoder_npz": os.path.join(art, "wavernn_params.npz"),
                "corpus_dir": corpus_dir, "corpus_meta": os.path.join(corpus_dir, "train.txt"),
                "log_dir": os.path.join(work, "train")}, os.path.join(work, "spec.pt"))

    t0 = time.time()
    try:
        mp.spawn(parallel_rank, args=(PAR_WORLD, work), nprocs=PAR_WORLD)
    except Exception as e:  # a rank's exception (its traceback) or exit fails the phase
        raise SmokeFailure(f"{tag}: a rank failed: {e}") from e
    ranks = [torch.load(os.path.join(work, f"rank{r}.pt"), weights_only=False) for r in range(PAR_WORLD)]
    phase(tag, f"two ranks over gloo on {ranks[0]['device']} (spawned, one process a rank): {time.time() - t0:.1f} s "
          f"wall, imports and CUDA set-up included. Two ranks on one card time-slice it: the times below are "
          f"no scaling figure")

    # the data-parallel Tacotron step against the one-process step
    dp_launches = {k: 0 for k in k34}
    for md in (False, True):
        ref, got = refs[md], [r[f"taco_md{int(md)}"] for r in ranks]
        g = got[0]
        loss_rel = abs(g["loss"] - ref["loss"]) / abs(ref["loss"])
        g_err, g_at = tc_grad_error(g, ref, {f"postnet/layers/{cfg.tacotron.postnet_layers - 1}/conv/b"})
        s_err = max(float(((g["stats"][n] - v).abs() - tol_rel * v.abs()).max()) for n, v in ref["stats"].items())
        aux_rel = max(abs(g["aux"][k] - v) / max(abs(v), 1e-12) for k, v in ref["aux"].items())
        for r in got:
            for k in k34:
                dp_launches[k] += r["launches"][k]
        phase(tag, f"{smi}: data-parallel Tacotron step mask_decoder={md}, {PAR_WORLD} x {B // PAR_WORLD} rows "
              f"(T_in={T_in}, T={T}, lengths uneven across the halves) vs one process x {B}: loss {g['loss']!r} / {ref['loss']!r} ({loss_rel:.2e} relative, "
              f"tol {PAR_TOL['loss']}), aux terms {aux_rel:.2e}, gradients max|d|/max|g| {g_err:.2e} at {g_at} "
              f"(tol {PAR_TOL['grad']}), BN statistics max(|d| - {tol_rel}|x|) {s_err:.2e} (tol {tol_abs}); "
              f"ReLUs pinned to the one-process pattern ({sum(r['flips'] for r in got)} units of the ranks' own "
              f"signs differ); ms per rank (CUDA events) " + ", ".join(f"{r['ms']:.1f}" for r in got)
              + "; K3/K4 launches per rank " + ", ".join(f"{r['launches']['tacotron_train_fwd']}/"
                                                          f"{r['launches']['tacotron_train_bwd']}" for r in got))
        summary.append(f"DP 2x{B // PAR_WORLD} vs {B} md={md}: loss {loss_rel:.2e}, grads {g_err:.2e}, BN {s_err:.2e}, "
                       f"ms " + "/".join(f"{r['ms']:.1f}" for r in got))
        check(loss_rel <= PAR_TOL["loss"] and aux_rel <= PAR_TOL["loss"], f"{tag}: md={md} loss {loss_rel:.2e}")
        check(g_err <= PAR_TOL["grad"], f"{tag}: md={md} gradient {g_err:.2e} at {g_at}")
        check(s_err <= tol_abs, f"{tag}: md={md} BN statistics {s_err:.2e}")
        check(got[1]["loss"] == g["loss"] and all(torch.equal(a, b) for a, b in zip(got[0]["grads"], got[1]["grads"])),
              f"{tag}: md={md} the ranks' global loss or gradients differ")
        check(all(r["launches"] == {k: 1 for k in k34} for r in got), f"{tag}: md={md} K3/K4 launches per rank "
              f"{[r['launches'] for r in got]}, expected 1/1")

    # run_training on two ranks
    from tacotronv2_wavernn_chinese_tpu_torch.utils.checkpoints import CheckpointManager
    from tacotronv2_wavernn_chinese_tpu_torch.utils.metrics import read_scalars

    run = [r["run"] for r in ranks]
    log_dir = os.path.join(work, "train")
    ckpts = CheckpointManager(os.path.join(log_dir, "taco_pretrained")).all_steps()
    rows = [r["step"] for r in read_scalars(os.path.join(log_dir, "scalars.jsonl"))]
    phase(tag, f"run_training on two ranks: steps {run[0]['steps']}, {run[0]['s']:.1f} s on rank 0; checkpoints "
          f"{ckpts}, scalars rows {rows}; rank 0 logged {len(run[0]['logs'])} lines, rank 1 {len(run[1]['logs'])}; "
          f"K3/K4 launches per rank " + ", ".join(f"{r['launches']['tacotron_train_fwd']}/"
                                                  f"{r['launches']['tacotron_train_bwd']}" for r in run))
    summary.append(f"run_training steps {run[0]['steps']}, checkpoints {ckpts}, scalars rows {rows}")
    check(all(r["steps"] == [2, 3] for r in run), f"{tag}: run_training steps {[r['steps'] for r in run]}")
    check(ckpts == [1, 2, 3] and rows == [1, 2, 3], f"{tag}: checkpoints {ckpts}, scalars rows {rows}")
    check("restored checkpoint at step 2" in run[0]["logs"] and run[1]["logs"] == [],
          f"{tag}: rank 0 did not restore, or rank 1 logged")
    check(run[0]["checksum"] == run[1]["checksum"], f"{tag}: the ranks' params differ after run_training")
    check(all(r["launches"] == {k: 3 for k in k34} for r in run), f"{tag}: run_training K3/K4 launches "
          f"{[r['launches'] for r in run]}, expected 3/3 a rank")

    # fold-sharded generation against one process
    n_cls = 2 ** bits
    labels = lambda y: torch.round((y.double() + 1.0) * (n_cls - 1) / 2.0).long()
    ft = torch.as_tensor(folds, device=dev)
    with torch.no_grad():
        one = labels(W.generate_kernel(wp, wcfg, ft, 0, bits, apply_mu_law=False, greedy=True).cpu())
        shard = labels(torch.cat([r["gen"]["greedy"] for r in ranks]))
        cond = W.precompute_conditioning(wp, wcfg, ft)
        w = WK.pack_weights(wp, wcfg)
        gaps = torch.full(one.t().shape, float("inf"))
        for b in range(one.shape[0]):
            bad = torch.nonzero(one[b] != shard[b])
            if bad.numel():  # the plain version's gaps where this fold first differs
                t_bad = int(bad[0])
                _, gp = WK.sample_labels_plain(cond[: t_bad + 1, b:b + 1].contiguous(), w, 0, True, return_gaps=True)
                gaps[: t_bad + 1, b] = gp[:, 0].cpu()
        cmp = compare_labels(shard.t(), one.t(), gaps, n_cls, f"{tag} greedy")
        sampled_equal = []
        for r in range(PAR_WORLD):
            k = folds.shape[0] // PAR_WORLD
            ref_s = W.generate_kernel(wp, wcfg, ft[r * k:(r + 1) * k], G.fold_seed(7, r), bits, apply_mu_law=False)
            sampled_equal.append(torch.equal(ref_s.cpu(), ranks[r]["gen"]["sampled"]))
    dev_x, host_x = ranks[0]["gen"]["dist_True"], ranks[0]["gen"]["dist_False"]
    x_err = float(np.abs(dev_x - host_x).max())
    gen_launches = sum(r["gen"]["launches"] for r in ranks)
    phase(tag, f"{smi}: fold-sharded generation of a served mel ({mel.shape[0]} frames, {folds.shape[0]} folds, 8 a "
          f"rank, {folds.shape[1]} frames x {hop} samples a fold): greedy vs one process {cmp['compared']} steps "
          f"compared, {cmp['diverged']} folds diverged at a near-tie, max|d| {cmp['max_abs_err']:.2e}; sampled "
          f"rank blocks equal to one process at the rank-folded seed: {sampled_equal}; device crossfade vs host "
          f"max|d| {x_err:.2e} (tol {PAR_TOL['xfade']}), {dev_x.shape[0]} samples; K1 launches per rank "
          + ", ".join(str(r["gen"]["launches"]) for r in ranks) + "; ms per rank (CUDA events) "
          + "; ".join(", ".join(f"{k} {v:.1f}" for k, v in r["gen"]["ms"].items()) for r in ranks))
    summary.append(f"fold-sharded greedy {cmp['compared']} steps, {cmp['diverged']} diverged; sampled equal "
                   f"{sampled_equal}; crossfade {x_err:.2e}; K1 greedy ms "
                   + "/".join(f"{r['gen']['ms']['greedy']:.1f}" for r in ranks))
    check(all(sampled_equal), f"{tag}: sampled blocks differ from one process at the rank-folded seed")
    check(x_err <= PAR_TOL["xfade"], f"{tag}: device crossfade {x_err:.2e} from the host path")
    check(dev_x.shape[0] == mel.shape[0] * hop and np.isfinite(dev_x).all(), f"{tag}: generated wav {dev_x.shape}")
    check(all(r["gen"]["launches"] == 4 for r in ranks), f"{tag}: K1 launches per rank "
          f"{[r['gen']['launches'] for r in ranks]}, expected 4 (greedy, sampled, two generate_distributed)")
    check(torch.equal(torch.as_tensor(dev_x), torch.as_tensor(ranks[1]["gen"]["dist_True"])),
          f"{tag}: the ranks returned different waveforms")

    # TP against the unsharded step, on the unsharded step's ReLU pattern
    t = ranks[0]["tp"]
    tp_err = grad_error({"grads": t["grads"]}, tp_exact)
    card_err = grad_error(tp_card, tp_exact)
    bound_ = max(F32_GRAD_FACTOR * card_err, F32_GRAD_FLOOR)
    l_rel = abs(t["loss"] - tp_card["loss"]) / abs(tp_card["loss"])
    steps_rel = max(abs(a - b) / abs(b) for a, b in zip(t["losses"], tp_losses))
    H, FC, NC = wcfg.rnn_dims, wcfg.fc_dims, n_cls
    want = {"fc3/w": (FC, NC // 2), "gru1/wi": (H, 3 * H // 2), "I/w": (1 + cfg.audio.num_mels + wcfg.res_out_dims // 4,
            H // 2), "mu/fc3/w": (FC, NC // 2), "nu/gru2/wh": (H, 3 * H // 2), "fc3/b": (NC,)}
    phase(tag, f"{smi}: WaveRNN dp=1 x tp=2 at rnn {H}, fc {FC}, B={tp_batch} x {tb[0]['x'].shape[1]}: loss "
          f"{t['loss']!r} / {tp_card['loss']!r} ({l_rel:.2e} relative, tol {PAR_TOL['tp_loss']}); gathered "
          f"gradients vs the float64 step on the unsharded f32 step's ReLU pattern {tp_err:.2e} of max|g| (the "
          f"unsharded f32 step {card_err:.2e}; bound {bound_:.2e}); {t['flips']} of {t['units']} ReLU units of the "
          f"TP step's own sign differ; two steps' losses {t['losses']} vs {tp_losses} ({steps_rel:.2e}); shards "
          f"after two steps {t['shapes']}; ms per rank (CUDA events) grads "
          + ", ".join(f"{r['tp']['ms']:.1f}" for r in ranks) + ", steps "
          + "; ".join(", ".join(f"{v:.1f}" for v in r["tp"]["step_ms"]) for r in ranks))
    summary.append(f"TP loss {l_rel:.2e}, grads {tp_err:.2e} from float64 (unsharded {card_err:.2e}), step ms "
                   + "/".join(f"{v:.1f}" for v in t["step_ms"]))
    check(l_rel <= PAR_TOL["tp_loss"] and steps_rel <= PAR_TOL["tp_loss"], f"{tag}: TP loss {l_rel:.2e} / {steps_rel:.2e}")
    check(tp_err <= bound_, f"{tag}: TP gradients {tp_err:.2e} of max|g| from float64, bound {bound_:.2e}")
    check(all(r["tp"]["shapes"] == want for r in ranks), f"{tag}: TP shards {t['shapes']}, expected {want}")
    return {"dp_train": dp_launches, "fold_sharded_gen": gen_launches, "summary": summary}


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
ENCODER_KEYS = ("tacotron_encoder_fwd", "tacotron_encoder_bwd")
ENCODER_SHAPES = ((32, 160), (4, 48))  # B, T_in of K5/K6: the training cell's batch, a serving call's
SCALING_SHAPE = (160, 200)  # T_in, T of the batch-scaling line
TRAIN_CORPUS = {"utts": 64, "symbols": (40, 150), "frames": (200, 600)}
TRAIN_STEPS, TRAIN_CKPT_EVERY = 6, 3


def run_all(cfg, dev, serve_frames: int, core_shape=TRAIN_CORE_SHAPE, corpus=TRAIN_CORPUS,
            wavernn_train=None, train_configs=None, cbhg=None, parallel=None) -> dict:
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
    httpd, th = start_server(synth)
    port = httpd.server_address[1]
    try:
        t0 = time.time()
        SRV.warmup(synth, httpd.service.max_batch_hard)
        phase("serve", f"warmup (batch buckets up to {httpd.service.max_batch_hard}) "
              f"{time.time() - t0:.1f} s")
        res = synth.synthesize(SENTENCES[0], seed=3)
        check(np.isfinite(res["wav"]).all(), "serve: non-finite audio")
        check(res["wav"].shape[0] == serve_frames * 275, f"serve: wav length {res['wav'].shape[0]}")

        ops.reset_launch_counts()
        for i, text in enumerate(SENTENCES):
            body, host_ms, ev_ms = post(port, "/generate_tts", {"text": text, "seed": i})
            check(body.get("status") == 0, f"serve: /generate_tts failed: {body.get('error')}")
            check_wav(body["wav_b64"], f"/generate_tts #{i}", serve_frames * 275)
            phase("serve", f"/generate_tts #{i} ({body['pyin'][:40]}...): {host_ms:.1f} ms host, "
                  f"{ev_ms:.1f} ms CUDA events, {body['duration_s']:.2f} s audio")
        body, host_ms, ev_ms = post(port, "/generate_tts_batch", {"texts": SENTENCES, "seed": 5})
        check(body.get("status") == 0, f"serve: /generate_tts_batch failed: {body.get('error')}")
        for j, r_ in enumerate(body["results"]):
            check_wav(r_["wav_b64"], f"/generate_tts_batch[{j}]", serve_frames * 275)
        phase("serve", f"/generate_tts_batch x{len(SENTENCES)}: {host_ms:.1f} ms host, {ev_ms:.1f} ms CUDA events")
        launches = {k: ops.LAUNCHES[k] for k in ("wavernn_sample", "tacotron_decode", "tacotron_encoder_fwd")}
        phase("serve", f"kernel launches on the serve path: {launches}")
        # where one request's time goes: the acoustic decode vs the vocoder
        ids0 = synth.symbols.encode(get_pyin(SENTENCES[0])[0])
        box = {}
        parts = traced_spans(lambda: box.__setitem__("m", synth.mel_from_ids([ids0], seed=[0])))
        t_mel = span_ms(parts["synth.decode"])
        t_voc = cuda_ms(lambda: synth.mels_to_wavs([box["m"][0][0]], seed=0))
        phase("serve", f"one request split (CUDA events): text->mel {t_mel:.1f} ms (encoder "
              f"{span_ms(parts['tacotron.encoder']):.1f}, decode K2 {span_ms(parts['tacotron.decoder']):.1f}, "
              f"postnet {span_ms(parts['tacotron.postnet']):.1f}), mel->wav {t_voc:.1f} ms")
        for k, v in launches.items():
            check(v > 0, f"serve: kernel {k} was never launched on the serve path")
    finally:
        stop_server(httpd, th)

    # ---------------- griffin-lim ----------------
    t_ph = time.time()
    gl = run_griffin_lim(cfg, dev, tp_long, serve_frames, smi)
    phase("griffin-lim", f"took {time.time() - t_ph:.1f} s")

    # ---------------- preprocess + gta ----------------
    t_ph = time.time()
    pg = run_preprocess_gta(cfg, dev, tp)
    phase("preprocess + gta", f"took {time.time() - t_ph:.1f} s")

    # ---------------- cli ----------------
    t_ph = time.time()
    cli = run_cli(cfg, os.path.join(HERE, "build", "chip_smoke_gl_artifact"),
                  os.path.join(art, "wavernn_params.npz"), serve_frames)
    phase("cli", f"took {time.time() - t_ph:.1f} s")

    # ---------------- train ----------------
    tr = run_train_phase(cfg, dev, core_shape, corpus, TRAIN_STEPS, TRAIN_CKPT_EVERY)

    # ---------------- wavernn train ----------------
    t_ph = time.time()
    wt = run_wavernn_train(cfg, dev, tp, smi, **(wavernn_train or {}))
    phase("wavernn train", f"took {time.time() - t_ph:.1f} s")

    # ---------------- train configs ----------------
    t_ph = time.time()
    tc = run_train_configs(cfg, dev, smi, tr["batch"], tr["params"], tr["ckpt_dir"], wt["ckpt_dir"], wt["meta"],
                           wt["pre_dir"], **(train_configs or {}))
    phase("train configs", f"took {time.time() - t_ph:.1f} s")

    # ---------------- cbhg + variants ----------------
    t_ph = time.time()
    cb = run_cbhg_variants(cfg, dev, smi, tr["batch"], wp, wt["meta"], wt["pre_dir"], serve_frames, **(cbhg or {}))
    phase("cbhg + variants", f"took {time.time() - t_ph:.1f} s")

    # ---------------- parallel ----------------
    t_ph = time.time()
    par = run_parallel(cfg, dev, smi, art, **(parallel or {}))
    phase("parallel", f"took {time.time() - t_ph:.1f} s")

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

    from tacotronv2_wavernn_chinese_tpu_torch.ops import tacotron_decoder_kernel as DK
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
    # K5/K6 at the training cell's batch and a serving call's
    k56 = [run_k56(dev, B_, Ti_, tcfg.encoder_lstm_units, tcfg.enc_conv_channels, f"encoder B={B_} T_in={Ti_}")
           for B_, Ti_ in ENCODER_SHAPES]
    with open(os.path.join(ops.BUILD_INFO["dir"], "tacotron_encoder.so.log")) as f:
        enc_log = f.read()
    paths = {"serve": launches, "griffin_lim": gl["launches"], "cli_synthesize": cli["synthesize"],
             "train": tr["launches"], "train_configs": tc["launches"], "cbhg_train": cb["train_launches"],
             "gta": {"tacotron_encoder_fwd": pg["gta_k5"]}}
    kernels = {"kernels": [
        {"name": "wavernn_sample", "route": "cuda",
         "source": "tacotronv2_wavernn_chinese_tpu_torch/csrc/wavernn_sample.cu",
         "replaces": "tacotronv2_wavernn_chinese_tpu/ops/wavernn_kernel.py:234",
         "launches": launches["wavernn_sample"], "max_abs_err": k1["max_abs_err"],
         "ms": k1["ms"], "plain_ms": k1["plain_ms"], "bound_ms": bms1, "bound_by": by1,
         "library_ms": None, "launches_by_path": {"serve": launches["wavernn_sample"],
                                                  "cli_wavernn_gen": cli["wavernn_gen"]["wavernn_sample"],
                                                  "wavernn train": wt["k1_launches"],
                                                  "cbhg_serve": cb["serve_launches"]["wavernn_sample"],
                                                  "fold_sharded_gen": par["fold_sharded_gen"]},
         "compared_steps": k1["compared"], "uncompared_steps": k1["uncompared"],
         "diverged_folds": k1["diverged"], "grid_blocks": k1_plan.blocks, "fold_tile": k1_plan.fold_tile},
        {"name": "tacotron_decode", "route": "cuda",
         "source": "tacotronv2_wavernn_chinese_tpu_torch/csrc/tacotron_decode.cu",
         "replaces": "tacotronv2_wavernn_chinese_tpu/ops/tacotron_decoder_kernel.py:627",
         "launches": launches["tacotron_decode"], "max_abs_err": k2["max_abs_err"],
         "ms": k2["ms"], "plain_ms": k2["plain_ms"], "bound_ms": bms2, "bound_by": by2,
         "library_ms": None, "launches_by_path": {
             "serve": launches["tacotron_decode"], "griffin_lim": gl["launches"]["tacotron_decode"],
             "cli_synthesize": cli["synthesize"]["tacotron_decode"],
             "cbhg_serve": cb["serve_launches"]["tacotron_decode"]},
         "grid_blocks": k2_plan.blocks, "clusters": k2_plan.clusters},
        {"name": "tacotron_train_fwd", "route": "cuda",
         "source": "tacotronv2_wavernn_chinese_tpu_torch/csrc/tacotron_train_fwd.cu",
         "replaces": "tacotronv2_wavernn_chinese_tpu/ops/tacotron_trainer_kernel.py:689",
         "launches": tr["launches"]["tacotron_train_fwd"], "max_abs_err": k34["k3_err"],
         "ms": k34["k3_ms"], "plain_ms": k34["k3_plain_ms"], "bound_ms": bms3, "bound_by": by3,
         "library_ms": None, "launches_by_path": {
             "train": tr["launches"]["tacotron_train_fwd"], "gta": pg["gta_launches"],
             "train_mixed_precision": tc["launches"]["mixed_precision"]["tacotron_train_fwd"],
             "train_configs_eager": sum(v["tacotron_train_fwd"] for k, v in tc["launches"].items()
                                        if k not in KERNEL_CONFIGS),
             "gta_eager": sum(v["k3"] for v in tc["gta"].values()),
             "cbhg_train": cb["train_launches"]["tacotron_train_fwd"], "cbhg_gta": cb["gta_k3"],
             "dp_train": par["dp_train"]["tacotron_train_fwd"]},
         "grid_blocks": k34["blocks"], "clusters": k34["clusters"]},
        {"name": "tacotron_train_bwd", "route": "cuda",
         "source": "tacotronv2_wavernn_chinese_tpu_torch/csrc/tacotron_train_bwd.cu",
         "replaces": "tacotronv2_wavernn_chinese_tpu/ops/tacotron_trainer_kernel.py:761",
         "launches": tr["launches"]["tacotron_train_bwd"], "max_abs_err": k34["k4_err"],
         "max_rel_err": k34["k4_rel"],
         "ms": k34["k4_ms"], "plain_ms": k34["k4_plain_ms"], "bound_ms": bms4, "bound_by": by4,
         "library_ms": None, "launches_by_path": {
             "train": tr["launches"]["tacotron_train_bwd"],
             "train_mixed_precision": tc["launches"]["mixed_precision"]["tacotron_train_bwd"],
             "train_configs_eager": sum(v["tacotron_train_bwd"] for k, v in tc["launches"].items()
                                        if k not in KERNEL_CONFIGS),
             "cbhg_train": cb["train_launches"]["tacotron_train_bwd"],
             "dp_train": par["dp_train"]["tacotron_train_bwd"]},
         "grid_blocks": k34["blocks"], "clusters": k34["clusters"]},
        *encoder_entries(k56, enc_log, paths), *branch_entries,
    ]}
    phase("kernels", f"shapes: K1 T={k1['T']} folds={k1['B']}; K2 B={mem_s.shape[0]} "
          f"T_in={mem_s.shape[1]} steps={k2['steps']}; K3/K4 B={Bm} T_in={Tim} T={Tm}; "
          f"total {time.time() - t_start:.1f} s")
    print(json.dumps(kernels), flush=True)
    phase("parallel", f"{smi}: summary: " + "; ".join(par["summary"]))
    return kernels


if __name__ == "__main__":
    try:
        code = main()
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr, flush=True)
        code = 1
    sys.exit(code)
