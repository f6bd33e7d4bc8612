"""Operations and bytes of the work the inputs need, from the widths of a
configuration file (its ``tacotron``, ``wavernn`` and ``audio`` sections),
never from the program.

Each counts delivered work: the samples a request is served, the real
rows of a batch at their own lengths, and not the fold overlap, the padded
rows or the padded positions a launch also computes.  Operations are 2 x
multiply-adds (float32 on the CUDA cores); bytes count each input read
once and each output written once, in float32.  ``bound_s`` is the least
time the card could take: the larger of operations over the f32 peak and
bytes over the memory bandwidth.
"""

from __future__ import annotations

import math

from ..core import PEAK_BYTES_PER_S, PEAK_F32_FLOP_PER_S

NUM_MELS = 80


def bound_s(flops: float, nbytes: float) -> float:
    return max(flops / PEAK_F32_FLOP_PER_S, nbytes / PEAK_BYTES_PER_S)


# ---------------------------------------------------------------------------
# WaveRNN
# ---------------------------------------------------------------------------


def _aux(w: dict) -> int:
    return w["res_out_dims"] // 4


def wavernn_sample_macs(w: dict, bits: int) -> int:
    """Multiply-adds of one sample of the loop: the I projection of
    [sample, mel, a1], both GRUs' input and hidden products, fc1-fc3."""
    H, FC, NC, aux = w["rnn_dims"], w["fc_dims"], 2**bits, _aux(w)
    return ((1 + NUM_MELS + aux) * H + 2 * H * 3 * H + (H + aux) * 3 * H + H * 3 * H
            + (H + aux) * FC + (FC + aux) * FC + FC * NC)


def wavernn_sample_work(w: dict, bits: int, samples: int, launches: int = 1):
    """(flops, bytes) of the sample loop delivering ``samples`` samples in
    ``launches`` launches: the weights read once a launch, each sample's
    conditioning (mel and four aux slices) read and its label written."""
    macs = wavernn_sample_macs(w, bits)
    H, FC, NC = w["rnn_dims"], w["fc_dims"], 2**bits
    weights = macs + H + 12 * H + 2 * FC + NC  # matrices and biases
    return 2.0 * macs * samples, 4.0 * (weights * launches + samples * (NUM_MELS + 4 * _aux(w) + 1))


def wavernn_conditioning_flops(w: dict, frames: int) -> float:
    """The MelResNet over ``frames`` frames and the upsample's smoothing
    convolutions up to frames x hop samples."""
    C, R, pad = w["compute_dims"], w["res_out_dims"], w["pad"]
    per_frame = (2 * pad + 1) * NUM_MELS * C + 2 * w["res_blocks"] * C * C + C * R
    smooth, length = 0, frames
    for s in w["upsample_factors"]:
        length *= s
        smooth += length * NUM_MELS * (2 * s + 1)
    return 2.0 * (frames * per_frame + smooth)


def wavernn_train_work(w: dict, bits: int, B: int, seq_frames: int):
    """(flops, bytes) of one WaveRNN train step on B windows of
    ``seq_frames`` frames: 3 x the forward's flops (the backward's two
    products per forward product); bytes: params, both Adam moments and the
    batch read, params and moments written (activations not counted)."""
    H, FC, C, pad = w["rnn_dims"], w["fc_dims"], w["compute_dims"], w["pad"]
    aux, R, NC = _aux(w), w["res_out_dims"], 2**bits
    hop = math.prod(w["upsample_factors"])
    T = seq_frames * hop
    per_sample = wavernn_sample_macs(w, bits)
    per_frame = (2 * pad + 1) * NUM_MELS * C + 2 * w["res_blocks"] * C * C + C * R
    smooth, length = 0, seq_frames + 2 * pad
    for s_ in w["upsample_factors"]:
        length *= s_
        smooth += length * NUM_MELS * (2 * s_ + 1)
    macs = B * (T * per_sample + seq_frames * per_frame + smooth)
    n_params = ((1 + NUM_MELS + aux) * H + H + 2 * (H * 3 * H + 3 * H) + (H + aux) * 3 * H + H * 3 * H
                + 6 * H + (H + aux) * FC + FC + (FC + aux) * FC + FC + FC * NC + NC
                + (2 * pad + 1) * NUM_MELS * C + 2 * w["res_blocks"] * C * C + C * R + R
                + 4 * C * (2 * w["res_blocks"] + 1) + sum(2 * s_ + 1 for s_ in w["upsample_factors"]))
    nbytes = 4.0 * (6 * n_params + B * T * 2 + B * (seq_frames + 2 * pad) * NUM_MELS)
    return 3 * 2.0 * macs, nbytes


# ---------------------------------------------------------------------------
# Tacotron-2
# ---------------------------------------------------------------------------


def _widths(t: dict):
    """(P prenet out, U decoder units, V memory width, A attention, F
    location filters, taps)."""
    return (t["prenet_layers"][-1], t["decoder_lstm_units"], 2 * t["encoder_lstm_units"], t["attention_dim"],
            t["attention_filters"], t["attention_kernel"])


def encoder_flops(t: dict, L: int) -> float:
    """The embedding's convolutions, both LSTM directions and the
    attention keys over ``L`` positions."""
    E, K, C, u = t["embedding_dim"], t["enc_conv_kernel"], t["enc_conv_channels"], t["encoder_lstm_units"]
    convs = K * E * C + (t["enc_conv_layers"] - 1) * K * C * C
    lstm = 2 * (C + u) * 4 * u
    return 2.0 * L * (convs + lstm + 2 * u * t["attention_dim"])


def postnet_flops(t: dict, frames: int) -> float:
    K, C, n = t["postnet_kernel"], t["postnet_channels"], t["postnet_layers"]
    return 2.0 * frames * (K * NUM_MELS * C + (n - 1) * K * C * C + C * NUM_MELS)


def decoder_step_macs(t: dict, L: int) -> int:
    """One inference decoder step at L positions: the prenet, both LSTMs,
    the context, forward attention (query, location filter, energies) and
    the frame, stop and mu projections."""
    P, U, V, A, _, taps = _widths(t)
    p1, p2 = t["prenet_layers"]
    r = t["outputs_per_step"]
    nproj = (NUM_MELS + 1) * r + 1
    return (NUM_MELS * p1 + p1 * p2 + (p2 + V + U) * 4 * U + 2 * U * 4 * U + L * V + (U + V) * nproj
            + U * A + L * (taps * A + A))


def decoder_work(t: dict, L: int, steps: int):
    """(flops, row bytes) of one row decoding ``steps`` steps at its own
    ``L`` positions: its keys, memory and mask read, its frames, stop
    logits and alignments written.  ``decoder_weight_bytes`` is read once
    a launch."""
    _, _, V, A, _, _ = _widths(t)
    r = t["outputs_per_step"]
    flops = 2.0 * decoder_step_macs(t, L) * steps
    return flops, 4.0 * (L * (A + V + 1) + steps * ((NUM_MELS + 1) * r + L))


def decoder_weight_bytes(t: dict) -> float:
    P, U, V, A, _, taps = _widths(t)
    p1, p2 = t["prenet_layers"]
    nproj = (NUM_MELS + 1) * t["outputs_per_step"] + 1
    w = (NUM_MELS * p1 + p1 * p2 + (p2 + V + U) * 4 * U + 2 * U * 4 * U + (U + V) * nproj + p1 + p2 + 8 * U
         + nproj + U * A + taps * A + 3 * A)
    return 4.0 * w


def trainer_work(t: dict, B: int, T: int, L: int, backward: bool, masks: bool = True):
    """(flops, bytes) of the teacher-forced decoder core, forward (K3) or
    backward (K4), over T steps of B rows at L positions.  The forward
    saves the gate pre-activations and the query projection and the
    backward reads them instead of recomputing them: their bytes count in
    both, their products in the forward only."""
    P, U, V, A, F, taps = _widths(t)
    small = taps * F + F * A + 2 * A + V + U + 1
    keep = 4 * U if masks else 0
    memory = B * L * (A + V)
    if not backward:
        gates = (P + V + U) * 4 * U + 2 * U * 4 * U
        macs = gates + U * A + L * (taps * F + F * A + A + V) + V + U
        saves = T * B * (3 * L + 6 * U + 2 * V + 1 + 8 * U + A)
        nbytes = T * B * (P + keep) + memory + B * L + gates + 8 * U + U * A + small + saves
    else:
        gates = (V + U) * 4 * U + 2 * U * 4 * U
        macs = gates + U * A + V + U + L * (V + 3 * taps * F + 3 * F * A + 2 * A)
        saves = T * B * (3 * U + V + 3 * L + 1 + 8 * U + A)
        outs = T * B * (8 * U + A + 1 + V) + B * L * A + (taps * F + F * A + 2 * A)
        nbytes = T * B * keep + memory + B * L + T * B * (U + V + L) + gates + U * A + small + saves + outs
    return 2.0 * macs * T * B, 4.0 * nbytes


def tacotron_forward_flops(t: dict, L: int, T: int) -> float:
    """One utterance's teacher-forced forward at its own L symbols and T
    frames: the encoder, T decoder steps and the postnet."""
    return encoder_flops(t, L) + 2.0 * decoder_step_macs(t, L) * T + postnet_flops(t, T)


# ---------------------------------------------------------------------------
# Griffin-Lim
# ---------------------------------------------------------------------------


def griffin_lim_flops(frames: int, n_fft: int, iters: int) -> float:
    """``iters`` iterations over ``frames`` frames: a real FFT and an
    inverse of n_fft points a frame and iteration at 2.5 n log2 n each,
    one more inverse to start, and ~20 operations a bin for the phase
    update, the windows and the normalised overlap-add."""
    bins = n_fft // 2 + 1
    per_frame = 2 * 2.5 * n_fft * math.log2(n_fft) + 20 * bins
    return float(frames * (iters + 0.5) * per_frame)


def griffin_lim_fft_work(frames: int, n_fft: int, iters: int):
    """(flops, bytes) of the transforms alone: per frame and iteration a
    forward real FFT (n_fft floats in, n_fft/2 + 1 complex out) and an
    inverse (the reverse), plus the starting inverse."""
    bins = n_fft // 2 + 1
    n_tf = frames * (2 * iters + 1)
    return n_tf * 2.5 * n_fft * math.log2(n_fft), n_tf * 4.0 * (n_fft + 2 * bins)


def trainer_weight_bytes(t: dict, backward: bool) -> float:
    """The bytes of ``trainer_work`` that do not grow with rows or steps:
    the weights read (and, backward, their gradients written) once."""
    P, U, V, A, F, taps = _widths(t)
    small = taps * F + F * A + 2 * A + V + U + 1
    if not backward:
        return 4.0 * ((P + V + U) * 4 * U + 2 * U * 4 * U + 8 * U + U * A + small)
    return 4.0 * ((V + U) * 4 * U + 2 * U * 4 * U + U * A + small + taps * F + F * A + 2 * A)


def trainer_rows_work(t: dict, rows, backward: bool):
    """(flops, bytes) of one launch over ``rows`` [(frames, symbols)], each
    row at its own lengths, the weights counted once."""
    flops = nbytes = 0.0
    for T, L in rows:
        f, b = trainer_work(t, 1, T // t["outputs_per_step"], L, backward)
        flops, nbytes = flops + f, nbytes + b
    return flops, nbytes - max(len(rows) - 1, 0) * trainer_weight_bytes(t, backward)
