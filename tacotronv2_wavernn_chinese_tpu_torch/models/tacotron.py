"""Tacotron-2 acoustic model: phoneme ids -> mel spectrogram.

embedding(128) -> 3x[conv5-256 + ReLU + BN] -> BiLSTM(256/dir, zoneout 0.1)
-> decoder (prenet 256/256 with always-on dropout, 2x LSTM 256, attention
(forward by default; LSA, GMM or Graves), frame/stop projections of r
frames a step) -> 5-layer postnet.

Inference: the autoregressive decode runs as one CUDA kernel on the card
(``ops.tacotron_decoder_kernel``); ``decoder_step`` below is the step the
plain version loops over.

Training (``forward_teacher_forced``, ``tacotron_loss``): full teacher
forcing, with the prenet batched over every step before the decoder core
and the frame/stop projections batched after it; the core runs K3/K4 on the
card (``ops.tacotron_trainer_kernel``).  All randomness of one forward
(encoder and postnet dropout, zoneout, prenet dropout) is drawn up front
into a ``TrainRand`` from an explicit ``torch.Generator``, or handed in.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..config import TacotronModelConfig
from ..ops import tacotron_decoder_kernel as DK
from ..ops import tacotron_trainer_kernel as TK
from . import attention as ATT
from . import layers as L

Params = dict


class TacotronOutput(NamedTuple):
    decoder_output: torch.Tensor  # [B, T_out, M] pre-postnet mels
    mel_outputs: torch.Tensor  # [B, T_out, M] post-postnet mels
    stop_logits: torch.Tensor  # [B, T_out]
    alignments: torch.Tensor  # [B, T_dec, T_in]
    stop_lengths: torch.Tensor | None = None  # [B] inference: frames until the stop token


def input_mask(input_lengths: torch.Tensor, T_in: int) -> torch.Tensor:
    """[B, T_in] float 1/0 mask of valid encoder positions."""
    ar = torch.arange(T_in, device=input_lengths.device)[None, :]
    return (ar < input_lengths[:, None]).to(torch.float32)


class TrainRand(NamedTuple):
    """Every random mask one teacher-forced forward consumes (the
    counterpart of the JAX package's StepRand, for all steps at once).
    Keep-masks are boolean; None where the knob is off."""

    enc_drop: tuple | None  # per encoder conv layer, [B, T_in, C]
    enc_fw: tuple | None  # forward encoder LSTM (cell, hidden) zoneout, [T_in, B, units]
    enc_bw: tuple | None  # backward encoder LSTM, in its loop order
    pre: tuple | None  # per prenet layer, [T_dec, B, width]
    z1: tuple | None  # decoder LSTM1 (cell, hidden) zoneout, [T_dec, B, u]
    z2: tuple | None  # decoder LSTM2
    post_drop: tuple | None  # per postnet layer, [B, T_out, C]


def draw_train_rand(params: Params, cfg: TacotronModelConfig, batch: int, t_in: int, t_out: int,
                    generator: torch.Generator, train: bool = True) -> TrainRand:
    """All masks of one forward, drawn from ``generator`` on its device.
    The prenet dropout is always on; the others only in train mode."""
    B, t_dec = batch, t_out // cfg.outputs_per_step
    rate, zr = cfg.dropout_rate, cfg.zoneout_rate
    pre = L.prenet_masks(params["prenet"], rate, (t_dec, B), generator)
    if not train:
        return TrainRand(None, None, None, pre, None, None, None)
    keep = lambda shape, r: L.keep_mask(shape, r, generator)
    pair = lambda shape: (keep(shape, zr), keep(shape, zr)) if zr > 0.0 else None
    drops = lambda n, T, C: tuple(keep((B, T, C), rate) for _ in range(n)) if rate > 0.0 else None
    return TrainRand(
        drops(cfg.enc_conv_layers, t_in, cfg.enc_conv_channels),
        pair((t_in, B, cfg.encoder_lstm_units)), pair((t_in, B, cfg.encoder_lstm_units)),
        pre,
        pair((t_dec, B, cfg.decoder_lstm_units)), pair((t_dec, B, cfg.decoder_lstm_units)),
        drops(cfg.postnet_layers, t_out, cfg.postnet_channels),
    )


def encode(params: Params, cfg: TacotronModelConfig, inputs: torch.Tensor, input_lengths: torch.Tensor):
    """[B, T_in] ids -> memory [B, T_in, 2*units], zero past each length
    (eval mode: no dropout, zoneout as EMA)."""
    return _encode(params, cfg, inputs, input_lengths, None)[0]


def encode_train(params: Params, cfg: TacotronModelConfig, inputs, input_lengths, rand: TrainRand):
    """Train-mode encoder (conv dropout, BN batch statistics, zoneout
    masks) -> (memory, enc_convs params with the updated BN statistics)."""
    return _encode(params, cfg, inputs, input_lengths, rand)


def _encode(params, cfg, inputs, input_lengths, rand):
    x = params["embedding"][inputs.long()]
    if rand is None:
        x, new_convs = L.conv_stack(params["enc_convs"], x), params["enc_convs"]
    else:
        x, new_convs = L.conv_stack_train(params["enc_convs"], x, cfg.dropout_rate, rand.enc_drop)
    fw = L.unidir_lstm(params["enc_lstm_fw"], x, cfg.encoder_lstm_units, cfg.zoneout_rate,
                       masks=None if rand is None else rand.enc_fw)
    bw = L.unidir_lstm(
        params["enc_lstm_bw"], x, cfg.encoder_lstm_units, cfg.zoneout_rate,
        reverse=True, lengths=input_lengths, masks=None if rand is None else rand.enc_bw,
    )
    memory = torch.cat([fw, bw], dim=-1)
    return memory * input_mask(input_lengths, inputs.shape[1])[..., None], new_convs


class DecoderCarry(NamedTuple):
    c1: torch.Tensor
    h1: torch.Tensor
    c2: torch.Tensor
    h2: torch.Tensor
    att: ATT.AttentionState


def init_decoder_carry(cfg: TacotronModelConfig, batch: int, mem_len: int, value_dim: int, device=None):
    u = cfg.decoder_lstm_units
    z = lambda: torch.zeros(batch, u, device=device)
    return DecoderCarry(z(), z(), z(), z(), ATT.init_state(cfg, batch, mem_len, value_dim, device))


def decoder_step(
    params: Params,
    cfg: TacotronModelConfig,
    prev_frame: torch.Tensor,  # [B, M]
    carry: DecoderCarry,
    keys: torch.Tensor,
    values: torch.Tensor,
    mem_mask: torch.Tensor,
    prenet_masks=None,
    w_comb=None,
    b_comb=None,
):
    """One inference decoder step (reference Architecture_wrappers.py:175-218):
    prenet -> concat(context) -> 2x zoneout LSTM -> attention of
    ``cfg.attention_mode`` -> projections.  Returns (frames [B, 80r],
    stops [B, r], align [B, T_in], new carry)."""
    pre = L.prenet(params["prenet"], prev_frame, cfg.dropout_rate, masks=prenet_masks)
    x = torch.cat([pre, carry.att.context], dim=-1)
    c1, h1, out1 = L.zoneout_lstm_step(params["dec_lstm1"], x, carry.c1, carry.h1, cfg.zoneout_rate)
    c2, h2, out2 = L.zoneout_lstm_step(params["dec_lstm2"], out1, carry.c2, carry.h2, cfg.zoneout_rate)
    context, align, att_state = ATT.step(
        params["attention"], cfg, out2, carry.att, keys, values, mem_mask, w_comb, b_comb
    )
    proj_in = torch.cat([out2, context], dim=-1)
    w = torch.cat([params["frame_projection"]["w"], params["stop_projection"]["w"]], dim=1)
    b = torch.cat([params["frame_projection"]["b"], params["stop_projection"]["b"]])
    out = proj_in @ w + b
    n_frame = params["frame_projection"]["w"].shape[1]
    return out[:, :n_frame], out[:, n_frame:], align, DecoderCarry(c1, h1, c2, h2, att_state)


def decode_autoregressive(
    params: Params,
    cfg: TacotronModelConfig,
    memory: torch.Tensor,
    mem_mask: torch.Tensor,
    seeds,
    max_iters: int | None = None,
):
    """Dynamic-stop decode of at most T = max_iters steps -> (frames
    [B, T*r, 80], stops [B, T*r], aligns [B, T, T_in], stop_len [B] in
    frames).  CUDA tensors run the decode kernel, CPU tensors its plain
    version."""
    T = max_iters if max_iters is not None else cfg.max_iters
    return DK.decode_autoregressive_kernel(params, cfg, memory, mem_mask, seeds, T)


def apply_postnet(params: Params, cfg: TacotronModelConfig, frames: torch.Tensor) -> torch.Tensor:
    """5x tanh convs (last linear) + residual projection
    (reference modules.py:345-376, tacotron.py:115-122)."""
    acts = [torch.tanh] * (cfg.postnet_layers - 1) + [None]
    x = L.conv_stack(params["postnet"], frames, activations=acts)
    return frames + L.dense(params["postnet_projection"], x)


def apply_postnet_train(params: Params, cfg: TacotronModelConfig, frames: torch.Tensor, masks):
    """Train-mode postnet (BN batch statistics, dropout keep-masks per
    layer) -> (mels, postnet params with the updated BN statistics)."""
    acts = [torch.tanh] * (cfg.postnet_layers - 1) + [None]
    x, new_p = L.conv_stack_train(params["postnet"], frames, cfg.dropout_rate, masks, activations=acts)
    return frames + L.dense(params["postnet_projection"], x), new_p


def _clip_mel(x: torch.Tensor, cfg: TacotronModelConfig) -> torch.Tensor:
    """Output clipping (reference tacotron.py:111-112,119-122)."""
    if not cfg.clip_outputs:
        return x
    return torch.clamp(x, -4.0 - cfg.lower_bound_decay, 4.0)


def forward_inference(
    params: Params,
    cfg: TacotronModelConfig,
    inputs: torch.Tensor,
    input_lengths: torch.Tensor,
    seeds,
    max_iters: int | None = None,
) -> TacotronOutput:
    """Autoregressive inference.  ``seeds`` [B]: row b's prenet dropout
    depends only on seeds[b], so a row decodes the same alone or batched."""
    if cfg.predict_linear:
        raise NotImplementedError("the CBHG mel->linear head is not ported yet (ROADMAP.md, queue item 12)")
    memory = encode(params, cfg, inputs, input_lengths)
    mem_mask = input_mask(input_lengths, inputs.shape[1])
    frames, stops, aligns, stop_len = decode_autoregressive(params, cfg, memory, mem_mask, seeds, max_iters)
    frames = _clip_mel(frames, cfg)
    mel_out = _clip_mel(apply_postnet(params, cfg, frames), cfg)
    return TacotronOutput(frames, mel_out, stops, aligns, stop_len)


# ---------------------------------------------------------------------------
# training: teacher-forced forward and loss
# ---------------------------------------------------------------------------


def _decoder_core(params, cfg, pre_all, masks, keys, memory, mem_mask, fused_decoder: str):
    """Route the teacher-forced core: on the card only K3/K4 run it (any
    batch size the shape envelope takes); on the CPU "off" is the eager
    loop, anything else the same autograd Function with the kernels' plain
    versions."""
    B, T_in = memory.shape[0], memory.shape[1]
    if cfg.attention_mode != "forward" or cfg.smoothing:
        raise NotImplementedError(
            f"attention_mode={cfg.attention_mode!r}, smoothing={cfg.smoothing}: training runs forward "
            "attention without smoothing (ROADMAP.md, queue item 6)"
        )
    if memory.device.type == "cuda":
        if fused_decoder == "off":
            raise NotImplementedError(
                "fused_decoder='off' is the eager loop, the kernels' plain version: on the card "
                "the teacher-forced core runs only through K3/K4 (ROADMAP.md, queue item 6)"
            )
        if not TK.train_supported(cfg):
            raise NotImplementedError(
                "the trainer kernels take two prenet layers and widths that are multiples of 4 "
                "(ROADMAP.md, queue item 5)"
            )
        clusters = TK.card_clusters(memory.device)
        if not TK.train_supported_shape(B, T_in, cfg, clusters):
            raise NotImplementedError(
                f"B={B}, T_in={T_in} is beyond the trainer kernels' envelope (T_in <= "
                f"{TK.max_t_in(B, TK.widths(cfg), clusters)} at this batch) (ROADMAP.md, queue item 5)"
            )
    if memory.device.type == "cpu" and fused_decoder == "off":
        return TK.fused_core_plain(params, cfg, pre_all, masks, keys, memory, mem_mask)
    return TK.fused_core_apply(params, cfg, pre_all, masks, keys, memory, mem_mask)


def decode_teacher_forced(
    params: Params,
    cfg: TacotronModelConfig,
    memory: torch.Tensor,
    mem_mask: torch.Tensor,
    mel_targets: torch.Tensor,  # [B, T_out, M], T_out divisible by r
    train: bool,
    rand: TrainRand,
    teacher_forcing_ratio: float = 1.0,
    fused_decoder: str = "auto",
):
    """Teacher-forced decode under full teacher forcing (reference
    helpers.py:136-142): every step's input is the ground-truth frame, so
    the prenet runs over all steps at once before the core and the
    frame/stop projections over all steps after it.  Returns (frames
    [B, T_out, M], stops [B, T_out], alignments [B, T_dec, T_in])."""
    if not (isinstance(teacher_forcing_ratio, (int, float)) and teacher_forcing_ratio >= 1.0):
        raise NotImplementedError(
            f"teacher_forcing_ratio={teacher_forcing_ratio}: scheduled sampling is not ported yet "
            "(ROADMAP.md, queue item 6)"
        )
    B, T_out, M = mel_targets.shape
    r = cfg.outputs_per_step
    keys = ATT.precompute_keys(params["attention"], cfg, memory)
    # <GO> zero frame, then the target frames strided by r, shifted one step
    strided = mel_targets[:, r - 1::r, :]
    dec_inputs = torch.cat([mel_targets.new_zeros(B, 1, M), strided[:, :-1, :]], dim=1)
    pre_all = L.prenet(params["prenet"], dec_inputs.transpose(0, 1), cfg.dropout_rate, masks=rand.pre)
    masks = None
    if train and cfg.zoneout_rate > 0.0:
        masks = (rand.z1[0], rand.z1[1], rand.z2[0], rand.z2[1])
    out2, ctx, aligns = _decoder_core(params, cfg, pre_all, masks, keys, memory, mem_mask, fused_decoder)
    proj_in = torch.cat([out2, ctx], dim=-1)  # [T, B, u+V]
    w = torch.cat([params["frame_projection"]["w"], params["stop_projection"]["w"]], dim=1)
    b = torch.cat([params["frame_projection"]["b"], params["stop_projection"]["b"]])
    out = proj_in @ w + b
    n_frame = params["frame_projection"]["w"].shape[1]
    frames = out[..., :n_frame].transpose(0, 1).reshape(B, T_out, M)
    stops = out[..., n_frame:].transpose(0, 1).reshape(B, T_out)
    return frames, stops, aligns.transpose(0, 1)


def forward_teacher_forced(
    params: Params,
    cfg: TacotronModelConfig,
    inputs: torch.Tensor,
    input_lengths: torch.Tensor,
    mel_targets: torch.Tensor,
    train: bool,
    rand: TrainRand | None = None,
    generator: torch.Generator | None = None,
    teacher_forcing_ratio: float = 1.0,
    fused_decoder: str = "auto",
):
    """Full teacher-forced forward -> (TacotronOutput, params with the
    updated BN statistics; eval mode returns them unchanged).  The masks come
    from ``rand``, else are drawn from ``generator`` (required then)."""
    if cfg.predict_linear:
        raise NotImplementedError("the CBHG mel->linear head is not ported yet (ROADMAP.md, queue item 12)")
    if rand is None:
        if generator is None:
            raise ValueError("forward_teacher_forced needs rand or a torch.Generator")
        rand = draw_train_rand(params, cfg, inputs.shape[0], inputs.shape[1], mel_targets.shape[1],
                               generator, train)
    if train:
        memory, new_convs = encode_train(params, cfg, inputs, input_lengths, rand)
    else:
        memory, new_convs = encode(params, cfg, inputs, input_lengths), params["enc_convs"]
    mem_mask = input_mask(input_lengths, inputs.shape[1])
    frames, stops, aligns = decode_teacher_forced(
        params, cfg, memory, mem_mask, mel_targets, train, rand, teacher_forcing_ratio, fused_decoder,
    )
    frames = _clip_mel(frames, cfg)
    if train:
        mel_out, new_post = apply_postnet_train(params, cfg, frames, rand.post_drop)
    else:
        mel_out, new_post = apply_postnet(params, cfg, frames), params["postnet"]
    mel_out = _clip_mel(mel_out, cfg)
    new_params = dict(params, enc_convs=new_convs, postnet=new_post)
    return TacotronOutput(frames, mel_out, stops, aligns), new_params


def tacotron_loss(
    out: TacotronOutput,
    mel_targets: torch.Tensor,
    stop_targets: torch.Tensor,
    target_lengths: torch.Tensor,
    params: Params,
    cfg: TacotronModelConfig,
    reg_weight: float = 1e-6,
    mask_decoder: bool = False,
    stop_pos_weight: float = 1.0,
    loss_frames: torch.Tensor | None = None,
):
    """before/after MSE + stop cross-entropy + L2 (reference
    tacotron.py:195-253) -> (loss, aux dict).  ``mask_decoder`` takes the
    masked variants (modules.py:403-485, the only branch that weights the
    positive stop class); ``loss_frames`` [B] drops the frames past each
    batch's reference length (bucket padding)."""
    T = mel_targets.shape[1]
    ar = torch.arange(T, device=mel_targets.device)[None, :]
    M = mel_targets.shape[-1]
    if mask_decoder:
        m3 = (ar < target_lengths[:, None]).to(torch.float32)[..., None]
        denom = torch.sum(m3) * M
        before = torch.sum(((out.decoder_output - mel_targets) ** 2) * m3) / denom
        after = torch.sum(((out.mel_outputs - mel_targets) ** 2) * m3) / denom
        ce = _weighted_sigmoid_ce(stop_targets, out.stop_logits, stop_pos_weight) * m3[..., 0]
        stop_loss = torch.sum(ce) / torch.clamp_min(torch.sum((ce != 0).to(torch.float32)), 1.0)
    elif loss_frames is None:
        before = torch.mean((out.decoder_output - mel_targets) ** 2)
        after = torch.mean((out.mel_outputs - mel_targets) ** 2)
        stop_loss = torch.mean(_weighted_sigmoid_ce(stop_targets, out.stop_logits, 1.0))
    else:
        fmask = (ar < loss_frames[:, None]).to(torch.float32)
        n = torch.clamp_min(torch.sum(fmask), 1.0)
        f3 = fmask[..., None]
        before = torch.sum(((out.decoder_output - mel_targets) ** 2) * f3) / (n * M)
        after = torch.sum(((out.mel_outputs - mel_targets) ** 2) * f3) / (n * M)
        stop_loss = torch.sum(_weighted_sigmoid_ce(stop_targets, out.stop_logits, 1.0) * fmask) / n
    reg = reg_weight * l2_regularizables(params)
    loss = before + after + stop_loss + reg
    aux = {"before": before, "after": after, "stop": stop_loss, "reg": reg, "loss": loss}
    return loss, aux


def _weighted_sigmoid_ce(targets, logits, pos_weight: float):
    """tf.nn.weighted_cross_entropy_with_logits."""
    log_w = 1.0 + (pos_weight - 1.0) * targets
    return (1.0 - targets) * logits + log_w * (
        torch.log1p(torch.exp(-torch.abs(logits))) + torch.relu(-logits)
    )


_L2_SKIP_TOP = {
    "embedding", "enc_lstm_fw", "enc_lstm_bw", "dec_lstm1", "dec_lstm2",
    "frame_projection", "stop_projection", "postnet_projection", "linear_projection",
}


def l2_regularizables(params: Params) -> torch.Tensor:
    """Sum of 0.5*||w||^2 over the regularized weights (reference
    tacotron.py:246-248): no biases, LSTM/GRU kernels, embeddings or
    projection layers; BN scale/bias are in, the BN moving statistics out."""
    total = 0.0

    def walk(tree, path):
        nonlocal total
        if isinstance(tree, dict):
            for k, v in tree.items():
                walk(v, path + (k,))
        elif isinstance(tree, (list, tuple)):
            for i, v in enumerate(tree):
                walk(v, path + (str(i),))
        else:
            if path[0] in _L2_SKIP_TOP:
                return
            name = path[-1]
            if "bn" in path:
                if name in ("mean", "var"):
                    return
            elif name in ("b", "bias", "v", "bi", "bh") or any("gru" in c for c in path):
                return
            total = total + 0.5 * torch.sum(tree ** 2)

    walk(params, ())
    return total
