"""Tacotron-2 acoustic model, inference: phoneme ids -> mel spectrogram.

embedding(128) -> 3x[conv5-256 + ReLU + BN] -> BiLSTM(256/dir, zoneout 0.1)
-> autoregressive decoder (prenet 256/256 with always-on dropout, 2x LSTM
256, forward attention, frame/stop projections, r=1) -> 5-layer postnet.

The decode loop runs as one CUDA kernel on the card
(``ops.tacotron_decoder_kernel``); ``decoder_step`` below is the step the
plain version loops over.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..config import TacotronModelConfig
from ..ops import tacotron_decoder_kernel as DK
from . import attention as ATT
from . import layers as L

Params = dict


class TacotronOutput(NamedTuple):
    decoder_output: torch.Tensor  # [B, T_out, M] pre-postnet mels
    mel_outputs: torch.Tensor  # [B, T_out, M] post-postnet mels
    stop_logits: torch.Tensor  # [B, T_out]
    alignments: torch.Tensor  # [B, T_out, T_in]
    stop_lengths: torch.Tensor  # [B] frames until the stop token


def input_mask(input_lengths: torch.Tensor, T_in: int) -> torch.Tensor:
    """[B, T_in] float 1/0 mask of valid encoder positions."""
    ar = torch.arange(T_in, device=input_lengths.device)[None, :]
    return (ar < input_lengths[:, None]).to(torch.float32)


def encode(params: Params, cfg: TacotronModelConfig, inputs: torch.Tensor, input_lengths: torch.Tensor):
    """[B, T_in] ids -> memory [B, T_in, 2*units], zero past each length
    (eval mode: no dropout, zoneout as EMA)."""
    x = params["embedding"][inputs.long()]
    x = L.conv_stack(params["enc_convs"], x)
    fw = L.unidir_lstm(params["enc_lstm_fw"], x, cfg.encoder_lstm_units, cfg.zoneout_rate)
    bw = L.unidir_lstm(
        params["enc_lstm_bw"], x, cfg.encoder_lstm_units, cfg.zoneout_rate,
        reverse=True, lengths=input_lengths,
    )
    memory = torch.cat([fw, bw], dim=-1)
    return memory * input_mask(input_lengths, inputs.shape[1])[..., None]


class DecoderCarry(NamedTuple):
    c1: torch.Tensor
    h1: torch.Tensor
    c2: torch.Tensor
    h2: torch.Tensor
    att: ATT.AttentionState


def init_decoder_carry(cfg: TacotronModelConfig, batch: int, mem_len: int, value_dim: int, device=None):
    u = cfg.decoder_lstm_units
    z = lambda: torch.zeros(batch, u, device=device)
    return DecoderCarry(z(), z(), z(), z(), ATT.init_state(batch, mem_len, value_dim, device))


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
    prenet -> concat(context) -> 2x zoneout LSTM -> attention -> projections.
    Returns (frame [B, 80], stop [B, 1], align [B, T_in], new carry)."""
    pre = L.prenet(params["prenet"], prev_frame, cfg.dropout_rate, masks=prenet_masks)
    x = torch.cat([pre, carry.att.context], dim=-1)
    c1, h1, out1 = L.zoneout_lstm_step(params["dec_lstm1"], x, carry.c1, carry.h1, cfg.zoneout_rate)
    c2, h2, out2 = L.zoneout_lstm_step(params["dec_lstm2"], out1, carry.c2, carry.h2, cfg.zoneout_rate)
    context, align, att_state = ATT.forward_step(
        params["attention"], out2, carry.att, keys, values, mem_mask, w_comb, b_comb
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
    """Dynamic-stop decode -> (frames [B,T,80], stops [B,T],
    aligns [B,T,T_in], stop_len [B]).  CUDA tensors run the decode kernel,
    CPU tensors its plain version."""
    T = max_iters if max_iters is not None else cfg.max_iters
    return DK.decode_autoregressive_kernel(params, cfg, memory, mem_mask, seeds, T)


def apply_postnet(params: Params, cfg: TacotronModelConfig, frames: torch.Tensor) -> torch.Tensor:
    """5x tanh convs (last linear) + residual projection
    (reference modules.py:345-376, tacotron.py:115-122)."""
    acts = [torch.tanh] * (cfg.postnet_layers - 1) + [None]
    x = L.conv_stack(params["postnet"], frames, activations=acts)
    return frames + L.dense(params["postnet_projection"], x)


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
        raise NotImplementedError("the CBHG mel->linear head is not ported yet (ROADMAP.md)")
    memory = encode(params, cfg, inputs, input_lengths)
    mem_mask = input_mask(input_lengths, inputs.shape[1])
    frames, stops, aligns, stop_len = decode_autoregressive(params, cfg, memory, mem_mask, seeds, max_iters)
    frames = _clip_mel(frames, cfg)
    mel_out = _clip_mel(apply_postnet(params, cfg, frames), cfg)
    return TacotronOutput(frames, mel_out, stops, aligns, stop_len)
