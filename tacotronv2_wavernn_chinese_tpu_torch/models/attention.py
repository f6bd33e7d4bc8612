"""Forward attention (the default mode), on torch tensors.

The forward + location-sensitive hybrid of the reference
(tacotron/models/attention.py:66-231): a location conv over the cumulated
alignments, energies against the precomputed keys, a masked softmax, and
the forward recursion with transition probability mu.  The other modes
(LSA, GMM, Graves), anti-repeat and smoothing are not ported yet
(ROADMAP.md, queue item 6).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..config import TacotronModelConfig
from . import layers as L

NEG_INF = -1e9


def check_supported(cfg: TacotronModelConfig) -> None:
    """Raise for the attention options this port does not run yet."""
    if cfg.attention_mode != "forward" or cfg.anti_repeat or cfg.smoothing:
        raise NotImplementedError(
            f"attention_mode={cfg.attention_mode!r}, anti_repeat={cfg.anti_repeat}, "
            f"smoothing={cfg.smoothing}: only forward attention without anti-repeat "
            "or smoothing is ported (ROADMAP.md, queue item 6)"
        )


class AttentionState(NamedTuple):
    context: torch.Tensor  # [B, V] previous context (input feeding)
    cumulated: torch.Tensor  # [B, T] cumulated softmax alignments
    alpha: torch.Tensor  # [B, T] forward-recursion state
    mu: torch.Tensor  # [B, 1] transition probability


def init_state(batch: int, mem_len: int, value_dim: int, device=None) -> AttentionState:
    """Alpha and cumulated start one-hot at position 0, mu at 0.5
    (reference attention.py:112-117)."""
    one_hot0 = torch.zeros(batch, mem_len, device=device)
    one_hot0[:, 0] = 1.0
    return AttentionState(
        context=torch.zeros(batch, value_dim, device=device),
        cumulated=one_hot0.clone(),
        alpha=one_hot0,
        mu=torch.full((batch, 1), 0.5, device=device),
    )


def precompute_keys(params, memory: torch.Tensor) -> torch.Tensor:
    """Project memory once per utterance (BahdanauAttention memory_layer)."""
    return L.dense(params["memory_layer"], memory)


def combined_location_weights(params):
    """The location conv (1 -> F) followed by the location dense (F -> A,
    no bias) is one conv (1 -> A): both are linear.  Returns
    (w [taps, A], b [A]); f64 products so the weights carry no extra
    rounding."""
    conv_w = params["location_conv"]["w"][:, 0, :].double()  # [taps, F]
    w_loc = params["location_layer"]["w"].double()  # [F, A]
    w = (conv_w @ w_loc).float()
    b = (params["location_conv"]["b"].double() @ w_loc).float()
    return w, b


def location_energy(params, query, cumulated, keys, w_comb=None, b_comb=None):
    """v . tanh(keys + W_query q + conv(cumulated) + b) (attention.py:9-41);
    the conv is SAME over the encoder axis."""
    if w_comb is None:
        w_comb, b_comb = combined_location_weights(params)
    pq = L.dense(params["query_layer"], query)[:, None, :]  # [B, 1, A]
    loc = L.conv1d({"w": w_comb[:, None, :]}, cumulated[..., None]) + b_comb  # [B, T, A]
    return torch.sum(params["v"] * torch.tanh(keys + pq + loc + params["b"]), dim=-1)


def masked_softmax(energy: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    energy = torch.where(mask > 0, energy, torch.full_like(energy, NEG_INF))
    return torch.softmax(energy, dim=-1)


def forward_step(params, query, state: AttentionState, keys, values, mask, w_comb=None, b_comb=None):
    """One forward-attention step -> (context, alignment, new state)
    (reference attention.py:119-231).  The right shift of alpha is
    zero-filled and the 1e-10 sits inside the product."""
    energy = location_energy(params, query, state.cumulated, keys, w_comb, b_comb)
    align_sm = masked_softmax(energy, mask)
    cumulated = state.cumulated + align_sm
    alpha, mu = state.alpha, state.mu
    shift_alpha = torch.nn.functional.pad(alpha, (1, 0))[:, :-1]
    align = ((1.0 - mu) * alpha + mu * shift_alpha + 1e-10) * align_sm
    align = align / torch.sum(align, dim=-1, keepdim=True)
    context = torch.einsum("bt,btv->bv", align, values)
    new_mu = torch.sigmoid(L.dense(params["mu_layer"], torch.cat([context, query], dim=-1)))
    return context, align, AttentionState(context, cumulated, align, new_mu)
