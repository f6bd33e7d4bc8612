"""The four attention mechanisms of the decoder, on torch tensors, with
one superset state.

* ``forward`` — forward + location-sensitive hybrid (the default mode,
  reference tacotron/models/attention.py:66-231), with the inference-time
  anti-repeat / dwell-limit machinery of forward_attention.py:171-215.
* ``lsa`` — vanilla location-sensitive attention with the optional
  synthesis window (location_sensitive_attention.py:95-226).
* ``gmm`` — GMM (v0) attention (gmm_attention.py:9-67), with its 0.2
  dropout on [query, previous context] in train mode.
* ``graves`` — discretized Graves attention (graves_attention.py:10-110).

Every step takes ``train``: anti-repeat and the LSA synthesis window act
only at eval/inference, GMM's dropout only in training (from a keep-mask
the caller draws), Graves has no train/eval difference.  Every mode can
smooth its location-sensitive softmax into a normalised sigmoid
(``cfg.smoothing``).  Masking uses additive -1e9 energies (softmax modes)
or 1e-20 floors (graves), as the reference's sequence masks do.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..config import TacotronModelConfig
from . import layers as L

NEG_INF = -1e9
MODES = ("forward", "lsa", "gmm", "graves")
GMM_DROPOUT = 0.2  # reference gmm_attention.py:28


class AttentionState(NamedTuple):
    """Superset carry of all modes.  ``extra`` is the mode's vector state:
    forward mu [B, 1], gmm kappa [B, mixtures], graves mu [B, heads], lsa
    unused [B, 1]."""

    context: torch.Tensor  # [B, V] previous context (input feeding)
    alignments: torch.Tensor  # [B, T] previous (or, for lsa, cumulated) alignments
    cumulated: torch.Tensor  # [B, T] cumulated softmax alignments
    alpha: torch.Tensor  # [B, T] forward-recursion state
    extra: torch.Tensor  # [B, K] mode-specific vector state
    max_attention: torch.Tensor  # [B] int32 argmax of the last alignments
    pos_rec: torch.Tensor  # [B] int32 dwell counter (anti-repeat)


def init_state(cfg: TacotronModelConfig, batch: int, mem_len: int, value_dim: int, device=None) -> AttentionState:
    """Forward starts alpha and cumulated one-hot at position 0 and mu at
    0.5 (reference attention.py:112-117); the other modes start at zeros."""
    zeros = lambda *s: torch.zeros(*s, device=device)
    mode = cfg.attention_mode
    if mode not in MODES:
        raise ValueError(f"unknown attention mode {mode!r}")
    alpha, cumulated = zeros(batch, mem_len), zeros(batch, mem_len)
    if mode == "forward":
        alpha[:, 0] = 1.0
        cumulated[:, 0] = 1.0
        extra = torch.full((batch, 1), 0.5, device=device)
    elif mode == "gmm":
        extra = zeros(batch, cfg.num_attn_mixtures)
    elif mode == "graves":
        extra = zeros(batch, cfg.graves_heads)
    else:
        extra = zeros(batch, 1)
    izero = torch.zeros(batch, dtype=torch.int32, device=device)
    return AttentionState(zeros(batch, value_dim), zeros(batch, mem_len), cumulated, alpha, extra,
                          izero, izero.clone())


def precompute_keys(params, cfg: TacotronModelConfig, memory: torch.Tensor) -> torch.Tensor:
    """Project memory once per utterance (BahdanauAttention memory_layer);
    gmm and graves use the raw memory."""
    if cfg.attention_mode in ("forward", "lsa"):
        return L.dense(params["memory_layer"], memory)
    return memory


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


def location_energy(params, query, conv_input, keys, w_comb=None, b_comb=None):
    """v . tanh(keys + W_query q + conv(conv_input) + b) (attention.py:9-41);
    the conv is SAME over the encoder axis."""
    if w_comb is None:
        w_comb, b_comb = combined_location_weights(params)
    pq = L.dense(params["query_layer"], query)[:, None, :]  # [B, 1, A]
    loc = L.conv1d({"w": w_comb[:, None, :]}, conv_input[..., None]) + b_comb  # [B, T, A]
    return torch.sum(params["v"] * torch.tanh(keys + pq + loc + params["b"]), dim=-1)


def masked_softmax(energy: torch.Tensor, mask: torch.Tensor, smoothing: bool = False) -> torch.Tensor:
    """Softmax over the valid positions, or with ``smoothing`` the
    normalised sigmoid (attention.py _smoothing_normalization)."""
    if smoothing:
        sig = torch.sigmoid(energy) * mask
        return sig / torch.sum(sig, dim=-1, keepdim=True)
    energy = torch.where(mask > 0, energy, torch.full_like(energy, NEG_INF))
    return torch.softmax(energy, dim=-1)


def argmax_first(x: torch.Tensor) -> torch.Tensor:
    """int32 index of the first maximum of each row (jnp.argmax's tie rule)."""
    T = x.shape[-1]
    pos = torch.arange(T, device=x.device)
    hit = x == x.max(dim=-1, keepdim=True).values
    return torch.where(hit, pos, torch.full_like(pos, T)).min(dim=-1).values.to(torch.int32)


def anti_repeat_constrain(align, max_att, prev_max, prev_pos_rec, cfg: TacotronModelConfig):
    """The long-sentence anti-repeat / dwell-limit rule (reference
    forward_attention.py:176-215, the variant enabled at inference): a
    monotonic argmax, a cap on the dwell at one position, alignments
    windowed to [max-2, max+3), and the argmax bin (clipped to the last
    position) set to twice the windowed sum, with the near-zero-sum guard.
    Returns (align before renormalising, max_att, pos_rec)."""
    T = align.shape[-1]
    pos = torch.arange(T, device=align.device)[None, :]
    max_att = torch.where(max_att <= prev_max, prev_max, prev_max + 1)
    short = (prev_pos_rec < cfg.dwell_limit_first) & (max_att > 2)
    max_att = torch.where(short, prev_max, max_att)
    pos_rec = torch.where(max_att == prev_max, prev_pos_rec + 1, torch.ones_like(prev_pos_rec))
    over = pos_rec >= cfg.dwell_limit_rest
    max_att = torch.where(over, max_att + 1, max_att)
    pos_rec = torch.where(over, torch.ones_like(pos_rec), pos_rec)
    window = (pos >= (max_att - 2)[:, None]) & (pos < (max_att + 3)[:, None])
    align = torch.where(window, align, torch.zeros_like(align))
    att_sum = torch.sum(align, dim=-1, keepdim=True)
    att_sum = torch.where(att_sum < 1e-10, torch.ones_like(att_sum), att_sum)
    at_max = pos == torch.clamp(max_att, 0, T - 1)[:, None]
    align = torch.where(at_max, att_sum * 2.0, align)
    return align, max_att.to(torch.int32), pos_rec.to(torch.int32)


def lsa_window_bounds(cfg: TacotronModelConfig) -> tuple:
    """(back, ahead): the synthesis window keeps [prev - back, prev + ahead)
    (reference location_sensitive_attention.py:201-214): 'monotonic' (the
    anti_repeat flag) looks w steps forward, 'window' ceil(w/2) back and
    w//2 forward."""
    w = cfg.synthesis_window
    return (0, w) if cfg.anti_repeat else (w // 2 + w % 2, w // 2)


def lsa_window_valid(prev_max: torch.Tensor, T: int, cfg: TacotronModelConfig) -> torch.Tensor:
    """bool [B, T]: the positions the LSA synthesis window keeps."""
    back, ahead = lsa_window_bounds(cfg)
    pos = torch.arange(T, device=prev_max.device)[None, :]
    prev = prev_max.to(torch.int64)[:, None]
    return (pos >= prev - back) & (pos < prev + ahead)


def forward_step(params, cfg, query, state: AttentionState, keys, values, mask, w_comb=None, b_comb=None,
                 train: bool = False):
    """Forward attention (reference attention.py:119-231): the location
    energy over the cumulated alignments, the forward recursion with a
    zero-filled shift and the 1e-10 inside the product, anti-repeat (not in
    training) between the recursion and the renormalisation, and mu from
    [context, query]."""
    energy = location_energy(params, query, state.cumulated, keys, w_comb, b_comb)
    align_sm = masked_softmax(energy, mask, cfg.smoothing)
    cumulated = state.cumulated + align_sm
    alpha, mu = state.alpha, state.extra
    shift_alpha = torch.nn.functional.pad(alpha, (1, 0))[:, :-1]
    align = ((1.0 - mu) * alpha + mu * shift_alpha + 1e-10) * align_sm
    max_att, pos_rec = argmax_first(align), state.pos_rec
    if cfg.anti_repeat and not train:
        align, max_att, pos_rec = anti_repeat_constrain(align, max_att, state.max_attention, state.pos_rec, cfg)
    align = align / torch.sum(align, dim=-1, keepdim=True)
    context = torch.einsum("bt,btv->bv", align, values)
    new_mu = torch.sigmoid(L.dense(params["mu_layer"], torch.cat([context, query], dim=-1)))
    return context, align, AttentionState(context, align, cumulated, align, new_mu, max_att, pos_rec)


def lsa_step(params, cfg, query, state: AttentionState, keys, values, mask, w_comb=None, b_comb=None,
             train: bool = False):
    """Vanilla location-sensitive attention (reference
    location_sensitive_attention.py:169-226): the location energy over the
    previous (or cumulated) alignments, energies outside the synthesis
    window at -1e9 (not in training)."""
    energy = location_energy(params, query, state.alignments, keys, w_comb, b_comb)
    if cfg.synthesis_constraint and not train:
        valid = lsa_window_valid(state.max_attention, energy.shape[-1], cfg)
        energy = torch.where(valid, energy, torch.full_like(energy, NEG_INF))
    align = masked_softmax(energy, mask, cfg.smoothing)
    next_align = align + state.alignments if cfg.cumulative_weights else align
    context = torch.einsum("bt,btv->bv", align, values)
    return context, align, state._replace(context=context, alignments=next_align,
                                          cumulated=state.cumulated + align, max_attention=argmax_first(align))


def gmm_step(params, cfg, query, state: AttentionState, values, mask, train: bool = False, drop_mask=None):
    """GMM (v0) attention (reference gmm_attention.py:25-67):
    (alpha, beta, kappa increment) = exp(dense([query, context])), the
    dense's input under inverted dropout at ``GMM_DROPOUT`` from the
    boolean keep-mask ``drop_mask`` [B, q + v] in training (JAX
    ``gmm_dropout_mask``)."""
    inputs = torch.cat([query, state.context], dim=-1)
    if train and drop_mask is not None:
        inputs = L.dropout(inputs, GMM_DROPOUT, mask=drop_mask)
    p = torch.exp(L.dense(params["gmm_layer"], inputs))
    K = cfg.num_attn_mixtures
    alpha_m, beta, kappa_d = p[:, :K], p[:, K:2 * K], p[:, 2 * K:]
    kappa = state.extra + kappa_d
    u = torch.arange(values.shape[1], dtype=torch.float32, device=values.device)[None, None, :]
    score = torch.sum((alpha_m / beta)[..., None] * torch.exp(-((kappa[..., None] - u) ** 2) / beta[..., None]),
                      dim=1)
    align = masked_softmax(score, mask)
    context = torch.einsum("bt,btv->bv", align, values)
    return context, align, state._replace(context=context, alignments=align, cumulated=state.cumulated + align,
                                          extra=kappa, max_attention=argmax_first(align))


def graves_step(params, cfg, query, state: AttentionState, values, mask):
    """Discretized Graves attention (reference graves_attention.py:63-110):
    each head's mixture weight, width and advance from a two-layer dense
    over the query; the alignment is the difference of the mixture's
    logistic CDF at the position edges, 1e-20 where masked."""
    h = torch.relu(L.dense(params["layer1"], query))
    gbk = L.dense(params["layer2"], h)
    H = cfg.graves_heads
    g_t, b_t, k_t = gbk[:, :H], gbk[:, H:2 * H], gbk[:, 2 * H:]
    mu_t = state.extra + torch.nn.functional.softplus(k_t)
    sig_t = torch.nn.functional.softplus(b_t) + 1e-5
    g_t = torch.softmax(g_t, dim=1) + 1e-5
    T = values.shape[1]
    pos = (torch.arange(T + 1, dtype=torch.float32, device=values.device) + 0.5)[None, None, :]
    x = (mu_t[..., None] - pos) / sig_t[..., None]
    alpha_t = torch.sum(g_t[..., None] * (1.0 / (1.0 + torch.sigmoid(x))), dim=1)  # [B, T+1]
    align = alpha_t[:, 1:] - alpha_t[:, :-1]
    align = torch.where(mask > 0, align, torch.full_like(align, 1e-20))
    context = torch.einsum("bt,btv->bv", align, values)
    return context, align, state._replace(context=context, alignments=align, cumulated=state.cumulated + align,
                                          extra=mu_t, max_attention=argmax_first(align))


def step(params, cfg: TacotronModelConfig, query, state: AttentionState, keys, values, mask,
         w_comb=None, b_comb=None, train: bool = False, drop_mask=None):
    """One attention step of ``cfg.attention_mode`` -> (context [B, V],
    alignment [B, T], new state).  ``w_comb``/``b_comb``: the combined
    location filter, when the caller hoisted it out of its loop;
    ``train`` selects training (JAX ``step``), ``drop_mask`` is GMM's
    dropout keep-mask then."""
    mode = cfg.attention_mode
    if mode == "forward":
        return forward_step(params, cfg, query, state, keys, values, mask, w_comb, b_comb, train)
    if mode == "lsa":
        return lsa_step(params, cfg, query, state, keys, values, mask, w_comb, b_comb, train)
    if mode == "gmm":
        return gmm_step(params, cfg, query, state, values, mask, train, drop_mask)
    if mode == "graves":
        return graves_step(params, cfg, query, state, values, mask)
    raise ValueError(f"unknown attention mode {mode!r}")
