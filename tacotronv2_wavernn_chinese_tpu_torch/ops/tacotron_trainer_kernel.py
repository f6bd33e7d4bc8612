"""The teacher-forced Tacotron-2 decoder core for training: two CUDA
kernels joined by a ``torch.autograd.Function``, and their plain versions.

The core is the serial part of the teacher-forced decode: per step, two
zoneout LSTMs and forward attention (location conv at F width over the
cumulated alignments, F->A location dense, tanh energies against the keys,
masked softmax, forward recursion with transition probability mu, context,
next mu).  The prenet runs batched before it and the frame/stop
projections batched after it (models/tacotron.py).

* ``train_fwd`` (K3, csrc/tacotron_train_fwd.cu) runs every step in one
  launch and writes out2, ctx and align plus the residual saves of
  ``FWD_OUTS``.
* ``train_bwd`` (K4, csrc/tacotron_train_bwd.cu) runs the reverse-time
  adjoint in one launch.  It streams the per-step adjoints ``d_g1``,
  ``d_g2``, ``d_q``, ``d_mulin`` and ``d_ctx_tot`` out (the "stream"
  layout), and keeps ``d_keys`` and per-row partials of ``d_conv``,
  ``d_wloc``, ``d_v`` and ``d_ball``.  The weight gradients, the prenet
  cotangent and ``d_values`` are then large matrix products over all steps
  and rows (``weight_grads``).
* ``FusedCore`` is the autograd Function over the two; ``fused_core_apply``
  is the entry point.  ``fused_core_plain`` is the same function as an eager
  loop over steps, differentiated by autograd.

For a CUDA tensor ``train_fwd``/``train_bwd`` launch their kernel or raise;
only CPU tensors go to their plain versions (``train_fwd_plain``, and
``train_bwd_plain``, the same adjoint written out in torch).

Replaces the JAX package's ops/tacotron_trainer_kernel.py (``_fwd_call``,
``_bwd_call``, ``_core``).  Scope (``train_supported``): forward attention
without smoothing, two prenet layers, widths that are multiples of 4; the
T_in envelope is the kernels' shared-memory budget
(``train_supported_shape``).  Both values of the config's ``fused_wgrads``
run the stream layout; the in-kernel "accum" layout and bf16 weights are
ROADMAP.md queue item 2.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from ..config import TacotronModelConfig
from . import LAUNCHES, check_launch, load, require_f32_contiguous, stream_ptr

NEG_INF = -1e9

# weight tensors the core differentiates through, in the JAX package's
# order; the location-conv bias is merged into ``ball`` outside the kernels
CORE_WEIGHTS = (
    "l1_pre", "l1_ctx", "l1_h", "l1_b",
    "l2_x", "l2_h", "l2_b",
    "wq", "w_conv", "w_loc", "ball", "v",
    "mu_c", "mu_q", "mu_b",
)

# forward outputs: primals, then the residual saves the backward reads
FWD_OUTS = (
    "out2", "ctx", "align",
    "align_sm", "out1", "c1p", "h1p", "c2p", "h2p", "ctxp", "alphap", "mup",
)

# backward outputs (stream layout): per-step adjoints, then the attention
# gradients kept in the kernel (d_conv, d_wloc, d_v, d_ball per row)
BWD_OUTS = (
    "d_g1", "d_g2", "d_q", "d_mulin", "d_ctx_tot",
    "d_keys", "d_conv", "d_wloc", "d_v", "d_ball",
)

THREADS = 1024  # block size of both kernels (csrc/tacotron_train_common.cuh)
SMEM_LIMIT = 232448  # opt-in dynamic shared memory of one block on sm_90


def train_supported(cfg: TacotronModelConfig) -> bool:
    """Configurations the two kernels compute."""
    return (
        cfg.attention_mode == "forward"
        and not cfg.smoothing
        and len(cfg.prenet_layers) == 2
        and all(n % 4 == 0 for n in (cfg.prenet_layers[-1], cfg.decoder_lstm_units,
                                     2 * cfg.encoder_lstm_units, cfg.attention_dim))
    )


def _up4(n: int) -> int:
    return (n + 3) & ~3


def widths(cfg: TacotronModelConfig) -> tuple:
    """(P, U, V, A, F, taps): prenet out, decoder LSTM, encoder (values),
    attention, location filters and location conv taps."""
    return (cfg.prenet_layers[-1], cfg.decoder_lstm_units, 2 * cfg.encoder_lstm_units,
            cfg.attention_dim, cfg.attention_filters, cfg.attention_kernel)


def smem_floats(kind: str, t_in: int, dims: tuple) -> int:
    """Shared-memory floats of one block of K3 ("fwd") or K4 ("bwd") at
    encoder length ``t_in`` for ``dims`` = ``widths(cfg)``: the layouts of
    ``fwd_layout``/``bwd_layout`` in csrc/tacotron_train_common.cuh, term
    for term (chip_smoke checks the two agree)."""
    P, U, V, A, Fw, taps = dims
    W = THREADS // 32
    T4 = _up4(t_in)
    if kind == "fwd":
        return (_up4(P + V + U) + 2 * U + 3 * U + 4 * U + _up4(A) + _up4(taps * Fw) + _up4(Fw * A)
                + W * _up4(Fw) + 64 + 4 * T4)
    if kind == "bwd":
        return (_up4(P + V + U) + 2 * U + U + 4 * U + 4 * U + 4 * U + 2 * V + U + _up4(V + U)
                + 2 * U + U + 4 * _up4(A) + _up4(taps * Fw) + 2 * _up4(Fw * A) + W * _up4(Fw)
                + 3 * W * _up4(A) + 64 + 5 * T4)
    raise ValueError(kind)


def max_t_in(dims: tuple) -> int:
    """The longest encoder sequence both kernels take: the backward's
    shared memory (a fixed part plus 5 T_in-length vectors) is the larger."""
    return ((SMEM_LIMIT // 4 - smem_floats("bwd", 0, dims)) // 5) & ~3


def train_supported_shape(batch: int, t_in: int, cfg: TacotronModelConfig) -> bool:
    """True when both kernels' shared memory fits at this encoder length;
    any batch size runs (one block per row)."""
    return batch >= 1 and 1 <= t_in <= max_t_in(widths(cfg))


def pack_core_weights(params: dict, cfg: TacotronModelConfig) -> tuple:
    """The CORE_WEIGHTS tuple from a params tree (differentiable slices).
    The location-conv bias rides through the F->A dense into one merged
    energy bias, built here so its gradient chains to the original params."""
    pre = cfg.prenet_layers[-1]
    u = cfg.decoder_lstm_units
    att = params["attention"]
    l1 = params["dec_lstm1"]["w"]
    l2 = params["dec_lstm2"]["w"]
    V = l1.shape[0] - pre - u
    w_loc = att["location_layer"]["w"]  # [F, A]
    ball = (att["location_conv"]["b"] @ w_loc + att["b"])[None]
    return (
        l1[:pre], l1[pre:pre + V], l1[pre + V:], params["dec_lstm1"]["b"][None],
        l2[:u], l2[u:], params["dec_lstm2"]["b"][None],
        att["query_layer"]["w"], att["location_conv"]["w"][:, 0], w_loc, ball, att["v"][None],
        att["mu_layer"]["w"][:V], att["mu_layer"]["w"][V:], att["mu_layer"]["b"][None],
    )


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------


def _im2col(cum: torch.Tensor, taps: int) -> torch.Tensor:
    """[B, T_in] -> [B, T_in, taps]: win[b, t, k] = cum[b, t + k - padl]
    (zero outside), the SAME window of the location conv."""
    padl = (taps - 1) // 2
    return F.pad(cum, (padl, taps - 1 - padl)).unfold(1, taps, 1)


def _col2im(G: torch.Tensor, t_in: int) -> torch.Tensor:
    """Transpose of ``_im2col``: out[b, s] = sum_k G[b, s + padl - k, k]."""
    B, _, taps = G.shape
    padl = (taps - 1) // 2
    acc = G.new_zeros(B, t_in + taps - 1)
    for k in range(taps):
        acc[:, k:k + t_in] += G[:, :, k]
    return acc[:, padl:padl + t_in]


def _gates(g: torch.Tensor, c_prev: torch.Tensor):
    u = c_prev.shape[-1]
    si = torch.sigmoid(g[:, :u])
    tj = torch.tanh(g[:, u:2 * u])
    sf = torch.sigmoid(g[:, 2 * u:3 * u] + 1.0)
    so = torch.sigmoid(g[:, 3 * u:])
    new_c = sf * c_prev + si * tj
    return si, tj, sf, so, new_c, so * torch.tanh(new_c)


def _keep_zone(masks, idx: int, s: int, zoneout: float):
    """(keep, zone) factors of zoneout at step s: the mask and 1 - mask in
    train mode, (1 - rate, rate) in eval mode."""
    if masks is not None:
        m = masks[idx][s]
        return m, 1.0 - m
    return 1.0 - zoneout, zoneout


def _fwd_loop(w, pre_seq, masks, keys, values, mem_mask, zoneout: float, keep_saves: bool):
    (l1_pre, l1_ctx, l1_h, l1_b, l2_x, l2_h, l2_b, wq, w_conv, w_loc, ball, v,
     mu_c, mu_q, mu_b) = w
    T, B, _ = pre_seq.shape
    T_in, V = values.shape[1], values.shape[2]
    u = l1_h.shape[0]
    taps = w_conv.shape[0]
    z = lambda n: pre_seq.new_zeros(B, n)
    c1, h1, c2, h2, ctx = z(u), z(u), z(u), z(u), z(V)
    alpha = z(T_in)
    alpha[:, 0] = 1.0
    cum = alpha.clone()
    mu = pre_seq.new_full((B, 1), 0.5)
    outs = {k: [] for k in FWD_OUTS}
    for s in range(T):
        if keep_saves:
            for k, val in (("c1p", c1), ("h1p", h1), ("c2p", c2), ("h2p", h2), ("ctxp", ctx),
                           ("alphap", alpha), ("mup", mu[:, 0])):
                outs[k].append(val)
        g1 = pre_seq[s] @ l1_pre + ctx @ l1_ctx + h1 @ l1_h + l1_b
        _, _, _, _, new_c1, new_h1 = _gates(g1, c1)
        keep, zone = _keep_zone(masks, 0, s, zoneout)
        c1 = keep * new_c1 + zone * c1
        keep, zone = _keep_zone(masks, 1, s, zoneout)
        h1 = keep * new_h1 + zone * h1
        out1 = new_h1
        g2 = out1 @ l2_x + h2 @ l2_h + l2_b
        _, _, _, _, new_c2, new_h2 = _gates(g2, c2)
        keep, zone = _keep_zone(masks, 2, s, zoneout)
        c2 = keep * new_c2 + zone * c2
        keep, zone = _keep_zone(masks, 3, s, zoneout)
        h2 = keep * new_h2 + zone * h2
        out2 = new_h2
        pq = out2 @ wq
        feats = _im2col(cum, taps) @ w_conv  # [B, T_in, F]
        th = torch.tanh(keys + pq[:, None, :] + feats @ w_loc + ball)
        energy = torch.sum(th * v, dim=-1)
        energy = torch.where(mem_mask > 0, energy, torch.full_like(energy, NEG_INF))
        align_sm = torch.softmax(energy, dim=-1)
        cum = cum + align_sm
        shift = F.pad(alpha, (1, 0))[:, :-1]
        pre_align = ((1.0 - mu) * alpha + mu * shift + 1e-10) * align_sm
        align = pre_align / torch.sum(pre_align, dim=-1, keepdim=True)
        ctx = torch.einsum("bt,btv->bv", align, values)
        mu = torch.sigmoid(ctx @ mu_c + out2 @ mu_q + mu_b)
        alpha = align
        for k, val in (("out2", out2), ("ctx", ctx), ("align", align)):
            outs[k].append(val)
        if keep_saves:
            outs["align_sm"].append(align_sm)
            outs["out1"].append(out1)
    return {k: torch.stack(vals) for k, vals in outs.items() if vals}


def train_fwd_plain(w, pre_seq, masks, keys, values, mem_mask, zoneout: float) -> dict:
    """Plain version of K3: the forward loop, returning every ``FWD_OUTS``
    tensor ([T, B, ...]; ``mup`` is [T, B])."""
    with torch.no_grad():
        return _fwd_loop(w, pre_seq, masks, keys, values, mem_mask, zoneout, True)


def train_bwd_plain(w, pre_seq, masks, keys, values, mem_mask, zoneout: float, saves: dict,
                    cots) -> dict:
    """Plain version of K4: the reverse-time adjoint of the forward loop in
    the stream layout, batched over rows.  ``cots`` are the cotangents of
    (out2, ctx, align).  Returns every ``BWD_OUTS`` tensor; d_conv, d_wloc,
    d_v and d_ball are per row ([B, ...])."""
    (l1_pre, l1_ctx, l1_h, l1_b, l2_x, l2_h, l2_b, wq, w_conv, w_loc, ball, v,
     mu_c, mu_q, mu_b) = w
    T, B, _ = pre_seq.shape
    T_in, V = values.shape[1], values.shape[2]
    u, A = l1_h.shape[0], wq.shape[1]
    taps, Fw = w_conv.shape
    g_out2, g_ctx, g_align = cots
    S = saves
    cum = pre_seq.new_zeros(B, T_in)
    cum[:, 0] = 1.0
    cum = cum + S["align_sm"].sum(0)
    z = lambda *shape: pre_seq.new_zeros(*shape)
    a_c1, a_h1, a_c2, a_h2 = z(B, u), z(B, u), z(B, u), z(B, u)
    a_ctx, a_alpha, a_cum, a_mu = z(B, V), z(B, T_in), z(B, T_in), z(B, 1)
    out = {"d_g1": z(T, B, 4 * u), "d_g2": z(T, B, 4 * u), "d_q": z(T, B, A), "d_mulin": z(T, B),
           "d_ctx_tot": z(T, B, V), "d_keys": z(B, T_in, A), "d_conv": z(B, taps, Fw),
           "d_wloc": z(B, Fw, A), "d_v": z(B, A), "d_ball": z(B, A)}
    for s in reversed(range(T)):
        align_sm = S["align_sm"][s]
        cum = cum - align_sm  # the conv input of step s
        out1, out2, ctx_t, align_t = S["out1"][s], S["out2"][s], S["ctx"][s], S["align"][s]
        c1p, h1p, c2p, h2p = S["c1p"][s], S["h1p"][s], S["c2p"][s], S["h2p"][s]
        ctxp, alphap, mup = S["ctxp"][s], S["alphap"][s], S["mup"][s][:, None]
        d_out2 = g_out2[s]
        d_ctx_tot = g_ctx[s] + a_ctx
        d_align_tot = g_align[s] + a_alpha
        # mu_t = sigmoid(ctx_t . mu_c + out2 . mu_q + mu_b), recomputed
        mu_t = torch.sigmoid(ctx_t @ mu_c + out2 @ mu_q + mu_b)
        d_lin = a_mu * mu_t * (1.0 - mu_t)
        d_ctx_tot = d_ctx_tot + d_lin @ mu_c.t()
        d_out2 = d_out2 + d_lin @ mu_q.t()
        out["d_mulin"][s] = d_lin[:, 0]
        out["d_ctx_tot"][s] = d_ctx_tot
        # context = align . values
        d_align_tot = d_align_tot + torch.einsum("btv,bv->bt", values, d_ctx_tot)
        # align = pre / sum(pre), pre = w * align_sm
        shift = F.pad(alphap, (1, 0))[:, :-1]
        w_t = (1.0 - mup) * alphap + mup * shift + 1e-10
        S_t = torch.sum(w_t * align_sm, dim=-1, keepdim=True)
        d_pre = (d_align_tot - torch.sum(d_align_tot * align_t, dim=-1, keepdim=True)) / S_t
        d_align_sm = d_pre * w_t + a_cum
        d_w = d_pre * align_sm
        d_mu_prev = torch.sum(d_w * (shift - alphap), dim=-1, keepdim=True)
        a_alpha_next = d_w * (1.0 - mup) + F.pad(d_w * mup, (0, 1))[:, 1:]
        # masked softmax (masked positions have align_sm = 0, hence d_e = 0)
        d_e = align_sm * (d_align_sm - torch.sum(d_align_sm * align_sm, dim=-1, keepdim=True))
        # energies: recompute, then adjoints through tanh, the F->A dense
        # and the location conv
        pq = out2 @ wq
        win = _im2col(cum, taps)
        feats = win @ w_conv
        th = torch.tanh(keys + pq[:, None, :] + feats @ w_loc + ball)
        d_th = d_e[..., None] * v * (1.0 - th * th)
        out["d_v"] += torch.sum(th * d_e[..., None], dim=1)
        out["d_ball"] += torch.sum(d_th, dim=1)
        out["d_keys"] += d_th
        d_q = torch.sum(d_th, dim=1)
        d_f = d_th @ w_loc.t()
        out["d_conv"] += win.transpose(1, 2) @ d_f
        out["d_wloc"] += feats.transpose(1, 2) @ d_th
        a_cum_next = a_cum + _col2im(d_f @ w_conv.t(), T_in)
        d_out2 = d_out2 + d_q @ wq.t()
        out["d_q"][s] = d_q
        # LSTM2 (gates recomputed)
        g2 = out1 @ l2_x + h2p @ l2_h + l2_b
        si, tj, sf, so, new_c2, _ = _gates(g2, c2p)
        th_c = torch.tanh(new_c2)
        m_c, z_c = _keep_zone(masks, 2, s, zoneout)
        m_h, z_h = _keep_zone(masks, 3, s, zoneout)
        d_new_h = a_h2 * m_h + d_out2
        d_new_c = a_c2 * m_c + d_new_h * so * (1.0 - th_c * th_c)
        a_c2 = a_c2 * z_c + d_new_c * sf
        d_g2 = torch.cat([d_new_c * tj * si * (1.0 - si), d_new_c * si * (1.0 - tj * tj),
                          d_new_c * c2p * sf * (1.0 - sf), d_new_h * th_c * so * (1.0 - so)], dim=-1)
        out["d_g2"][s] = d_g2
        d_out1 = d_g2 @ l2_x.t()
        a_h2 = a_h2 * z_h + d_g2 @ l2_h.t()
        # LSTM1
        g1 = pre_seq[s] @ l1_pre + ctxp @ l1_ctx + h1p @ l1_h + l1_b
        si, tj, sf, so, new_c1, _ = _gates(g1, c1p)
        th_c = torch.tanh(new_c1)
        m_c, z_c = _keep_zone(masks, 0, s, zoneout)
        m_h, z_h = _keep_zone(masks, 1, s, zoneout)
        d_new_h = a_h1 * m_h + d_out1
        d_new_c = a_c1 * m_c + d_new_h * so * (1.0 - th_c * th_c)
        a_c1 = a_c1 * z_c + d_new_c * sf
        d_g1 = torch.cat([d_new_c * tj * si * (1.0 - si), d_new_c * si * (1.0 - tj * tj),
                          d_new_c * c1p * sf * (1.0 - sf), d_new_h * th_c * so * (1.0 - so)], dim=-1)
        out["d_g1"][s] = d_g1
        a_h1 = a_h1 * z_h + d_g1 @ l1_h.t()
        a_ctx = d_g1 @ l1_ctx.t()
        a_alpha, a_cum, a_mu = a_alpha_next, a_cum_next, d_mu_prev
    return out


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------


def _dims(w, pre_seq, keys, values):
    T, B, P = pre_seq.shape
    T_in, V = values.shape[1], values.shape[2]
    U, A = w[2].shape[0], w[7].shape[1]
    taps, Fw = w[8].shape
    return T, B, T_in, P, U, V, A, Fw, taps


def _check_cuda_args(w, pre_seq, masks, keys, values, mem_mask, dev):
    T, B, T_in, P, U, V, A, Fw, taps = _dims(w, pre_seq, keys, values)
    for name, n in (("prenet width", P), ("decoder_lstm_units", U), ("encoder width", V),
                    ("attention_dim", A)):
        if n % 4:
            raise NotImplementedError(
                f"the trainer kernels need {name} divisible by 4, got {n} (ROADMAP.md, queue item 2)"
            )
    if T_in > max_t_in((P, U, V, A, Fw, taps)):
        raise NotImplementedError(
            f"T_in={T_in} exceeds the trainer kernels' shared-memory envelope of "
            f"{max_t_in((P, U, V, A, Fw, taps))} (ROADMAP.md, queue item 2)"
        )
    require_f32_contiguous("pre_seq", pre_seq, dev)
    require_f32_contiguous("keys", keys, dev, (B, T_in, A))
    require_f32_contiguous("values", values, dev, (B, T_in, V))
    require_f32_contiguous("mem_mask", mem_mask, dev, (B, T_in))
    if masks is not None:
        for i, m in enumerate(masks):
            require_f32_contiguous(f"zoneout mask {i}", m, dev, (T, B, U))


def _ptr_array(tensors) -> ctypes.Array:
    return (ctypes.c_void_p * len(tensors))(*[0 if t is None else t.data_ptr() for t in tensors])


def _pack_fwd(w):
    """K3's weight layout: every gate matrix transposed to [out, in] (the
    three LSTM1 input segments joined), the small vectors flattened."""
    (l1_pre, l1_ctx, l1_h, l1_b, l2_x, l2_h, l2_b, wq, w_conv, w_loc, ball, v,
     mu_c, mu_q, mu_b) = (t.detach() for t in w)
    c = lambda t: t.contiguous()
    return [
        c(torch.cat([l1_pre, l1_ctx, l1_h]).t()), c(l1_b.reshape(-1)),
        c(torch.cat([l2_x, l2_h]).t()), c(l2_b.reshape(-1)), c(wq.t()),
        c(w_conv), c(w_loc), c(ball.reshape(-1)), c(v.reshape(-1)),
        c(mu_c.reshape(-1)), c(mu_q.reshape(-1)), c(mu_b.reshape(-1)),
    ]


def train_fwd(w, pre_seq, masks, keys, values, mem_mask, zoneout: float) -> dict:
    """K3: the forward loop.  CUDA: one kernel launch; CPU: the plain
    version.  ``masks`` is (mc1, mh1, mc2, mh2) f32 [T, B, U] keep-masks
    (train mode) or None (eval-mode EMA at rate ``zoneout``)."""
    if pre_seq.device.type == "cpu":
        return train_fwd_plain(w, pre_seq, masks, keys, values, mem_mask, zoneout)
    if pre_seq.device.type != "cuda":
        raise NotImplementedError(f"no trainer kernel for device {pre_seq.device}")
    dev = pre_seq.device
    _check_cuda_args(w, pre_seq, masks, keys, values, mem_mask, dev)
    T, B, T_in, P, U, V, A, Fw, taps = _dims(w, pre_seq, keys, values)
    e = lambda *shape: torch.empty(shape, dtype=torch.float32, device=dev)
    outs = {"out2": e(T, B, U), "ctx": e(T, B, V), "align": e(T, B, T_in),
            "align_sm": e(T, B, T_in), "out1": e(T, B, U), "c1p": e(T, B, U), "h1p": e(T, B, U),
            "c2p": e(T, B, U), "h2p": e(T, B, U), "ctxp": e(T, B, V), "alphap": e(T, B, T_in),
            "mup": e(T, B)}
    if T == 0 or B == 0:
        return outs
    wk = _pack_fwd(w)
    m = list(masks) if masks is not None else [None] * 4
    ptrs = _ptr_array([pre_seq, *m, keys, values, mem_mask, *wk, *[outs[k] for k in FWD_OUTS]])
    lib = load("tacotron_train_fwd.cu")
    with torch.cuda.device(dev):
        err = lib.tacotron_train_fwd_launch(
            ptrs, B, T, T_in, P, U, V, A, Fw, taps, int(masks is not None), float(zoneout),
            stream_ptr(dev),
        )
    LAUNCHES["tacotron_train_fwd"] += 1
    check_launch(err, "tacotron_train_fwd")
    return outs


def _cum_T(align_sm: torch.Tensor) -> torch.Tensor:
    """The cumulated alignments after the last step: one-hot(0) + sum of
    every step's softmax alignment (the backward rebuilds earlier ones)."""
    cum = align_sm.sum(0)
    cum[:, 0] += 1.0
    return cum.contiguous()


def train_bwd(w, pre_seq, masks, keys, values, mem_mask, zoneout: float, saves: dict, cots) -> dict:
    """K4: the reverse-time adjoint.  CUDA: one kernel launch; CPU: the
    plain version.  Returns every ``BWD_OUTS`` tensor."""
    if pre_seq.device.type == "cpu":
        return train_bwd_plain(w, pre_seq, masks, keys, values, mem_mask, zoneout, saves, cots)
    if pre_seq.device.type != "cuda":
        raise NotImplementedError(f"no trainer kernel for device {pre_seq.device}")
    dev = pre_seq.device
    _check_cuda_args(w, pre_seq, masks, keys, values, mem_mask, dev)
    T, B, T_in, P, U, V, A, Fw, taps = _dims(w, pre_seq, keys, values)
    e = lambda *shape: torch.empty(shape, dtype=torch.float32, device=dev)
    outs = {"d_g1": e(T, B, 4 * U), "d_g2": e(T, B, 4 * U), "d_q": e(T, B, A), "d_mulin": e(T, B),
            "d_ctx_tot": e(T, B, V), "d_keys": e(B, T_in, A), "d_conv": e(B, taps, Fw),
            "d_wloc": e(B, Fw, A), "d_v": e(B, A), "d_ball": e(B, A)}
    if T == 0 or B == 0:
        for k in ("d_keys", "d_conv", "d_wloc", "d_v", "d_ball"):
            outs[k].zero_()
        return outs
    cots = [c.contiguous() for c in cots]
    for name, c, shape in zip(("g_out2", "g_ctx", "g_align"), cots,
                              ((T, B, U), (T, B, V), (T, B, T_in))):
        require_f32_contiguous(name, c, dev, shape)
    for k in FWD_OUTS:
        require_f32_contiguous(k, saves[k], dev)
    wk = _pack_fwd(w)
    wd = [t.detach() for t in w]
    # the adjoint products W^T d read the [in, out] layout row by row
    l1_io = torch.cat([wd[0], wd[1], wd[2]]).contiguous()
    l2_io = torch.cat([wd[4], wd[5]]).contiguous()
    wq_io = wd[7].contiguous()
    w_locT = wd[9].t().contiguous()
    scratch = e(B, T_in * (2 * Fw + A))
    m = list(masks) if masks is not None else [None] * 4
    ptrs = _ptr_array([
        pre_seq, *m, keys, values, mem_mask, _cum_T(saves["align_sm"]), *cots,
        *wk, l1_io, l2_io, wq_io, w_locT,
        *[saves[k] for k in FWD_OUTS], *[outs[k] for k in BWD_OUTS], scratch,
    ])
    lib = load("tacotron_train_bwd.cu")
    with torch.cuda.device(dev):
        err = lib.tacotron_train_bwd_launch(
            ptrs, B, T, T_in, P, U, V, A, Fw, taps, int(masks is not None), float(zoneout),
            stream_ptr(dev),
        )
    LAUNCHES["tacotron_train_bwd"] += 1
    check_launch(err, "tacotron_train_bwd")
    return outs


def weight_grads(w, pre_seq, saves: dict, bwd: dict):
    """The products over all steps and rows that turn K4's streamed
    adjoints into gradients: (CORE_WEIGHTS gradients, d_pre_seq,
    d_values).  Large matrix products, as in the JAX package's custom VJP."""
    T, B, _ = pre_seq.shape
    flat = lambda x: x.reshape(T * B, -1)
    d_g1, d_g2, d_mulin = flat(bwd["d_g1"]), flat(bwd["d_g2"]), bwd["d_mulin"].reshape(-1)
    dW = (
        flat(pre_seq).t() @ d_g1,
        flat(saves["ctxp"]).t() @ d_g1,
        flat(saves["h1p"]).t() @ d_g1,
        d_g1.sum(0)[None],
        flat(saves["out1"]).t() @ d_g2,
        flat(saves["h2p"]).t() @ d_g2,
        d_g2.sum(0)[None],
        flat(saves["out2"]).t() @ flat(bwd["d_q"]),
        bwd["d_conv"].sum(0),
        bwd["d_wloc"].sum(0),
        bwd["d_ball"].sum(0, keepdim=True),
        bwd["d_v"].sum(0, keepdim=True),
        (flat(saves["ctx"]).t() @ d_mulin)[:, None],
        (flat(saves["out2"]).t() @ d_mulin)[:, None],
        d_mulin.sum()[None, None],
    )
    d_pre = bwd["d_g1"] @ w[0].detach().t()
    d_values = torch.einsum("tbi,tbv->biv", saves["align"], bwd["d_ctx_tot"])
    return dW, d_pre, d_values


class FusedCore(torch.autograd.Function):
    """Forward: K3; backward: K4 then ``weight_grads``.  Inputs after the
    non-differentiable (zoneout, masks, mem_mask): pre_seq, keys, values
    and the CORE_WEIGHTS tensors."""

    @staticmethod
    def forward(ctx, zoneout, masks, mem_mask, pre_seq, keys, values, *w):
        outs = train_fwd(w, pre_seq, masks, keys, values, mem_mask, zoneout)
        m = list(masks) if masks is not None else []
        ctx.zoneout, ctx.n_masks = zoneout, len(m)
        ctx.save_for_backward(pre_seq, keys, values, mem_mask, *m, *w, *[outs[k] for k in FWD_OUTS])
        return outs["out2"], outs["ctx"], outs["align"]

    @staticmethod
    def backward(ctx, g_out2, g_ctx, g_align):
        saved = ctx.saved_tensors
        pre_seq, keys, values, mem_mask = saved[:4]
        k = 4 + ctx.n_masks
        masks = tuple(saved[4:k]) if ctx.n_masks else None
        w = saved[k:k + len(CORE_WEIGHTS)]
        saves = dict(zip(FWD_OUTS, saved[k + len(CORE_WEIGHTS):]))
        cots = [torch.zeros_like(saves[n]) if g is None else g
                for g, n in zip((g_out2, g_ctx, g_align), ("out2", "ctx", "align"))]
        bwd = train_bwd(w, pre_seq, masks, keys, values, mem_mask, ctx.zoneout, saves, cots)
        dW, d_pre, d_values = weight_grads(w, pre_seq, saves, bwd)
        return (None, None, None, d_pre, bwd["d_keys"], d_values, *dW)


def _masks_f32(masks):
    if masks is None:
        return None
    return tuple(m.to(torch.float32).contiguous() for m in masks)


def fused_core_apply(params: dict, cfg: TacotronModelConfig, pre_seq, masks, keys, values, mem_mask):
    """The teacher-forced core -> (out2 [T, B, U], ctx [T, B, V],
    aligns [T, B, T_in]), differentiable.  ``masks``: (mc1, mh1, mc2, mh2)
    zoneout keep-masks [T, B, U] (train mode) or None (eval-mode EMA).
    The weight gradients always take the stream layout, whatever
    ``tacotron_train.fused_wgrads`` says (the in-kernel "accum" layout is
    ROADMAP.md queue item 2).  CUDA tensors run K3/K4, CPU tensors their
    plain versions."""
    w = pack_core_weights(params, cfg)
    return FusedCore.apply(
        float(cfg.zoneout_rate), _masks_f32(masks), mem_mask.to(torch.float32).contiguous(),
        pre_seq.contiguous(), keys.contiguous(), values.contiguous(), *w,
    )


def fused_core_plain(params: dict, cfg: TacotronModelConfig, pre_seq, masks, keys, values, mem_mask):
    """The same function as ``fused_core_apply`` as an eager loop over
    steps, differentiated by autograd (the reference the kernels are held
    against)."""
    w = pack_core_weights(params, cfg)
    outs = _fwd_loop(w, pre_seq, _masks_f32(masks), keys, values, mem_mask.to(torch.float32),
                     float(cfg.zoneout_rate), False)
    return outs["out2"], outs["ctx"], outs["align"]
