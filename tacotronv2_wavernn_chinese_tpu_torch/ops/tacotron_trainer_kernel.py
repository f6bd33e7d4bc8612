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
  ``FWD_OUTS`` (the gate pre-activations and the query projection among
  them).
* ``train_bwd`` (K4, csrc/tacotron_train_bwd.cu) runs the reverse-time
  adjoint in one launch.  It streams the per-step adjoints ``d_g1``,
  ``d_g2``, ``d_q``, ``d_mulin`` and ``d_ctx_tot`` out (the "stream"
  layout), and keeps ``d_keys`` and per-block partials of ``d_conv``,
  ``d_wloc``, ``d_v`` and ``d_ball``.  The weight gradients, the prenet
  cotangent and ``d_values`` are then large matrix products over all steps
  and rows (``weight_grads``).

Both kernels are one grid of thread-block clusters, about one block per SM,
that holds the gate weights once on chip for all batch rows
(csrc/tacotron_train_common.cuh).  ``k34_plan`` is that grid's plan, term
for term as the .cu files compute it; the wrappers compare it with the
library's own numbers before every launch.
* ``FusedCore`` is the autograd Function over the two; ``fused_core_apply``
  is the entry point.  ``fused_core_plain`` is the same function as an eager
  loop over steps, differentiated by autograd.

For a CUDA tensor ``train_fwd``/``train_bwd`` launch their kernel or raise;
only CPU tensors go to their plain versions (``train_fwd_plain``, and
``train_bwd_plain``, the same adjoint written out in torch).

Replaces the JAX package's ops/tacotron_trainer_kernel.py (``_fwd_call``,
``_bwd_call``, ``_core``).  Scope (``train_supported``): forward attention
without smoothing, two prenet layers, widths that are multiples of 4; the
batch and T_in envelope is the plan's (``train_supported_shape``: at most
eight rows per cluster, and a block's shared memory).  Both values of the
config's ``fused_wgrads`` run the stream layout; the in-kernel "accum"
layout, bf16 weights and a wider envelope are ROADMAP.md queue item 5.
"""

from __future__ import annotations

import ctypes
import dataclasses

import torch
import torch.nn.functional as F

from ..config import TacotronModelConfig
from ..utils import device_index
from ..utils import metrics as M
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
# (the gate pre-activations g1, g2 and the query projection pq among them,
# so that the backward recomputes no product)
FWD_OUTS = (
    "out2", "ctx", "align",
    "align_sm", "out1", "c1p", "h1p", "c2p", "h2p", "ctxp", "alphap", "mup", "g1", "g2", "pq",
)

# backward outputs (stream layout): per-step adjoints, then the attention
# gradients kept in the kernel (d_conv, d_wloc, d_v, d_ball as partials)
BWD_OUTS = (
    "d_g1", "d_g2", "d_q", "d_mulin", "d_ctx_tot",
    "d_keys", "d_conv", "d_wloc", "d_v", "d_ball",
)

THREADS = 512  # block size of both kernels (csrc/tacotron_train_common.cuh)
CLUSTER = 8  # blocks of a thread-block cluster
CHUNK = THREADS // 32  # K4's attention positions per chunk (one per warp)
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


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def widths(cfg: TacotronModelConfig) -> tuple:
    """(P, U, V, A, F, taps): prenet out, decoder LSTM, encoder (values),
    attention, location filters and location conv taps."""
    return (cfg.prenet_layers[-1], cfg.decoder_lstm_units, 2 * cfg.encoder_lstm_units,
            cfg.attention_dim, cfg.attention_filters, cfg.attention_kernel)


def _cut(i: int, per: int, n: int) -> range:
    lo = min(i * per, n)
    return range(lo, min(lo + per, n))


@dataclasses.dataclass(frozen=True)
class K34Plan:
    """The grid of both trainer kernels (csrc/tacotron_train_common.cuh
    ``tr_plan``): ``clusters`` clusters of CLUSTER blocks.  Rank q of every
    cluster holds the K-units [q*k_units, ...) on the reduction side of the
    products; cluster c owns the outputs of the units [c*units_c, ...)
    (rank q merging [q*units_b, ...) of them) and K4's context rows
    [c*ctx_c, ...); row b's attention runs on blocks_per_row blocks of
    cluster b // rows_per_cluster, ``positions`` encoder positions each."""

    B: int
    T_in: int
    dims: tuple
    clusters: int
    blocks: int
    k_units: int
    units_c: int
    units_b: int
    ctx_c: int
    ctx_b: int
    prenet_k: int
    ctx_k: int
    rows_per_cluster: int
    blocks_per_row: int
    positions: int

    def k_unit_range(self, q: int) -> range:
        return _cut(q, self.k_units, self.dims[1])

    def out_units(self, c: int, q: int) -> range:
        cu = _cut(c, self.units_c, self.dims[1])
        own = _cut(q, self.units_b, len(cu))
        return range(cu.start + own.start, cu.start + own.stop)

    def ctx_rows(self, c: int, q: int) -> range:
        cv = _cut(c, self.ctx_c, self.dims[2])
        own = _cut(q, self.ctx_b, len(cv))
        return range(cv.start + own.start, cv.start + own.stop)

    def row(self, k: int):
        """(row, slice) of block k's attention, row None when it has none."""
        c, q = divmod(k, CLUSTER)
        b = c * self.rows_per_cluster + q // self.blocks_per_row
        return (b if b < self.B else None), q % self.blocks_per_row

    def position_range(self, k: int) -> range:
        b, sl = self.row(k)
        return _cut(sl, self.positions, self.T_in) if b is not None else range(0)

    def smem_floats(self, kind: str) -> int:
        """Shared-memory floats of one block: ``fwd_layout``/``bwd_layout``
        in the .cu files, term for term."""
        P, U, V, A, Fw, taps = self.dims
        B, Ku, uc, vc, nT4 = self.B, self.k_units, self.units_c, self.ctx_c, _up4(self.positions)
        halo = _up4(self.positions + taps - 1)
        if kind == "fwd":
            LK1 = _up4(self.prenet_k + self.ctx_k + Ku) + 4
            LK2 = _up4(2 * Ku) + 4
            ng = 4 * uc
            return (ng * LK1 + ng * LK2 + Ku * A + _up4(taps * Fw) + Fw * A + _up4(4 * B * Ku)
                    + B * LK1 + _up4(B * ng) + self.rows_per_cluster * A + 2 * A
                    + 2 * (THREADS // 32) * _up4(Fw) + halo + 2 * nT4 + V + 16 + 64)
        if kind == "bwd":
            L4 = 4 * Ku + 4
            n2, n1 = 2 * uc, vc + uc
            products = B * L4 + _up4(B * n2) + _up4(B * n1)
            chunk = max(CHUNK * ((Fw + 7) & ~7) + _up4(CHUNK * (Fw + 1)) + _up4(CHUNK * (A + 1))
                        + 4 * CHUNK * 32, 2 * (THREADS // 32) * A)
            return (n2 * L4 + n1 * L4 + Ku * A + _up4(taps * Fw) + _up4(Fw * (A + 1))
                    + _up4(4 * B * Ku) + max(products, chunk) + halo + 4 * nT4 + V + 2 * A
                    + self.rows_per_cluster * A + 3 * A + Fw * A + _up4(taps * Fw) + 16 + 64)
        raise ValueError(kind)

    def smem_bytes(self, kind: str) -> int:
        return 4 * self.smem_floats(kind)

    def scratch_floats(self) -> int:
        """K4's global exchange: a_ctx [B, V], y3 [B, U], [d_out1 | d_h2]
        [B, 2U], d_h1 [2, B, U], the conv transpose's terms [B, T_in, taps]."""
        P, U, V, A, Fw, taps = self.dims
        return self.B * (V + 5 * U + self.T_in * taps)

    def fits(self) -> bool:
        """Whether both kernels launch: at most eight rows per cluster, the
        widths K4's per-position warp takes (A <= 128 columns, F and taps
        <= 32 lanes), and one block's shared memory."""
        P, U, V, A, Fw, taps = self.dims
        return (self.blocks_per_row > 0 and A <= 128 and Fw <= 32 and taps <= 32
                and max(self.smem_bytes("fwd"), self.smem_bytes("bwd")) <= SMEM_LIMIT)


def k34_plan(batch: int, t_in: int, dims: tuple, clusters: int) -> K34Plan:
    """The plan of both kernels for ``clusters`` resident clusters
    (``tr_plan``, term for term); ``fits`` says whether it launches."""
    P, U, V, A, Fw, taps = dims
    rpc = 1
    while rpc * clusters < batch:
        rpc *= 2
    bpr = CLUSTER // rpc if rpc <= CLUSTER else 0
    uc, vc = _cdiv(U, clusters), _cdiv(V, clusters)
    return K34Plan(batch, t_in, tuple(dims), clusters, clusters * CLUSTER, _cdiv(U, CLUSTER),
                   uc, _cdiv(uc, CLUSTER), vc, _cdiv(vc, CLUSTER), _cdiv(P, CLUSTER), _cdiv(V, CLUSTER),
                   rpc, bpr, _cdiv(t_in, bpr) if bpr else 0)


def max_t_in(batch: int, dims: tuple, clusters: int) -> int:
    """The longest encoder sequence both kernels take at this batch size
    (their shared memory grows with the positions of a block); 0 when the
    batch itself does not fit."""
    lo, hi = 0, 1 << 16
    while lo < hi:
        mid = (lo + hi + 1) // 2
        if k34_plan(batch, mid, dims, clusters).fits():
            lo = mid
        else:
            hi = mid - 1
    return lo


def launch_plan(batch: int, t_in: int, dims: tuple, clusters: int) -> K34Plan:
    """The plan of a launch; NotImplementedError beyond the envelope."""
    plan = k34_plan(batch, t_in, dims, clusters)
    if not plan.fits():
        raise NotImplementedError(
            f"B={batch}, T_in={t_in} is beyond the trainer kernels' envelope on a card with {clusters} "
            f"resident clusters of {CLUSTER} blocks (at most {clusters * CLUSTER} rows; "
            f"T_in <= {max_t_in(batch, dims, clusters)} at B={batch}) (ROADMAP.md, queue item 5)"
        )
    return plan


def train_supported_shape(batch: int, t_in: int, cfg: TacotronModelConfig, clusters: int) -> bool:
    """True when both kernels' plan fits at this batch size and encoder
    length on a card that keeps ``clusters`` clusters resident."""
    return batch >= 1 and t_in >= 1 and k34_plan(batch, t_in, widths(cfg), clusters).fits()


_CLUSTERS: dict = {}


def card_clusters(device: torch.device) -> int:
    """Clusters of CLUSTER blocks that both kernels keep resident at once on
    ``device`` (one block per SM), asked of the card once per device."""
    key = device_index(device)
    if key not in _CLUSTERS:
        with torch.cuda.device(key):
            n = min(load("tacotron_train_fwd.cu").tacotron_train_fwd_clusters(),
                    load("tacotron_train_bwd.cu").tacotron_train_bwd_clusters())
        if n <= 0:
            raise RuntimeError(f"the trainer kernels cannot keep a cluster resident (cudaError {-n})")
        _CLUSTERS[key] = n
    return _CLUSTERS[key]


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
        if keep_saves:
            for k, val in (("g1", g1), ("g2", g2), ("pq", pq)):
                outs[k].append(val)
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
    tensor ([T, B, ...]; ``mup`` is [T, B]; g1 and g2 are the gate
    pre-activations with their bias, before the forget bias +1)."""
    with torch.no_grad():
        return _fwd_loop(w, pre_seq, masks, keys, values, mem_mask, zoneout, True)


def train_bwd_plain(w, pre_seq, masks, keys, values, mem_mask, zoneout: float, saves: dict,
                    cots) -> dict:
    """Plain version of K4: the reverse-time adjoint of the forward loop in
    the stream layout, batched over rows, on the forward's saves (gate
    pre-activations and query projection included).  ``cots`` are the
    cotangents of (out2, ctx, align).  Returns every ``BWD_OUTS`` tensor;
    d_conv, d_wloc, d_v and d_ball are partials per row ([B, ...]; the
    kernel's are per block), which ``weight_grads`` sums."""
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
        out2, ctx_t, align_t = S["out2"][s], S["ctx"][s], S["align"][s]
        c1p, c2p = S["c1p"][s], S["c2p"][s]
        alphap, mup = S["alphap"][s], S["mup"][s][:, None]
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
        pq = S["pq"][s]
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
        si, tj, sf, so, new_c2, _ = _gates(S["g2"][s], c2p)
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
        si, tj, sf, so, new_c1, _ = _gates(S["g1"][s], c1p)
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


def _cuda_plan(w, pre_seq, masks, keys, values, mem_mask, dev) -> K34Plan:
    """Checks the arguments of a launch and returns its plan; raises
    NotImplementedError for shapes the kernels do not take."""
    T, B, T_in, P, U, V, A, Fw, taps = _dims(w, pre_seq, keys, values)
    for name, n in (("prenet width", P), ("decoder_lstm_units", U), ("encoder width", V),
                    ("attention_dim", A)):
        if n % 4:
            raise NotImplementedError(
                f"the trainer kernels need {name} divisible by 4, got {n} (ROADMAP.md, queue item 5)"
            )
    plan = launch_plan(B, T_in, (P, U, V, A, Fw, taps), card_clusters(dev))
    require_f32_contiguous("pre_seq", pre_seq, dev)
    require_f32_contiguous("keys", keys, dev, (B, T_in, A))
    require_f32_contiguous("values", values, dev, (B, T_in, V))
    require_f32_contiguous("mem_mask", mem_mask, dev, (B, T_in))
    if masks is not None:
        for i, m in enumerate(masks):
            require_f32_contiguous(f"zoneout mask {i}", m, dev, (T, B, U))
    return plan


def _check_plan(lib, kind: str, plan: K34Plan) -> None:
    """The library's own layout against the plan, before every launch."""
    P, U, V, A, Fw, taps = plan.dims
    args = (plan.B, plan.T_in, P, U, V, A, Fw, taps)
    ok = getattr(lib, f"tacotron_train_{kind}_smem_bytes")(*args, plan.clusters) == plan.smem_bytes(kind)
    if kind == "bwd":
        ok = ok and lib.tacotron_train_bwd_scratch_floats(*args) == plan.scratch_floats()
    if not ok:
        raise RuntimeError(f"k34_plan and csrc/tacotron_train_{kind}.cu disagree on the kernel's layout")


def _ptr_array(tensors) -> ctypes.Array:
    return (ctypes.c_void_p * len(tensors))(*[0 if t is None else t.data_ptr() for t in tensors])


def _pack(w):
    """The kernels' weight layout: the gate matrices [in, out] with the
    LSTM1 input segments joined, the small vectors flattened."""
    (l1_pre, l1_ctx, l1_h, l1_b, l2_x, l2_h, l2_b, wq, w_conv, w_loc, ball, v,
     mu_c, mu_q, mu_b) = (t.detach() for t in w)
    c = lambda t: t.contiguous()
    return {
        "l1": c(torch.cat([l1_pre, l1_ctx, l1_h])), "l1_b": c(l1_b.reshape(-1)),
        "l2": c(torch.cat([l2_x, l2_h])), "l2_b": c(l2_b.reshape(-1)), "wq": c(wq),
        "w_conv": c(w_conv), "w_loc": c(w_loc), "ball": c(ball.reshape(-1)), "v": c(v.reshape(-1)),
        "mu_c": c(mu_c.reshape(-1)), "mu_q": c(mu_q.reshape(-1)), "mu_b": c(mu_b.reshape(-1)),
    }


def train_fwd(w, pre_seq, masks, keys, values, mem_mask, zoneout: float) -> dict:
    """K3: the forward loop.  CUDA: one cluster-grid launch; CPU: the plain
    version.  ``masks`` is (mc1, mh1, mc2, mh2) f32 [T, B, U] keep-masks
    (train mode) or None (eval-mode EMA at rate ``zoneout``)."""
    if pre_seq.device.type == "cpu":
        return train_fwd_plain(w, pre_seq, masks, keys, values, mem_mask, zoneout)
    if pre_seq.device.type != "cuda":
        raise NotImplementedError(f"no trainer kernel for device {pre_seq.device}")
    dev = pre_seq.device
    plan = _cuda_plan(w, pre_seq, masks, keys, values, mem_mask, dev)
    T, B, T_in, P, U, V, A, Fw, taps = _dims(w, pre_seq, keys, values)
    e = lambda *shape: torch.empty(shape, dtype=torch.float32, device=dev)
    outs = {"out2": e(T, B, U), "ctx": e(T, B, V), "align": e(T, B, T_in),
            "align_sm": e(T, B, T_in), "out1": e(T, B, U), "c1p": e(T, B, U), "h1p": e(T, B, U),
            "c2p": e(T, B, U), "h2p": e(T, B, U), "ctxp": e(T, B, V), "alphap": e(T, B, T_in),
            "mup": e(T, B), "g1": e(T, B, 4 * U), "g2": e(T, B, 4 * U), "pq": e(T, B, A)}
    if T == 0 or B == 0:
        return outs
    wk = _pack(w)
    m = list(masks) if masks is not None else [None] * 4
    ptrs = _ptr_array([pre_seq, *m, keys, values, mem_mask,
                       *[wk[k] for k in ("l1", "l1_b", "l2", "l2_b", "wq", "w_conv", "w_loc", "ball", "v",
                                         "mu_c", "mu_q", "mu_b")],
                       *[outs[k] for k in FWD_OUTS]])
    lib = load("tacotron_train_fwd.cu")
    _check_plan(lib, "fwd", plan)
    counter = torch.zeros(1, dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        err = lib.tacotron_train_fwd_launch(
            ptrs, counter.data_ptr(), B, T, T_in, P, U, V, A, Fw, taps, plan.clusters,
            int(masks is not None), float(zoneout), stream_ptr(dev),
        )
    LAUNCHES["tacotron_train_fwd"] += 1
    M.stamp("k3")
    check_launch(err, "tacotron_train_fwd")
    return outs


def _cum_T(align_sm: torch.Tensor) -> torch.Tensor:
    """The cumulated alignments after the last step: one-hot(0) + sum of
    every step's softmax alignment (the backward rebuilds earlier ones)."""
    cum = align_sm.sum(0)
    cum[:, 0] += 1.0
    return cum.contiguous()


def train_bwd(w, pre_seq, masks, keys, values, mem_mask, zoneout: float, saves: dict, cots) -> dict:
    """K4: the reverse-time adjoint.  CUDA: one cluster-grid launch; CPU:
    the plain version.  Returns every ``BWD_OUTS`` tensor (on the card,
    d_conv, d_wloc, d_v and d_ball are per-block partials [G, ...])."""
    if pre_seq.device.type == "cpu":
        return train_bwd_plain(w, pre_seq, masks, keys, values, mem_mask, zoneout, saves, cots)
    if pre_seq.device.type != "cuda":
        raise NotImplementedError(f"no trainer kernel for device {pre_seq.device}")
    dev = pre_seq.device
    plan = _cuda_plan(w, pre_seq, masks, keys, values, mem_mask, dev)
    T, B, T_in, P, U, V, A, Fw, taps = _dims(w, pre_seq, keys, values)
    e = lambda *shape: torch.empty(shape, dtype=torch.float32, device=dev)
    G = plan.blocks
    outs = {"d_g1": e(T, B, 4 * U), "d_g2": e(T, B, 4 * U), "d_q": e(T, B, A), "d_mulin": e(T, B),
            "d_ctx_tot": e(T, B, V), "d_keys": torch.zeros((B, T_in, A), dtype=torch.float32, device=dev),
            "d_conv": e(G, taps, Fw), "d_wloc": e(G, Fw, A), "d_v": e(G, A), "d_ball": e(G, A)}
    if T == 0 or B == 0:
        for k in ("d_conv", "d_wloc", "d_v", "d_ball"):
            outs[k].zero_()
        return outs
    cots = [c.contiguous() for c in cots]
    for name, c, shape in zip(("g_out2", "g_ctx", "g_align"), cots,
                              ((T, B, U), (T, B, V), (T, B, T_in))):
        require_f32_contiguous(name, c, dev, shape)
    for k in FWD_OUTS:
        require_f32_contiguous(k, saves[k], dev)
    wk = _pack(w)
    cum_T = _cum_T(saves["align_sm"])  # held until the launch: the kernel reads it
    scratch = torch.zeros(plan.scratch_floats(), dtype=torch.float32, device=dev)
    m = list(masks) if masks is not None else [None] * 4
    ptrs = _ptr_array([
        *m, keys, values, cum_T, *cots,
        *[wk[k] for k in ("w_conv", "w_loc", "ball", "v", "mu_c", "mu_q", "mu_b", "l1", "l2", "wq")],
        *[saves[k] for k in ("out2", "ctx", "align", "align_sm", "c1p", "c2p", "alphap", "mup",
                             "g1", "g2", "pq")],
        *[outs[k] for k in BWD_OUTS], scratch,
    ])
    lib = load("tacotron_train_bwd.cu")
    _check_plan(lib, "bwd", plan)
    counter = torch.zeros(1, dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        err = lib.tacotron_train_bwd_launch(
            ptrs, counter.data_ptr(), B, T, T_in, P, U, V, A, Fw, taps, plan.clusters,
            int(masks is not None), float(zoneout), stream_ptr(dev),
        )
    LAUNCHES["tacotron_train_bwd"] += 1
    M.stamp("k4")
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
        with M.span("k3", device=True):
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
        # autograd's device thread holds no span of the step: link to it
        with M.span("k4", device=True, parent=M.linked()):
            bwd = train_bwd(w, pre_seq, masks, keys, values, mem_mask, ctx.zoneout, saves, cots)
        with M.span("train.weight_grads", device=True, parent=M.linked()):
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
    ROADMAP.md queue item 5).  CUDA tensors run K3/K4, CPU tensors their
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
