"""The Tacotron-2 autoregressive decode (K2): CUDA kernel wrapper and its
plain version.

``decode_autoregressive_kernel`` runs the whole decode to ``max_iters``
steps (csrc/tacotron_decode.cu: one launch per row group, whole-batch early
exit); ``decode_autoregressive_plain`` is the same function in plain
PyTorch, a loop over ``models.tacotron.decoder_step`` with the same random
generator.  Both take (params, cfg, memory [B, T_in, V], mem_mask [B, T_in],
seeds [B], max_iters) and return (frames [B, T*r, 80], stops [B, T*r],
aligns [B, T, T_in], stop_len [B] in frames), r = cfg.outputs_per_step.
For a CUDA tensor the wrapper launches the kernel or raises; only a CPU
tensor goes to the plain version.

The kernel is one grid of thread-block clusters (about one block per SM)
that holds every decoder weight feeding the next step on chip for the whole
decode.  ``k2_plan`` is that grid's plan, term for term as the .cu file
computes it; the wrapper compares it with the library's own numbers before
every launch.  A batch that one launch cannot hold (more rows than the
grid's, or shared memory for the rows and positions) runs as sequential
launches over equal row groups, the last one padded by repeating a real row
(``row_groups``): a row's decode depends only on its own inputs and seed,
so its stop length and its frames up to the stop are those of one decode
over all rows.

Scope of the kernel (``check_supported``, the TPU kernel's ``supported``):
forward attention with or without anti-repeat, LSA with or without the
synthesis window (either type, cumulative_weights on or off), either with
smoothing, GMM attention of up to 128 mixtures and Graves attention of up to
128 heads; r = 1-6 under either stop policy; two prenet layers; widths that
are multiples of 4.  Beyond that the card raises NotImplementedError
(ROADMAP.md, queue item 15); the plain version takes every configuration.

Randomness: the prenet dropout of row b at step t draws
``hash_bits(seeds[b], 0, t, lane)`` with lanes [0, p1) for the first layer
and [p1, p1 + p2) for the second, so a row's dropout depends only on its
own seed and the step.
"""

from __future__ import annotations

import ctypes
import dataclasses

import torch

from ..config import TacotronModelConfig
from . import (
    LAUNCHES, check_launch, hash_bits, keep_threshold, load, ptr, require_f32_contiguous,
    stream_ptr,
)

NUM_MELS = 80
STOP_FILL = 1e4  # stop logit written for steps after every row is done
MAX_R = 6  # frames a step the kernel takes (the TPU kernel's bound)
MAX_MIX = 128  # GMM mixtures, Graves heads the kernel takes (the TPU kernel's bound)
MODE_IDS = {"forward": 0, "lsa": 1, "gmm": 2, "graves": 3}  # csrc/tacotron_decode.cu K2_*

WEIGHT_ORDER = (
    "pre_w1", "pre_b1", "pre_w2", "pre_b2", "l1", "l1_b", "l2", "l2_b",
    "wq", "w_comb", "b_comb", "att_v", "att_b", "proj", "proj_b", "wx", "wx_b",
    "wd", "wd_b", "wd2", "wd2_b",
)


def row_seeds(seeds, batch: int, device) -> torch.Tensor:
    """Per-row seeds as int32 [B] (Python ints wrap to 32 bits), the form
    both the kernel and the plain version read."""
    if isinstance(seeds, torch.Tensor):
        s = seeds.to(device=device, dtype=torch.int64)
    else:
        s = torch.as_tensor([int(v) for v in seeds], dtype=torch.int64, device=device)
    s = ((s & 0xFFFFFFFF) ^ 0x80000000) - 0x80000000
    if tuple(s.shape) != (batch,):
        raise ValueError(f"seeds must be [B]={batch}, got {tuple(s.shape)}")
    return s.to(torch.int32).contiguous()


def check_supported(cfg: TacotronModelConfig, device=None) -> None:
    """Raise for a decoder configuration that cannot run on ``device``
    (None: the card).  The plain version (CPU) runs every attention mode
    and every r; the kernel runs every mode at r = 1-6, GMM with up to 128
    mixtures and Graves with up to 128 heads."""
    from ..models.attention import MODES

    if cfg.attention_mode not in MODES:
        raise ValueError(f"unknown attention mode {cfg.attention_mode!r}")
    if cfg.outputs_per_step < 1:
        raise ValueError(f"outputs_per_step={cfg.outputs_per_step} must be at least 1")
    if len(cfg.prenet_layers) != 2:
        raise NotImplementedError("the decoder kernel and its plain version take exactly two prenet layers")
    if device is not None and torch.device(device).type == "cpu":
        return
    if n_mix(cfg) > MAX_MIX:
        what = "num_attn_mixtures" if cfg.attention_mode == "gmm" else "graves_heads"
        raise NotImplementedError(
            f"{what}={n_mix(cfg)}: the decode kernel takes up to {MAX_MIX}, as the TPU kernel does "
            "(ROADMAP.md, queue item 15)"
        )
    if cfg.outputs_per_step > MAX_R:
        raise NotImplementedError(
            f"outputs_per_step={cfg.outputs_per_step}: the decode kernel takes r up to {MAX_R}, as the TPU "
            "kernel does (ROADMAP.md, queue item 15)"
        )


def proj_mu(cfg: TacotronModelConfig) -> int:
    """1 when the kernel's projection has forward attention's mu column,
    else 0 (k2_plan, pack_weights and the launch all take it from here)."""
    return int(cfg.attention_mode == "forward")


def n_mix(cfg: TacotronModelConfig) -> int:
    """GMM's mixtures or Graves' heads; 0 for forward and LSA attention."""
    return {"gmm": cfg.num_attn_mixtures, "graves": cfg.graves_heads}.get(cfg.attention_mode, 0)


def branch(cfg: TacotronModelConfig) -> dict:
    """What the grid's plan takes of ``cfg``: r, mu, the mode and N
    (``k2_plan(..., **branch(cfg))``)."""
    return {"r": cfg.outputs_per_step, "mu": proj_mu(cfg), "mode": MODE_IDS[cfg.attention_mode],
            "n_mix": n_mix(cfg)}


def k2_variant(cfg: TacotronModelConfig) -> int:
    """The kernel instantiation of ``cfg`` (csrc/tacotron_decode.cu
    k2_kernel): 16 GMM, 32 Graves, whatever the other flags say (neither
    reads them, as in the TPU kernel); else bit 0 LSA, bit 1 anti-repeat
    (forward attention only: under LSA the flag picks the window's type,
    which reaches the kernel as the window's bounds, not as a bit), bit 2
    smoothing, bit 3 the LSA synthesis window."""
    if cfg.attention_mode in ("gmm", "graves"):
        return 16 if cfg.attention_mode == "gmm" else 32
    lsa = cfg.attention_mode == "lsa"
    return (int(lsa) | (int(cfg.anti_repeat and not lsa) << 1) | (int(cfg.smoothing) << 2)
            | (int(lsa and cfg.synthesis_constraint) << 3))


def stop_lengths(stops: torch.Tensor, max_iters: int, r: int = 1, stop_at_any: bool = True) -> torch.Tensor:
    """Frames until the stop (exclusive of the first flagged frame,
    reference tacotron_synthesize.py:105), from stops [B, T*r]: the first
    step whose r flags (sigmoid > 0.5) are any (``stop_at_any``) or all
    set, times r, plus the first flagged frame inside it; else max_iters * r
    (the JAX decode's per-step rule, models/tacotron.py:483-493)."""
    B = stops.shape[0]
    fin = (torch.sigmoid(stops) > 0.5).reshape(B, -1, r)
    ex_done = fin.any(dim=-1) if stop_at_any else fin.all(dim=-1)
    idx = torch.argmax(ex_done.to(torch.int32), dim=-1)
    step_fin = fin[torch.arange(B, device=stops.device), idx]
    first = torch.argmax(step_fin.to(torch.int32), dim=-1)
    full = torch.full_like(idx, max_iters * r)
    return torch.where(ex_done.any(dim=-1), idx * r + first, full).to(torch.int32)


def pack_weights(params: dict, cfg: TacotronModelConfig) -> dict:
    """Model params -> the kernel's layout: every dense transposed to
    [out, in]; the projection outputs that stay on chip (the last frame,
    the r stop logits and, for forward attention, mu) stacked into one
    [NP, u+V] matrix over the input [out2 | context]; for forward and LSA
    attention the location conv and location dense combined into one
    [taps, A] filter; for GMM gmm_layer's bias (its matrix is packed per
    rank, ``pack_rank_slices``), for Graves layer1 and layer2.  The other
    frame columns ("wx") are packed per rank as well.  The weights a mode
    does not have are absent."""
    att = params["attention"]
    U = cfg.decoder_lstm_units
    V = params["frame_projection"]["w"].shape[0] - U
    t = lambda a: a.t().contiguous()
    fw, fb = params["frame_projection"]["w"], params["frame_projection"]["b"]
    cols, bias = [fw[:, -NUM_MELS:], params["stop_projection"]["w"]], [fb[-NUM_MELS:], params["stop_projection"]["b"]]
    if proj_mu(cfg):
        mu_w = att["mu_layer"]["w"]  # rows [context (V); query (u)]
        cols.append(torch.cat([mu_w[V:], mu_w[:V]], dim=0))
        bias.append(att["mu_layer"]["b"])
    layers = params["prenet"]["layers"]
    out = {
        "pre_w1": t(layers[0]["w"]), "pre_b1": layers[0]["b"].contiguous(),
        "pre_w2": t(layers[1]["w"]), "pre_b2": layers[1]["b"].contiguous(),
        "l1": t(params["dec_lstm1"]["w"]), "l1_b": params["dec_lstm1"]["b"].contiguous(),
        "l2": t(params["dec_lstm2"]["w"]), "l2_b": params["dec_lstm2"]["b"].contiguous(),
        "proj": t(torch.cat(cols, dim=1)), "proj_b": torch.cat(bias).contiguous(),
        "wx_b": fb[: fb.shape[0] - NUM_MELS].contiguous(),
    }
    if cfg.attention_mode in ("forward", "lsa"):
        from ..models.attention import combined_location_weights

        w_comb, b_comb = combined_location_weights(att)
        out.update(wq=t(att["query_layer"]["w"]), w_comb=w_comb.contiguous(), b_comb=b_comb.contiguous(),
                   att_v=att["v"].contiguous(), att_b=att["b"].contiguous())
    elif cfg.attention_mode == "gmm":
        out["wd_b"] = att["gmm_layer"]["b"].contiguous()
    else:
        out.update(wd=t(att["layer1"]["w"]), wd_b=att["layer1"]["b"].contiguous(),
                   wd2=t(att["layer2"]["w"]), wd2_b=att["layer2"]["b"].contiguous())
    return out


def pack_rank_slices(w: torch.Tensor, plan: "K2Plan") -> torch.Tensor:
    """Output columns of a dense ``w`` [U+V, n] over the projection's input
    [out2 | context], [CLUSTER, n, LKP]: rank q's slice holds them over the
    inputs it owns, in the order of its input row (its out2 K-units from 0,
    its context K-slice from k_units; zeros elsewhere).  The frame columns
    before the last frame (``pack_other_frames``) and GMM's gmm_layer are
    packed so; the kernel reads the first from global memory, and the
    second too where its slice does not fit on chip."""
    U, Ku = plan.dims[2], plan.k_units
    out = w.new_zeros(CLUSTER, w.shape[1], plan.lkp)
    for q in range(CLUSTER):
        ku, kv = plan.k_unit_range(q), plan.ctx_range(q)
        out[q, :, : len(ku)] = w[list(ku)].t()
        out[q, :, Ku: Ku + len(kv)] = w[[U + v for v in kv]].t()
    return out.contiguous()


def pack_other_frames(params: dict, plan: "K2Plan") -> torch.Tensor:
    """The frame columns before the last frame, [CLUSTER, 80(r-1), LKP]
    (``pack_rank_slices``); they only leave the kernel."""
    return pack_rank_slices(params["frame_projection"]["w"][:, : plan.NX], plan)


# ---------------------------------------------------------------------------
# the kernel's grid plan (csrc/tacotron_decode.cu k2_plan / k2_layout)
# ---------------------------------------------------------------------------

CLUSTER = 8  # blocks of a thread-block cluster
SMEM_LIMIT = 232448  # opt-in dynamic shared memory of one block on sm_90
POSITIONS = 32  # attention positions a row block aims for (K2_POS)


def _up4(n: int) -> int:
    return (n + 3) & ~3


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _cut(i: int, per: int, n: int) -> range:
    lo = min(i * per, n)
    return range(lo, min(lo + per, n))


def widths(cfg: TacotronModelConfig, value_dim: int) -> tuple:
    """(P1, P2, U, V, A, taps): prenet widths, decoder LSTM, encoder
    (values), attention and location conv taps."""
    p1, p2 = cfg.prenet_layers
    return (p1, p2, cfg.decoder_lstm_units, value_dim, cfg.attention_dim, cfg.attention_kernel)


@dataclasses.dataclass(frozen=True)
class K2Plan:
    """The decode kernel's grid (csrc/tacotron_decode.cu ``k2_plan``):
    ``clusters`` clusters of CLUSTER blocks.  Rank q of every cluster holds
    the K-units [q*k_units, ...) on the reduction side of the gate and query
    products, the prenet-1 outputs [q*pre1_k, ...), the prenet-2 outputs
    [q*prenet_k, ...) (its pre2 K-slice of x1), the context inputs
    [q*ctx_k, ...) and the projection columns of its out2 K-units and
    context inputs; cluster c owns the gate outputs of the units
    [c*units_c, ...) (rank q merging [q*units_b, ...) of them); row b's
    attention runs on blocks_per_row blocks of cluster b // rows_per_cluster,
    ``positions`` encoder positions each.  Of the projection, NP outputs
    stay on chip (the last frame, r stops, mu when ``mu``); cluster c
    computes the other frame columns [c*ec, ...) of NX from global memory.
    ``mode`` is the attention (MODE_IDS) and ``n_mix`` GMM's mixtures or
    Graves' heads: GMM's dense slice over rank q's projection inputs stays
    on chip when ``res`` (where the plan then fits a block), else comes
    from L2; Graves' layer1 slice over rank q's out2 K-units and its
    layer2 outputs [q*c3, ...) stay on chip."""

    B: int
    T_in: int
    dims: tuple
    clusters: int
    blocks: int
    k_units: int
    units_c: int
    units_b: int
    pre1_k: int
    prenet_k: int
    ctx_k: int
    rows_per_cluster: int
    blocks_per_row: int
    positions: int
    r: int = 1
    mu: int = 1
    mode: int = 0
    n_mix: int = 0
    res: int = 0

    @property
    def loc(self) -> bool:
        """Forward or LSA attention (keys, the location conv, wq)."""
        return self.mode <= MODE_IDS["lsa"]

    @property
    def h1(self) -> int:
        """Graves: layer1's width."""
        return self.dims[2] // 4 if self.mode == MODE_IDS["graves"] else 0

    @property
    def c3(self) -> int:
        """Graves: layer2 outputs a rank holds."""
        return _cdiv(3 * self.n_mix, CLUSTER) if self.mode == MODE_IDS["graves"] else 0

    def layer2_range(self, q: int) -> range:
        return _cut(q, self.c3, 3 * self.n_mix)

    @property
    def NP(self) -> int:
        return NUM_MELS + self.r + self.mu

    @property
    def NX(self) -> int:
        return NUM_MELS * (self.r - 1)

    @property
    def ec(self) -> int:
        return _cdiv(self.NX, self.clusters)

    @property
    def ldp(self) -> int:
        """Row stride of the merged projection outputs."""
        return _up4(self.NP + 2)

    @property
    def ldx(self) -> int:
        """Row stride of the projection partials (on-chip outputs, then the
        cluster's other frame columns)."""
        return self.ldp + _up4(self.ec)

    @property
    def lkp(self) -> int:
        """Row stride of a rank's projection inputs [out2 K-units | ctx K-slice]."""
        return _up4(self.k_units + self.ctx_k) + 4

    def other_frames(self, c: int) -> range:
        """The frame columns (of the NX before the last frame) cluster c computes."""
        return _cut(c, self.ec, self.NX)

    def k_unit_range(self, q: int) -> range:
        return _cut(q, self.k_units, self.dims[2])

    def out_units(self, c: int, q: int) -> range:
        cu = _cut(c, self.units_c, self.dims[2])
        own = _cut(q, self.units_b, len(cu))
        return range(cu.start + own.start, cu.start + own.stop)

    def pre1_range(self, q: int) -> range:
        return _cut(q, self.pre1_k, self.dims[0])

    def pre2_range(self, q: int) -> range:
        return _cut(q, self.prenet_k, self.dims[1])

    def ctx_range(self, q: int) -> range:
        return _cut(q, self.ctx_k, self.dims[3])

    def proj_inputs(self, q: int) -> list:
        """Columns of the projection input [out2 | ctx] that rank q holds."""
        U = self.dims[2]
        return list(self.k_unit_range(q)) + [U + v for v in self.ctx_range(q)]

    def row(self, k: int):
        """(row, slice) of block k's attention, row None when it has none."""
        c, q = divmod(k, CLUSTER)
        rr = q // self.blocks_per_row
        b = c * self.rows_per_cluster + rr
        return (b if rr < self.rows_per_cluster and b < self.B else None), q % self.blocks_per_row

    def position_range(self, k: int) -> range:
        b, sl = self.row(k)
        return _cut(sl, self.positions, self.T_in) if b is not None else range(0)

    def smem_floats(self) -> int:
        """Shared-memory floats of one block: ``k2_layout`` in the .cu file,
        term for term."""
        P1, P2, U, V, A, taps = self.dims
        B, Ku, Kp, Kv, ng, nT = self.B, self.k_units, self.prenet_k, self.ctx_k, 4 * self.units_c, self.positions
        LK1, LK2, LKP = _up4(Kp + Kv + Ku) + 4, _up4(2 * Ku) + 4, self.lkp
        LKM, LKG = _up4(NUM_MELS) + 4, _up4(P1) + 4
        LDP, LDX = self.ldp, self.ldx
        LKQ, LKH, LDG, rpc = _up4(Ku) + 4, _up4(self.h1) + 4, _up4(3 * self.n_mix), self.rows_per_cluster
        gmm, graves = self.mode == MODE_IDS["gmm"], self.mode == MODE_IDS["graves"]
        if self.loc:  # wq, the location filter, v and the energy bias
            att_w = Ku * A + _up4(taps * A) + 2 * _up4(A)
        else:  # GMM's dense slice (on chip or not); Graves' layer1 and layer2 slices
            att_w = self.res * 3 * self.n_mix * LKP if gmm else self.h1 * LKQ + self.c3 * LKH
        weights = (ng * LK1 + ng * LK2 + self.NP * LKP + self.pre1_k * LKM + Kp * LKG + _up4(self.pre1_k)
                   + _up4(Kp) + LDP + att_w)
        rows = _up4(4 * B * Ku) + B * LK1 + B * max(LKG, LKP) + B * max(ng, LDX) + B * LDP + 4 * _up4(B)
        if self.loc:  # pqp, pq, the conv's input and halo, alpha
            att_rows = rpc * A + _up4(A) + _up4(nT + taps - 1) + _up4(nT)
        else:  # dq, dh, dg; the row's parameters and state
            att_rows = (rpc * LDG if gmm else 2 * rpc * LKH + rpc * LDG) + LDG + _up4(self.n_mix)
        attention = att_rows + _up4(nT + 1 if graves else nT) + _up4(nT) + _up4(V) + 16 + 64
        return weights + rows + attention

    def smem_bytes(self) -> int:
        return 4 * self.smem_floats()

    def scratch_floats(self) -> int:
        """The global exchange: g1 [B, 4U], g2 [B, 4U], ctx [B, V]."""
        P1, P2, U, V, A, taps = self.dims
        return self.B * (8 * U + V)

    def fits(self) -> bool:
        """Whether one launch takes the rows: at most CLUSTER rows per
        cluster, and one block's shared memory."""
        return self.blocks_per_row > 0 and self.smem_bytes() <= SMEM_LIMIT


def k2_plan(batch: int, t_in: int, dims: tuple, clusters: int, r: int = 1, mu: int = 1, mode: int = 0,
            n_mix: int = 0) -> K2Plan:
    """The plan of one launch for ``clusters`` resident clusters
    (``k2_plan`` of the .cu file, term for term), r frames a step, ``mu``
    1 for forward attention (the projection's mu column), else 0, ``mode``
    the attention (MODE_IDS; forward and LSA share a layout) and ``n_mix``
    GMM's mixtures or Graves' heads (``branch(cfg)`` gives all four);
    ``fits`` says whether it launches.  GMM keeps its dense slice on chip
    where the plan then fits (``res``)."""
    P1, P2, U, V, A, taps = dims
    rpc = 1
    while rpc * clusters < batch:
        rpc *= 2
    bpr = 0
    if rpc <= CLUSTER:
        bpr = 1
        while bpr < CLUSTER // rpc and bpr * POSITIONS < t_in:
            bpr *= 2
    uc = _cdiv(U, clusters)
    gmm = int(mode == MODE_IDS["gmm"])
    plan = K2Plan(batch, t_in, tuple(dims), clusters, clusters * CLUSTER, _cdiv(U, CLUSTER), uc,
                  _cdiv(uc, CLUSTER), _cdiv(P1, CLUSTER), _cdiv(P2, CLUSTER), _cdiv(V, CLUSTER),
                  rpc, bpr, _cdiv(t_in, bpr) if bpr else 0, r, mu, mode, n_mix, gmm)
    if gmm and plan.smem_bytes() > SMEM_LIMIT:
        plan = dataclasses.replace(plan, res=0)
    return plan


def rows_per_launch(t_in: int, dims: tuple, clusters: int, r: int = 1, mu: int = 1, mode: int = 0,
                    n_mix: int = 0) -> int:
    """The most rows one launch takes at this encoder length (the grid's
    rows, and shared memory, which grows with the rows and with a block's
    positions); 0 when not even one row fits."""
    lo, hi = 0, clusters * CLUSTER  # fits() only turns false as the rows grow
    while lo < hi:
        mid = (lo + hi + 1) // 2
        if k2_plan(mid, t_in, dims, clusters, r, mu, mode, n_mix).fits():
            lo = mid
        else:
            hi = mid - 1
    return lo


def row_groups(batch: int, group: int) -> list:
    """Equal row groups of at most ``group`` rows: [(start, stop, size)],
    ``size`` >= stop - start the rows of the launch (the last group padded)."""
    n = _cdiv(batch, group)
    size = _cdiv(batch, n)
    return [(i * size, min(batch, (i + 1) * size), size) for i in range(n)]


def decode_in_groups(decode_group, memory, mem_mask, seeds: torch.Tensor, group: int):
    """``decode_group(memory, mem_mask, seeds)`` over row groups of at most
    ``group`` rows, each padded by repeating its last real row (a padded
    zero row would never fire the stop token and would pin the group at
    max_iters); the results are concatenated and trimmed to the batch."""
    B = memory.shape[0]
    outs = []
    for lo, hi, size in row_groups(B, group):
        pick = torch.arange(lo, lo + size, device=memory.device).clamp_max(hi - 1)
        outs.append(decode_group(memory[pick].contiguous(), mem_mask[pick].contiguous(),
                                 seeds[pick.to(seeds.device)].contiguous()))
    return tuple(torch.cat([o[i][: hi - lo] for o, (lo, hi, _) in zip(outs, row_groups(B, group))])
                 for i in range(len(outs[0])))


_CLUSTERS: dict = {}


def card_clusters(device: torch.device) -> int:
    """Clusters of CLUSTER blocks the decode kernel keeps resident at once
    on ``device`` (one block per SM), asked of the card once per device."""
    key = torch.device(device).index or 0
    if key not in _CLUSTERS:
        with torch.cuda.device(key):
            n = load("tacotron_decode.cu").tacotron_decode_clusters()
        if n <= 0:
            raise RuntimeError(f"the decode kernel cannot keep a cluster resident (cudaError {-n})")
        _CLUSTERS[key] = n
    return _CLUSTERS[key]


def launch_group(t_in: int, dims: tuple, clusters: int, r: int = 1, mu: int = 1, mode: int = 0,
                 n_mix: int = 0) -> int:
    """Rows per launch; NotImplementedError when not even one row fits."""
    group = rows_per_launch(t_in, dims, clusters, r, mu, mode, n_mix)
    if group == 0:
        raise NotImplementedError(
            f"T_in={t_in} with widths {dims}, r={r} and attention mode {mode} ({n_mix} mixtures or heads) is "
            f"beyond the decode kernel's envelope on a card with {clusters} "
            f"resident clusters of {CLUSTER} blocks: one row's weight slices and positions exceed a block's "
            f"shared memory (ROADMAP.md, queue item 15)"
        )
    return group


def decode_autoregressive_kernel(params, cfg: TacotronModelConfig, memory, mem_mask, seeds, max_iters: int):
    """The whole decode.  CUDA: one kernel launch per row group; CPU: the
    plain version."""
    check_supported(cfg, memory.device)
    if memory.device.type == "cpu":
        return decode_autoregressive_plain(params, cfg, memory, mem_mask, seeds, max_iters)
    if memory.device.type != "cuda":
        raise NotImplementedError(f"no decoder kernel for device {memory.device}")
    from ..models.attention import lsa_window_bounds, precompute_keys

    dev = memory.device
    B, T_in, V = memory.shape
    br = branch(cfg)
    r, mu, N = br["r"], br["mu"], br["n_mix"]
    dims = widths(cfg, V)
    P1, P2, U, _, A, taps = dims
    for name, n in (("prenet widths", P1), ("prenet widths", P2), ("decoder_lstm_units", U),
                    ("encoder width", V), ("attention_dim", A)):
        if n % 4:
            raise NotImplementedError(f"the decoder kernel needs {name} divisible by 4, got {n}")
    w = pack_weights(params, cfg)
    NP = NUM_MELS + r + mu
    shapes = {
        "pre_w1": (P1, NUM_MELS), "pre_b1": (P1,), "pre_w2": (P2, P1), "pre_b2": (P2,),
        "l1": (4 * U, P2 + V + U), "l1_b": (4 * U,), "l2": (4 * U, 2 * U), "l2_b": (4 * U,),
        "proj": (NP, U + V), "proj_b": (NP,), "wx_b": (NUM_MELS * (r - 1),),
        **{"forward": {"wq": (A, U), "w_comb": (taps, A), "b_comb": (A,), "att_v": (A,), "att_b": (A,)},
           "gmm": {"wd_b": (3 * N,)},
           "graves": {"wd": (U // 4, U), "wd_b": (U // 4,), "wd2": (3 * N, U // 4), "wd2_b": (3 * N,)},
           }["forward" if cfg.attention_mode == "lsa" else cfg.attention_mode],
    }
    for k, shape in shapes.items():
        require_f32_contiguous(k, w[k], dev, shape)
    seeds = row_seeds(seeds, B, dev)
    mem_mask = mem_mask.to(torch.float32)
    if max_iters <= 0 or B == 0:  # nothing to run
        T = max(max_iters, 0)
        stops = memory.new_empty((B, T * r))
        return (memory.new_empty((B, T * r, NUM_MELS)), stops, memory.new_empty((B, T, T_in)),
                stop_lengths(stops, T, r, cfg.stop_at_any))
    clusters = card_clusters(dev)
    group = launch_group(T_in, dims, clusters, **br)
    rate = float(cfg.dropout_rate)
    back, ahead = lsa_window_bounds(cfg)
    cw = 1.0 if cfg.attention_mode == "forward" or cfg.cumulative_weights else 0.0
    lib = load("tacotron_decode.cu")
    dummy = w["wx_b"].new_zeros(4)  # the pointer of an argument the branch does not read
    rank_plan = k2_plan(1, T_in, dims, clusters, **br)  # the rank slices depend on the widths only
    if r > 1:
        w["wx"] = pack_other_frames(params, rank_plan)
        require_f32_contiguous("wx", w["wx"], dev, (CLUSTER, rank_plan.NX, rank_plan.lkp))
    if cfg.attention_mode == "gmm":
        w["wd"] = pack_rank_slices(params["attention"]["gmm_layer"]["w"], rank_plan)
        require_f32_contiguous("wd", w["wd"], dev, (CLUSTER, 3 * N, rank_plan.lkp))
    loc = cfg.attention_mode in ("forward", "lsa")

    def launch(mem, mask, sd):
        Bg = mem.shape[0]
        plan = k2_plan(Bg, T_in, dims, clusters, **br)
        lib_smem = lib.tacotron_decode_smem_bytes(Bg, T_in, *dims, r, mu, br["mode"], N, clusters)
        lib_scratch = lib.tacotron_decode_scratch_floats(Bg, T_in, *dims, r, mu, br["mode"], N, clusters)
        if (lib_smem, lib_scratch) != (plan.smem_bytes(), plan.scratch_floats()):
            raise RuntimeError(
                f"tacotron_decode: the library's layout ({lib_smem} bytes of shared memory, {lib_scratch} "
                f"exchange floats) differs from k2_plan ({plan.smem_bytes()}, {plan.scratch_floats()})"
            )
        # GMM and Graves read no keys (precompute_keys gives them the memory itself)
        keys = precompute_keys(params["attention"], cfg, mem).contiguous() if loc else dummy
        mem = mem.contiguous()
        mask = mask.contiguous()
        if loc:
            require_f32_contiguous("keys", keys, dev, (Bg, T_in, A))
        require_f32_contiguous("memory", mem, dev, (Bg, T_in, V))
        require_f32_contiguous("mem_mask", mask, dev, (Bg, T_in))
        frames = torch.empty((max_iters, Bg, NUM_MELS * r), dtype=torch.float32, device=dev)
        stops = torch.empty((max_iters, Bg, r), dtype=torch.float32, device=dev)
        aligns = torch.empty((max_iters, Bg, T_in), dtype=torch.float32, device=dev)
        scratch = torch.empty((plan.scratch_floats(),), dtype=torch.float32, device=dev)
        counter = torch.zeros((1,), dtype=torch.int32, device=dev)
        weights = [w.get(k, dummy) for k in WEIGHT_ORDER]
        tensors = [keys, mem, mask, sd, *weights, frames, stops, aligns, scratch]
        ptrs = (ctypes.c_void_p * len(tensors))(*[t.data_ptr() for t in tensors])
        with torch.cuda.device(dev):
            err = lib.tacotron_decode_launch(
                ptrs, ptr(counter), Bg, T_in, *dims, r, mu, br["mode"], N, k2_variant(cfg), int(max_iters), clusters,
                1 if cfg.stop_at_any else r, back, ahead, int(cfg.dwell_limit_first), int(cfg.dwell_limit_rest),
                cw, float(cfg.zoneout_rate), 1.0 - float(cfg.zoneout_rate), 1.0 - rate,
                keep_threshold(rate) if rate > 0.0 else 0xFFFFFFFF, stream_ptr(dev),
            )
        LAUNCHES["tacotron_decode"] += 1
        check_launch(err, "tacotron_decode")
        return frames.transpose(0, 1), stops.transpose(0, 1), aligns.transpose(0, 1)

    frames, stops, aligns = decode_in_groups(launch, memory, mem_mask, seeds, group)
    frames = frames.reshape(B, max_iters * r, NUM_MELS)
    stops = stops.reshape(B, max_iters * r)
    return frames, stops, aligns, stop_lengths(stops, max_iters, r, cfg.stop_at_any)


def prenet_keep_masks(seeds: torch.Tensor, step: int, p1: int, p2: int, rate: float):
    """The prenet keep-masks of one step, [B, p1] and [B, p2], from the
    shared generator (the kernel draws the same bits)."""
    s = seeds.to(torch.int64)[:, None]
    lanes = torch.arange(p1 + p2, device=seeds.device, dtype=torch.int64)[None, :]
    keep = hash_bits(s, 0, step, lanes) < keep_threshold(rate)
    return keep[:, :p1], keep[:, p1:]


def decode_autoregressive_plain(
    params, cfg: TacotronModelConfig, memory, mem_mask, seeds, max_iters: int, prenet_masks=None
):
    """Plain version of the decode kernel (the ``decoder_step`` loop), for
    every attention mode and every r: the last of a step's r frames is fed
    back, and a row is done at the first step whose stop flags are any
    (``cfg.stop_at_any``) or all set.

    ``prenet_masks`` (optional): one boolean keep-mask per prenet layer,
    shaped [T, B, width], replacing the generator's draws (tests inject
    another framework's masks).  Finished rows keep advancing with real
    outputs until every row is done; later steps hold frames 0, stops 1e4
    and aligns 0, as in the kernel."""
    from ..models import attention as ATT
    from ..models import tacotron as T

    check_supported(cfg, "cpu")
    B, T_in, V = memory.shape
    dev = memory.device
    r = cfg.outputs_per_step
    p1, p2 = cfg.prenet_layers
    rate = float(cfg.dropout_rate)
    seeds = row_seeds(seeds, B, dev)
    att = params["attention"]
    keys = ATT.precompute_keys(att, cfg, memory)
    w_comb = b_comb = None
    if "location_conv" in att:  # hoisted out of the loop
        w_comb, b_comb = ATT.combined_location_weights(att)
    frames = memory.new_zeros(max_iters, B, NUM_MELS * r)
    stops = memory.new_full((max_iters, B, r), STOP_FILL)
    aligns = memory.new_zeros(max_iters, B, T_in)
    carry = T.init_decoder_carry(cfg, B, T_in, V, dev)
    prev = memory.new_zeros(B, NUM_MELS)
    finished = torch.zeros(B, dtype=torch.bool, device=dev)
    for t in range(max_iters):
        if bool(finished.all()):
            break
        if rate <= 0.0:
            masks = None
        elif prenet_masks is not None:
            masks = tuple(m[t].to(dev) for m in prenet_masks)
        else:
            masks = prenet_keep_masks(seeds, t, p1, p2, rate)
        frame, stop, align, carry = T.decoder_step(
            params, cfg, prev, carry, keys, memory, mem_mask, masks, w_comb, b_comb
        )
        frames[t], stops[t], aligns[t] = frame, stop, align
        fired = torch.sigmoid(stop) > 0.5
        finished = finished | (fired.any(dim=-1) if cfg.stop_at_any else fired.all(dim=-1))
        prev = frame[:, -NUM_MELS:]
    frames = frames.transpose(0, 1).reshape(B, max_iters * r, NUM_MELS)
    stops = stops.transpose(0, 1).reshape(B, max_iters * r)
    aligns = aligns.transpose(0, 1)
    return frames, stops, aligns, stop_lengths(stops, max_iters, r, cfg.stop_at_any)
