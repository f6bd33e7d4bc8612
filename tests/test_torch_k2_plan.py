"""The grid plan of the decode kernel (K2), on the CPU.

``k2_plan`` mirrors csrc/tacotron_decode.cu ``k2_plan`` and ``k2_layout``
term for term; on the card the wrapper compares it with the library before
every launch.  Here: every gate column, projection column, prenet column,
row and position has exactly one owner, and every weight lies in exactly
one block's slices per cluster; the default widths fit one launch over the
serve envelope (batches up to 16, the longest input a 500-character text
gives), and a shape beyond it raises; a plain-torch emulation of the grid's
split (K-sliced products merged in rank order, the projection and the
prenet redundant in every cluster, per-cluster done flags, a row's
attention over its blocks) equals ``decode_autoregressive_plain``, with
every cluster leaving the step loop at the same step, for the default
branch and for anti-repeat, smoothing, LSA and its window, r = 2-6, GMM and
Graves (the row's argmax merged over its blocks, the other frame columns
from each cluster's share, GMM's and Graves' denses merged in rank order,
Graves' edges per block); the plan's projection outputs and shared memory
for each mode, r and mixture count, GMM's dense on chip or from L2; and the
row-group path equals one plain decode over all rows."""

import dataclasses

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from tacotronv2_wavernn_chinese_tpu_torch import ops as OPS
from tacotronv2_wavernn_chinese_tpu_torch.config import default_config
from tacotronv2_wavernn_chinese_tpu_torch.frontend import default_symbols, get_pyin
from tacotronv2_wavernn_chinese_tpu_torch.ops import tacotron_decoder_kernel as DK
from tacotronv2_wavernn_chinese_tpu_torch.utils.checkpoints import init_tacotron

CFG = default_config().tacotron
DIMS = DK.widths(CFG, 2 * CFG.encoder_lstm_units)  # (256, 256, 256, 512, 128, 31)
C = DK.CLUSTER


def _clusters(n_sm: int) -> int:
    """Stand-in for the card's count: whole clusters of one block per SM."""
    return n_sm // C


@pytest.mark.parametrize("n_sm", [132, 114, 8])
@pytest.mark.parametrize("batch", [1, 4, 5, 16])
def test_every_column_row_and_position_has_one_owner(batch, n_sm):
    P1, P2, U, V, A, taps = DIMS
    t_in = 160
    clusters = _clusters(n_sm)
    group = min(batch, clusters * C)  # the rows of one launch
    plan = DK.k2_plan(group, t_in, DIMS, clusters)
    assert plan.blocks == clusters * C <= n_sm
    # reduction side, in every cluster: K-units, prenet outputs, context and
    # projection inputs, each on one rank
    assert [u for q in range(C) for u in plan.k_unit_range(q)] == list(range(U))
    assert [i for q in range(C) for i in plan.pre1_range(q)] == list(range(P1))
    assert [i for q in range(C) for i in plan.pre2_range(q)] == list(range(P2))
    assert [v for q in range(C) for v in plan.ctx_range(q)] == list(range(V))
    assert sorted(i for q in range(C) for i in plan.proj_inputs(q)) == list(range(U + V))
    # output side: each unit's four gate columns merged by one block of the grid
    owners = [u for c in range(clusters) for q in range(C) for u in plan.out_units(c, q)]
    assert owners == list(range(U))
    assert sorted(g * U + u for u in owners for g in range(4)) == list(range(4 * U))
    # attention: every (row, position) on one block, a row's blocks in one cluster
    seen = {}
    for k in range(plan.blocks):
        b, _ = plan.row(k)
        for t in plan.position_range(k):
            assert (b, t) not in seen
            seen[b, t] = k
    assert sorted(seen) == [(b, t) for b in range(group) for t in range(t_in)]
    for b in range(group):
        assert len({seen[b, t] // C for t in range(t_in)}) == 1


def test_every_weight_is_held_once_per_cluster():
    """The slices of a cluster's eight blocks hold every prenet, wq and
    projection weight once, and the clusters together every l1 and l2
    weight once (each cluster its units' gate rows): after the prologue no
    decoder weight is read from L2."""
    P1, P2, U, V, A, taps = DIMS
    plan = DK.k2_plan(4, 32, DIMS, 15)
    cu = [range(min(c * plan.units_c, U), min((c + 1) * plan.units_c, U)) for c in range(plan.clusters)]
    l1 = sum(4 * len(cu[c]) * (len(plan.pre2_range(q)) + len(plan.ctx_range(q)) + len(plan.k_unit_range(q)))
             for c in range(plan.clusters) for q in range(C))
    l2 = sum(4 * len(cu[c]) * 2 * len(plan.k_unit_range(q)) for c in range(plan.clusters) for q in range(C))
    assert (l1, l2) == (4 * U * (P2 + V + U), 4 * U * 2 * U)
    assert sum(len(plan.k_unit_range(q)) * A for q in range(C)) == U * A
    assert sum(plan.NP * len(plan.proj_inputs(q)) for q in range(C)) == plan.NP * (U + V)
    assert sum(len(plan.pre1_range(q)) * 80 + len(plan.pre2_range(q)) * P1 for q in range(C)) == 80 * P1 + P2 * P1


def test_the_serve_shape_plan():
    """B=4, T_in=32 on the H100's 15 resident clusters: 120 blocks; a row's
    attention on one block of 32 positions; each rank holding 32 K-units,
    18 units' gate rows per cluster, 32 prenet outputs per layer and 64
    context inputs; 183,408 bytes of shared memory a block."""
    plan = DK.k2_plan(4, 32, DIMS, 15)
    assert (plan.blocks, plan.k_units, plan.units_c, plan.units_b) == (120, 32, 18, 3)
    assert (plan.pre1_k, plan.prenet_k, plan.ctx_k) == (32, 32, 64)
    assert (plan.rows_per_cluster, plan.blocks_per_row, plan.positions) == (1, 1, 32)
    assert plan.smem_bytes() == 183_408 and plan.fits()
    assert plan.scratch_floats() == 4 * (8 * 256 + 512)
    # longer inputs spread a row over more blocks, up to the cluster's
    assert [DK.k2_plan(4, t, DIMS, 15).blocks_per_row for t in (33, 64, 65, 256, 2048)] == [2, 2, 4, 8, 8]
    assert DK.k2_plan(16, 2048, DIMS, 15).blocks_per_row == 4


def _worst_case_t_in() -> int:
    """The longest symbol sequence a 500-character request gives (the
    server's cap): 13-digit numbers read with their units, each followed by
    a two-symbol hanzi, padded to a multiple of 16 as the synthesizer does."""
    text = ("9999999999999你" * 40)[:500]
    n = len(default_symbols().encode(get_pyin(text)[0]))
    assert n > 2000
    return n + (-n) % 16


@pytest.mark.parametrize("clusters", [16, 15, 14])
def test_default_widths_fit_over_the_serve_envelope(clusters):
    """One launch takes every serve bucket (B <= 16) at every T_in up to the
    worst 500-character text; a larger batch runs in row groups."""
    t_max = _worst_case_t_in()
    assert t_max <= 2048
    for t_in in (1, 16, 32, 64, 256, 1024, t_max):
        assert DK.rows_per_launch(t_in, DIMS, clusters) >= 16
        for batch in (1, 2, 4, 8, 16):
            plan = DK.k2_plan(batch, t_in, DIMS, clusters)
            assert plan.fits() and plan.smem_bytes() <= DK.SMEM_LIMIT
    assert DK.launch_group(64, DIMS, clusters) == DK.rows_per_launch(64, DIMS, clusters) < clusters * C


@pytest.mark.parametrize("args", [(100_000, 15), (160, 1)])
def test_shapes_beyond_the_envelope_raise(args):
    """Not even one row fits: an input far beyond the text cap, or a card
    whose single cluster cannot hold the weight slices."""
    t_in, clusters = args
    with pytest.raises(NotImplementedError, match="ROADMAP.md, queue item 15"):
        DK.launch_group(t_in, DIMS, clusters)


def test_row_groups_are_equal_and_cover_the_batch():
    assert DK.row_groups(5, 8) == [(0, 5, 5)]
    assert DK.row_groups(30, 21) == [(0, 15, 15), (15, 30, 15)]
    assert DK.row_groups(123, 21) == [(i * 21, min(123, (i + 1) * 21), 21) for i in range(6)]


# ---------------------------------------------------------------------------
# the grid's split, emulated in plain torch
# ---------------------------------------------------------------------------


def _tiny_cfg(dropout: float):
    return dataclasses.replace(
        CFG, embedding_dim=16, enc_conv_channels=16, enc_conv_layers=1, encoder_lstm_units=12,
        attention_dim=8, attention_filters=4, attention_kernel=5, prenet_layers=(20, 12),
        decoder_lstm_units=16, postnet_channels=16, postnet_layers=1, dropout_rate=dropout,
    )


def _inputs(cfg, B, T_in, seed, stop_bias=None):
    params = init_tacotron(seed, cfg)
    g = torch.Generator().manual_seed(seed)
    for k in ("frame_projection", "stop_projection", "dec_lstm1", "dec_lstm2"):  # livelier dynamics
        params[k] = {n: v * 3.0 for n, v in params[k].items()}
    if stop_bias is not None:
        params["stop_projection"] = dict(params["stop_projection"],
                                         b=torch.full_like(params["stop_projection"]["b"], stop_bias))
    V = 2 * cfg.encoder_lstm_units
    lens = np.linspace(T_in, max(1, T_in // 3), B).astype(int)
    mask = torch.as_tensor((np.arange(T_in)[None, :] < lens[:, None]).astype(np.float32))
    memory = (torch.rand(B, T_in, V, generator=g) * 2 - 1) * mask[..., None]
    return params, memory, mask


def _cast(tree, dtype):
    """Every tensor of a tree of dicts, lists and tuples in ``dtype``."""
    if isinstance(tree, dict):
        return {k: _cast(v, dtype) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_cast(v, dtype) for v in tree)
    return tree.to(dtype)


def _row_argmax(x, slices):
    """The row's (max, first index) as the kernel merges it: each block's
    first maximum over its slice, then the blocks in rank order, a later
    block taking over only on a larger value."""
    best_v, best_i = -float("inf"), None
    for r in slices:
        if len(r):
            i = r.start + int(torch.argmax(x[r]))  # torch.argmax: the first maximum
            if float(x[i]) > best_v:
                best_v, best_i = float(x[i]), i
    return best_i


def emulate_decode(plan, params, cfg, memory, mem_mask, seeds, max_iters):
    """K2's split, one cluster at a time within each step: x1/x2 slices of
    each rank against its gate rows, partials added in rank order and merged
    by the cluster that owns the unit; LSTM epilogues, prenet and the
    on-chip projection outputs (last frame, r stops, mu) computed in every
    cluster for all rows (partials over each rank's [out2 | ctx] inputs,
    merged in rank order); the other frame columns, cluster c's share, from
    the per-rank packed weights (``pack_other_frames``); per-cluster done
    flags under the stop policy; a row's attention over its blocks
    (per-slice softmax or sigmoid statistics, normaliser and context
    partials merged in the row's rank order; anti-repeat and the LSA window
    from the row's argmax merged over its blocks, anti-repeat's alignment
    from its support of at most six positions; GMM's dense over each rank's
    [out2 | previous context] slice (``pack_rank_slices``) and Graves'
    layer1 over each rank's out2 K-units merged in rank order, Graves'
    layer2 by output slices, each block's GMM scores with its softmax
    statistics merged over the row, each block's Graves head sums at its
    position edges, differenced).  Returns the kernel's outputs [T, B, ...]
    and each cluster's exit step."""
    from tacotronv2_wavernn_chinese_tpu_torch.models.attention import lsa_window_bounds, precompute_keys

    P1, P2, U, V, A, taps = plan.dims
    B, T_in, _ = memory.shape
    NC, padl, M, r = plan.clusters, (taps - 1) // 2, DK.NUM_MELS, plan.r
    forward, lsa = cfg.attention_mode == "forward", cfg.attention_mode == "lsa"
    gmm, graves = cfg.attention_mode == "gmm", cfg.attention_mode == "graves"
    anti, win, smooth = forward and cfg.anti_repeat, lsa and cfg.synthesis_constraint, cfg.smoothing
    cw = 0.0 if lsa and not cfg.cumulative_weights else 1.0
    back, ahead = lsa_window_bounds(cfg)
    need = 1 if cfg.stop_at_any else r
    w = DK.pack_weights(params, cfg)
    wx = DK.pack_other_frames(params, plan) if r > 1 else None
    N = DK.n_mix(cfg)
    wd = DK.pack_rank_slices(params["attention"]["gmm_layer"]["w"], plan) if gmm else None
    keys = precompute_keys(params["attention"], cfg, memory)
    rate = float(cfg.dropout_rate)
    s64 = DK.row_seeds(seeds, B, "cpu").to(torch.int64)[:, None]
    kr = [plan.k_unit_range(q) for q in range(C)]
    r1 = [plan.pre1_range(q) for q in range(C)]
    r2 = [plan.pre2_range(q) for q in range(C)]
    rv = [plan.ctx_range(q) for q in range(C)]
    cu = [range(min(c * plan.units_c, U), min((c + 1) * plan.units_c, U)) for c in range(NC)]
    gate_rows = [torch.tensor([g * U + j for g in range(4) for j in cu[c]], dtype=torch.long) for c in range(NC)]
    x1_cols = [list(r2[q]) + [P2 + v for v in rv[q]] + [P2 + V + u for u in kr[q]] for q in range(C)]
    x2_cols = [list(kr[q]) + [U + u for u in kr[q]] for q in range(C)]
    rows = {}
    for k in range(plan.blocks):
        b, _ = plan.row(k)
        if b is not None:
            rows.setdefault(b, []).append(plan.position_range(k))
    z = lambda *s: torch.zeros(*s)
    # per-cluster copies of everything a cluster computes for all rows
    st = [[z(B, U) for _ in range(4)] for _ in range(NC)]  # c1, h1, c2, h2
    fr = [z(B, plan.NP) for _ in range(NC)]
    mu = [torch.full((B,), 0.5) for _ in range(NC)]
    done = [torch.zeros(B, dtype=torch.bool) for _ in range(NC)]
    ctx, alpha, cum = z(B, V), z(B, T_in), z(B, T_in)
    if forward:
        alpha[:, 0] = cum[:, 0] = 1.0
    max_att, pos_rec = [0] * B, [0] * B  # held by the row's blocks
    mix = z(B, N)  # GMM kappa, Graves mu: held by the row's blocks
    frames, aligns = z(max_iters, B, M * r), z(max_iters, B, T_in)
    stops = torch.full((max_iters, B, r), DK.STOP_FILL)
    exits = [None] * NC

    def keep(step, lanes):
        return DK.hash_bits(s64, 0, step, torch.as_tensor(lanes, dtype=torch.int64)[None, :]) < DK.keep_threshold(rate)

    for s in range(max_iters):
        g1, g2 = z(B, 4 * U), z(B, 4 * U)
        x1 = []
        for c in range(NC):
            # prenet: each rank's outputs of layer 1, gathered, then its pre2 K-slice
            pre1 = z(B, P1)
            for q in range(C):
                y = torch.relu(fr[c][:, :M] @ w["pre_w1"][r1[q]].t() + w["pre_b1"][r1[q]])
                if rate > 0:
                    y = torch.where(keep(s, list(r1[q])), y / (1.0 - rate), torch.zeros_like(y))
                pre1[:, r1[q]] = y
            pre2 = z(B, P2)
            for q in range(C):
                y = torch.relu(pre1 @ w["pre_w2"][r2[q]].t() + w["pre_b2"][r2[q]])
                if rate > 0:
                    y = torch.where(keep(s, [P1 + i for i in r2[q]]), y / (1.0 - rate), torch.zeros_like(y))
                pre2[:, r2[q]] = y
            x1.append(torch.cat([pre2, ctx, st[c][1]], -1))
            rows_c = gate_rows[c]
            g1[:, rows_c] = sum(x1[c][:, x1_cols[q]] @ w["l1"][rows_c][:, x1_cols[q]].t() for q in range(C))
        g1 = g1 + w["l1_b"]
        for c in range(NC):
            c1, h1, c2, h2 = st[c]
            si, tj = torch.sigmoid(g1[:, :U]), torch.tanh(g1[:, U:2 * U])
            sf, so = torch.sigmoid(g1[:, 2 * U:3 * U] + 1.0), torch.sigmoid(g1[:, 3 * U:])
            nc = sf * c1 + si * tj
            out1 = so * torch.tanh(nc)
            st[c][0], st[c][1] = (1 - cfg.zoneout_rate) * nc + cfg.zoneout_rate * c1, \
                (1 - cfg.zoneout_rate) * out1 + cfg.zoneout_rate * h1
            x2 = torch.cat([out1, h2], -1)
            rows_c = gate_rows[c]
            g2[:, rows_c] = sum(x2[:, x2_cols[q]] @ w["l2"][rows_c][:, x2_cols[q]].t() for q in range(C))
        g2 = g2 + w["l2_b"]
        out2 = []
        for c in range(NC):
            _, _, c2, h2 = st[c]
            si, tj = torch.sigmoid(g2[:, :U]), torch.tanh(g2[:, U:2 * U])
            sf, so = torch.sigmoid(g2[:, 2 * U:3 * U] + 1.0), torch.sigmoid(g2[:, 3 * U:])
            nc = sf * c2 + si * tj
            o2 = so * torch.tanh(nc)
            st[c][2], st[c][3] = (1 - cfg.zoneout_rate) * nc + cfg.zoneout_rate * c2, \
                (1 - cfg.zoneout_rate) * o2 + cfg.zoneout_rate * h2
            out2.append(o2)
        # attention of each row on its cluster's blocks
        new_ctx, new_alpha, a_sm_all = z(B, V), z(B, T_in), z(B, T_in)
        for b, slices in rows.items():
            c = b // plan.rows_per_cluster
            if gmm or graves:
                a_sm = _mixture_alignment(plan, w, wd, out2[c][b], ctx[b], mix, b, slices, mem_mask[b], kr, rv)
                new_alpha[b] = a_sm
                new_ctx[b] = sum(a_sm[r] @ memory[b, r] for r in slices)
                continue
            pq = sum(out2[c][b, kr[q]] @ w["wq"][:, kr[q]].t() for q in range(C))
            win_in = F.pad(cum[b], (padl, taps - 1 - padl)).unfold(0, taps, 1)  # [T_in, taps]
            en = torch.tanh(keys[b] + (pq + w["b_comb"] + w["att_b"]) + win_in @ w["w_comb"]) @ w["att_v"]
            pos = torch.arange(T_in)
            valid = (pos >= max_att[b] - back) & (pos < max_att[b] + ahead) if win else torch.ones(T_in, dtype=torch.bool)
            if smooth:
                en = torch.where(valid, torch.sigmoid(en) * mem_mask[b], torch.zeros_like(en))
                a_sm = en / sum(en[r].sum() for r in slices)
            else:
                en = torch.where(valid & (mem_mask[b] > 0), en, torch.full_like(en, -1e9))
                stats = [(en[r].max(), torch.exp(en[r] - en[r].max()).sum()) for r in slices if len(r)]
                Mx = max(m for m, _ in stats)
                a_sm = torch.exp(en - Mx) / sum(zz * torch.exp(m - Mx) for m, zz in stats)
            a_sm_all[b] = a_sm
            if lsa:
                new_alpha[b] = a_sm
                new_ctx[b] = sum(a_sm[r] @ memory[b, r] for r in slices)
                if win:
                    max_att[b] = _row_argmax(a_sm, slices)
                continue
            shift = F.pad(alpha[b], (1, 0))[:-1]
            pre = ((1 - mu[c][b]) * alpha[b] + mu[c][b] * shift + 1e-10) * a_sm
            if not anti:
                S2 = sum(pre[r].sum() for r in slices)
                new_alpha[b] = pre / S2
                new_ctx[b] = sum(new_alpha[b, r] @ memory[b, r] for r in slices)
                continue
            arg, pm, pp = _row_argmax(pre, slices), max_att[b], pos_rec[b]
            m = pm if arg <= pm else pm + 1
            if pp < cfg.dwell_limit_first and m > 2:
                m = pm
            p = pp + 1 if m == pm else 1
            if p >= cfg.dwell_limit_rest:
                m, p = m + 1, 1
            max_att[b], pos_rec[b] = m, p
            lo, hi, cm = max(m - 2, 0), min(m + 3, T_in), min(max(m, 0), T_in - 1)
            s_win = sum(float(pre[t]) for t in range(lo, hi))
            boost = 2.0 * (1.0 if s_win < 1e-10 else s_win)
            support = {t: (boost if t == cm else float(pre[t])) for t in range(lo, hi)}
            support.setdefault(cm, boost)
            total = sum(support.values())
            for t, v in support.items():
                new_alpha[b, t] = v / total
            new_ctx[b] = sum(new_alpha[b, t] * memory[b, t] for t in support)
        ctx, alpha, cum = new_ctx, new_alpha, cw * cum + a_sm_all
        aligns[s] = alpha
        # projections, mu and the done flags: every cluster for all rows
        pin_cols = [plan.proj_inputs(q) for q in range(C)]
        for c in range(NC):
            pin = torch.cat([out2[c], ctx], -1)
            fr[c] = sum(pin[:, pin_cols[q]] @ w["proj"][:, pin_cols[q]].t() for q in range(C)) + w["proj_b"]
            if forward:
                mu[c] = torch.sigmoid(fr[c][:, M + r])
            fired = (torch.sigmoid(fr[c][:, M:M + r]) > 0.5).sum(-1)
            done[c] = done[c] | (fired >= need)
            cols = plan.other_frames(c)  # this cluster's other frame columns, from each rank's packed slice
            for q in range(C):
                slots = torch.zeros(B, plan.lkp)
                slots[:, : len(kr[q])] = out2[c][:, list(kr[q])]
                slots[:, plan.k_units: plan.k_units + len(rv[q])] = ctx[:, list(rv[q])]
                if len(cols):
                    frames[s][:, cols.start:cols.stop] += slots @ wx[q, cols.start:cols.stop].t()
            if len(cols):
                frames[s][:, cols.start:cols.stop] += w["wx_b"][cols.start:cols.stop]
        frames[s][:, M * (r - 1):], stops[s] = fr[0][:, :M], fr[0][:, M:M + r]
        for c in range(NC):
            if exits[c] is None and bool(done[c].all()):
                exits[c] = s + 1
        if all(e is not None for e in exits):
            break
    return frames, stops, aligns, exits


def _mixture_alignment(plan, w, wd, out2, ctx_prev, mix, b, slices, mask, kr, rv):
    """Row b's GMM or Graves alignment as the row's blocks form it (``mix``
    [B, N] advanced in place): GMM's dense partials over each rank's
    [out2 | previous context] slots merged in rank order, scores per block
    with (max, sum) statistics merged over the row; Graves' layer1 partials
    over each rank's out2 K-units merged in rank order, relu, layer2 by each
    rank's output slice, the head sums at each block's nT + 1 edges."""
    N, Ku = plan.n_mix, plan.k_units
    if plan.mode == DK.MODE_IDS["gmm"]:
        p = 0.0
        for q in range(C):
            slots = torch.zeros(plan.lkp)
            slots[: len(kr[q])] = out2[list(kr[q])]
            slots[Ku: Ku + len(rv[q])] = ctx_prev[list(rv[q])]
            p = p + wd[q] @ slots
        p = torch.exp(p + w["wd_b"])
        a, beta = p[:N] / p[N:2 * N], p[N:2 * N]
        mix[b] = mix[b] + p[2 * N:]
        stats, sc = [], torch.zeros(len(mask))
        for r in slices:
            if not len(r):
                continue
            t = torch.arange(r.start, r.stop, dtype=torch.float32)
            s = torch.sum(a[:, None] * torch.exp(-((mix[b][:, None] - t) ** 2) / beta[:, None]), dim=0)
            sc[r] = torch.where(mask[r] > 0, s, torch.full_like(s, -1e9))
            stats.append((sc[r].max(), torch.exp(sc[r] - sc[r].max()).sum()))
        Mx = max(m for m, _ in stats)
        return torch.exp(sc - Mx) / sum(zz * torch.exp(m - Mx) for m, zz in stats)
    hid = torch.relu(sum(out2[list(kr[q])] @ w["wd"][:, list(kr[q])].t() for q in range(C)) + w["wd_b"])
    gbk = torch.zeros(3 * N)
    for q in range(C):
        o3 = list(plan.layer2_range(q))
        gbk[o3] = w["wd2"][o3] @ hid + w["wd2_b"][o3]
    g = torch.softmax(gbk[:N], 0) + 1e-5
    sig = F.softplus(gbk[N:2 * N]) + 1e-5
    mix[b] = mix[b] + F.softplus(gbk[2 * N:])
    align = torch.zeros(len(mask))
    for r in slices:
        if not len(r):
            continue
        edges = torch.arange(r.start, r.stop + 1, dtype=torch.float32) + 0.5
        head = torch.sum(g[:, None] * (1.0 / (1.0 + torch.sigmoid((mix[b][:, None] - edges) / sig[:, None]))), dim=0)
        align[r] = torch.where(mask[r] > 0, head[1:] - head[:-1], torch.full((len(r),), 1e-20))
    return align


@pytest.mark.parametrize("stop_bias", [None, -30.0], ids=["rows_stop", "runs_to_max_iters"])
@pytest.mark.parametrize("t_in", [20, 70], ids=["one_block_per_row", "four_blocks_per_row"])
@pytest.mark.parametrize("clusters", [2, 3], ids=["2_clusters", "3_clusters_ragged"])
def test_grid_split_equals_the_plain_decode(clusters, t_in, stop_bias):
    """B=3, U=16, P=(20, 12), V=24, A=8, 5 taps, dropout 0.5: with 2
    clusters rows pair up in a cluster, with 3 each cluster has one row and
    the units split 6/6/4; at T_in=70 a row's attention spans four blocks
    of 18 positions (the conv's halo crossing slices).  With the weights of
    seed 4 the rows stop at different steps before max_iters; with the stop
    bias at -30 none stops.  The emulation equals the plain decode within
    1e-5, and every cluster leaves the loop at the step the plain decode
    stops (or none does)."""
    cfg = _tiny_cfg(0.5)
    B, max_iters = 3, 40
    params, memory, mask = _inputs(cfg, B, t_in, seed=4, stop_bias=stop_bias)
    seeds = [5, 6, 7]
    dims = DK.widths(cfg, memory.shape[2])
    plan = DK.k2_plan(B, t_in, dims, clusters)
    assert plan.blocks_per_row == (1 if t_in == 20 else 4)
    want = DK.decode_autoregressive_plain(params, cfg, memory, mask, seeds, max_iters)
    frames, stops, aligns, exits = emulate_decode(plan, params, cfg, memory, mask, seeds, max_iters)
    if stop_bias is None:
        n_run = int(want[3].max()) + 1
        assert n_run < max_iters and len(set(want[3].tolist())) == B  # rows stop at different steps
        assert exits == [n_run] * clusters
    else:
        assert exits == [None] * clusters and int(want[3].min()) == max_iters
    _assert_equals_plain(frames, stops, aligns, want, max_iters, cfg)


# name: (config overrides, stop bias, seed of the weights and inputs): the
# branches K2 takes beyond the default.  With the stop bias at -30 no row
# stops in 40 steps, and short dwell limits make anti-repeat walk across
# the row's blocks; the other seeds (and GMM's stop bias of -2) stop the
# rows at different steps.
BRANCHES = {
    "anti_repeat": (dict(anti_repeat=True, dwell_limit_first=1, dwell_limit_rest=2), -30.0, 4),
    "anti_repeat_smoothing": (dict(anti_repeat=True, smoothing=True, dwell_limit_first=2, dwell_limit_rest=3),
                              -30.0, 4),
    "lsa_window_monotonic": (dict(attention_mode="lsa", synthesis_constraint=True, anti_repeat=True), -30.0, 4),
    "lsa_window_symmetric_smoothing": (dict(attention_mode="lsa", synthesis_constraint=True, synthesis_window=4,
                                            smoothing=True, cumulative_weights=False), -30.0, 4),
    "lsa": (dict(attention_mode="lsa"), None, 10),
    "r3_stop_all": (dict(outputs_per_step=3, stop_at_any=False), None, 11),
    "r6": (dict(outputs_per_step=6), None, 15),
    "r2_anti_repeat": (dict(outputs_per_step=2, anti_repeat=True, dwell_limit_first=1, dwell_limit_rest=2),
                       -30.0, 4),
    "gmm": (dict(attention_mode="gmm"), -2.0, 7),
    "graves": (dict(attention_mode="graves"), -30.0, 4),
    "graves_r3_stop_all": (dict(attention_mode="graves", outputs_per_step=3, stop_at_any=False), None, 19),
}


@pytest.mark.parametrize("branch", list(BRANCHES))
def test_branch_grid_split_equals_the_plain_decode(branch):
    """The grid's split for each branch on 3 clusters at T_in=70 (a row's
    attention over four blocks of 18 positions, so the argmax, the
    anti-repeat support, the window, GMM's softmax statistics and Graves'
    edges cross blocks), B=3, dropout 0.5, 40 steps: equal to the plain
    decode within 1e-5, with every cluster leaving the loop at the step the
    plain decode's last row stops (or none when the stop bias is -30); at
    r > 1 the other frame columns come from each cluster's share of the
    per-rank packed weights.  GMM and Graves run in float64: Graves'
    alignment is a difference of O(1) head sums, whose f32 cancellation
    leaves ~2e-7 a position and ~3e-6 in the first frame of seed 4, and
    GMM's exp of its dense amplifies the rounding of the rank-ordered merge
    to ~3e-5 by step 20 of seed 7 in f32; in float64 both agree with the
    plain decode to ~1e-13, so the check holds the split's arithmetic, not
    its rounding."""
    over, stop_bias, seed = BRANCHES[branch]
    cfg = dataclasses.replace(_tiny_cfg(0.5), **over)
    B, T_in, max_iters, clusters, r = 3, 70, 40, 3, cfg.outputs_per_step
    params, memory, mask = _inputs(cfg, B, T_in, seed=seed, stop_bias=stop_bias)
    dims = DK.widths(cfg, memory.shape[2])
    plan = DK.k2_plan(B, T_in, dims, clusters, **DK.branch(cfg))
    assert plan.blocks_per_row == 4
    seeds = [5, 6, 7]
    dtype = torch.float64 if cfg.attention_mode in ("gmm", "graves") else torch.float32
    params, memory, mask = _cast((params, memory, mask), dtype)
    default = torch.get_default_dtype()
    torch.set_default_dtype(dtype)
    try:
        want = DK.decode_autoregressive_plain(params, cfg, memory, mask, seeds, max_iters)
        frames, stops, aligns, exits = emulate_decode(plan, params, cfg, memory, mask, seeds, max_iters)
    finally:
        torch.set_default_dtype(default)
    if stop_bias != -30.0:
        n_run = int(want[3].max()) // r + 1
        assert n_run < max_iters and exits == [n_run] * clusters
        assert len(set((want[3] // r).tolist())) > 1  # rows stop at different steps
    else:
        assert exits == [None] * clusters and int(want[3].min()) == max_iters * r
    _assert_equals_plain(frames, stops, aligns, want, max_iters, cfg)
    if cfg.anti_repeat and cfg.attention_mode == "forward":
        assert (want[2] > 0).sum(-1).max() <= 6  # the support: [m-2, m+3) and the clipped bin
        assert int(torch.argmax(want[2][:, -1], -1).min()) > 18  # the rows walked past the first block


@pytest.mark.parametrize("mode", ["forward", "lsa"])
@pytest.mark.parametrize("r", [1, 2, 3, 4, 5, 6])
def test_plan_for_each_mode_and_r(r, mode):
    """The projection outputs kept on chip (the last frame, r stops, mu for
    forward attention) and the other frame columns split over the clusters;
    every r up to 6 fits one launch over the serve envelope on the card's
    15 clusters, and the shared memory at B=4, T_in=32 is the library's
    (csrc/tacotron_decode.cu tacotron_decode_smem_bytes, read on the H100
    for these configurations)."""
    mu = int(mode == "forward")
    plan = DK.k2_plan(4, 32, DIMS, 15, r, mu)
    assert (plan.NP, plan.NX) == (80 + r + mu, 80 * (r - 1))
    cols = [list(plan.other_frames(c)) for c in range(15)]
    assert [j for c in cols for j in c] == list(range(plan.NX))
    assert plan.ldx >= plan.ldp + plan.ec and plan.lkp == 100
    library = {("lsa", 1): 183_008, ("forward", 1): 183_408, ("forward", 2): 184_080, ("forward", 3): 184_544,
               ("forward", 6): 186_144}
    if (mode, r) in library:
        assert plan.smem_bytes() == library[mode, r]
    t_max = _worst_case_t_in()
    for t_in in (1, 32, 256, t_max):
        assert DK.rows_per_launch(t_in, DIMS, 15, r, mu) >= 16
        assert DK.k2_plan(16, t_in, DIMS, 15, r, mu).smem_bytes() <= DK.SMEM_LIMIT


@pytest.mark.parametrize("mode", ["gmm", "graves"])
@pytest.mark.parametrize("n", [5, 10, 128])
def test_plan_for_each_mixture_mode(mode, n):
    """GMM with n mixtures and Graves with n heads: no wq, location filter,
    v, energy bias or conv halo; GMM's dense slice of 3n outputs over each
    rank's [out2 | ctx] inputs on chip where it fits, Graves' layer1 slice
    over each rank's out2 K-units and 3n/8 layer2 outputs a rank; every
    serve bucket fits one launch up to the worst 500-character text on 15
    clusters; the shared memory at B=4, T_in=32 is the .cu file's
    (k2_layout compiled for the host with the CUDA declarations stubbed,
    equal to this plan in 17,010 configurations; GMM 5 and 128 and Graves
    10 and 128 read from the library on the H100)."""
    cfg = dataclasses.replace(CFG, attention_mode=mode, num_attn_mixtures=n, graves_heads=n)
    br = DK.branch(cfg)
    assert br == {"r": 1, "mu": 0, "mode": DK.MODE_IDS[mode], "n_mix": n}
    plan = DK.k2_plan(4, 32, DIMS, 15, **br)
    library = {("gmm", 5): 154_480, ("gmm", 10): 160_624, ("gmm", 128): 151_904, ("graves", 5): 158_800,
               ("graves", 10): 159_488, ("graves", 128): 174_736}
    assert plan.smem_bytes() == library[mode, n] and plan.NP == 81
    if mode == "graves":
        assert (plan.h1, plan.c3, plan.res) == (64, _cdiv(3 * n, C), 0)
        assert [j for q in range(C) for j in plan.layer2_range(q)] == list(range(3 * n))
    else:
        assert (plan.h1, plan.c3, plan.res) == (0, 0, int(n < 128))
    t_max = _worst_case_t_in()
    for t_in in (1, 32, 256, t_max):
        assert DK.rows_per_launch(t_in, DIMS, 15, **br) >= 16
        for batch in (1, 4, 16):
            assert DK.k2_plan(batch, t_in, DIMS, 15, **br).fits()


def _cdiv(a, b):
    return -(-a // b)


@pytest.mark.parametrize("shape", [(1, 32, 75), (4, 32, 68), (16, 32, 41), (16, 2048, 37)])
def test_gmm_dense_on_chip_where_it_fits(shape):
    """GMM's 3K x LKP slice stays in shared memory up to the largest K whose
    plan fits a block (75 mixtures at B=1, 68 at the serve shape B=4,
    T_in=32, 41 at B=16), and comes from L2 beyond, where the plan is
    smaller; both launch."""
    B, t_in, k_max = shape
    on = DK.k2_plan(B, t_in, DIMS, 15, 1, 0, DK.MODE_IDS["gmm"], k_max)
    off = DK.k2_plan(B, t_in, DIMS, 15, 1, 0, DK.MODE_IDS["gmm"], k_max + 1)
    assert (on.res, off.res) == (1, 0) and on.fits() and off.fits()
    held = dataclasses.replace(off, res=1)
    assert on.smem_bytes() <= DK.SMEM_LIMIT < held.smem_bytes()
    assert held.smem_bytes() - off.smem_bytes() == 4 * 3 * (k_max + 1) * off.lkp  # the slice, and nothing else


def test_variants_name_the_kernel_instantiations():
    """k2_variant: bit 0 LSA, bit 1 anti-repeat (forward only; under LSA the
    flag picks the window type, which reaches the kernel as its bounds),
    bit 2 smoothing, bit 3 the LSA window; the eight combinations the kernel
    instantiates, and no other; GMM 16 and Graves 32, whatever anti-repeat,
    smoothing and the window say (neither reads them, as in the TPU
    kernel)."""
    cases = {
        (): 0, (("anti_repeat", True),): 2, (("smoothing", True),): 4,
        (("anti_repeat", True), ("smoothing", True)): 6, (("attention_mode", "lsa"),): 1,
        (("attention_mode", "lsa"), ("smoothing", True)): 5,
        (("attention_mode", "lsa"), ("synthesis_constraint", True)): 9,
        (("attention_mode", "lsa"), ("synthesis_constraint", True), ("anti_repeat", True)): 9,
        (("attention_mode", "lsa"), ("synthesis_constraint", True), ("smoothing", True)): 13,
        (("synthesis_constraint", True),): 0,
    }
    for mode, want in (("gmm", 16), ("graves", 32)):
        for flags in ((), ("anti_repeat",), ("smoothing",), ("synthesis_constraint",),
                      ("anti_repeat", "smoothing", "synthesis_constraint")):
            cases[(("attention_mode", mode),) + tuple((f, True) for f in flags)] = want
    for over, want in cases.items():
        assert DK.k2_variant(dataclasses.replace(CFG, **dict(over))) == want


def _assert_equals_plain(frames, stops, aligns, want, max_iters, cfg):
    B, r = frames.shape[1], cfg.outputs_per_step
    got = (frames.transpose(0, 1).reshape(B, -1, DK.NUM_MELS), stops.transpose(0, 1).reshape(B, -1),
           aligns.transpose(0, 1))
    for name, a, b in zip(("frames", "stops", "aligns"), got, want):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5, msg=name)
    assert torch.equal(DK.stop_lengths(got[1], max_iters, r, cfg.stop_at_any), want[3])


def test_row_groups_equal_one_plain_decode():
    """B = 8 x 2 clusters + 3 = 19 rows in groups of 7 (each group padded by
    repeating its last row): stop lengths equal one plain decode over all
    rows, and so do frames and alignments up to each row's stop."""
    cfg = _tiny_cfg(0.5)
    B, T_in, max_iters = 19, 12, 30
    params, memory, mask = _inputs(cfg, B, T_in, seed=9)
    seeds = DK.row_seeds(list(range(100, 100 + B)), B, "cpu")
    OPS.reset_launch_counts()
    one = DK.decode_autoregressive_plain(params, cfg, memory, mask, seeds, max_iters)
    calls = []

    def group(mem, msk, sd):
        calls.append(mem.shape[0])
        return DK.decode_autoregressive_plain(params, cfg, mem, msk, sd, max_iters)[:3]

    frames, stops, aligns = DK.decode_in_groups(group, memory, mask, seeds, 7)
    assert calls == [7, 7, 7] and frames.shape == one[0].shape
    stop_len = DK.stop_lengths(stops, max_iters)
    assert torch.equal(stop_len, one[3])
    assert int(one[3].min()) < max_iters  # some rows stop
    for b in range(B):
        n = int(stop_len[b])
        torch.testing.assert_close(frames[b, :n], one[0][b, :n], rtol=0, atol=1e-6)
        torch.testing.assert_close(aligns[b, :n], one[2][b, :n], rtol=0, atol=1e-6)
    assert OPS.LAUNCHES["tacotron_decode"] == 0
