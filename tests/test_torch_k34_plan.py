"""The grid plan of the trainer kernels (K3 forward, K4 backward), on the CPU.

``k34_plan`` mirrors csrc/tacotron_train_common.cuh ``tr_plan`` and the two
``.cu`` layout functions term for term; on the card the wrappers compare it
with the library before every launch.  Here: every hidden unit, gate column,
context row and encoder position has exactly one owner; the default widths
fit one block's shared memory over the envelope, and shapes beyond it
raise; and a plain-torch emulation of the grid's split (per-rank partial
products merged in rank order, per-slice position sums merged across a
row's blocks, the softmax merged from per-slice maxima and sums, the conv
transpose through per-position terms) equals the kernels' plain versions."""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from tacotronv2_wavernn_chinese_tpu_torch.config import default_config
from tacotronv2_wavernn_chinese_tpu_torch.ops import tacotron_trainer_kernel as TK

DIMS = TK.widths(default_config().tacotron)  # (256, 256, 512, 128, 32, 31)
C = TK.CLUSTER


def _clusters(n_sm: int) -> int:
    """Stand-in for the card's count: whole clusters of one block per SM."""
    return n_sm // C


@pytest.mark.parametrize("n_sm", [132, 114, 8])
@pytest.mark.parametrize("batch", [1, 10, 32, 64])
def test_every_unit_column_row_and_position_has_one_owner(batch, n_sm):
    P, U, V, A, Fw, taps = DIMS
    t_in = 160
    plan = TK.k34_plan(batch, t_in, DIMS, _clusters(n_sm))
    assert plan.blocks == plan.clusters * C <= n_sm
    # reduction side: the ranks' K-units cover the units once, in every cluster
    assert [u for q in range(C) for u in plan.k_unit_range(q)] == list(range(U))
    # output side: each unit's outputs (its four gate columns in K3, its
    # [d_out1 | d_h2] and d_h1 rows in K4) and each context row, one block
    owners = [u for c in range(plan.clusters) for q in range(C) for u in plan.out_units(c, q)]
    assert owners == list(range(U))
    gate_cols = sorted(g * U + u for u in owners for g in range(4))
    assert gate_cols == list(range(4 * U))
    assert [v for c in range(plan.clusters) for q in range(C) for v in plan.ctx_rows(c, q)] == list(range(V))
    # attention: every (row, position) on one block, a row's blocks in one cluster
    seen = {}
    if plan.blocks_per_row == 0:
        assert batch > plan.clusters * C and not plan.fits()
        return
    for k in range(plan.blocks):
        b, sl = plan.row(k)
        for t in plan.position_range(k):
            assert (b, t) not in seen
            seen[b, t] = k
    assert sorted(seen) == [(b, t) for b in range(batch) for t in range(t_in)]
    for b in range(batch):
        assert len({seen[b, t] // C for t in range(t_in)}) == 1


@pytest.mark.parametrize("clusters", [16, 15, 14])
@pytest.mark.parametrize("batch", [1, 10, 32, 64])
def test_default_widths_fit_over_the_envelope(batch, clusters):
    for t_in in (1, 160, 1024):
        plan = TK.launch_plan(batch, t_in, DIMS, clusters)
        assert plan.fits()
        assert max(plan.smem_bytes("fwd"), plan.smem_bytes("bwd")) <= TK.SMEM_LIMIT
    n = TK.max_t_in(batch, DIMS, clusters)
    assert n >= 1024 and not TK.k34_plan(batch, n + 1, DIMS, clusters).fits()


@pytest.mark.parametrize("args", [(64, 4096, 15), (121, 160, 15), (32, 160, 1), (1, 100_000, 15)])
def test_shapes_beyond_the_envelope_raise(args):
    batch, t_in, clusters = args
    with pytest.raises(NotImplementedError, match="ROADMAP.md, queue item 5"):
        TK.launch_plan(batch, t_in, DIMS, clusters)


@pytest.mark.parametrize("dims", [(256, 256, 512, 160, 32, 31), (256, 256, 512, 128, 40, 31),
                                  (256, 256, 512, 128, 32, 35)], ids=["A160", "F40", "taps35"])
def test_widths_beyond_a_warp_per_position_raise(dims):
    """K4 runs a position's attention columns, filters and taps on the
    lanes of one warp: A <= 128, F <= 32 and taps <= 32."""
    assert not TK.k34_plan(32, 160, dims, 15).fits()
    with pytest.raises(NotImplementedError, match="queue item 5"):
        TK.launch_plan(32, 160, dims, 15)


def test_the_train_shape_plan():
    """B=32, T_in=160 on the H100's 15 resident clusters: 120 blocks, two
    blocks of 80 positions per row, each rank holding 32 K-units; the gate
    weights of one block are 57.6 KB of l1/l2 in K3 and 47.0 KB in K4, plus
    the 16 KB of wq rows in both."""
    plan = TK.k34_plan(32, 160, DIMS, 15)
    assert (plan.blocks, plan.k_units, plan.units_c, plan.units_b) == (120, 32, 18, 3)
    assert (plan.rows_per_cluster, plan.blocks_per_row, plan.positions) == (4, 2, 80)
    L4, ng = 4 * plan.k_units + 4, 4 * plan.units_c
    assert 4 * ng * (L4 + 2 * plan.k_units + 4) == 57_600  # K3: l1 and l2 slices
    assert 4 * (2 * plan.units_c + plan.ctx_c + plan.units_c) * L4 == 46_992  # K4: l2 and l1 [ctx | h]
    assert plan.scratch_floats() == 32 * (512 + 5 * 256 + 160 * 31)


# ---------------------------------------------------------------------------
# the grid's split, emulated in plain torch
# ---------------------------------------------------------------------------

SMALL = (12, 16, 24, 8, 4, 5)  # P, U, V, A, F, taps: ragged slices on eight ranks


def _weights(seed: int):
    P, U, V, A, Fw, taps = SMALL
    g = torch.Generator().manual_seed(seed)
    r = lambda *s: torch.randn(*s, generator=g) * 0.4
    return (r(P, 4 * U), r(V, 4 * U), r(U, 4 * U), r(1, 4 * U), r(U, 4 * U), r(U, 4 * U), r(1, 4 * U),
            r(U, A), r(taps, Fw), r(Fw, A), r(1, A), r(1, A), r(V, 1), r(U, 1), r(1, 1))


def _inputs(B, T, T_in, seed):
    P, U, V, A, Fw, taps = SMALL
    rng = np.random.default_rng(seed)
    t = lambda a: torch.as_tensor(np.asarray(a, np.float32))
    lens = np.linspace(T_in, max(1, T_in // 3), B).astype(int)
    mask = (np.arange(T_in)[None, :] < lens[:, None]).astype(np.float32)
    values = rng.uniform(-1, 1, (B, T_in, V)) * mask[..., None]
    masks = tuple(t(rng.uniform(size=(T, B, U)) < 0.9) for _ in range(4))
    cots = (t(rng.normal(size=(T, B, U))), t(rng.normal(size=(T, B, V))), t(rng.normal(size=(T, B, T_in))))
    return (t(rng.uniform(0, 2, (T, B, P))), masks, t(rng.normal(0, 0.5, (B, T_in, A))), t(values), t(mask),
            cots)


def _row_slices(plan):
    """Row b -> its blocks' position ranges, in rank order."""
    rows = {}
    for k in range(plan.blocks):
        b, _ = plan.row(k)
        if b is not None:
            rows.setdefault(b, []).append((k, plan.position_range(k)))
    return rows


def _gates(g, c_prev):
    u = c_prev.shape[-1]
    si, tj = torch.sigmoid(g[:, :u]), torch.tanh(g[:, u:2 * u])
    sf, so = torch.sigmoid(g[:, 2 * u:3 * u] + 1.0), torch.sigmoid(g[:, 3 * u:])
    return si, tj, sf, so


def _ranked(plan, n: int, per: int):
    return [TK._cut(q, per, n) for q in range(C)]


def emulate_fwd(plan, w, pre, masks, keys, values, mem_mask, zoneout):
    """K3's split: x1/x2/out2 slices of each rank against its weight rows,
    partial products added in rank order; per row, per-slice softmax
    statistics (max, sum), normaliser and context partials merged in the
    row's rank order."""
    (l1_pre, l1_ctx, l1_h, l1_b, l2_x, l2_h, l2_b, wq, w_conv, w_loc, ball, v, mu_c, mu_q, mu_b) = w
    P, U, V, A, Fw, taps = plan.dims
    T, B = pre.shape[:2]
    T_in = values.shape[1]
    kr = [plan.k_unit_range(q) for q in range(C)]
    pr, cr = _ranked(plan, P, plan.prenet_k), _ranked(plan, V, plan.ctx_k)
    rows = _row_slices(plan)
    z = lambda n: torch.zeros(B, n)
    c1, h1, c2, h2, ctx, out2 = z(U), z(U), z(U), z(U), z(V), z(U)
    alpha = z(T_in)
    alpha[:, 0] = 1.0
    cum = alpha.clone()
    out = {k: [] for k in TK.FWD_OUTS}
    for s in range(T):
        mu = torch.full((B, 1), 0.5) if s == 0 else torch.sigmoid(ctx @ mu_c + out2 @ mu_q + mu_b)
        for k, val in (("c1p", c1), ("h1p", h1), ("c2p", c2), ("h2p", h2), ("ctxp", ctx), ("alphap", alpha),
                       ("mup", mu[:, 0])):
            out[k].append(val)
        g1 = sum(pre[s][:, pr[q]] @ l1_pre[pr[q]] + ctx[:, cr[q]] @ l1_ctx[cr[q]] + h1[:, kr[q]] @ l1_h[kr[q]]
                 for q in range(C)) + l1_b
        si, tj, sf, so = _gates(g1, c1)
        nc = sf * c1 + si * tj
        out1 = so * torch.tanh(nc)
        c1 = masks[0][s] * nc + (1 - masks[0][s]) * c1
        h1 = masks[1][s] * out1 + (1 - masks[1][s]) * h1
        g2 = sum(out1[:, kr[q]] @ l2_x[kr[q]] + h2[:, kr[q]] @ l2_h[kr[q]] for q in range(C)) + l2_b
        si, tj, sf, so = _gates(g2, c2)
        nc = sf * c2 + si * tj
        out2 = so * torch.tanh(nc)
        c2 = masks[2][s] * nc + (1 - masks[2][s]) * c2
        h2 = masks[3][s] * out2 + (1 - masks[3][s]) * h2
        pq = sum(out2[:, kr[q]] @ wq[kr[q]] for q in range(C))
        feats = TK._im2col(cum, taps) @ w_conv
        en = torch.sum(torch.tanh(keys + pq[:, None] + feats @ w_loc + ball) * v, -1)
        en = torch.where(mem_mask > 0, en, torch.full_like(en, TK.NEG_INF))
        a_sm, align, new_ctx = z(T_in), z(T_in), z(V)
        for b, slices in rows.items():
            stats = [(en[b, r].max(), torch.exp(en[b, r] - en[b, r].max()).sum()) for _, r in slices if len(r)]
            M = max(m for m, _ in stats)
            Z = sum(zz * torch.exp(m - M) for m, zz in stats)
            a_sm[b] = torch.exp(en[b] - M) / Z
            shift = F.pad(alpha[b], (1, 0))[:-1]
            pre_al = ((1 - mu[b]) * alpha[b] + mu[b] * shift + 1e-10) * a_sm[b]
            S2 = sum(pre_al[r].sum() for _, r in slices)
            align[b] = pre_al / S2
            new_ctx[b] = sum(align[b, r] @ values[b, r] for _, r in slices)
        cum, alpha, ctx = cum + a_sm, align, new_ctx
        for k, val in (("out2", out2), ("ctx", ctx), ("align", align), ("align_sm", a_sm), ("out1", out1),
                       ("g1", g1), ("g2", g2), ("pq", pq)):
            out[k].append(val)
    return {k: torch.stack(vals) for k, vals in out.items()}


def emulate_bwd(plan, w, masks, keys, values, zoneout, S, cots):
    """K4's split: y3 by each rank's K-units; [d_out1 | d_h2] and
    [a_ctx | d_h1] as the ranks' partial products over their gate columns,
    added in rank order; per row, the normalisation, recursion and softmax
    sums, d_q, and the per-block partials of d_v, d_ball, d_wloc and
    d_conv over each block's positions; the conv transpose through the
    per-position terms Z = d_f w_conv^T."""
    (l1_pre, l1_ctx, l1_h, l1_b, l2_x, l2_h, l2_b, wq, w_conv, w_loc, ball, v, mu_c, mu_q, mu_b) = w
    P, U, V, A, Fw, taps = plan.dims
    T, B = S["out2"].shape[:2]
    T_in = values.shape[1]
    padl = (taps - 1) // 2
    kr = [plan.k_unit_range(q) for q in range(C)]
    cols = [[g * U + u for g in range(4) for u in kr[q]] for q in range(C)]
    l2io, l1io = torch.cat([l2_x, l2_h]), torch.cat([l1_ctx, l1_h])
    rows = _row_slices(plan)
    G = plan.blocks
    z = torch.zeros
    out = {"d_g1": z(T, B, 4 * U), "d_g2": z(T, B, 4 * U), "d_q": z(T, B, A), "d_mulin": z(T, B),
           "d_ctx_tot": z(T, B, V), "d_keys": z(B, T_in, A), "d_conv": z(G, taps, Fw), "d_wloc": z(G, Fw, A),
           "d_v": z(G, A), "d_ball": z(G, A)}
    cum = S["align_sm"].sum(0)
    cum[:, 0] += 1.0
    a_c1, a_h1, a_c2, a_h2 = z(B, U), z(B, U), z(B, U), z(B, U)
    a_ctx, a_alpha, a_cum, a_mu = z(B, V), z(B, T_in), z(B, T_in), z(B)
    for s in reversed(range(T)):
        align_sm, alphap, mup = S["align_sm"][s], S["alphap"][s], S["mup"][s]
        cum = cum - align_sm
        mu_t = torch.sigmoid(S["ctx"][s] @ mu_c + S["out2"][s] @ mu_q + mu_b)[:, 0]
        d_lin = a_mu * mu_t * (1 - mu_t)
        d_ctx = cots[1][s] + a_ctx + d_lin[:, None] * mu_c[:, 0]
        out["d_mulin"][s], out["d_ctx_tot"][s] = d_lin, d_ctx
        d_q = z(B, A)
        new_alpha, new_acum, new_amu = z(B, T_in), a_cum.clone(), z(B)
        for b, slices in rows.items():
            bufA = cots[2][s, b] + a_alpha[b] + values[b] @ d_ctx[b]
            shift = F.pad(alphap[b], (1, 0))[:-1]
            wt = (1 - mup[b]) * alphap[b] + mup[b] * shift + 1e-10
            r1 = sum((bufA[r] * S["align"][s, b, r]).sum() for _, r in slices)
            St = sum((wt[r] * align_sm[b, r]).sum() for _, r in slices)
            d_pre = (bufA - r1) / St
            e = d_pre * wt + a_cum[b]
            dw = d_pre * align_sm[b]
            new_amu[b] = sum((dw[r] * (shift[r] - alphap[b, r])).sum() for _, r in slices)
            r2 = sum((e[r] * align_sm[b, r]).sum() for _, r in slices)
            new_alpha[b] = dw * (1 - mup[b]) + F.pad(dw, (0, 1))[1:] * mup[b]
            d_e = align_sm[b] * (e - r2)
            win = TK._im2col(cum[b:b + 1], taps)[0]
            feats = win @ w_conv
            th = torch.tanh(keys[b] + S["pq"][s, b] + feats @ w_loc + ball[0])
            dth = d_e[:, None] * v[0] * (1 - th * th)
            d_f = dth @ w_loc.t()
            Zt = d_f @ w_conv.t()  # [T_in, taps]
            out["d_keys"][b] += dth
            for k, r in slices:
                d_q[b] += dth[r].sum(0)
                out["d_v"][k] += (th[r] * d_e[r, None]).sum(0)
                out["d_ball"][k] += dth[r].sum(0)
                out["d_wloc"][k] += feats[r].t() @ dth[r]
                out["d_conv"][k] += win[r].t() @ d_f[r]
            for t in range(T_in):
                for j in range(taps):
                    if 0 <= t + padl - j < T_in:
                        new_acum[b, t] += Zt[t + padl - j, j]
        a_alpha, a_cum, a_mu = new_alpha, new_acum, new_amu
        out["d_q"][s] = d_q
        y3 = z(B, U)
        for q in range(C):
            y3[:, kr[q]] = d_q @ wq[kr[q]].t()
        d_out2 = cots[0][s] + d_lin[:, None] * mu_q[:, 0] + y3
        si, tj, sf, so = _gates(S["g2"][s], S["c2p"][s])
        thc = torch.tanh(sf * S["c2p"][s] + si * tj)
        dnh = a_h2 * masks[3][s] + d_out2
        dnc = a_c2 * masks[2][s] + dnh * so * (1 - thc * thc)
        a_c2, a_h2 = a_c2 * (1 - masks[2][s]) + dnc * sf, a_h2 * (1 - masks[3][s])
        d_g2 = torch.cat([dnc * tj * si * (1 - si), dnc * si * (1 - tj * tj), dnc * S["c2p"][s] * sf * (1 - sf),
                          dnh * thc * so * (1 - so)], -1)
        y2 = sum(d_g2[:, cols[q]] @ l2io[:, cols[q]].t() for q in range(C))
        a_h2 = a_h2 + y2[:, U:]
        si, tj, sf, so = _gates(S["g1"][s], S["c1p"][s])
        thc = torch.tanh(sf * S["c1p"][s] + si * tj)
        dnh = a_h1 * masks[1][s] + y2[:, :U]
        dnc = a_c1 * masks[0][s] + dnh * so * (1 - thc * thc)
        a_c1, a_h1 = a_c1 * (1 - masks[0][s]) + dnc * sf, a_h1 * (1 - masks[1][s])
        d_g1 = torch.cat([dnc * tj * si * (1 - si), dnc * si * (1 - tj * tj), dnc * S["c1p"][s] * sf * (1 - sf),
                          dnh * thc * so * (1 - so)], -1)
        y1 = sum(d_g1[:, cols[q]] @ l1io[:, cols[q]].t() for q in range(C))
        a_ctx, a_h1 = y1[:, :V], a_h1 + y1[:, V:]
        out["d_g2"][s], out["d_g1"][s] = d_g2, d_g1
    return out


@pytest.mark.parametrize("clusters", [2, 3], ids=["2_clusters", "3_clusters_ragged"])
def test_grid_split_equals_the_plain_versions(clusters):
    """B=3, T_in=20, T=6, U=16: with 2 clusters a row spans 4 blocks of 5
    positions; with 3, 8 blocks of 3 (the last one empty) and ragged
    output units (6, 6, 4)."""
    B, T, T_in = 3, 6, 20
    w = _weights(0)
    pre, masks, keys, values, mem_mask, cots = _inputs(B, T, T_in, 1)
    plan = TK.k34_plan(B, T_in, SMALL, clusters)
    assert plan.blocks_per_row == (4 if clusters == 2 else 8)
    want = TK.train_fwd_plain(w, pre, masks, keys, values, mem_mask, 0.1)
    got = emulate_fwd(plan, w, pre, masks, keys, values, mem_mask, 0.1)
    assert set(got) == set(want)
    for k in TK.FWD_OUTS:
        torch.testing.assert_close(got[k], want[k], atol=1e-5, rtol=1e-5, msg=k)
    want_b = TK.train_bwd_plain(w, pre, masks, keys, values, mem_mask, 0.1, want, cots)
    got_b = emulate_bwd(plan, w, masks, keys, values, 0.1, want, cots)
    for k in TK.BWD_OUTS:
        a, b = got_b[k], want_b[k]
        if k in ("d_conv", "d_wloc", "d_v", "d_ball"):  # per block vs per row: their sums
            a, b = a.sum(0), b.sum(0)
        scale = max(float(b.abs().max()), 1e-6)
        torch.testing.assert_close(a, b, atol=1e-5 * scale, rtol=0, msg=k)


def test_saved_preactivations_equal_the_recomputed_products():
    """K3 saves g1, g2 and pq so that K4 recomputes nothing: they equal
    the products of the other saves."""
    B, T, T_in = 3, 5, 12
    w = _weights(2)
    pre, masks, keys, values, mem_mask, _ = _inputs(B, T, T_in, 3)
    (l1_pre, l1_ctx, l1_h, l1_b, l2_x, l2_h, l2_b, wq, *_) = w
    S = TK.train_fwd_plain(w, pre, masks, keys, values, mem_mask, 0.1)
    torch.testing.assert_close(S["g1"], pre @ l1_pre + S["ctxp"] @ l1_ctx + S["h1p"] @ l1_h + l1_b)
    torch.testing.assert_close(S["g2"], S["out1"] @ l2_x + S["h2p"] @ l2_h + l2_b)
    torch.testing.assert_close(S["pq"], S["out2"] @ wq)


def test_train_supported_shape_follows_the_plan():
    cfg = default_config().tacotron
    assert TK.train_supported_shape(32, 160, cfg, 15)
    assert TK.train_supported_shape(64, 1024, cfg, 15)
    assert not TK.train_supported_shape(64, TK.max_t_in(64, DIMS, 15) + 1, cfg, 15)
    assert not TK.train_supported_shape(200, 16, cfg, 15)
