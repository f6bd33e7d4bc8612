"""The encoder's BiLSTM (ops/tacotron_encoder_kernel.py) on the CPU: the
plain versions of K5 and K6 against the eager loop the encoder ran before
them (kept here as the reference), the autograd Function's gradients, and
the launch plan that mirrors csrc/tacotron_encoder.cu, with the grid's
split of both kernels emulated in torch against the plain versions."""

import numpy as np
import pytest
import torch

from tacotronv2_wavernn_chinese_tpu_torch.models import layers as L
from tacotronv2_wavernn_chinese_tpu_torch.ops import tacotron_encoder_kernel as EK

TOL = 1e-6


def reverse_sequence(xs, lengths):
    """tf.reverse_sequence: each row reversed within its length."""
    T = xs.shape[1]
    ar = torch.arange(T)[None, :]
    idx = lengths[:, None].long() - 1 - ar
    idx = torch.where(idx >= 0, idx, ar)
    return torch.gather(xs, 1, idx[..., None].expand(-1, -1, xs.shape[-1]))


def eager_unidir_lstm(p, xs, units, zoneout_rate, reverse=False, lengths=None, masks=None):
    """The eager loop the encoder ran before K5 (one direction): the input
    half for all steps, then per step the h @ W_h product, the gates and
    zoneout."""
    B, T, D = xs.shape
    if reverse:
        xs = reverse_sequence(xs, lengths)
    zx_all = xs.transpose(0, 1) @ p["w"][:D]
    c = xs.new_zeros(B, units)
    h = xs.new_zeros(B, units)
    outs = []
    for t in range(T):
        z = zx_all[t] + h @ p["w"][D:] + p["b"]
        new_c, new_h = L._lstm_gates(z, c)
        if masks is not None and zoneout_rate > 0.0:
            c, h = L.zoneout_train(new_c, c, masks[0][t]), L.zoneout_train(new_h, h, masks[1][t])
        else:
            c, h = L.zoneout_eval(new_c, c, zoneout_rate), L.zoneout_eval(new_h, h, zoneout_rate)
        outs.append(new_h)
    hs = torch.stack(outs, dim=1)
    return reverse_sequence(hs, lengths) if reverse else hs


def eager_encoder(p_fw, p_bw, x, lengths, zoneout, masks_fw, masks_bw):
    """[forward | backward] outputs times the input mask, as ``_encode``
    computed them."""
    U = p_fw["b"].shape[0] // 4
    fw = eager_unidir_lstm(p_fw, x, U, zoneout, masks=masks_fw)
    bw = eager_unidir_lstm(p_bw, x, U, zoneout, reverse=True, lengths=lengths, masks=masks_bw)
    keep = (torch.arange(x.shape[1])[None, :] < lengths[:, None]).to(x.dtype)
    return torch.cat([fw, bw], dim=-1) * keep[..., None]


def case(B, T, U, D, train, seed, float_masks=False):
    rng = np.random.default_rng(seed)
    f = lambda *s, scale=1.0: torch.as_tensor(rng.uniform(-scale, scale, s), dtype=torch.float32)
    lens = rng.integers(1, T + 1, B)
    lens[0] = T
    layer = lambda: {"w": f(D + U, 4 * U, scale=1.0 / np.sqrt(D + U)), "b": f(4 * U, scale=0.3)}
    mask = lambda: torch.as_tensor(rng.uniform(size=(T, B, U)) < 0.8)
    masks = [(mask(), mask()), (mask(), mask())] if train else [None, None]
    if float_masks and train:
        masks = [tuple(m.to(torch.float32) for m in pair) for pair in masks]
    return {"x": f(B, T, D), "lengths": torch.as_tensor(lens), "fw": layer(), "bw": layer(), "masks": masks,
            "cot": f(B, T, 2 * U)}


def value_and_grads(fn, c, zoneout):
    leaf = lambda t: t.detach().clone().requires_grad_(True)
    p_fw = {k: leaf(v) for k, v in c["fw"].items()}
    p_bw = {k: leaf(v) for k, v in c["bw"].items()}
    x = leaf(c["x"])
    out = fn(p_fw, p_bw, x, c["lengths"], zoneout, *c["masks"])
    keep = (torch.arange(x.shape[1])[None, :] < c["lengths"][:, None]).to(x.dtype)[..., None]
    grads = torch.autograd.grad((out * keep * c["cot"]).sum(), [x, p_fw["w"], p_fw["b"], p_bw["w"], p_bw["b"]])
    return out.detach() * keep, dict(zip(("x", "fw/w", "fw/b", "bw/w", "bw/b"), grads))


CASES = [  # (B, T_in, U, D): T_in prime or odd, U not a multiple of 8 or 4
    (3, 13, 8, 16), (5, 29, 12, 20), (1, 7, 5, 12), (4, 17, 32, 32),
]


@pytest.mark.parametrize("train", [True, False], ids=["train", "eval"])
@pytest.mark.parametrize("shape", CASES, ids=lambda s: "B{}_T{}_U{}_D{}".format(*s))
def test_plain_forward_equals_the_eager_loop(shape, train):
    c = case(*shape, train, seed=sum(shape))
    masks = None if not train else (*c["masks"][0], *c["masks"][1])
    D = shape[3]
    zx = c["x"] @ torch.cat([c["fw"]["w"][:D], c["bw"]["w"][:D]], 1) + torch.cat([c["fw"]["b"], c["bw"]["b"]])
    wh = torch.stack([c["fw"]["w"][D:], c["bw"]["w"][D:]])
    out, saves = EK.encoder_fwd_plain(zx, wh, c["lengths"], masks, 0.1, True)
    want = eager_encoder(c["fw"], c["bw"], c["x"], c["lengths"], 0.1, *c["masks"])
    assert float((out - want).abs().max()) <= TOL
    past = torch.arange(shape[1])[None, :] >= c["lengths"][:, None]
    for k in ("out", *EK.SAVES):
        v = out if k == "out" else saves[k]
        assert float(v[past].abs().max()) == 0.0 if past.any() else True, k


@pytest.mark.parametrize("train", [True, False], ids=["train", "eval"])
@pytest.mark.parametrize("shape", CASES, ids=lambda s: "B{}_T{}_U{}_D{}".format(*s))
def test_plain_backward_gradients_equal_autograd_through_the_eager_loop(shape, train):
    c = case(*shape, train, seed=7 * sum(shape), float_masks=train and shape[0] == 1)
    out, got = value_and_grads(EK.bidirectional_lstm, c, 0.1)
    ref_out, want = value_and_grads(eager_encoder, c, 0.1)
    assert float((out - ref_out).abs().max()) <= TOL
    for n in want:
        assert float((got[n] - want[n]).abs().max()) <= TOL * max(1.0, float(want[n].abs().max())), n


def test_rate_zero_ignores_the_masks_and_no_grad_saves_nothing():
    c = case(3, 11, 8, 16, True, seed=5)
    a = EK.bidirectional_lstm(c["fw"], c["bw"], c["x"], c["lengths"], 0.0, *c["masks"])
    b = EK.bidirectional_lstm(c["fw"], c["bw"], c["x"], c["lengths"], 0.0)
    assert torch.equal(a, b)
    assert torch.allclose(a, eager_encoder(c["fw"], c["bw"], c["x"], c["lengths"], 0.0, None, None), atol=TOL)


# ---------------------------------------------------------------------------
# the launch plan
# ---------------------------------------------------------------------------

CLUSTERS = 15  # what an H100 keeps resident at one block per SM


@pytest.mark.parametrize("U", [5, 8, 12, 32, 256])
@pytest.mark.parametrize("B", [1, 3, 4, 16, 32, 57, 200])
def test_every_unit_column_row_and_k_has_one_owner(B, U):
    p = EK.enc_plan(B, U, CLUSTERS)
    units = [u for q in range(EK.CLUSTER) for u in p.units(q)]
    assert sorted(units) == list(range(U))
    cols = [c for q in range(EK.CLUSTER) for c in p.columns(q)]
    assert sorted(cols) == list(range(4 * U))
    assert all(len(p.columns(q)) <= p.ncol for q in range(EK.CLUSTER))
    rows = [b for g in range(p.groups) for b in p.group_rows(g)]
    assert rows == list(range(B)) and p.rows <= EK.RMAX and p.r4 % 4 == 0
    ks = [k for s in range(p.ks) for k in p.k_slice(s)]
    assert ks == list(range(U))
    assert p.np * p.ks <= EK.THREADS and p.rows * p.ub <= EK.THREADS


@pytest.mark.parametrize("B, groups, rows", [(32, 4, 8), (16, 4, 4), (4, 1, 4), (1, 1, 1), (3, 1, 3), (200, 25, 8)])
def test_row_groups_spread_the_batch_over_the_resident_clusters(B, groups, rows):
    p = EK.enc_plan(B, 256, CLUSTERS)
    assert (p.groups, p.rows) == (groups, rows)
    if B <= EK.RMAX * (CLUSTERS // 2):
        assert 2 * p.groups <= CLUSTERS


def test_default_widths_fit_and_the_layout_is_the_cu_files():
    p = EK.enc_plan(32, 256, CLUSTERS)
    assert p.fits() and (p.ub, p.ncol, p.ldw, p.np, p.ks, p.kc) == (32, 128, 136, 64, 8, 32)
    # en_layout: W [U, ldw]; K5 h [2, U, r4] and partials [ks, r4, ncol]; K6 dz [ncol, r4] and partials
    # [2, 8, ub, r4]
    assert p.smem_bytes("fwd") == 4 * (256 * 136 + 2 * 256 * 8 + 8 * 8 * 128) == 188416
    assert p.smem_bytes("bwd") == 4 * (256 * 136 + 128 * 8 + 2 * 8 * 32 * 8) == 159744
    assert max(p.smem_bytes(k) for k in ("fwd", "bwd")) <= EK.SMEM_LIMIT
    for B in (1, 4, 16, 32, 64):
        assert EK.enc_plan(B, 256, CLUSTERS).fits()
    assert 256 <= EK.max_units(32, CLUSTERS) < 320


def test_beyond_the_envelope_the_plan_raises_with_it():
    U = EK.max_units(32, CLUSTERS)
    assert EK.launch_plan(32, U, CLUSTERS).fits()
    with pytest.raises(NotImplementedError, match=f"U <= {U}"):
        EK.launch_plan(32, U + 1, CLUSTERS)


# ---------------------------------------------------------------------------
# the grid's split, emulated
# ---------------------------------------------------------------------------


def emulate(c, zoneout, train):
    """K5 then K6 as the grid splits them: per (direction, row group)
    cluster, each rank's gate columns from its W_h slice, K5's product as
    partials over the plan's K slices, K6's dh as eight ranks' partials
    added in rank order.  Returns (out, dz) in the kernels' layouts."""
    x, lengths = c["x"], c["lengths"]
    B, T, D = x.shape
    U = c["fw"]["b"].shape[0] // 4
    p = EK.enc_plan(B, U, CLUSTERS)
    zx = (x @ torch.cat([c["fw"]["w"][:D], c["bw"]["w"][:D]], 1)
          + torch.cat([c["fw"]["b"], c["bw"]["b"]])).view(B, T, 2, 4 * U)
    wh = torch.stack([c["fw"]["w"][D:], c["bw"]["w"][D:]])
    masks = (*c["masks"][0], *c["masks"][1]) if train else None
    out = torch.zeros(B, T, 2, U)
    acts, cprev = torch.zeros(B, T, 2, 4 * U), torch.zeros(B, T, 2, U)
    nc_s = torch.zeros(B, T, 2, U)
    for d in range(2):
        for g in range(p.groups):
            rows = list(p.group_rows(g))
            lens = [int(lengths[b]) for b in rows]
            h, cc = torch.zeros(len(rows), U), torch.zeros(len(rows), U)
            for t in range(max(lens)):
                hn, cn = h.clone(), cc.clone()
                for q in range(EK.CLUSTER):
                    cols = p.columns(q)
                    if not cols:
                        continue
                    part = sum(h[:, list(p.k_slice(s))] @ wh[d][list(p.k_slice(s))][:, cols] for s in range(p.ks))
                    for r, b in enumerate(rows):
                        if t >= lens[r]:
                            continue
                        pos = t if d == 0 else lens[r] - 1 - t
                        us = list(p.units(q))
                        z = zx[b, pos, d][cols] + part[r]
                        n = len(us)
                        si, tj = torch.sigmoid(z[:n]), torch.tanh(z[n:2 * n])
                        sf, so = torch.sigmoid(z[2 * n:3 * n] + 1.0), torch.sigmoid(z[3 * n:])
                        new_c = sf * cc[r, us] + si * tj
                        new_h = so * torch.tanh(new_c)
                        if masks is not None:
                            kc, kh = masks[2 * d][t, b, us], masks[2 * d + 1][t, b, us]
                            cn[r, us] = torch.where(kc, new_c - cc[r, us], torch.zeros(n)) + cc[r, us]
                            hn[r, us] = torch.where(kh, new_h - h[r, us], torch.zeros(n)) + h[r, us]
                        else:
                            cn[r, us] = (1 - zoneout) * new_c + zoneout * cc[r, us]
                            hn[r, us] = (1 - zoneout) * new_h + zoneout * h[r, us]
                        out[b, pos, d, us] = new_h
                        acts[b, pos, d] = acts[b, pos, d].index_put((torch.tensor(cols),), torch.cat([si, tj, sf, so]))
                        cprev[b, pos, d, us] = cc[r, us]
                        nc_s[b, pos, d, us] = new_c
                h, cc = hn, cn
    # K6
    gout = c["cot"].view(B, T, 2, U)
    dz = torch.zeros(B, T, 2, 4 * U)
    for d in range(2):
        for g in range(p.groups):
            rows = list(p.group_rows(g))
            lens = [int(lengths[b]) for b in rows]
            ah, ac = torch.zeros(len(rows), U), torch.zeros(len(rows), U)
            for t in reversed(range(max(lens))):
                d_step = torch.zeros(len(rows), 4 * U)
                ahd = torch.zeros(len(rows), U)
                for r, b in enumerate(rows):
                    if t >= lens[r]:
                        ac[r] = 0.0
                        continue
                    pos = t if d == 0 else lens[r] - 1 - t
                    si, tj, sf, so = acts[b, pos, d].split(U)
                    if masks is not None:
                        kc, kh = masks[2 * d][t, b].float(), masks[2 * d + 1][t, b].float()
                        zc, zh = 1 - kc, 1 - kh
                    else:
                        kc = kh = 1 - zoneout
                        zc = zh = zoneout
                    th = torch.tanh(nc_s[b, pos, d])
                    dnh = gout[b, pos, d] + kh * ah[r]
                    dnc = kc * ac[r] + dnh * so * (1 - th * th)
                    d_step[r] = torch.cat([dnc * tj * si * (1 - si), dnc * si * (1 - tj * tj),
                                           dnc * cprev[b, pos, d] * sf * (1 - sf), dnh * th * so * (1 - so)])
                    ac[r] = zc * ac[r] + dnc * sf
                    ahd[r] = zh * ah[r]
                    dz[b, pos, d] = d_step[r]
                partials = [d_step[:, p.columns(q)] @ wh[d][:, p.columns(q)].t() for q in range(EK.CLUSTER)]
                total = ahd.clone()
                for part in partials:  # rank order
                    total = total + part
                ah = total
    return out.reshape(B, T, 2 * U), dz.reshape(B, T, 8 * U)


@pytest.mark.parametrize("train", [True, False], ids=["train", "eval"])
@pytest.mark.parametrize("shape", [(5, 9, 12, 8), (9, 6, 16, 8)], ids=lambda s: "B{}_T{}_U{}_D{}".format(*s))
def test_the_grids_split_equals_the_plain_versions(shape, train):
    c = case(*shape, train, seed=3 + sum(shape))
    B, T, U, D = shape
    out, dz = emulate(c, 0.1, train)
    masks = (*c["masks"][0], *c["masks"][1]) if train else None
    zx = c["x"] @ torch.cat([c["fw"]["w"][:D], c["bw"]["w"][:D]], 1) + torch.cat([c["fw"]["b"], c["bw"]["b"]])
    wh = torch.stack([c["fw"]["w"][D:], c["bw"]["w"][D:]])
    want, saves = EK.encoder_fwd_plain(zx, wh, c["lengths"], masks, 0.1, True)
    assert float((out - want).abs().max()) <= TOL
    want_dz = EK.encoder_bwd_plain(wh, c["lengths"], masks, 0.1, saves, c["cot"])
    assert float((dz - want_dz).abs().max()) <= TOL * max(1.0, float(want_dz.abs().max()))
