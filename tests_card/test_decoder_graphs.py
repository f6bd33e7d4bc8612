"""The eager route's graphed decode (``models.decoder_graph``) on the card:
the captured forward and backward at the published Tacotron 2's widths
(B = 64, T_in = 160, T = 224, LSA, a 2 x 1,024 decoder) against autograd
through the eager loop; the capture count per key, replays per decode, a
second length that reuses the graphs, growth past ``T_cap``, a new encoder
length, the guard against a second forward before the backward; every
attention mode's graphs at small widths; and whole training steps through
the graphs against the eager loop."""

import dataclasses

import pytest
import torch

from tacotronv2_wavernn_chinese_tpu_torch.config import default_config
from tacotronv2_wavernn_chinese_tpu_torch.models import attention as ATT
from tacotronv2_wavernn_chinese_tpu_torch.models import decoder_graph as DG
from tacotronv2_wavernn_chinese_tpu_torch.models import layers as L
from tacotronv2_wavernn_chinese_tpu_torch.models import tacotron as T
from tacotronv2_wavernn_chinese_tpu_torch.train import tacotron_task as TT
from tacotronv2_wavernn_chinese_tpu_torch.utils import tree_leaves, tree_map
from tacotronv2_wavernn_chinese_tpu_torch.utils.checkpoints import init_tacotron

OUT_TOL = 1e-6  # max|d| of an output over its max|x|
GRAD_TOL = 1e-5  # max|d| of a gradient over its max|g|

SHEN = dict(embedding_dim=512, enc_conv_channels=512, encoder_lstm_units=256, attention_mode="lsa",
            attention_dim=128, attention_filters=32, attention_kernel=31, prenet_layers=(256, 256),
            decoder_lstm_units=1024, postnet_channels=512)
SMALL = dict(embedding_dim=16, enc_conv_channels=16, enc_conv_layers=2, encoder_lstm_units=16, attention_dim=16,
             attention_filters=4, attention_kernel=7, prenet_layers=(16, 16), decoder_lstm_units=32,
             postnet_channels=16, postnet_layers=2)


def _tc(**over):
    return dataclasses.replace(default_config().tacotron, **over)


def _decode(params, tc, memory, lens, frames, rand, train, graphed):
    mem_mask = T.input_mask(lens, memory.shape[1])
    keys = ATT.precompute_keys(params["attention"], tc, memory)
    pre_all = L.prenet(params["prenet"], frames, tc.dropout_rate, masks=rand.pre)
    w_comb = b_comb = None
    if "location_conv" in params["attention"]:
        w_comb, b_comb = ATT.combined_location_weights(params["attention"])
    zone = rand.z1 + rand.z2 if train and tc.zoneout_rate > 0.0 else None
    att = rand.att if train else None
    if graphed:
        return DG.decode(params, tc, train, pre_all, zone, att, keys, memory, mem_mask, w_comb, b_comb), pre_all
    carry = T.init_decoder_carry(tc, memory.shape[0], memory.shape[1], memory.shape[2], memory.device)
    outs = []
    for t in range(pre_all.shape[0]):
        z = None if zone is None else ((zone[0][t], zone[1][t]), (zone[2][t], zone[3][t]))
        out2, ctx, align, carry = T.decoder_step(
            params, tc, None, carry, keys, memory, mem_mask, None, w_comb, b_comb, train=train, zoneout_masks=z,
            att_mask=None if att is None else att[t], pre=pre_all[t], project=False)
        outs.append((out2, ctx, align))
    return tuple(torch.stack(v) for v in zip(*outs)), pre_all


def _setup(dev, tc, B, T_in, steps, train, seed=0):
    params = init_tacotron(seed, tc, device=dev)
    g = torch.Generator(device=dev).manual_seed(seed + 1)
    memory = torch.randn(B, T_in, 2 * tc.encoder_lstm_units, generator=g, device=dev)
    lens = torch.linspace(T_in, T_in // 3, B, device=dev).long()
    memory = memory * T.input_mask(lens, T_in)[..., None]
    frames = torch.rand(steps, B, 80, generator=g, device=dev) * 8 - 4
    rand = T.draw_train_rand(params, tc, B, T_in, steps, g, train)
    cot = [torch.randn(steps, B, n, generator=g, device=dev) for n in (tc.decoder_lstm_units, memory.shape[-1], T_in)]
    return params, memory, lens, frames, rand, cot


def _run(setup, tc, train, graphed, grad=True):
    params, memory, lens, frames, rand, cot = setup
    leaves = tree_map(lambda p: p.detach().clone().requires_grad_(grad), params)
    memory = memory.clone().requires_grad_(grad)
    outs, pre_all = _decode(leaves, tc, memory, lens, frames, rand, train, graphed)
    if not grad:
        return [o.detach() for o in outs], None
    pre_all.retain_grad()
    sum((o * c).sum() for o, c in zip(outs, cot)).backward()
    grads = [memory.grad, pre_all.grad] + [p.grad for p in tree_leaves(leaves)]
    return [o.detach() for o in outs], grads


def _rel(a, b):
    return float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30)


def _compare(got, want):
    (o_g, g_g), (o_e, g_e) = got, want
    for a, b in zip(o_g, o_e):
        assert _rel(a, b) <= OUT_TOL
    for a, b in zip(g_g or [], g_e or []):
        if b is None or float(b.abs().max()) == 0.0:
            assert a is None or float(a.abs().max()) == 0.0
        else:
            assert _rel(a, b) <= GRAD_TOL


@pytest.mark.card
def test_the_graphs_match_the_eager_loop_at_shen_widths_and_capture_once_a_key(card):
    tc = _tc(**SHEN)
    DG._GRAPHS.clear()
    DG._ARENAS.clear()
    c0, r0 = DG.DECODER_GRAPHS["captures"], DG.DECODER_GRAPHS["steps_replayed"]
    s = _setup(card, tc, 64, 160, 224, True)
    _compare(_run(s, tc, True, True), _run(s, tc, True, False))
    # one key: its forward and its backward graph, 224 replays forward
    assert DG.DECODER_GRAPHS["captures"] == c0 + 2 and DG.DECODER_GRAPHS["steps_replayed"] == r0 + 224
    assert len(DG._GRAPHS) == 1
    # a shorter decode at the same key reuses both graphs
    s2 = _setup(card, tc, 64, 160, 100, True, seed=1)
    _compare(_run(s2, tc, True, True), _run(s2, tc, True, False))
    assert DG.DECODER_GRAPHS["captures"] == c0 + 2 and DG.DECODER_GRAPHS["steps_replayed"] == r0 + 324
    # past T_cap: the arena grows and the key captures again
    (arena,) = DG._ARENAS.values()
    t_cap = arena.t_cap
    s3 = _setup(card, tc, 64, 160, t_cap + 8, True, seed=2)
    _compare(_run(s3, tc, True, True), _run(s3, tc, True, False))
    assert arena.t_cap >= t_cap + 8
    assert DG.DECODER_GRAPHS["captures"] == c0 + 4
    # a new encoder length is a new key
    s4 = _setup(card, tc, 64, 96, 64, True, seed=3)
    _compare(_run(s4, tc, True, True), _run(s4, tc, True, False))
    assert DG.DECODER_GRAPHS["captures"] == c0 + 6 and len(DG._GRAPHS) == 2


@pytest.mark.card
def test_a_second_forward_before_the_backward_raises(card):
    tc = _tc(**SMALL, attention_mode="lsa")
    params, memory, lens, frames, rand, cot = _setup(card, tc, 4, 20, 30, True)
    leaves = tree_map(lambda p: p.detach().clone().requires_grad_(True), params)
    outs, _ = _decode(leaves, tc, memory, lens, frames, rand, True, True)
    with pytest.raises(DG.ArenaBusy):
        _decode(leaves, tc, memory, lens, frames, rand, True, True)
    sum((o * c).sum() for o, c in zip(outs, cot)).backward()
    outs, _ = _decode(leaves, tc, memory, lens, frames, rand, True, True)
    sum((o * c).sum() for o, c in zip(outs, cot)).backward()


MODES = {"lsa": {"attention_mode": "lsa"}, "gmm": {"attention_mode": "gmm"},
         "graves": {"attention_mode": "graves"}, "forward_smoothing": {"smoothing": True},
         "forward_anti_repeat": {"anti_repeat": True}, "lsa_window": {"attention_mode": "lsa",
                                                                     "synthesis_constraint": True}}


@pytest.mark.card
@pytest.mark.parametrize("train", [True, False], ids=["train", "eval"])
@pytest.mark.parametrize("name", list(MODES))
def test_every_mode_replays_its_graphs(card, name, train):
    tc = _tc(**SMALL, **MODES[name])
    s = _setup(card, tc, 5, 24, 40, train, seed=7)
    r0 = DG.DECODER_GRAPHS["steps_replayed"]
    _compare(_run(s, tc, train, True), _run(s, tc, train, False))
    with torch.no_grad():
        _compare(_run(s, tc, train, True, grad=False), _run(s, tc, train, False, grad=False))
    assert DG.DECODER_GRAPHS["steps_replayed"] == r0 + 80


def _batch(dev, B=8, T_in=32, T_out=96):
    g = torch.Generator(device=dev).manual_seed(5)
    lens = torch.linspace(T_out, T_out // 2, B, device=dev).long()
    return {"inputs": torch.randint(1, 180, (B, T_in), generator=g, device=dev),
            "input_lengths": torch.linspace(T_in, T_in // 2, B, device=dev).long(),
            "mel_targets": torch.rand(B, T_out, 80, generator=g, device=dev) * 8 - 4,
            "stop_targets": (torch.arange(T_out, device=dev)[None] >= lens[:, None] - 1).float(),
            "target_lengths": lens, "loss_frames": torch.full((B,), T_out, device=dev)}


@pytest.mark.card
@pytest.mark.parametrize("mixed", [False, True], ids=["f32", "mixed_precision"])
def test_training_steps_through_the_graphs_match_the_eager_loop(card, monkeypatch, mixed):
    cfg = default_config()
    cfg = dataclasses.replace(cfg, tacotron=_tc(**SMALL, attention_mode="lsa"),
                              tacotron_train=dataclasses.replace(cfg.tacotron_train, mixed_precision=mixed))
    params = init_tacotron(3, cfg.tacotron, device=card)
    batch = _batch(card)

    def run(usable):
        monkeypatch.setattr(DG, "usable", lambda memory: usable and memory.is_cuda)
        gen = torch.Generator(device=card).manual_seed(99)
        _, _, _, grads = TT.compute_grads(params, cfg, batch, gen, 0)
        state = TT.TrainState(0, params, TT.adam_init(params))
        losses = []
        for step in range(2):
            gen.manual_seed(100 + step)
            state, metrics = TT.train_step(state, batch, gen, cfg)
            losses.append(metrics["loss"])
        return tree_leaves(grads), losses

    r0 = DG.DECODER_GRAPHS["steps_replayed"]
    grads_g, losses_g = run(True)
    assert DG.DECODER_GRAPHS["steps_replayed"] == r0 + 3 * 96
    grads_e, losses_e = run(False)
    for a, b in zip(losses_g, losses_e):
        assert abs(a - b) <= 1e-5 * abs(b)
    for a, b in zip(grads_g, grads_e):
        if float(b.abs().max()) == 0.0:
            continue
        if mixed:  # the bf16 round trip's backward rounds each summed cotangent: one bf16 ulp apart at most
            assert bool(((a - b).abs() <= 2.0 ** -7 * b.abs() + GRAD_TOL * float(b.abs().max())).all())
        else:
            assert _rel(a, b) <= GRAD_TOL
