"""The eager route's graphed decode (``models.decoder_graph``) on the CPU,
where it runs its step bodies without graphs: the forward's slots and the
backward's reverse loop of recompute and VJP against autograd through the
eager loop over ``decoder_step``, per attention mode, train and eval, and
under mixed precision; a whole training step's loss and every leaf's
gradient through it; the arena's growth and its guard against a second
forward before the first one's backward; and the counter and span
attribute, which stay at 0 and false on the CPU."""

import dataclasses

import numpy as np
import pytest
import torch

from tacotronv2_wavernn_chinese_tpu_torch.config import default_config
from tacotronv2_wavernn_chinese_tpu_torch.models import attention as ATT
from tacotronv2_wavernn_chinese_tpu_torch.models import decoder_graph as DG
from tacotronv2_wavernn_chinese_tpu_torch.models import layers as L
from tacotronv2_wavernn_chinese_tpu_torch.models import tacotron as T
from tacotronv2_wavernn_chinese_tpu_torch.train import tacotron_task as TT
from tacotronv2_wavernn_chinese_tpu_torch.utils import metrics as M
from tacotronv2_wavernn_chinese_tpu_torch.utils import precision as P
from tacotronv2_wavernn_chinese_tpu_torch.utils import tree_leaves, tree_map
from tacotronv2_wavernn_chinese_tpu_torch.utils.checkpoints import init_tacotron

REL = 1e-6  # max|d| over max|x| of an output or a gradient
BF16_ULP = 2.0 ** -7  # one unit in the last place of bf16, at most this share of the value

# name -> (attention mode, config overrides)
MODES = {
    "lsa": ("lsa", {}),
    "gmm": ("gmm", {}),
    "graves": ("graves", {}),
    "forward_smoothing": ("forward", {"smoothing": True, "anti_repeat": True}),
}


def _cfg(name: str, **extra):
    mode, over = MODES[name]
    cfg = default_config()
    return dataclasses.replace(cfg, tacotron=dataclasses.replace(
        cfg.tacotron, embedding_dim=16, enc_conv_channels=16, enc_conv_layers=2, encoder_lstm_units=8,
        attention_mode=mode, attention_dim=8, attention_filters=4, attention_kernel=7, prenet_layers=(12, 12),
        decoder_lstm_units=16, postnet_channels=16, postnet_layers=2, **over, **extra))


def _inputs(cfg, train: bool, B=3, T_in=11, steps=9, seed=0):
    """Leaves for one decode: params, memory, prenet inputs and masks."""
    tc = cfg.tacotron
    params = init_tacotron(seed, tc, device="cpu")
    g = torch.Generator().manual_seed(seed + 1)
    memory = torch.randn(B, T_in, 2 * tc.encoder_lstm_units, generator=g)
    lens = torch.tensor([T_in, T_in - 3, 4])[:B]
    memory = memory * T.input_mask(lens, T_in)[..., None]
    frames = torch.randn(steps, B, 80, generator=g)
    rand = T.draw_train_rand(params, tc, B, T_in, steps, g, train)
    cot = [torch.randn(steps, B, n, generator=g) for n in (tc.decoder_lstm_units, memory.shape[-1], T_in)]
    return params, memory, lens, frames, rand, cot


def _decode(params, tc, memory, lens, frames, rand, train: bool, graphed: bool):
    """The decoder's outputs from leaves, through the graphed decode's
    Function (without graphs) or the eager loop over ``decoder_step``."""
    mem_mask = T.input_mask(lens, memory.shape[1])
    keys = ATT.precompute_keys(params["attention"], tc, memory)
    pre_all = L.prenet(params["prenet"], frames, tc.dropout_rate, masks=rand.pre)
    w_comb = b_comb = None
    if "location_conv" in params["attention"]:
        w_comb, b_comb = ATT.combined_location_weights(params["attention"])
    zone = rand.z1 + rand.z2 if train and tc.zoneout_rate > 0.0 else None
    att = rand.att if train else None
    if graphed:
        return DG.decode(params, tc, train, pre_all, zone, att, keys, memory, mem_mask, w_comb, b_comb,
                         graphs=False), pre_all
    carry = T.init_decoder_carry(tc, memory.shape[0], memory.shape[1], memory.shape[2])
    outs = []
    for t in range(pre_all.shape[0]):
        z = None if zone is None else ((zone[0][t], zone[1][t]), (zone[2][t], zone[3][t]))
        out2, ctx, align, carry = T.decoder_step(
            params, tc, None, carry, keys, memory, mem_mask, None, w_comb, b_comb, train=train, zoneout_masks=z,
            att_mask=None if att is None else att[t], pre=pre_all[t], project=False)
        outs.append((out2, ctx, align))
    return tuple(torch.stack(v) for v in zip(*outs)), pre_all


def _values_and_grads(cfg, train: bool, graphed: bool, mixed: bool = False, **shape):
    params, memory, lens, frames, rand, cot = _inputs(cfg, train, **shape)
    master = tree_map(lambda p: p.detach().clone().requires_grad_(True), params)
    memory = memory.clone().requires_grad_(True)
    used = P.cast_params(master) if mixed else master
    (outs, pre_all) = _decode(used, cfg.tacotron, memory, lens, frames, rand, train, graphed)
    pre_all.retain_grad()
    loss = sum((o * c).sum() for o, c in zip(outs, cot))
    loss.backward()
    grads = {"memory": memory.grad, "pre_all": pre_all.grad}
    grads.update({f"leaf{i}": p.grad for i, p in enumerate(tree_leaves(master))})
    return [o.detach() for o in outs], float(loss.detach()), grads


def _close(a, b, what):
    scale = max(float(b.abs().max()), 1e-30)
    err = float((a - b).abs().max()) / scale
    assert err <= REL, f"{what}: {err:.3e} of max|x| {scale:.3e}"


@pytest.mark.parametrize("train", [True, False], ids=["train", "eval"])
@pytest.mark.parametrize("name", list(MODES))
def test_the_reverse_loop_matches_autograd_through_the_eager_loop(name, train):
    cfg = _cfg(name)
    outs_g, loss_g, grads_g = _values_and_grads(cfg, train, graphed=True)
    outs_e, loss_e, grads_e = _values_and_grads(cfg, train, graphed=False)
    for a, b, what in zip(outs_g, outs_e, ("out2", "context", "alignments")):
        _close(a, b, what)
    assert abs(loss_g - loss_e) <= REL * abs(loss_e)
    assert grads_g.keys() == grads_e.keys()
    for k, g in grads_e.items():
        if g is None:
            assert grads_g[k] is None or float(grads_g[k].abs().max()) == 0.0, k
        else:
            _close(grads_g[k], g, k)


def test_the_reverse_loop_matches_under_mixed_precision():
    cfg = _cfg("lsa")
    outs_g, loss_g, grads_g = _values_and_grads(cfg, True, graphed=True, mixed=True)
    outs_e, loss_e, grads_e = _values_and_grads(cfg, True, graphed=False, mixed=True)
    for a, b, what in zip(outs_g, outs_e, ("out2", "context", "alignments")):
        _close(a, b, what)
    assert abs(loss_g - loss_e) <= REL * abs(loss_e)
    for k, g in grads_e.items():
        if g is not None:
            _close(grads_g[k], g, k)


def _batch(B=3, T_in=10, T_out=12):
    rng = np.random.default_rng(5)
    lens = np.asarray([T_out, T_out - 3, T_out - 5], np.int32)[:B]
    b = {"inputs": rng.integers(1, 60, (B, T_in)).astype(np.int32),
         "input_lengths": np.asarray([T_in, 7, 5], np.int32)[:B],
         "mel_targets": rng.uniform(-4, 4, (B, T_out, 80)).astype(np.float32),
         "stop_targets": (np.arange(T_out)[None] >= lens[:, None] - 1).astype(np.float32),
         "target_lengths": lens, "loss_frames": np.full((B,), T_out, np.int32)}
    return {k: torch.as_tensor(v) for k, v in b.items()}


@pytest.mark.parametrize("mixed", [False, True], ids=["f32", "mixed_precision"])
@pytest.mark.parametrize("name", ["lsa", "gmm"])
def test_a_training_step_through_the_graphed_decode_matches_the_eager_loop(monkeypatch, name, mixed):
    cfg = _cfg(name)
    cfg = dataclasses.replace(cfg, tacotron_train=dataclasses.replace(cfg.tacotron_train, mixed_precision=mixed))
    params = init_tacotron(3, cfg.tacotron, device="cpu")
    batch = _batch()

    def grads(usable):
        monkeypatch.setattr(DG, "usable", lambda memory: usable)
        loss, aux, _, g = TT.compute_grads(params, cfg, batch, torch.Generator().manual_seed(11), 0)
        return float(loss), g

    loss_g, g_g = grads(True)
    loss_e, g_e = grads(False)
    assert abs(loss_g - loss_e) <= REL * abs(loss_e)
    for a, b in zip(tree_leaves(g_g), tree_leaves(g_e)):
        if float(b.abs().max()) == 0.0:
            continue
        if mixed:
            # the bf16 round trip's backward rounds each weight's summed
            # cotangent to bf16: sums one f32 rounding apart (the steps
            # added in another order) may land one bf16 ulp apart
            slack = BF16_ULP * b.abs() + REL * float(b.abs().max())
            assert bool(((a - b).abs() <= slack).all())
        else:
            _close(a, b, "leaf")


def test_the_arena_grows_and_the_same_key_decodes_any_length():
    cfg = _cfg("lsa")
    for T_out in (5, 13, 9):
        outs_g, _, grads_g = _values_and_grads(cfg, True, graphed=True, steps=T_out)
        outs_e, _, grads_e = _values_and_grads(cfg, True, graphed=False, steps=T_out)
        for a, b in zip(outs_g, outs_e):
            _close(a, b, f"T={T_out}")
        _close(grads_g["memory"], grads_e["memory"], f"T={T_out} memory")
    arena = DG._ARENAS["cpu"]
    assert arena.t_cap >= 13
    assert arena.flat[torch.float32].numel() >= arena.t_cap * 3 * 16  # at least the prenet slots


def test_a_second_decode_before_the_backward_raises():
    cfg = _cfg("lsa")
    tc = cfg.tacotron
    params, memory, lens, frames, rand, cot = _inputs(cfg, True)
    leaves = tree_map(lambda p: p.detach().clone().requires_grad_(True), params)
    (outs, _) = _decode(leaves, tc, memory, lens, frames, rand, True, graphed=True)
    with pytest.raises(DG.ArenaBusy):
        _decode(leaves, tc, memory, lens, frames, rand, True, graphed=True)
    with torch.no_grad(), pytest.raises(DG.ArenaBusy):
        _decode(leaves, tc, memory, lens, frames, rand, False, graphed=True)
    loss = sum((o * c).sum() for o, c in zip(outs, cot))
    loss.backward(retain_graph=True)
    # after its backward the arena is free; a later decode takes it, and
    # the first graph's second backward finds its saves overwritten
    (outs2, _) = _decode(leaves, tc, memory, lens, frames, rand, True, graphed=True)
    with pytest.raises(DG.ArenaBusy):
        loss.backward()
    sum((o * c).sum() for o, c in zip(outs2, cot)).backward()
    # a forward whose graph is freed without a backward frees the arena too
    (outs3, _) = _decode(leaves, tc, memory, lens, frames, rand, True, graphed=True)
    del outs3
    with torch.no_grad():
        _decode(leaves, tc, memory, lens, frames, rand, False, graphed=True)


def test_on_the_cpu_nothing_replays_and_the_span_says_so():
    assert "decoder_graphs" in M.counters()
    assert M.counters()["decoder_graphs"] is T.DECODER_GRAPHS is DG.DECODER_GRAPHS
    before = dict(T.DECODER_GRAPHS)
    cfg = _cfg("lsa")
    params = init_tacotron(0, cfg.tacotron, device="cpu")
    state = TT.TrainState(0, params, TT.adam_init(params))
    M.enable(False)
    M.drain()
    M.enable()
    try:
        TT.train_step(state, _batch(), torch.Generator().manual_seed(3), cfg)
        spans = [s for s in M.drain() if s["name"] == "tacotron.decoder"]
    finally:
        M.enable(False)
        M.drain()
    assert [s["attrs"]["graphed"] for s in spans] == [False]
    assert not DG.usable(torch.zeros(1))
    assert T.DECODER_GRAPHS == before
