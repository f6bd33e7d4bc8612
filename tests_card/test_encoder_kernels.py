"""K5 and K6 (csrc/tacotron_encoder.cu) on the card against their plain
versions, at the benchmark cells' shapes and the tests' small widths, and
their launch counts on the model's paths."""

import dataclasses

import numpy as np
import pytest
import torch

from tacotronv2_wavernn_chinese_tpu_torch import ops
from tacotronv2_wavernn_chinese_tpu_torch.config import default_config
from tacotronv2_wavernn_chinese_tpu_torch.models import tacotron as T
from tacotronv2_wavernn_chinese_tpu_torch.ops import tacotron_encoder_kernel as EK
from tacotronv2_wavernn_chinese_tpu_torch.utils.checkpoints import init_tacotron

# (B, T_in, U, D): the training cell's batch of 32 at T_in 32 to 160,
# serving's batches of 1-16, and small widths (U not a multiple of 8 too)
SHAPES = [(32, 32, 256, 256), (32, 97, 256, 256), (32, 160, 256, 256), (1, 23, 256, 256), (3, 41, 256, 256),
          (8, 64, 256, 256), (16, 96, 256, 256), (5, 37, 32, 32), (4, 20, 8, 16), (6, 17, 12, 16), (9, 30, 16, 32)]
OUT_TOL = 1e-5  # max|d| of the outputs (tanh-bounded), f32 sums in another order
GRAD_TOL = 1e-4  # max|d| of a gradient over its max|g|


def inputs(dev, B, T_in, U, D, train, seed):
    rng = np.random.default_rng(seed)
    f = lambda *s, scale=1.0: torch.as_tensor(rng.uniform(-scale, scale, s), dtype=torch.float32, device=dev)
    lens = np.linspace(T_in, max(1, T_in // 3), B).astype(np.int64)
    rng.shuffle(lens)
    lens[0] = T_in
    layer = lambda: {"w": f(D + U, 4 * U, scale=1.0 / np.sqrt(D + U)), "b": f(4 * U, scale=0.1)}
    masks = [tuple(torch.as_tensor(rng.uniform(size=(T_in, B, U)) < 0.9, device=dev) for _ in range(2))
             for _ in range(2)] if train else [None, None]
    return {"x": f(B, T_in, D), "lengths": torch.as_tensor(lens, device=dev), "fw": layer(), "bw": layer(),
            "masks": masks, "cot": f(B, T_in, 2 * U)}


def value_and_grads(apply, inp, zoneout):
    leaf = lambda t: t.detach().clone().requires_grad_(True)
    p_fw = {k: leaf(v) for k, v in inp["fw"].items()}
    p_bw = {k: leaf(v) for k, v in inp["bw"].items()}
    x = leaf(inp["x"])
    out = apply(p_fw, p_bw, x, inp["lengths"], zoneout, *inp["masks"])
    names = ["x", "fw/w", "fw/b", "bw/w", "bw/b"]
    grads = torch.autograd.grad((out * inp["cot"]).sum(), [x, p_fw["w"], p_fw["b"], p_bw["w"], p_bw["b"]])
    return out.detach(), dict(zip(names, grads))


@pytest.mark.card
@pytest.mark.parametrize("train", [True, False], ids=["train", "eval"])
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "B{}_T{}_U{}_D{}".format(*s))
def test_k5_k6_match_the_plain_versions(card, shape, train):
    B, T_in, U, D = shape
    inp = inputs(card, B, T_in, U, D, train, seed=B * 1000 + T_in)
    ops.reset_launch_counts()
    out_k, g_k = value_and_grads(EK.bidirectional_lstm, inp, 0.1)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["tacotron_encoder_fwd"] == 1 and ops.LAUNCHES["tacotron_encoder_bwd"] == 1
    out_p, g_p = value_and_grads(EK.bidirectional_lstm_plain, inp, 0.1)
    assert float((out_k - out_p).abs().max()) <= OUT_TOL
    past = torch.arange(T_in, device=card)[None, :] >= inp["lengths"][:, None]
    assert float(out_k[past].abs().max()) == 0.0 if past.any() else True
    for n in g_p:
        d, g = float((g_k[n] - g_p[n]).abs().max()), float(g_p[n].abs().max())
        assert d <= GRAD_TOL * max(g, 1e-6), (n, d, g)


@pytest.mark.card
def test_k5_without_saves_and_eval_output_equal_the_saving_launch(card):
    inp = inputs(card, 8, 50, 256, 256, False, seed=3)
    with torch.no_grad():
        a = EK.bidirectional_lstm(inp["fw"], inp["bw"], inp["x"], inp["lengths"], 0.1)
    b, _ = value_and_grads(EK.bidirectional_lstm, inp, 0.1)
    assert torch.equal(a, b)


def small_cfg():
    return dataclasses.replace(default_config().tacotron, encoder_lstm_units=64, enc_conv_channels=64)


@pytest.mark.card
def test_one_k5_per_encoder_call_one_k6_per_backward_and_no_plain_loop_on_the_card(card, monkeypatch):
    def refuse(name):
        real = getattr(EK, name)

        def guarded(*args, **kwargs):
            assert not any(isinstance(a, torch.Tensor) and a.is_cuda for a in args), f"{name} ran on the card"
            return real(*args, **kwargs)
        return guarded

    for name in ("encoder_fwd_plain", "encoder_bwd_plain"):
        monkeypatch.setattr(EK, name, refuse(name))
    tcfg = small_cfg()
    params = init_tacotron(0, tcfg, device=card)
    rng = np.random.default_rng(0)
    ids = torch.as_tensor(rng.integers(1, tcfg.vocab_size, (4, 30)), device=card)
    lens = torch.as_tensor([30, 22, 15, 7], device=card)
    ops.reset_launch_counts()
    with torch.no_grad():
        T.encode(params, tcfg, ids, lens)
        T.forward_inference(params, tcfg, ids, lens, seeds=[1, 2, 3, 4], max_iters=8)
    assert ops.LAUNCHES["tacotron_encoder_fwd"] == 2 and ops.LAUNCHES["tacotron_encoder_bwd"] == 0
    leaves = {k: v for k, v in params.items()}
    leaves["enc_lstm_fw"] = {k: v.detach().clone().requires_grad_(True) for k, v in params["enc_lstm_fw"].items()}
    gen = torch.Generator(device=card).manual_seed(5)
    rand = T.draw_train_rand(params, tcfg, 4, 30, 40, gen)
    memory, _ = T.encode_train(leaves, tcfg, ids, lens, rand)
    memory.square().sum().backward()
    torch.cuda.synchronize()
    assert ops.LAUNCHES["tacotron_encoder_fwd"] == 3 and ops.LAUNCHES["tacotron_encoder_bwd"] == 1
    assert torch.isfinite(leaves["enc_lstm_fw"]["w"].grad).all()


@pytest.mark.card
def test_envelope_raises_with_its_width(card):
    U = EK.max_units(4, EK.card_clusters(card)) + 8
    inp = inputs(card, 4, 10, U, 16, False, seed=1)
    with pytest.raises(NotImplementedError, match="encoder_lstm_units"):
        EK.bidirectional_lstm(inp["fw"], inp["bw"], inp["x"], inp["lengths"], 0.1)
