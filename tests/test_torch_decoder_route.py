"""The decoder's route made visible, on the CPU: the ``tacotron.decoder``
span carries the route a decode took ("kernel" for forward attention
under full teacher forcing, "eager" for every other teacher-forced
configuration, "k2" for an autoregressive decode), the attention mode, the
rows, the steps, the encoder positions and whether the steps replayed a
CUDA graph (never on the CPU); ``counters()["decoder_steps"]``
adds each decode's padded step count to its route, with the spans on or
off; off, nothing is allocated."""

import dataclasses

import numpy as np
import pytest
import torch

from tacotronv2_wavernn_chinese_tpu_torch.config import default_config
from tacotronv2_wavernn_chinese_tpu_torch.models import tacotron as T
from tacotronv2_wavernn_chinese_tpu_torch.train import tacotron_task as TT
from tacotronv2_wavernn_chinese_tpu_torch.utils import metrics as M
from tacotronv2_wavernn_chinese_tpu_torch.utils.checkpoints import init_tacotron


def _cfg(mode: str):
    cfg = default_config()
    return dataclasses.replace(cfg, tacotron=dataclasses.replace(
        cfg.tacotron, embedding_dim=16, enc_conv_channels=16, enc_conv_layers=2, encoder_lstm_units=16,
        attention_mode=mode, attention_dim=8, attention_filters=4, attention_kernel=7, prenet_layers=(16, 16),
        decoder_lstm_units=16, postnet_channels=16, postnet_layers=2))


def _batch(B=2, T_in=9, T_out=8):
    rng = np.random.default_rng(0)
    lens = np.asarray([T_out, T_out - 3], np.int32)[:B]
    b = {"inputs": rng.integers(1, 60, (B, T_in)).astype(np.int32),
         "input_lengths": np.asarray([T_in, 6], np.int32)[:B],
         "mel_targets": rng.uniform(-4, 4, (B, T_out, 80)).astype(np.float32),
         "stop_targets": (np.arange(T_out)[None] >= lens[:, None] - 1).astype(np.float32),
         "target_lengths": lens, "loss_frames": np.full((B,), T_out, np.int32)}
    return {k: torch.as_tensor(v) for k, v in b.items()}


def _step(cfg, T_out=8):
    params = init_tacotron(0, cfg.tacotron, device="cpu")
    state = TT.TrainState(0, params, TT.adam_init(params))
    return TT.train_step(state, _batch(T_out=T_out), torch.Generator().manual_seed(3), cfg)


@pytest.fixture(autouse=True)
def tracer_off():
    M.enable(False)
    M.drain()
    yield
    M.enable(False)
    M.drain()


def _decoder_spans():
    return [s for s in M.drain() if s["name"] == "tacotron.decoder"]


@pytest.mark.parametrize("mode, route", [("forward", "kernel"), ("lsa", "eager"), ("gmm", "eager")])
def test_a_training_step_records_its_route(mode, route):
    cfg = _cfg(mode)
    assert T.core_route(cfg.tacotron, True, 1.0) == route
    M.enable()
    _step(cfg)
    (s,) = _decoder_spans()
    assert s["attrs"] == {"route": route, "mode": mode, "rows": 2, "steps": 8, "positions": 9,
                          "graphed": False}


def test_an_autoregressive_decode_records_k2():
    cfg = _cfg("forward")
    params = init_tacotron(0, cfg.tacotron, device="cpu")
    ids, lens = torch.tensor([[5, 9, 30, 7], [4, 8, 0, 0]]), torch.tensor([4, 2])
    before = dict(M.counters()["decoder_steps"])
    M.enable()
    T.forward_inference(params, cfg.tacotron, ids, lens, [11, 12], max_iters=5)
    (s,) = _decoder_spans()
    assert s["attrs"] == {"route": "k2", "mode": "forward", "rows": 2, "steps": 5, "positions": 4,
                          "graphed": False}
    assert M.counters()["decoder_steps"] == dict(before, k2=before["k2"] + 5)


def test_decoder_steps_count_each_decode_by_route():
    steps = M.counters()["decoder_steps"]
    before = dict(steps)
    _step(_cfg("forward"), T_out=8)
    _step(_cfg("lsa"), T_out=16)
    _step(_cfg("lsa"), T_out=8)
    assert steps == dict(before, kernel=before["kernel"] + 8, eager=before["eager"] + 24)
    r3 = dataclasses.replace(_cfg("lsa"), tacotron=dataclasses.replace(_cfg("lsa").tacotron, outputs_per_step=3))
    _step(r3, T_out=12)  # r frames a step: 12 frames are 4 decoder steps
    assert steps["eager"] == before["eager"] + 28


class _Refuse:
    def __init__(self, *a, **k):
        raise AssertionError("tracing is off: nothing may be created")


def test_off_allocates_nothing_and_still_counts(monkeypatch):
    monkeypatch.setattr(M, "Span", _Refuse)
    monkeypatch.setattr(torch.cuda, "Event", _Refuse)
    monkeypatch.setattr(torch.cuda, "synchronize", _Refuse)
    before = dict(M.counters()["decoder_steps"])
    _step(_cfg("lsa"))
    _step(_cfg("forward"))
    assert M.drain() == []
    assert M.counters()["decoder_steps"] == dict(before, eager=before["eager"] + 8, kernel=before["kernel"] + 8)
