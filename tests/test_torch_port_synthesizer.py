"""The port's synthesizer trims each alignment at its stop, in decoder steps.

With r frames per decoder step, a row that stops after n frames ran
ceil(n / r) steps, so its alignment keeps [: ceil(n / r)] steps (the JAX
synthesizer's rule, infer/synthesizer.py ``mel_from_ids``), and its mel
keeps n frames.  ``forward_inference`` is stubbed to outputs of known
values at r = 1, 2 and 3 (tests/test_torch_port_decode_configs.py runs an
r = 3 decode end to end against the JAX synthesizer)."""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

from tacotronv2_wavernn_chinese_tpu_torch.config import default_config
from tacotronv2_wavernn_chinese_tpu_torch.infer import synthesizer as SY
from tacotronv2_wavernn_chinese_tpu_torch.models import tacotron as T
from tacotronv2_wavernn_chinese_tpu_torch.utils.checkpoints import init_tacotron


def _synth():
    cfg = default_config()
    tiny = dataclasses.replace(
        cfg.tacotron, embedding_dim=16, enc_conv_channels=16, enc_conv_layers=1, encoder_lstm_units=8,
        attention_dim=8, attention_filters=4, attention_kernel=5, prenet_layers=(8, 8),
        decoder_lstm_units=8, postnet_channels=8, postnet_layers=1,
    )
    cfg = dataclasses.replace(cfg, tacotron=tiny)
    return SY.Synthesizer(cfg, init_tacotron(0, tiny), device="cpu")


@pytest.mark.parametrize("r", [1, 2, 3])
def test_alignments_are_trimmed_to_decoder_steps(monkeypatch, r):
    synth = _synth()
    synth.cfg = dataclasses.replace(synth.cfg, tacotron=dataclasses.replace(synth.cfg.tacotron, outputs_per_step=r))
    stop_len = [7, 4, 12]
    steps, T_in = 4, 16  # 4 decoder steps of r frames
    seen = {}

    def forward_inference(params, cfg, inputs, input_lengths, seeds, max_iters):
        B = inputs.shape[0]
        seen["T_in"] = inputs.shape[1]
        frames = torch.arange(B * steps * r * 80, dtype=torch.float32).reshape(B, steps * r, 80)
        aligns = torch.arange(B * steps * T_in, dtype=torch.float32).reshape(B, steps, T_in)
        n = torch.as_tensor([min(x, steps * r) for x in stop_len], dtype=torch.int32)
        return T.TacotronOutput(frames, frames + 1.0, torch.zeros(B, steps * r), aligns, n)

    monkeypatch.setattr(T, "forward_inference", forward_inference)
    ids = [[3] * 5, [4] * 9, [5] * 2]
    mels, aligns, stops = synth.mel_from_ids(ids, seed=[0, 1, 2])
    assert seen["T_in"] == T_in
    for i, ids_i in enumerate(ids):
        n = min(stop_len[i], steps * r)
        assert stops[i] == n
        assert mels[i].shape == (n, 80)
        want = -(-n // r)
        assert aligns[i].shape == (want, len(ids_i))
        full = np.arange(3 * steps * T_in, dtype=np.float32).reshape(3, steps, T_in)
        np.testing.assert_array_equal(aligns[i], full[i, :want, : len(ids_i)])
