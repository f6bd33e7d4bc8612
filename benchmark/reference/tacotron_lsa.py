"""Tacotron-2 with location-sensitive attention, as published (Shen et al.,
"Natural TTS Synthesis by Conditioning WaveNet on Mel Spectrogram
Predictions", ICASSP 2018, arXiv:1712.05884, sections 2.2-2.4), in plain
PyTorch: the teacher-forced training forward of one batch, written from
the paper and from the ``LocationSensitiveAttention`` of the recipe it
descends from (github.com/Rayhane-mamah/Tacotron-2).

One decoder step t, for each row:

* the prenet's output of frame t - 1 (zeros at t = 0), joined to the
  previous context, feeds LSTM 1, whose raw output feeds LSTM 2; both
  carry their state under zoneout;
* the query is LSTM 2's raw output; the location features are the
  alignments cumulated over the steps before t (all zero at t = 0), put
  through 32 filters of width 31 and a dense 32 -> 128 without bias;
* e = v . tanh(W q + V h + U f + b), -1e9 outside the row's symbols, and a
  softmax over the symbols gives the alignment, which is added to the
  cumulated alignments (with ``cumulative_weights`` false it replaces
  them);
* the context is the alignment's sum of the encoder outputs, and the
  frame and stop projections read [query, context].

The encoder, the masks, zoneout, the postnet and the loss are
``reference/tacotron.py``'s.  Departures from the paper, all the
recipe's: ReLU before BatchNorm in the encoder's convolutions; the LSTM
forget bias +1 (TensorFlow's LSTMCell); attention reads LSTM 2's output
of step t and its context is projected at t and fed to step t + 1; the
location convolution has a bias; the decoder's frames are clipped to
[-4.1, 4]; the stop token's loss is over each row's frames up to the
batch's longest, without a weight on the positive class; BatchNorm's
statistics include the padding.  The location convolution and dense are
multiplied into one filter in float64 (both are linear).  TF32 is off
(``precision``).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from . import tacotron as RT

draw_masks = RT.draw_masks
loss = RT.loss


def encode_train(p, cfg, inputs, lengths, masks, stats):
    """The train-mode encoder -> memory [B, T_in, 2 * units], zero past each
    row's symbols; the BatchNorm statistics go to ``stats``."""
    rate = cfg["dropout_rate"]
    x = p["embedding"][inputs.long()]
    for k, lp in enumerate(p["enc_convs"]["layers"]):
        x, stats[("enc_convs", k)] = RT.bn_train(lp["bn"], torch.relu(RT.conv_same(lp["conv"], x)))
        x = RT.drop(x, masks["enc_drop"][k], rate)
    fw = RT.lstm_train(p["enc_lstm_fw"], x, masks["enc_fw"])
    bw = RT.reverse_within(RT.lstm_train(p["enc_lstm_bw"], RT.reverse_within(x, lengths), masks["enc_bw"]), lengths)
    valid = (torch.arange(inputs.shape[1], device=x.device)[None, :] < lengths[:, None]).to(torch.float32)
    return torch.cat([fw, bw], dim=-1) * valid[..., None], valid


def postnet_train(p, cfg, frames, masks, stats):
    """The train-mode postnet and its residual -> the clipped mel."""
    y = frames
    layers = p["postnet"]["layers"]
    for k, lp in enumerate(layers):
        z = RT.conv_same(lp["conv"], y)
        if k < len(layers) - 1:
            z = torch.tanh(z)
        y, stats[("postnet", k)] = RT.bn_train(lp["bn"], z)
        y = RT.drop(y, masks["post_drop"][k], cfg["dropout_rate"])
    return RT.clip_mel(frames + RT.dense(p["postnet_projection"], y), cfg)


def train_forward(p, cfg, batch: dict, masks: dict):
    """One teacher-forced training forward -> (decoder frames, mel, stop
    logits, the BatchNorm moving statistics it updates {path: stats})."""
    inputs, lengths, mels = batch["inputs"], batch["input_lengths"], batch["mel_targets"]
    B, T_in = inputs.shape
    T_out = mels.shape[1]
    rate = cfg["dropout_rate"]
    stats = {}
    memory, valid = encode_train(p, cfg, inputs, lengths, masks, stats)
    att = p["attention"]
    keys = memory @ att["memory_layer"]["w"]
    w_loc, b_loc = RT.location_filter(att)
    taps = w_loc.shape[0]
    left = (taps - 1) // 2
    dec_in = torch.cat([mels.new_zeros(B, 1, mels.shape[-1]), mels[:, :-1]], dim=1).transpose(0, 1)
    pre = dec_in
    for lp, m in zip(p["prenet"]["layers"], masks["pre"]):
        pre = RT.drop(torch.relu(RT.dense(lp, pre)), m, rate)
    U = cfg["decoder_lstm_units"]
    c1 = h1 = c2 = h2 = memory.new_zeros(B, U)
    ctx = memory.new_zeros(B, memory.shape[-1])
    cum = memory.new_zeros(B, T_in)
    outs = []
    for t in range(T_out):
        c1n, h1n = RT.lstm_cell(p["dec_lstm1"], torch.cat([pre[t], ctx], dim=-1), c1, h1)
        c2n, h2n = RT.lstm_cell(p["dec_lstm2"], h1n, c2, h2)
        c1, h1 = RT.zoneout(c1n, c1, masks["z1"][0][t]), RT.zoneout(h1n, h1, masks["z1"][1][t])
        c2, h2 = RT.zoneout(c2n, c2, masks["z2"][0][t]), RT.zoneout(h2n, h2, masks["z2"][1][t])
        q = h2n
        loc = F.conv1d(F.pad(cum[:, None, :], (left, taps - 1 - left)), w_loc.t()[:, None, :]).transpose(1, 2)
        energy = torch.tanh(keys + (q @ att["query_layer"]["w"])[:, None, :] + loc + b_loc + att["b"]) @ att["v"]
        energy = torch.where(valid > 0, energy, torch.full_like(energy, -1e9))
        a = torch.softmax(energy, dim=-1)
        cum = cum + a if cfg["cumulative_weights"] else a
        ctx = torch.einsum("bt,btv->bv", a, memory)
        outs.append(torch.cat([q, ctx], dim=-1))
    proj_in = torch.stack(outs, dim=1)
    frames = RT.clip_mel(RT.dense(p["frame_projection"], proj_in), cfg)
    stops = RT.dense(p["stop_projection"], proj_in)[..., 0]
    mel = postnet_train(p, cfg, frames, masks, stats)
    return frames, mel, stops, stats
