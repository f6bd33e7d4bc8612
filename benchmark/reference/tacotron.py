"""Tacotron-2 with forward attention, r = 1, in plain PyTorch (Shen et al.
2018; the forward attention of Zhang et al. 2018 as the lturing recipe
configures it): the equations of the configuration, written out for one
utterance at a time.

Weights are a nested dict with ``[in, out]`` matrices and ``[width, in,
out]`` convolutions; the LSTM gates are (i, j, f, o) with a forget bias of
+1 (TensorFlow's LSTMCell); BatchNorm has eps 1e-3; zoneout at inference
is the expectation (1 - z) new + z old of the carried state.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from . import rng

NUM_MELS = 80


def dense(p, x):
    y = x @ p["w"]
    return y + p["b"] if "b" in p else y


def conv_same(p, x):
    """[T, C_in] or [B, T, C_in] * w [W, C_in, C_out], SAME padding (the
    extra pad of an even width on the right)."""
    if x.dim() == 2:
        return conv_same(p, x[None])[0]
    W = p["w"].shape[0]
    left = (W - 1) // 2
    y = F.conv1d(F.pad(x.transpose(1, 2), (left, W - 1 - left)), p["w"].permute(2, 1, 0)).transpose(1, 2)
    return y + p["b"] if "b" in p else y


def bn_eval(p, x, eps=1e-3):
    return (x - p["mean"]) / torch.sqrt(p["var"] + eps) * p["scale"] + p["bias"]


def lstm_cell(p, x, c, h):
    z = torch.cat([x, h], dim=-1) @ p["w"] + p["b"]
    i, j, f, o = torch.chunk(z, 4, dim=-1)
    c_new = torch.sigmoid(f + 1.0) * c + torch.sigmoid(i) * torch.tanh(j)
    return c_new, torch.sigmoid(o) * torch.tanh(c_new)


def encode(p, cfg, ids: torch.Tensor, length: int) -> torch.Tensor:
    """ids [T_in] (padded with 0 past ``length``, as the batch it was served
    in) -> memory [T_in, 2 * units], zero past ``length``."""
    x = p["embedding"][ids.long()]
    for lp in p["enc_convs"]["layers"]:
        x = bn_eval(lp["bn"], torch.relu(conv_same(lp["conv"], x)))
    z = cfg["zoneout_rate"]
    units = cfg["encoder_lstm_units"]
    T_in = x.shape[0]

    def run(pl, xs):
        c = xs.new_zeros(units)
        h = xs.new_zeros(units)
        outs = []
        for t in range(xs.shape[0]):
            c_new, h_new = lstm_cell(pl, xs[t], c, h)
            outs.append(h_new)
            c, h = (1 - z) * c_new + z * c, (1 - z) * h_new + z * h
        return torch.stack(outs)

    fw = run(p["enc_lstm_fw"], x)
    # the backward direction reads each sequence reversed within its length
    bw = torch.flip(run(p["enc_lstm_bw"], torch.flip(x[:length], [0])), [0])
    if length < T_in:
        bw = torch.cat([bw, x.new_zeros(T_in - length, units)])
    mem = torch.cat([fw, bw], dim=-1)
    mem[length:] = 0.0
    return mem


def location_filter(att):
    """The location convolution (1 -> F) and the location dense (F -> A)
    as one convolution 1 -> A, multiplied in float64."""
    w = (att["location_conv"]["w"][:, 0, :].double() @ att["location_layer"]["w"].double()).float()
    b = (att["location_conv"]["b"].double() @ att["location_layer"]["w"].double()).float()
    return w, b


def prenet_masks(seed: int, steps: int, widths, rate: float, device) -> list:
    """The prenet's keep-masks of steps [0, steps): bits(seed, 0, step,
    lane) below the keep threshold, lanes [0, p1) for the first layer and
    [p1, p1 + p2) for the second -> [[steps, p1], [steps, p2]]."""
    lanes = torch.arange(sum(widths), device=device, dtype=torch.int64)[None, :]
    t = torch.arange(steps, device=device, dtype=torch.int64)[:, None]
    seed_t = torch.tensor(int(seed) & rng.M32, device=device)
    keep = rng.bits(seed_t, 0, t, lanes) < rng.keep_threshold(rate)
    return [keep[:, : widths[0]], keep[:, widths[0]:]]


def decode_teacher_forced(p, cfg, memory: torch.Tensor, length: int, frames_in: torch.Tensor, seed: int):
    """The decoder fed ``frames_in`` [T, 80] (frame t - 1 feeds step t;
    zeros feed step 0) -> (frames [T, 80], stop logits [T], alignments
    [T, T_in]).  The prenet's dropout is drawn from the request's seed."""
    att = p["attention"]
    T_in = memory.shape[0]
    dev = memory.device
    mask = torch.arange(T_in, device=dev) < length
    keys = memory @ att["memory_layer"]["w"]
    w_loc, b_loc = location_filter(att)
    taps = w_loc.shape[0]
    u = cfg["decoder_lstm_units"]
    z = cfg["zoneout_rate"]
    rate = cfg["dropout_rate"]
    widths = [lp["w"].shape[1] for lp in p["prenet"]["layers"]]
    c1 = h1 = c2 = h2 = memory.new_zeros(u)
    context = memory.new_zeros(memory.shape[1])
    alpha = memory.new_zeros(T_in)
    alpha[0] = 1.0
    cumulated = alpha.clone()
    mu = memory.new_full((1,), 0.5)
    prev = memory.new_zeros(NUM_MELS)
    frames, stops, aligns = [], [], []
    masks = prenet_masks(seed, frames_in.shape[0], widths, rate, dev)
    for t in range(frames_in.shape[0]):
        x = prev
        for lp, m in zip(p["prenet"]["layers"], masks):
            x = torch.relu(dense(lp, x))
            x = torch.where(m[t], x / (1.0 - rate), torch.zeros_like(x))
        c1n, h1n = lstm_cell(p["dec_lstm1"], torch.cat([x, context]), c1, h1)
        c2n, h2n = lstm_cell(p["dec_lstm2"], h1n, c2, h2)
        c1, h1 = (1 - z) * c1n + z * c1, (1 - z) * h1n + z * h1
        c2, h2 = (1 - z) * c2n + z * c2, (1 - z) * h2n + z * h2
        query = h2n
        loc = F.conv1d(F.pad(cumulated[None, None], ((taps - 1) // 2, taps - 1 - (taps - 1) // 2)),
                       w_loc.t()[:, None, :])[0].t() + b_loc
        energy = torch.tanh(keys + query @ att["query_layer"]["w"] + loc + att["b"]) @ att["v"]
        energy = torch.where(mask, energy, torch.full_like(energy, -1e9))
        a_sm = torch.softmax(energy, dim=-1)
        cumulated = cumulated + a_sm
        shifted = F.pad(alpha, (1, 0))[:-1]
        a = ((1.0 - mu) * alpha + mu * shifted + 1e-10) * a_sm
        a = a / a.sum()
        context = a @ memory
        mu = torch.sigmoid(dense(att["mu_layer"], torch.cat([context, query])))
        alpha = a
        out = torch.cat([query, context])
        frames.append(dense(p["frame_projection"], out))
        stops.append(dense(p["stop_projection"], out)[0])
        aligns.append(a)
        prev = frames_in[t]
    return torch.stack(frames), torch.stack(stops), torch.stack(aligns)


def clip_mel(x, cfg):
    if not cfg["clip_outputs"]:
        return x
    return torch.clamp(x, -4.0 - cfg["lower_bound_decay"], 4.0)


def postnet(p, cfg, frames: torch.Tensor) -> torch.Tensor:
    """frames [T, 80] (clipped decoder output) -> the clipped mel: five
    convolutions (tanh on all but the last), each then BatchNorm, a
    projection, and the residual."""
    x = frames
    layers = p["postnet"]["layers"]
    for k, lp in enumerate(layers):
        y = conv_same(lp["conv"], x)
        if k < len(layers) - 1:
            y = torch.tanh(y)
        x = bn_eval(lp["bn"], y)
    return clip_mel(frames + dense(p["postnet_projection"], x), cfg)


# ---------------------------------------------------------------------------
# training: one batch, teacher-forced, with the train-mode randomness
# ---------------------------------------------------------------------------


def draw_masks(cfg, B: int, T_in: int, T_out: int, gen: torch.Generator) -> dict:
    """Every keep-mask of one training forward, drawn from ``gen`` (uniform
    draws below 1 - rate) in the order the recipe's step draws them: the
    prenet's per layer [T, B, width]; the encoder convolutions' dropout
    [B, T_in, C] per layer; zoneout (cell, hidden) [T_in, B, units] of the
    forward and the backward encoder LSTM, then [T, B, units] of both
    decoder LSTMs; the postnet's dropout [B, T, C] per layer."""
    rate, zr = cfg["dropout_rate"], cfg["zoneout_rate"]
    keep = lambda shape, r: torch.rand(shape, generator=gen, device=gen.device) < (1.0 - r)
    u, U = cfg["encoder_lstm_units"], cfg["decoder_lstm_units"]
    return {
        "pre": [keep((T_out, B, w), rate) for w in cfg["prenet_layers"]],
        "enc_drop": [keep((B, T_in, cfg["enc_conv_channels"]), rate) for _ in range(cfg["enc_conv_layers"])],
        "enc_fw": (keep((T_in, B, u), zr), keep((T_in, B, u), zr)),
        "enc_bw": (keep((T_in, B, u), zr), keep((T_in, B, u), zr)),
        "z1": (keep((T_out, B, U), zr), keep((T_out, B, U), zr)),
        "z2": (keep((T_out, B, U), zr), keep((T_out, B, U), zr)),
        "post_drop": [keep((B, T_out, cfg["postnet_channels"]), rate) for _ in range(cfg["postnet_layers"])],
    }


def bn_train(p, x, eps=1e-3, momentum=0.99):
    """Batch statistics over every position, padding included (biased
    variance) -> (y, the moving mean and variance updated)."""
    dims = tuple(range(x.dim() - 1))
    mean = x.mean(dim=dims)
    var = ((x - mean) ** 2).mean(dim=dims)
    new = {"mean": (momentum * p["mean"] + (1 - momentum) * mean).detach(),
           "var": (momentum * p["var"] + (1 - momentum) * var).detach()}
    return (x - mean) / torch.sqrt(var + eps) * p["scale"] + p["bias"], new


def drop(x, keep, rate):
    return torch.where(keep, x / (1.0 - rate), torch.zeros_like(x))


def zoneout(new, old, keep):
    """Train-mode zoneout: the update is kept where ``keep`` is set."""
    return torch.where(keep, new - old, torch.zeros_like(new)) + old


def reverse_within(x, lengths):
    """Reverse each row's first ``length`` positions, the rest in place."""
    T = x.shape[1]
    ar = torch.arange(T, device=x.device)[None, :]
    idx = lengths[:, None].long() - 1 - ar
    idx = torch.where(idx >= 0, idx, ar)
    return torch.gather(x, 1, idx[..., None].expand(-1, -1, x.shape[-1]))


def lstm_train(p, x, masks):
    """[B, T, D] -> [B, T, units] outputs (the raw new h), zoneout carried."""
    B, T, _ = x.shape
    units = p["b"].shape[0] // 4
    c = h = x.new_zeros(B, units)
    outs = []
    for t in range(T):
        c_new, h_new = lstm_cell(p, x[:, t], c, h)
        outs.append(h_new)
        c, h = zoneout(c_new, c, masks[0][t]), zoneout(h_new, h, masks[1][t])
    return torch.stack(outs, dim=1)


def train_forward(p, cfg, batch: dict, masks: dict):
    """One teacher-forced training forward -> (decoder frames, mel, stop
    logits, the BatchNorm moving statistics it updates {path: stats})."""
    inputs, lengths, mels = batch["inputs"], batch["input_lengths"], batch["mel_targets"]
    B, T_in = inputs.shape
    T_out = mels.shape[1]
    rate = cfg["dropout_rate"]
    stats = {}
    x = p["embedding"][inputs.long()]
    for k, lp in enumerate(p["enc_convs"]["layers"]):
        x, stats[("enc_convs", k)] = bn_train(lp["bn"], torch.relu(conv_same(lp["conv"], x)))
        x = drop(x, masks["enc_drop"][k], rate)
    fw = lstm_train(p["enc_lstm_fw"], x, masks["enc_fw"])
    bw = reverse_within(lstm_train(p["enc_lstm_bw"], reverse_within(x, lengths), masks["enc_bw"]), lengths)
    valid = (torch.arange(T_in, device=x.device)[None, :] < lengths[:, None]).to(torch.float32)
    memory = torch.cat([fw, bw], dim=-1) * valid[..., None]
    att = p["attention"]
    keys = memory @ att["memory_layer"]["w"]
    w_loc, b_loc = location_filter(att)
    taps = w_loc.shape[0]
    left = (taps - 1) // 2
    dec_in = torch.cat([mels.new_zeros(B, 1, mels.shape[-1]), mels[:, :-1]], dim=1).transpose(0, 1)
    pre = dec_in
    for lp, m in zip(p["prenet"]["layers"], masks["pre"]):
        pre = drop(torch.relu(dense(lp, pre)), m, rate)
    U = cfg["decoder_lstm_units"]
    c1 = h1 = c2 = h2 = memory.new_zeros(B, U)
    ctx = memory.new_zeros(B, memory.shape[-1])
    alpha = memory.new_zeros(B, T_in)
    alpha[:, 0] = 1.0
    cum = alpha.clone()
    mu = memory.new_full((B, 1), 0.5)
    outs = []
    for t in range(T_out):
        c1n, h1n = lstm_cell(p["dec_lstm1"], torch.cat([pre[t], ctx], dim=-1), c1, h1)
        c2n, h2n = lstm_cell(p["dec_lstm2"], h1n, c2, h2)
        c1, h1 = zoneout(c1n, c1, masks["z1"][0][t]), zoneout(h1n, h1, masks["z1"][1][t])
        c2, h2 = zoneout(c2n, c2, masks["z2"][0][t]), zoneout(h2n, h2, masks["z2"][1][t])
        q = h2n
        loc = F.conv1d(F.pad(cum[:, None, :], (left, taps - 1 - left)), w_loc.t()[:, None, :]).transpose(1, 2)
        energy = torch.tanh(keys + (q @ att["query_layer"]["w"])[:, None, :] + loc + b_loc + att["b"]) @ att["v"]
        energy = torch.where(valid > 0, energy, torch.full_like(energy, -1e9))
        a_sm = torch.softmax(energy, dim=-1)
        cum = cum + a_sm
        a = ((1.0 - mu) * alpha + mu * F.pad(alpha, (1, 0))[:, :-1] + 1e-10) * a_sm
        a = a / a.sum(dim=-1, keepdim=True)
        ctx = torch.einsum("bt,btv->bv", a, memory)
        mu = torch.sigmoid(dense(att["mu_layer"], torch.cat([ctx, q], dim=-1)))
        alpha = a
        outs.append(torch.cat([q, ctx], dim=-1))
    proj_in = torch.stack(outs, dim=1)
    frames = clip_mel(dense(p["frame_projection"], proj_in), cfg)
    stops = dense(p["stop_projection"], proj_in)[..., 0]
    y = frames
    layers = p["postnet"]["layers"]
    for k, lp in enumerate(layers):
        z = conv_same(lp["conv"], y)
        if k < len(layers) - 1:
            z = torch.tanh(z)
        y, stats[("postnet", k)] = bn_train(lp["bn"], z)
        y = drop(y, masks["post_drop"][k], rate)
    mel = clip_mel(frames + dense(p["postnet_projection"], y), cfg)
    return frames, mel, stops, stats


L2_SKIP_TOP = {"embedding", "enc_lstm_fw", "enc_lstm_bw", "dec_lstm1", "dec_lstm2", "frame_projection",
               "stop_projection", "postnet_projection", "linear_projection"}


def l2_leaves(p, path=()):
    """The regularised weights: not the embedding, the LSTM kernels, the
    projections, biases, attention's v, or BatchNorm's moving statistics."""
    if isinstance(p, dict):
        for k, v in p.items():
            yield from l2_leaves(v, path + (k,))
    elif isinstance(p, (list, tuple)):
        for i, v in enumerate(p):
            yield from l2_leaves(v, path + (str(i),))
    else:
        name = path[-1]
        if path[0] in L2_SKIP_TOP:
            return
        if "bn" in path:
            if name in ("mean", "var"):
                return
        elif name in ("b", "bias", "v"):
            return
        yield p


def loss(p, cfg, batch, frames, mel, stops, reg_weight: float):
    """Mean squared error before and after the postnet and the stop
    cross-entropy over each row's first ``loss_frames`` frames, plus
    reg_weight x the L2 of the regularised weights."""
    T = batch["mel_targets"].shape[1]
    fmask = (torch.arange(T, device=frames.device)[None, :] < batch["loss_frames"][:, None]).to(torch.float32)
    n = torch.clamp_min(fmask.sum(), 1.0)
    M = frames.shape[-1]
    tgt = batch["mel_targets"]
    before = (((frames - tgt) ** 2) * fmask[..., None]).sum() / (n * M)
    after = (((mel - tgt) ** 2) * fmask[..., None]).sum() / (n * M)
    st = batch["stop_targets"]
    ce = (1.0 - st) * stops + torch.log1p(torch.exp(-torch.abs(stops))) + torch.relu(-stops)
    stop = (ce * fmask).sum() / n
    reg = reg_weight * sum(0.5 * (w ** 2).sum() for w in l2_leaves(p))
    return before + after + stop + reg
