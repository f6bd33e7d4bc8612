"""Functional building blocks over plain params dicts.

Each function mirrors its counterpart in the JAX package's
``models/layers.py`` and takes the same ``[in, out]`` weight layout:

* the LSTM cell uses TF gate order (i, j, f, o) with forget-gate bias +1;
* zoneout mixes the carried state only: with binary keep-masks in train
  mode, as an EMA in eval mode;
* dropout (always on in the prenet) takes its keep-masks from the caller,
  or draws them from an explicit ``torch.Generator``;
* BatchNorm (TF eps 1e-3 on the Tacotron side) uses batch statistics in
  train mode and returns the momentum-0.99 moving averages;
* the GRU cell uses torch gate order (r, z, n).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

Params = dict


def dense(p: Params, x: torch.Tensor) -> torch.Tensor:
    y = x @ p["w"]
    if "b" in p:
        y = y + p["b"]
    return y


def _conv(p: Params, x: torch.Tensor, left: int, right: int) -> torch.Tensor:
    """[B, T, C_in] x w [W, C_in, C_out] -> [B, T', C_out] with explicit
    time padding (zeros)."""
    xt = F.pad(x.transpose(1, 2), (left, right))
    y = F.conv1d(xt, p["w"].permute(2, 1, 0)).transpose(1, 2)
    if "b" in p:
        y = y + p["b"]
    return y


def conv1d(p: Params, x: torch.Tensor) -> torch.Tensor:
    """SAME-padded 1-D convolution over [B, T, C] (TF/XLA padding: the extra
    pad of an even width goes on the right)."""
    width = p["w"].shape[0]
    left = (width - 1) // 2
    return _conv(p, x, left, width - 1 - left)


def conv1d_valid(p: Params, x: torch.Tensor) -> torch.Tensor:
    return _conv(p, x, 0, 0)


def batchnorm(p: Params, x: torch.Tensor, eps: float = 1e-3) -> torch.Tensor:
    """Eval-mode BatchNorm over the last axis (TF default eps 1e-3)."""
    return (x - p["mean"]) * torch.rsqrt(p["var"] + eps) * p["scale"] + p["bias"]


def batchnorm_train(p: Params, x: torch.Tensor, momentum: float = 0.99, eps: float = 1e-3):
    """Train-mode BatchNorm -> (y, updated params).  Statistics are taken
    over every axis but the last, padded positions included; the moving
    averages track the biased variance (tf.layers.batch_normalization).
    The updated statistics carry no gradient."""
    axes = tuple(range(x.dim() - 1))
    mean = x.mean(dim=axes)
    var = x.var(dim=axes, unbiased=False)
    new_p = dict(
        p,
        mean=(momentum * p["mean"] + (1 - momentum) * mean).detach(),
        var=(momentum * p["var"] + (1 - momentum) * var).detach(),
    )
    return (x - mean) * torch.rsqrt(var + eps) * p["scale"] + p["bias"], new_p


def keep_mask(shape, rate: float, generator: torch.Generator, device=None) -> torch.Tensor:
    """A boolean dropout keep-mask (True with probability 1 - rate) drawn
    from ``generator`` on its device."""
    device = generator.device if device is None else device
    return torch.rand(shape, generator=generator, device=device) < (1.0 - rate)


def dropout(x: torch.Tensor, rate: float, mask: torch.Tensor | None = None,
            generator: torch.Generator | None = None) -> torch.Tensor:
    """Inverted dropout from a keep-mask, or from one drawn from
    ``generator``; rate 0 is the identity."""
    if rate == 0.0:
        return x
    if mask is None:
        mask = keep_mask(x.shape, rate, generator, x.device)
    return torch.where(mask, x / (1.0 - rate), torch.zeros_like(x))


def _lstm_gates(z: torch.Tensor, c: torch.Tensor):
    i, j, f, o = torch.chunk(z, 4, dim=-1)
    new_c = torch.sigmoid(f + 1.0) * c + torch.sigmoid(i) * torch.tanh(j)
    new_h = torch.sigmoid(o) * torch.tanh(new_c)
    return new_c, new_h


def lstm_step(p: Params, x: torch.Tensor, c: torch.Tensor, h: torch.Tensor):
    """One LSTM step; gate order (i, j, f, o), forget bias 1.0 (TF LSTMCell)."""
    z = torch.cat([x, h], dim=-1) @ p["w"] + p["b"]
    return _lstm_gates(z, c)


def zoneout_eval(new: torch.Tensor, prev: torch.Tensor, rate: float) -> torch.Tensor:
    """Eval-mode zoneout: a deterministic EMA of the carried state."""
    if rate == 0.0:
        return new
    return (1.0 - rate) * new + rate * prev


def zoneout_train(new: torch.Tensor, prev: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Train-mode zoneout: keep the state delta where ``mask`` is set
    (reference modules.py:131-138)."""
    return torch.where(mask.bool(), new - prev, torch.zeros_like(new)) + prev


def zoneout_lstm_step(p: Params, x, c, h, rate: float, zx=None, masks=None):
    """Returns ``(c_carry, h_carry, out)``: zoneout mixes only the carried
    state, the raw ``new_h`` goes downstream (reference modules.py:114-142).
    ``zx`` is the precomputed input half of the gate matmul; ``masks``
    (cell, hidden keep-masks) select train-mode zoneout, None eval mode."""
    if zx is not None:
        units = h.shape[-1]
        z = zx + h @ p["w"][p["w"].shape[0] - units:] + p["b"]
        new_c, new_h = _lstm_gates(z, c)
    else:
        new_c, new_h = lstm_step(p, x, c, h)
    if masks is not None and rate > 0.0:
        return zoneout_train(new_c, c, masks[0]), zoneout_train(new_h, h, masks[1]), new_h
    return zoneout_eval(new_c, c, rate), zoneout_eval(new_h, h, rate), new_h


def reverse_sequence(xs: torch.Tensor, lengths: torch.Tensor | None) -> torch.Tensor:
    """Reverse each sequence within its own valid length (positions past it
    stay in place), like tf.reverse_sequence."""
    if lengths is None:
        return torch.flip(xs, dims=[1])
    T = xs.shape[1]
    ar = torch.arange(T, device=xs.device)[None, :]
    idx = lengths.to(xs.device)[:, None].long() - 1 - ar
    idx = torch.where(idx >= 0, idx, ar)
    return torch.gather(xs, 1, idx[..., None].expand(-1, -1, xs.shape[-1]))


def unidir_lstm(
    p: Params,
    xs: torch.Tensor,
    units: int,
    zoneout_rate: float = 0.0,
    reverse: bool = False,
    lengths: torch.Tensor | None = None,
    masks=None,
) -> torch.Tensor:
    """LSTM over [B, T, D] -> [B, T, units]; with ``reverse`` and
    ``lengths`` it is tf.nn.bidirectional_dynamic_rnn's backward pass.
    ``masks`` (cell, hidden) zoneout keep-masks [T, B, units], indexed by
    loop step (after the per-length reversal), select train mode."""
    B, T, D = xs.shape
    if reverse:
        xs = reverse_sequence(xs, lengths)
    zx_all = xs.transpose(0, 1) @ p["w"][:D]  # [T, B, 4H]
    c = xs.new_zeros(B, units)
    h = xs.new_zeros(B, units)
    outs = []
    for t in range(T):
        m = None if masks is None else (masks[0][t], masks[1][t])
        c, h, out = zoneout_lstm_step(p, None, c, h, zoneout_rate, zx=zx_all[t], masks=m)
        outs.append(out)
    hs = torch.stack(outs, dim=1)
    if reverse:
        hs = reverse_sequence(hs, lengths)
    return hs


def gru_step_from_gates(p: Params, gi: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
    """torch.nn.GRUCell semantics from a precomputed input projection
    ``gi = x @ wi + bi``: n = tanh(gi_n + r * (h @ wh + bh)_n)."""
    gh = h @ p["wh"] + p["bh"]
    H = h.shape[-1]
    r = torch.sigmoid(gi[..., :H] + gh[..., :H])
    z = torch.sigmoid(gi[..., H:2 * H] + gh[..., H:2 * H])
    n = torch.tanh(gi[..., 2 * H:] + r * gh[..., 2 * H:])
    return (1.0 - z) * n + z * h


def prenet(p: Params, x: torch.Tensor, rate: float, masks=None) -> torch.Tensor:
    """Prenet with always-on dropout (reference modules.py:220-251).

    ``masks`` holds one boolean keep-mask per layer, shaped like that
    layer's output; None (or rate 0) applies no dropout."""
    for i, lp in enumerate(p["layers"]):
        x = torch.relu(dense(lp, x))
        if masks is not None and rate > 0.0:
            x = torch.where(masks[i], x / (1.0 - rate), torch.zeros_like(x))
    return x


def prenet_masks(p: Params, rate: float, shape_prefix, generator: torch.Generator):
    """One keep-mask per prenet layer, shaped ``shape_prefix + (width,)``,
    drawn from ``generator``; None when rate is 0."""
    if rate == 0.0:
        return None
    return tuple(
        keep_mask(tuple(shape_prefix) + (lp["w"].shape[1],), rate, generator)
        for lp in p["layers"]
    )


def conv_stack(p: Params, x: torch.Tensor, activations=None) -> torch.Tensor:
    """Eval-mode conv -> activation -> BN stack (reference modules.py:379-391);
    ``activations`` defaults to ReLU on every layer, None entries are linear."""
    return _conv_stack(p, x, activations, False, 0.0, None)[0]


def conv_stack_train(p: Params, x: torch.Tensor, rate: float, masks=None, activations=None):
    """Train-mode conv -> activation -> BN (batch statistics) -> dropout
    stack; ``masks`` holds one keep-mask per layer (None: no dropout).
    Returns (y, params with the updated BN statistics)."""
    return _conv_stack(p, x, activations, True, rate, masks)


def _conv_stack(p, x, activations, train, rate, masks):
    new_layers = []
    for i, lp in enumerate(p["layers"]):
        act = torch.relu if activations is None else activations[i]
        y = conv1d(lp["conv"], x)
        if act is not None:
            y = act(y)
        if train:
            y, bn = batchnorm_train(lp["bn"], y)
            if masks is not None:
                y = dropout(y, rate, mask=masks[i])
        else:
            y, bn = batchnorm(lp["bn"], y), lp["bn"]
        new_layers.append(dict(lp, bn=bn))
        x = y
    return x, {"layers": new_layers}
