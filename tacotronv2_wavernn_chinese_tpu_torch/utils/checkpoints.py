"""The weight bridge (flat npz files <-> nested dicts of torch tensors) and
training checkpoints.

The JAX package exports its parameters as nested dicts/lists of arrays in a
flat ``.npz`` (``save_params_npz`` below writes the same format, key
``a/b/0/w`` for ``tree["a"]["b"][0]["w"]``).  The port keeps that tree and
its ``[in, out]`` dense layout as is; only the leaves become f32 torch
tensors on the chosen device.

``init_tacotron`` / ``init_wavernn`` build trees with the shapes of the JAX
inits (same initializer families, numpy draws from an explicit seed) so
full-width random weights can be made without JAX.

``CheckpointManager`` keeps step-keyed training checkpoints (step, params
and Adam state in one ``torch.save`` file each), in place of the JAX
package's Orbax manager.
"""

from __future__ import annotations

import os
import re
from typing import Any

import numpy as np
import torch

from ..config import TacotronModelConfig, WaveRNNModelConfig
from . import tree_map

Params = dict


# ---------------------------------------------------------------------------
# flat npz
# ---------------------------------------------------------------------------


def save_params_npz(path: str, params: Any) -> None:
    """Flat single-file export; torch tensors are written as numpy arrays."""
    flat = {}

    def walk(tree, prefix):
        if isinstance(tree, dict):
            for k, v in tree.items():
                walk(v, f"{prefix}/{k}" if prefix else k)
        elif isinstance(tree, (list, tuple)):
            for i, v in enumerate(tree):
                walk(v, f"{prefix}/{i}")
        elif isinstance(tree, torch.Tensor):
            flat[prefix] = tree.detach().cpu().numpy()
        else:
            flat[prefix] = np.asarray(tree)

    walk(params, "")
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    np.savez(path, **flat)


def load_params_npz(path: str) -> dict:
    """Inverse of save_params_npz: rebuild the nested dict/list tree."""
    data = np.load(path)
    tree: dict = {}
    for key in data.files:
        parts = key.split("/")
        node = tree
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = data[key]

    def listify(node):
        if isinstance(node, dict):
            keys = list(node.keys())
            if keys and all(k.isdigit() for k in keys):
                return [listify(node[str(i)]) for i in range(len(keys))]
            return {k: listify(v) for k, v in node.items()}
        return node

    return listify(tree)


# ---------------------------------------------------------------------------
# training checkpoints
# ---------------------------------------------------------------------------


class CheckpointManager:
    """One file per saved step, ``ckpt-<step>.pt`` under ``directory``,
    holding {"step", "params", "opt_state"} with CPU tensors.  A save is
    written to a temporary name and renamed, so a file that exists is
    whole; the newest ``max_to_keep`` are kept (reference
    tf.train.Saver(max_to_keep=20), tacotron/train.py:127)."""

    _NAME = re.compile(r"^ckpt-(\d+)\.pt$")

    def __init__(self, directory: str, max_to_keep: int = 20):
        self.directory = os.path.abspath(directory)
        self.max_to_keep = max_to_keep
        os.makedirs(self.directory, exist_ok=True)

    def _path(self, step: int) -> str:
        return os.path.join(self.directory, f"ckpt-{step}.pt")

    def all_steps(self) -> list[int]:
        steps = []
        for name in os.listdir(self.directory):
            m = self._NAME.match(name)
            if m:
                steps.append(int(m.group(1)))
        return sorted(steps)

    def latest_step(self) -> int | None:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def save(self, step: int, params: Any, opt_state: Any) -> None:
        cpu = lambda t: _tree_to(t, torch.device("cpu"))
        blob = {"step": int(step), "params": cpu(params), "opt_state": cpu(opt_state)}
        tmp = self._path(step) + ".tmp"
        torch.save(blob, tmp)
        os.replace(tmp, self._path(step))
        for old in self.all_steps()[:-self.max_to_keep]:
            os.remove(self._path(old))

    def restore(self, device, step: int | None = None) -> dict | None:
        """The checkpoint at ``step`` (default: the latest) with its tensors
        on ``device``, or None when there is none."""
        step = self.latest_step() if step is None else step
        if step is None:
            return None
        blob = torch.load(self._path(step), map_location="cpu", weights_only=True)
        dev = torch.device(device)
        return {"step": int(blob["step"]), "params": _tree_to(blob["params"], dev),
                "opt_state": _tree_to(blob["opt_state"], dev)}


def _tree_to(tree, device):
    return tree_map(lambda t: t.detach().to(device) if isinstance(t, torch.Tensor) else t, tree)


# ---------------------------------------------------------------------------
# numpy tree -> torch tree
# ---------------------------------------------------------------------------


def _shapes(tree):
    if isinstance(tree, dict):
        return {k: _shapes(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_shapes(v) for v in tree]
    return tuple(tree.shape)


def _to_torch(tree, device):
    if isinstance(tree, dict):
        return {k: _to_torch(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_to_torch(v, device) for v in tree]
    if isinstance(tree, torch.Tensor):
        return tree.detach().to(device=device, dtype=torch.float32).contiguous()
    return torch.from_numpy(np.array(tree, dtype=np.float32)).to(device)


def _check_tree(tree, template, what: str) -> None:
    got, want = _shapes(tree), _shapes(template)
    if got != want:
        raise ValueError(f"{what} parameters do not match the config: got {got}, want {want}")


def tacotron_from_numpy(tree: Params, cfg: TacotronModelConfig, device="cpu") -> Params:
    """JAX-layout Tacotron params (nested numpy) -> f32 torch tensors.

    The tree is checked leaf by leaf against the shapes ``cfg`` implies."""
    _check_tree(tree, init_tacotron(0, cfg, device="meta"), "tacotron")
    return _to_torch(tree, torch.device(device))


def wavernn_from_numpy(
    tree: Params, cfg: WaveRNNModelConfig, device="cpu", num_mels: int = 80, bits: int = 10
) -> Params:
    """JAX-layout WaveRNN params (nested numpy) -> f32 torch tensors."""
    _check_tree(tree, init_wavernn(0, cfg, num_mels, bits, device="meta"), "wavernn")
    return _to_torch(tree, torch.device(device))


# ---------------------------------------------------------------------------
# inits with the JAX inits' shapes (models/tacotron.py:46, models/wavernn.py:44)
# ---------------------------------------------------------------------------


class _Init:
    """Draws leaves from one numpy Generator; on the ``meta`` device only
    the shapes are made (used to validate loaded trees)."""

    def __init__(self, seed: int, device):
        self.device = torch.device(device)
        self.meta = self.device.type == "meta"
        self.rng = np.random.default_rng(seed)

    def _t(self, a: np.ndarray | tuple) -> torch.Tensor:
        if self.meta:
            return torch.empty(a, device="meta")
        return torch.from_numpy(np.asarray(a, np.float32)).to(self.device)

    def uniform(self, shape, limit):
        if self.meta:
            return self._t(tuple(shape))
        return self._t(self.rng.uniform(-limit, limit, shape))

    def glorot(self, shape):
        if len(shape) == 1:
            fan_in = fan_out = shape[0]
        elif len(shape) == 2:
            fan_in, fan_out = shape
        else:
            rf = int(np.prod(shape[:-2]))
            fan_in, fan_out = shape[-2] * rf, shape[-1] * rf
        return self.uniform(shape, np.sqrt(6.0 / (fan_in + fan_out)))

    def full(self, shape, value):
        return self._t(tuple(shape)) if self.meta else self._t(np.full(shape, value))

    def dense(self, i, o, bias=True):
        p = {"w": self.glorot((i, o))}
        if bias:
            p["b"] = self.full((o,), 0.0)
        return p

    def conv(self, width, i, o, bias=True):
        p = {"w": self.glorot((width, i, o))}
        if bias:
            p["b"] = self.full((o,), 0.0)
        return p

    def bn(self, dim):
        return {
            "scale": self.full((dim,), 1.0),
            "bias": self.full((dim,), 0.0),
            "mean": self.full((dim,), 0.0),
            "var": self.full((dim,), 1.0),
        }

    def lstm(self, i, units):
        return {"w": self.glorot((i + units, 4 * units)), "b": self.full((4 * units,), 0.0)}

    def gru(self, i, units):
        s = 1.0 / np.sqrt(units)
        return {
            "wi": self.uniform((i, 3 * units), s),
            "wh": self.uniform((units, 3 * units), s),
            "bi": self.uniform((3 * units,), s),
            "bh": self.uniform((3 * units,), s),
        }

    def conv_stack(self, n, width, i, ch):
        layers = []
        for _ in range(n):
            layers.append({"conv": self.conv(width, i, ch), "bn": self.bn(ch)})
            i = ch
        return {"layers": layers}


def init_tacotron(seed: int, cfg: TacotronModelConfig, device="cpu") -> Params:
    """Random Tacotron-2 params with the JAX init's tree and shapes, for
    every attention mode and every r (the CBHG head is not ported yet, see
    ROADMAP.md, queue item 12)."""
    if cfg.predict_linear:
        raise NotImplementedError("the CBHG mel->linear head is not ported yet (ROADMAP.md, queue item 12)")
    g = _Init(seed, device)
    enc_out = 2 * cfg.encoder_lstm_units
    M, r = 80, cfg.outputs_per_step
    q = cfg.decoder_lstm_units
    prenet, d = [], M
    for s in cfg.prenet_layers:
        prenet.append(g.dense(d, s))
        d = s
    return {
        "embedding": g.uniform((cfg.vocab_size, cfg.embedding_dim), 0.5),
        "enc_convs": g.conv_stack(
            cfg.enc_conv_layers, cfg.enc_conv_kernel, cfg.embedding_dim, cfg.enc_conv_channels
        ),
        "enc_lstm_fw": g.lstm(cfg.enc_conv_channels, cfg.encoder_lstm_units),
        "enc_lstm_bw": g.lstm(cfg.enc_conv_channels, cfg.encoder_lstm_units),
        "attention": _init_attention(g, cfg, enc_out, q),
        "prenet": {"layers": prenet},
        "dec_lstm1": g.lstm(cfg.prenet_layers[-1] + enc_out, cfg.decoder_lstm_units),
        "dec_lstm2": g.lstm(cfg.decoder_lstm_units, cfg.decoder_lstm_units),
        "frame_projection": g.dense(cfg.decoder_lstm_units + enc_out, M * r),
        "stop_projection": g.dense(cfg.decoder_lstm_units + enc_out, r),
        "postnet": g.conv_stack(cfg.postnet_layers, cfg.postnet_kernel, M, cfg.postnet_channels),
        "postnet_projection": g.dense(cfg.postnet_channels, M),
    }


def _init_attention(g: _Init, cfg: TacotronModelConfig, memory_dim: int, query_dim: int) -> Params:
    """The attention params of ``cfg.attention_mode`` (JAX
    models/attention.py init_params)."""
    mode, A = cfg.attention_mode, cfg.attention_dim
    if mode in ("forward", "lsa"):
        p = {
            "memory_layer": g.dense(memory_dim, A, bias=False),
            "query_layer": g.dense(query_dim, A, bias=False),
            "location_conv": g.conv(cfg.attention_kernel, 1, cfg.attention_filters),
            "location_layer": g.dense(cfg.attention_filters, A, bias=False),
            "v": g.glorot((A,)),
            "b": g.full((A,), 0.0),
        }
        if mode == "forward":
            p["mu_layer"] = g.dense(memory_dim + query_dim, 1)  # over [context, query]
        return p
    if mode == "gmm":
        return {"gmm_layer": g.dense(query_dim + memory_dim, 3 * cfg.num_attn_mixtures)}
    if mode == "graves":
        H, h = cfg.graves_heads, cfg.decoder_lstm_units // 4
        p = {"layer1": g.dense(query_dim, h), "layer2": g.dense(h, 3 * H)}
        if not g.meta:  # bias (0, 10, 1) per (g, b, k) block (reference graves_attention.py:36-38)
            p["layer2"]["b"] = g._t(np.concatenate([np.zeros(H), np.full(H, 10.0), np.ones(H)]))
        return p
    raise ValueError(f"unknown attention mode {mode!r}")


def init_wavernn(
    seed: int, cfg: WaveRNNModelConfig, num_mels: int = 80, bits: int = 10, device="cpu"
) -> Params:
    """Random WaveRNN params with the JAX init's tree and shapes."""
    g = _Init(seed, device)
    aux = cfg.res_out_dims // 4
    n_classes = 2**bits if cfg.mode == "RAW" else 30
    c = cfg.compute_dims
    blocks = [
        {"conv1": g.conv(1, c, c, bias=False), "bn1": g.bn(c),
         "conv2": g.conv(1, c, c, bias=False), "bn2": g.bn(c)}
        for _ in range(cfg.res_blocks)
    ]
    return {
        "resnet": {
            "conv_in": g.conv(2 * cfg.pad + 1, num_mels, c, bias=False),
            "bn_in": g.bn(c),
            "blocks": blocks,
            "conv_out": g.conv(1, c, cfg.res_out_dims),
        },
        "upsample": {
            "kernels": [g.full((2 * s + 1,), 1.0 / (2 * s + 1)) for s in cfg.upsample_factors]
        },
        "I": g.dense(num_mels + aux + 1, cfg.rnn_dims),
        "gru1": g.gru(cfg.rnn_dims, cfg.rnn_dims),
        "gru2": g.gru(cfg.rnn_dims + aux, cfg.rnn_dims),
        "fc1": g.dense(cfg.rnn_dims + aux, cfg.fc_dims),
        "fc2": g.dense(cfg.fc_dims + aux, cfg.fc_dims),
        "fc3": g.dense(cfg.fc_dims, n_classes),
    }
