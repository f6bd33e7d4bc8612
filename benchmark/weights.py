"""Random weights made on the card from the run's seed.

The port's init draws leaf by leaf on the host.  Here one
``torch.Generator`` on the device fills one flat buffer with uniform draws
in a single call, and each leaf is a slice of it, scaled by the same rule
the published models initialise with: Glorot-uniform matrices and
convolutions, uniform(1/sqrt(units)) GRU leaves, uniform(0.5) embeddings,
zero biases, BatchNorm at identity, the upsample taps at 1/(2s+1).  The
tree's layout is read from shapes alone (``meta`` tensors), so nothing the
program computed enters the weights; both the program and the reference
are handed the same tensors.
"""

from __future__ import annotations

import math

import torch


def leaves_with_paths(tree, path=()):
    if isinstance(tree, dict):
        for k in tree:
            yield from leaves_with_paths(tree[k], path + (k,))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from leaves_with_paths(v, path + (i,))
    else:
        yield path, tree


def _rebuild(tree, values, path=()):
    if isinstance(tree, dict):
        return {k: _rebuild(v, values, path + (k,)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_rebuild(v, values, path + (i,)) for i, v in enumerate(tree)]
    return values[path]


def _glorot_limit(shape) -> float:
    if len(shape) == 1:
        fan_in = fan_out = shape[0]
    elif len(shape) == 2:
        fan_in, fan_out = shape
    else:
        rf = math.prod(shape[:-2])
        fan_in, fan_out = shape[-2] * rf, shape[-1] * rf
    return math.sqrt(6.0 / (fan_in + fan_out))


def leaf_rule(path, shape):
    """(kind, value): "uniform" with a half-width, or "const" with a value."""
    name = path[-1]
    if "upsample" in path:
        return "const", 1.0 / shape[0]
    if path[0] == "embedding":
        return "uniform", 0.5
    if any(str(p).startswith("gru") for p in path):  # wi, wh, bi, bh of a GRU
        units = shape[-1] // 3
        return "uniform", 1.0 / math.sqrt(units)
    if name in ("scale", "var"):
        return "const", 1.0
    if name in ("bias", "mean", "b"):
        return "const", 0.0
    return "uniform", _glorot_limit(shape)


def make_params(template, seed: int, device) -> dict:
    """Fill a tree of ``meta`` tensors with seeded draws on ``device``."""
    items = list(leaves_with_paths(template))
    total = sum(t.numel() for _, t in items)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % (2**63))
    flat = torch.rand(total, generator=gen, device=device, dtype=torch.float32).mul_(2.0).sub_(1.0)
    values, off = {}, 0
    for path, t in items:
        n = t.numel()
        kind, v = leaf_rule(path, tuple(t.shape))
        if kind == "uniform":
            values[path] = flat[off: off + n].view(tuple(t.shape)).mul_(v)
        else:
            values[path] = torch.full(tuple(t.shape), v, device=device, dtype=torch.float32)
        off += n
    return _rebuild(template, values)


def with_stop_bias(params: dict, bias: float) -> dict:
    """The stop projection's bias set to ``bias`` (-30: no request stops
    before ``max_iters``)."""
    sp = dict(params["stop_projection"])
    sp["b"] = torch.full_like(sp["b"], float(bias))
    return dict(params, stop_projection=sp)
