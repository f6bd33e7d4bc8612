"""The trainers' shared optimizer and step skeleton.

The task modules (``tacotron_task``, ``wavernn_task``, ``hifigan_task``)
turn a loss into new parameters the same way: the gradient of every params
leaf (``grads_of``), then ``optimizer_step``: optax's global-norm clip,
Adam, and ``new_params + updates`` (the BN statistics advance with the
forward's moving averages; their gradients, so their updates, are zero).
The recipes differ in where Adam puts epsilon and the bias corrections:
each task passes its rule (``tf1_rule``, ``optax_rule``) as an argument.
HiFi-GAN steps two parameter trees, each with a state of its own, without
clipping and with AdamW's decoupled decay (``weight_decay``).

Nothing here reads a tensor back to the host: the step's one readback is
``readback``, after the update has been queued.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable

import torch

from ..utils import tree_leaves, tree_map
from ..utils.metrics import span


@dataclass
class TrainState:
    step: int
    params: Any  # nested dict of f32 tensors (the JAX package's tree)
    opt_state: dict  # {"count": int, "mu": tree, "nu": tree}


def adam_init(params) -> dict:
    zeros = lambda: tree_map(lambda p: torch.zeros_like(p, memory_format=torch.contiguous_format), params)
    return {"count": 0, "mu": zeros(), "nu": zeros()}


def tf1_rule(count: int, lr: float, b1: float, b2: float, eps: float) -> Callable:
    """TF-1.x epsilon semantics (tf.train.AdamOptimizer, the Tacotron
    reference's optimizer): ``update = -lr * sqrt(1-b2^t)/(1-b1^t) *
    m / (sqrt(v) + eps)``, epsilon on the uncorrected second-moment root."""
    c = torch.tensor(float(count), dtype=torch.float32)
    lr_factor = float(torch.sqrt(1.0 - b2 ** c) / (1.0 - b1 ** c))
    return lambda m, v: lr_factor * m / (torch.sqrt(v) + eps) * -lr


def optax_rule(count: int, lr: float, b1: float, b2: float, eps: float) -> Callable:
    """optax.adam: ``update = -lr * m̂ / (sqrt(v̂) + eps)`` with m̂ = m / (1 -
    b1^t), v̂ = v / (1 - b2^t), the corrections in f32 as optax computes
    them."""
    c = torch.tensor(float(count), dtype=torch.float32)
    bc1 = float(1.0 - torch.tensor(b1, dtype=torch.float32) ** c)
    bc2 = float(1.0 - torch.tensor(b2, dtype=torch.float32) ** c)
    return lambda m, v: -lr * ((m / bc1) / (torch.sqrt(v / bc2) + eps))


def adam(grads, state: dict, rule: Callable, lr: float, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
         weight_decay: float = 0.0, params=None):
    """Adam whose update from the moments is ``rule``'s (``tf1_rule`` or
    ``optax_rule``).  Returns (updates, new state); the moments are updated
    in place.  A ``weight_decay`` other than 0 decays ``params`` apart from
    the moments, as torch's AdamW: the update gains ``-lr * weight_decay *
    p``."""
    count = state["count"] + 1
    update = rule(count, lr, b1, b2, eps)

    def leaf(g, m, v):
        m.mul_(b1).add_((1.0 - b1) * g)
        v.mul_(b2).add_((1.0 - b2) * (g * g))
        return update(m, v)

    updates = tree_map(leaf, grads, state["mu"], state["nu"])
    if weight_decay:
        updates = tree_map(lambda u, p: u - (lr * weight_decay) * p.detach(), updates, params)
    return updates, {"count": count, "mu": state["mu"], "nu": state["nu"]}


def _like(tree, flat: list):
    """``flat``'s tensors in ``tree``'s structure (``tree_leaves`` order)."""
    it = iter(flat)
    return tree_map(lambda _: next(it), tree)


def global_norm(tree) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(g * g) for g in tree_leaves(tree)))


def clip_by_global_norm(grads, max_norm: float, norm: torch.Tensor | None = None):
    """optax.clip_by_global_norm: unchanged below the limit, else g/|g|*max,
    chosen on the device.  ``norm`` is the tree's global norm when the
    caller knows it (a tensor-parallel tree whose shards live on several
    ranks).  Returns (clipped, norm)."""
    norm = global_norm(grads) if norm is None else norm
    keep = norm < max_norm
    # where(keep, g, g / norm * max_norm) in two multi-tensor launches, g / 1 * 1 being g exactly:
    # launches a leaf cost the host-bound WaveRNN step about 3.5 ms on an H100
    flat = torch._foreach_mul(torch._foreach_div(tree_leaves(grads), torch.where(keep, 1.0, norm)),
                              torch.where(keep, 1.0, max_norm))
    return _like(grads, flat), norm


def grads_of(loss_of: Callable, params):
    """``loss_of(leaves) -> (loss, extra)`` on detached copies of the params
    leaves, and the gradient of every leaf (zeros where the loss does not
    depend on it, as for the BN moving statistics) -> (loss, extra, grads)."""
    leaves = tree_map(lambda p: p.detach().requires_grad_(True), params)
    with span("train.forward", device=True):
        loss, extra = loss_of(leaves)
    flat = tree_leaves(leaves)
    with span("train.backward", device=True):
        gs = torch.autograd.grad(loss, flat, allow_unused=True)
    return loss, extra, _like(leaves, [torch.zeros_like(p) if g is None else g for p, g in zip(flat, gs)])


def optimizer_step(state: TrainState, new_params, grads, max_norm: float | None, rule: Callable, lr: float,
                   b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8, norm: torch.Tensor | None = None,
                   frozen: tuple = (), weight_decay: float = 0.0):
    """Clip, Adam, then ``new_params + updates`` -> (new state, grad norm).
    The top-level params in ``frozen`` take zero updates.  With
    ``max_norm`` None nothing is clipped and no norm is taken (the grad
    norm returned is None); ``weight_decay`` is ``adam``'s."""
    with torch.no_grad(), span("train.optimizer", device=True):
        if max_norm is None:
            clipped = grads
        else:
            clipped, norm = clip_by_global_norm(grads, max_norm, norm)
        updates, opt_state = adam(clipped, state.opt_state, rule, lr, b1, b2, eps, weight_decay, new_params)
        if frozen:
            updates = {k: tree_map(torch.zeros_like, v) if k in frozen else v for k, v in updates.items()}
        params = tree_map(lambda p, u: p.detach() + u, new_params, updates)
    return TrainState(state.step + 1, params, opt_state), norm


def readback(values: dict) -> dict:
    """The step's one host read: named scalar tensors -> floats, in one
    transfer."""
    with span("train.readback"):
        return dict(zip(values, torch.stack([v.detach().reshape(()) for v in values.values()]).tolist()))
