"""Mixed-precision training policy: bf16 weights, f32 master and state
(the JAX package's ``utils/precision.py``, behind
``tacotron_train.mixed_precision`` and ``wavernn_train.mixed_precision``,
both off by default).

Policy (``cast_params``):

* float weight leaves are rounded to bf16;
* BatchNorm subtrees (keys starting with ``bn``) stay f32: their moving
  statistics are part of the f32 master state;
* the Tacotron ``attention`` subtree stays f32: the forward recursion
  multiplies probabilities with a 1e-10 floor and renormalises, where
  bf16's 8-bit mantissa drifts, and its tensors are small.

The JAX package hands the model bf16 leaves, and its products promote
``f32 @ bf16`` to f32: every product but one is f32 on bf16-rounded
weights.  ``torch.matmul`` and ``F.conv1d`` do not promote, so the port
makes that promotion here, once: a rounded leaf comes back as f32
(``.to(bf16).to(f32)``).  The one product JAX computes bf16 x bf16 is the
first encoder convolution, fed by the gather of the bf16 embedding: the
leaves under ``BF16_COMPUTE`` stay bf16, so that convolution, its bias and
its output are bf16 in both packages.

The cast happens inside the loss function, so gradients are taken against
the f32 master: the backward of the round trip rounds each leaf's
cotangent to bf16 once before it returns to f32, as the transpose of JAX's
``convert_element_type`` does.  ``merge_master`` recombines after the
forward: the BN and ``skip`` subtrees (the BN statistics are the only
leaves a forward changes) come from the computed tree, the rest from the
master, so the master never round-trips through bf16.
"""

from __future__ import annotations

import contextlib
from typing import Any

import torch

from . import tree_map

# key paths of the leaves the JAX package computes with in bf16 x bf16
BF16_COMPUTE = (("embedding",), ("enc_convs", "layers", 0, "conv"))
SKIP = frozenset({"attention"})


def _keep_f32(key, skip: frozenset) -> bool:
    return key in skip or (isinstance(key, str) and key.startswith("bn"))


def cast_params(node: Any, dtype=torch.bfloat16, skip: frozenset = SKIP, low: tuple = BF16_COMPUTE,
                path: tuple = ()) -> Any:
    """Round float weight leaves to ``dtype`` (differentiably): as ``dtype``
    under a ``low`` key path, else back in their own dtype; BN and ``skip``
    subtrees are returned as they are."""
    if isinstance(node, dict):
        return {k: (v if _keep_f32(k, skip) else cast_params(v, dtype, skip, low, path + (k,)))
                for k, v in node.items()}
    if isinstance(node, (list, tuple)):
        return type(node)(cast_params(v, dtype, skip, low, path + (i,)) for i, v in enumerate(node))
    if isinstance(node, torch.Tensor) and node.is_floating_point():
        if any(path[:len(p)] == p for p in low):
            return node.to(dtype)
        return node.to(dtype).to(node.dtype)
    return node


def merge_master(master: Any, computed: Any, skip: frozenset = SKIP) -> Any:
    """The f32 master tree after a mixed-precision forward: the BN and
    ``skip`` subtrees (everything the forward could have changed) from
    ``computed``, every other leaf from ``master``."""
    if isinstance(master, dict):
        return {k: (computed[k] if _keep_f32(k, skip) else merge_master(v, computed[k], skip))
                for k, v in master.items()}
    if isinstance(master, (list, tuple)):
        return type(master)(merge_master(m, c, skip) for m, c in zip(master, computed))
    return master


def cast_to_float32(tree: Any) -> Any:
    """Upcast any float leaves of a tree or NamedTuple to f32 (the loss
    side)."""
    up = lambda x: x.float() if isinstance(x, torch.Tensor) and x.is_floating_point() else x
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(cast_to_float32(v) for v in tree))
    if isinstance(tree, (dict, list, tuple)):
        return tree_map(up, tree)
    return up(tree)


@contextlib.contextmanager
def fp32_precision(mode: str = "ieee"):
    """f32 matmuls and cuDNN convolutions and RNNs in ``mode`` ("ieee":
    full f32, "tf32") inside the block; the previous flags are restored on
    exit.  Uses the per-operator flags only: torch refuses to read the
    legacy ``allow_tf32`` once they differ.  The Tacotron entry points
    (``forward_inference``, the train and eval steps) and the WaveRNN steps
    run inside it; the building blocks follow their caller's flags."""
    flags = (torch.backends.cuda.matmul, torch.backends.cudnn.conv, torch.backends.cudnn.rnn)
    prev = [f.fp32_precision for f in flags]
    for f in flags:
        f.fp32_precision = mode
    try:
        yield
    finally:
        for f, p in zip(flags, prev):
            f.fp32_precision = p
