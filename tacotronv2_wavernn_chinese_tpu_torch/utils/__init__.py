"""Small shared helpers: shape bucketing, device resolution, params trees."""

from __future__ import annotations

import torch


def round_up(x: int, m: int) -> int:
    """Round ``x`` up to a multiple of ``m``."""
    return x if x % m == 0 else x + m - x % m


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """The device an entry point runs on.

    ``None`` means the card: without a CUDA device this raises instead of
    continuing on the CPU.  The CPU is used only when asked for by name.  A
    CUDA device without an index is the current one (``cuda:LOCAL_RANK``
    on a rank that ``parallel.distributed.initialize`` set up)."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run the "
                "plain PyTorch path on the CPU"
            )
        return torch.device("cuda", torch.cuda.current_device())
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device!r} requested but CUDA is not available")
    if dev.type == "cuda" and dev.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return dev


def device_index(device) -> int:
    """The index of a CUDA device; an index-less ``"cuda"`` is the current
    device, not card 0."""
    dev = torch.device(device)
    return torch.cuda.current_device() if dev.index is None else dev.index


def tree_map(fn, tree, *rest):
    """Apply ``fn`` leaf-wise over nested dicts/lists/tuples of tensors
    (the params trees of this package); ``rest`` trees share the structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v, *(r[i] for r in rest)) for i, v in enumerate(tree))
    return fn(tree, *rest)


def tree_leaves(tree) -> list:
    """The leaves of a nested dict/list tree, in insertion order."""
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in tree_leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in tree_leaves(v)]
    return [tree]
