"""Small shared helpers: shape bucketing and device resolution."""

from __future__ import annotations

import torch


def round_up(x: int, m: int) -> int:
    """Round ``x`` up to a multiple of ``m``."""
    return x if x % m == 0 else x + m - x % m


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """The device an entry point runs on.

    ``None`` means the card: without a CUDA device this raises instead of
    continuing on the CPU.  The CPU is used only when asked for by name."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run the "
                "plain PyTorch path on the CPU"
            )
        return torch.device("cuda")
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device!r} requested but CUDA is not available")
    return dev
