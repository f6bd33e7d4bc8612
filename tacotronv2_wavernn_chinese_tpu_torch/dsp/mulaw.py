"""Mu-law label conversion on torch tensors.

Reference: wavernn/utils/dsp.py:8-45 (label/float conversions, decode).
"""

from __future__ import annotations

import torch


def label_2_float(x: torch.Tensor, bits: int) -> torch.Tensor:
    """Integer label [0, 2^bits-1] -> float [-1, 1].

    The op order ``2*x / (n-1) - 1`` is part of the contract: the sample
    loops feed this value back, and the precomputed-reciprocal form differs
    by one ulp for some labels, which lets greedy trajectories diverge."""
    return 2.0 * x.to(torch.float32) / (2**bits - 1.0) - 1.0


def mu_law_expand(labels: torch.Tensor, bits: int) -> torch.Tensor:
    """Labels [0, 2**bits) -> float wav by mu-law expansion
    (reference decode_mu_law with from_labels=True, dsp.py:42-47)."""
    mu = 2**bits - 1
    x = 2.0 * labels.to(torch.float32) / mu - 1.0
    return torch.sign(x) / mu * ((1.0 + mu) ** torch.abs(x) - 1.0)
