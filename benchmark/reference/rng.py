"""The counter-based random bits the served models draw their prenet
dropout and their sampling noise from: three rounds of the murmur3 32-bit
finalizer over (seed, row, step), then one over the lane.  Written out
here in int64 arithmetic masked to 32 bits, so the reference derives a
request's masks and noise from the request's seed by itself.
"""

from __future__ import annotations

import torch

M32 = 0xFFFFFFFF
GOLDEN = 0x9E3779B9


def mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """(x * c) mod 2^32 for 0 <= x < 2^32, without int64 overflow."""
    lo = x * (c & 0xFFFF)
    hi = ((x * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & M32


def fmix32(h: torch.Tensor) -> torch.Tensor:
    h = h ^ (h >> 16)
    h = mul32(h, 0x85EBCA6B)
    h = h ^ (h >> 13)
    h = mul32(h, 0xC2B2AE35)
    return h ^ (h >> 16)


def bits(seed, row, step, lane) -> torch.Tensor:
    """uint32 random bits (in int64) of broadcastable int64 tensors."""
    k = fmix32((seed & M32) ^ GOLDEN)
    k = fmix32(k ^ (row & M32))
    k = fmix32(k ^ (step & M32))
    return fmix32((k + mul32(lane & M32, GOLDEN)) & M32)


def keep_threshold(rate: float) -> int:
    """A unit is kept when its bits are below (1 - rate) * 2^32."""
    return int((1.0 - rate) * 4294967295.0)


def gumbel(b: torch.Tensor) -> torch.Tensor:
    """uint32 bits -> standard Gumbel noise: the high 23 bits as a uniform
    in [1, 2) by the exponent trick, minus 1, floored at 1e-9."""
    f = ((b >> 9) | 0x3F800000).to(torch.int32).view(torch.float32) - 1.0
    return -torch.log(-torch.log(torch.clamp_min(f, 1e-9)))


def wrap32(seed: int) -> int:
    """A seed as the served models read it: its low 32 bits, signed."""
    return ((int(seed) & M32) ^ 0x80000000) - 0x80000000
