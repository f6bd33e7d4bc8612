"""Batch grouping for multi-step dispatch (train_step_many).

Yields groups of ``spd`` same-shape batches that run back to back, falling
back to single-batch groups near ``total_steps`` and at the epoch tail (a
copy of the JAX package's ``train/grouping.py``, which imports no JAX).
"""

from __future__ import annotations

from typing import Callable, Iterable, Iterator


def fused_groups(
    batch_iter: Iterable,
    spd: int,
    current_step: Callable[[], int],
    total_steps: int,
    key_fn: Callable | None = None,
) -> Iterator[list]:
    """Yield lists of groupable batches, length ``spd`` or 1.

    ``current_step`` is a zero-arg callable returning the live step counter
    — it advances as the caller dispatches yielded groups, which is what
    stops iteration at ``total_steps`` and forces the single-step tail when
    a full group would overshoot.  ``key_fn(batch)`` returns the static
    shape key batches must share to stack (None groups everything, e.g.
    fixed-size vocoder windows).
    """
    buf: dict = {}
    for batch in batch_iter:
        step = current_step()
        if step >= total_steps:
            return
        if spd <= 1 or step + spd > total_steps:
            yield [batch]
            continue
        k = key_fn(batch) if key_fn is not None else None
        buf.setdefault(k, []).append(batch)
        if len(buf[k]) == spd:
            yield buf.pop(k)
    # epoch tail: part-filled groups go one step at a time
    for group in buf.values():
        for b in group:
            if current_step() < total_steps:
                yield [b]
