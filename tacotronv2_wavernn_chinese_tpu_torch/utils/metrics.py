"""Scalar metrics logging + profiling hooks.

An append-only JSONL stream of scalars per run (in place of the
reference's TensorBoard summaries, tacotron/train.py:41-62), the embedding
projector dump, and a ``torch.profiler`` capture of a window of training
steps.  ``MetricsWriter``, ``read_scalars`` and ``dump_embedding_projector``
are copies of the JAX package's ``utils/metrics.py``.
"""

from __future__ import annotations

import json
import os
import time
from typing import Any, Mapping


class MetricsWriter:
    """Append-only scalars.jsonl: one {"step": N, "wall": t, ...} per write."""

    def __init__(self, log_dir: str, name: str = "scalars.jsonl"):
        os.makedirs(log_dir, exist_ok=True)
        self.path = os.path.join(log_dir, name)
        self._f = open(self.path, "a", buffering=1, encoding="utf-8")
        self._t0 = time.time()

    def write(self, step: int, scalars: Mapping[str, Any]) -> None:
        row = {"step": int(step), "wall": round(time.time() - self._t0, 3)}
        for k, v in scalars.items():
            try:
                row[k] = float(v)
            except (TypeError, ValueError):
                row[k] = str(v)
        self._f.write(json.dumps(row) + "\n")

    def close(self) -> None:
        self._f.close()


def read_scalars(path: str) -> list[dict]:
    with open(path, encoding="utf-8") as f:
        return [json.loads(line) for line in f if line.strip()]


def dump_embedding_projector(embedding, symbols: list[str], out_dir: str) -> None:
    """Write the character-embedding table in TensorBoard-projector TSV
    format (embedding.tsv + metadata.tsv) — the reference logs the same
    table via the TB projector config (tacotron/train.py:26-39,220-227)."""
    import numpy as np

    os.makedirs(out_dir, exist_ok=True)
    emb = embedding.detach().cpu().numpy() if hasattr(embedding, "detach") else np.asarray(embedding)
    with open(os.path.join(out_dir, "embedding.tsv"), "w", encoding="utf-8") as f:
        for row in emb:
            f.write("\t".join(f"{v:.6f}" for v in row) + "\n")
    with open(os.path.join(out_dir, "metadata.tsv"), "w", encoding="utf-8") as f:
        for i in range(emb.shape[0]):
            label = symbols[i] if i < len(symbols) else f"sym_{i}"
            f.write(label + "\n")


class Profiler:
    """``torch.profiler`` capture (CPU and, when present, CUDA activity) of
    training steps [start_step, start_step + num_steps).

    Usage: ``prof = Profiler(log_dir, start_step=10, num_steps=5)`` then call
    ``prof.step(step)`` once per training step; a Chrome trace lands at
    ``log_dir/trace-steps-<start>-<stop>.json``.
    """

    def __init__(self, log_dir: str | None, start_step: int = 10, num_steps: int = 5):
        self.log_dir = log_dir
        self.start_step = start_step
        self.stop_step = start_step + num_steps
        self._prof = None

    def step(self, step: int) -> None:
        if self.log_dir is None:
            return
        if self._prof is None and step == self.start_step:
            import torch

            acts = [torch.profiler.ProfilerActivity.CPU]
            if torch.cuda.is_available():
                acts.append(torch.profiler.ProfilerActivity.CUDA)
            self._prof = torch.profiler.profile(activities=acts)
            self._prof.__enter__()
        elif self._prof is not None and step >= self.stop_step:
            self.close()

    def close(self) -> None:
        if self._prof is None:
            return
        self._prof.__exit__(None, None, None)
        os.makedirs(self.log_dir, exist_ok=True)
        self._prof.export_chrome_trace(
            os.path.join(self.log_dir, f"trace-steps-{self.start_step}-{self.stop_step}.json")
        )
        self._prof = None
