"""Tests of the benchmark: CPU tests of its generators, arithmetic, files
and harness, and tests marked ``card`` that run only where CUDA is.

Run: ``python -m pytest benchmark/tests -q`` (on the card, the ``card``
tests run too).  Nothing here imports JAX.
"""

import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA card; skipped with a reason elsewhere")


@pytest.fixture
def card():
    """Skip unless CUDA is there (decided inside the test, not at import)."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: run python -m pytest benchmark/tests -m card on the card")
    return "cuda"


TINY = {
    "tacotron": {"embedding_dim": 16, "enc_conv_channels": 32, "encoder_lstm_units": 16, "attention_dim": 16,
                 "attention_filters": 4, "prenet_layers": [16, 16], "decoder_lstm_units": 16,
                 "postnet_channels": 16},
    "wavernn": {"rnn_dims": 32, "fc_dims": 32, "compute_dims": 16, "res_blocks": 2},
    "wavernn_gen": {"target": 550, "overlap": 275},
    "tacotron_train": {"batch_size": 4},
    "wavernn_train": {"batch_size": 4},
}


# The Griffin-Lim cell, kept out of BENCHMARK.json (its latency follows
# the host's speed too far for a bound) with its files in place: the tests
# still run its path and its comparison from a checkout that holds it.
GL_CELL = "fwd-gl.serve-poisson"
GL_ENTRIES = {
    "configs": {"name": "tacotron2-fwd-griffinlim", "source": "https://github.com/lturing/tacotronv2_wavernn_chinese",
                "file": "benchmark/configs/tacotron2-fwd-griffinlim.json", "reduced": [], "why": "Griffin-Lim"},
    "workloads": {"name": GL_CELL, "config": "tacotron2-fwd-griffinlim", "traffic": "serve-poisson-gl", "chips": 1,
                  "why": "the Griffin-Lim path"},
}


def root_of(cell: str, tmp) -> str:
    """The checkout to run ``cell`` from: this one, or for the Griffin-Lim
    cell a copy of BENCHMARK.json that holds it beside this benchmark."""
    import json

    from benchmark import core

    if cell != GL_CELL:
        return core.ROOT
    root = os.path.join(str(tmp), "checkout-gl")
    os.makedirs(root, exist_ok=True)
    spec = core.load_spec(core.ROOT)
    for key, entry in GL_ENTRIES.items():
        spec[key] = [e for e in spec[key] if e["name"] != entry["name"]] + [entry]
    with open(os.path.join(root, "BENCHMARK.json"), "w", encoding="utf-8") as f:
        json.dump(spec, f)
    if not os.path.exists(os.path.join(root, "benchmark")):
        os.symlink(core.HERE, os.path.join(root, "benchmark"))
    return root


def tiny_context(cell: str, seed: int, workdir: str, seconds: float = 2.0, rate: float = 3.0, device: str = "cpu"):
    """A run of ``cell`` at small widths and a short window, on ``device``,
    skipping the harness's look for a card; its files go to ``workdir``."""
    import time
    import types

    from benchmark import run as R

    args = types.SimpleNamespace(workload=cell, seed=seed, seconds=seconds, trace=0, rate=rate)
    ctx = R.make_context(args, root=root_of(cell, workdir), device=device, patch=TINY, workdir=workdir,
                         t_start=time.monotonic())
    if ctx.traffic["kind"] == "serve_open_loop":
        ctx.traffic = dict(ctx.traffic, frames=8, timeout_s=30.0)
    elif ctx.traffic["kind"] == "train_tacotron":
        c = dict(ctx.traffic["corpus"], utterances=24, frames_median=30, frames_min=16, frames_max=48,
                 frames_per_symbol=4, symbols_min=4, symbols_max=12)
        ctx.traffic = dict(ctx.traffic, corpus=c)
    else:
        c = dict(ctx.traffic["corpus"], utterances=60, frames_median=20, frames_min=12, frames_max=30)
        ctx.traffic = dict(ctx.traffic, corpus=c)
    return ctx


@pytest.fixture
def card_absent():
    """Skip where a card is there (the refusal is what is tested)."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the refusal without one cannot be shown here")
