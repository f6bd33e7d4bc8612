"""Tacotron-2 training: ``train.tacotron_task.train_step`` in a loop, on
batches that the port's ``TacotronDataset.batches`` (length grouping, the
configured pad multiples) reads from a corpus that set-up writes from the
seed.

Set-up writes the corpus, makes the weights on the card from the seed,
and drives the one training state through its first steps on the window's
own feed and call; the reference follows those steps.  The window then
runs steps until its seconds are spent; ``train_step_ms`` is the time
from the window's start to the end of its last step over the steps.  The
masks of step s are drawn from a generator seeded from the run's seed and
s, so the reference draws them again.  With ``--trace 1`` a device trace
covers a few steps in the middle of the window, opened and closed between
steps.
"""

from __future__ import annotations

import math
import os
import time

from .. import core, portcfg, traffic_gen
from ..compare import train_tacotron as CMP
from ..weights import make_params
from . import train_common as TC


def step_seed(seed: int, step: int) -> int:
    return (int(seed) % (2**40)) * 4099 + step


def symbols_for_corpus() -> list:
    with open(CMP.SYMBOLS, encoding="utf-8") as f:
        table = [line.rstrip("\n") for line in f if line.rstrip("\n")]
    return [s for s in table if s not in ("_", "~")]


def run(ctx) -> dict:
    import torch

    from tacotronv2_wavernn_chinese_tpu_torch.data.loader import TacotronDataset, read_metadata
    from tacotronv2_wavernn_chinese_tpu_torch.train import tacotron_task as task
    from tacotronv2_wavernn_chinese_tpu_torch.train.tacotron_train import batch_to_device
    from tacotronv2_wavernn_chinese_tpu_torch.utils.checkpoints import init_tacotron

    tr = ctx.traffic
    cfg = portcfg.build(ctx.conf, ctx.patch)
    dev = ctx.device
    meta = traffic_gen.tacotron_corpus(tr, ctx.seed, os.path.join(ctx.workdir, "corpus"), symbols_for_corpus())
    dataset = TacotronDataset(read_metadata(meta), os.path.dirname(meta), cfg)
    params = make_params(init_tacotron(0, cfg.tacotron, device="meta"), ctx.seed, dev)
    state = task.TrainState(0, params, task.adam_init(params))
    gen = torch.Generator(device=dev)
    epoch = [0]

    def feed():
        while True:
            yield from dataset.batches(epoch_seed=(ctx.seed + epoch[0]) % 2**32)
            epoch[0] += 1

    batches = feed()
    steps: list = []

    def one_step(keep=None):
        nonlocal state
        t0 = time.monotonic()
        b = next(batches)
        t1 = time.monotonic()
        arrays = batch_to_device(b, dev)
        gen.manual_seed(step_seed(ctx.seed, state.step))
        if keep is not None:
            keep.append(arrays)
        state, metrics = task.train_step(state, arrays, gen, cfg)
        t2 = time.monotonic()
        steps.append({"t0": t0, "t1": t2, "load_s": t1 - t0, "lengths": b.input_lengths.tolist(),
                      "frames": b.target_lengths.tolist(), "loss": metrics["loss"]})
        return metrics

    # the first steps: warm-up, and the steps the reference follows
    n_check = int(tr["check"]["steps"])
    p0 = {"params": TC.clone(params)}
    check_batches: list = []
    losses, mu1 = [], None
    for i in range(max(n_check, int(tr["warm_steps"]))):
        m = one_step(check_batches if i < n_check else None)
        if i < n_check:
            losses.append(m["loss"])
        if i == 0:
            mu1 = TC.clone(state.opt_state["mu"])
        if i == n_check - 1:
            p3 = TC.clone(state.params)
    setup_s = time.monotonic() - ctx.t_start
    win = TC.run_window(ctx, tr, one_step, steps)
    rec = {"model": "tacotron", "steps": win["steps"], "steps_traced": win["steps_traced"],
           "conf": ctx.conf_sections, "window_s": win["window_s"], "train_step_ms": win["train_step_ms"]}
    if "trace" in win:
        rec["trace"] = win["trace"]
    state = None
    vals = CMP.readings(ctx.conf_sections, p0["params"], check_batches,
                        [step_seed(ctx.seed, s) for s in range(n_check)], dev,
                        {"losses": losses, "mu1": mu1, "params3": p3})
    control = CMP.readings(ctx.conf_sections, p0["params"], check_batches,
                           [step_seed(ctx.seed, s) for s in range(n_check)], dev, None,
                           control=True) if getattr(ctx, "control", False) else None
    checks = CMP.judge(tr["check"]["limits"], vals)
    e2e = {"setup_s": setup_s, "train_step_ms": rec["train_step_ms"]}
    failed = sum(1 for s in rec["steps"] if not math.isfinite(s["loss"]))
    return {"attempted": len(rec["steps"]), "failed": failed, "e2e": e2e, "record": rec, "device": win["device"],
            "checks": checks, "breakdown": win["breakdown"], "readings": vals, "control": control}

