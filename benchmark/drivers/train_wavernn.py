"""WaveRNN training: ``train.wavernn_task.train_step`` in a loop, on the
windows that the port's C++ loader (``data/native_loader.py``: worker
threads and a prefetch ring) samples from a corpus that set-up writes from
the seed.

Set-up writes the corpus, builds and starts the loader, makes the weights
on the card from the seed and drives the one training state through its
first steps on the window's own feed and call; the reference follows
those steps on the windows they were fed.  The window and the trace are
the Tacotron training cell's (``drivers/train_common.py``).
"""

from __future__ import annotations

import math
import os
import time

from .. import portcfg, traffic_gen
from ..compare import train_wavernn as CMP
from ..weights import make_params
from . import train_common as TC


def run(ctx) -> dict:
    from tacotronv2_wavernn_chinese_tpu_torch.data.loader import VocoderDataset, read_metadata
    from tacotronv2_wavernn_chinese_tpu_torch.data.native_loader import NativeVocoderLoader
    from tacotronv2_wavernn_chinese_tpu_torch.train import wavernn_task as task
    from tacotronv2_wavernn_chinese_tpu_torch.utils.checkpoints import init_wavernn

    tr = ctx.traffic
    cfg = portcfg.build(ctx.conf, ctx.patch)
    dev = ctx.device
    meta = traffic_gen.vocoder_corpus(tr, ctx.seed, os.path.join(ctx.workdir, "vocoder_corpus"))
    data_dir = os.path.dirname(meta)
    dataset = VocoderDataset(read_metadata(meta), data_dir, cfg)
    loader = NativeVocoderLoader(dataset.rows, data_dir, cfg, n_workers=int(tr["loader"]["workers"]),
                                 ring_size=int(tr["loader"]["ring"]), seed=int(ctx.seed) % 2**63,
                                 indices=dataset.train_indices)
    try:
        params = make_params(init_wavernn(0, cfg.wavernn, cfg.audio.num_mels, cfg.audio.bits, device="meta"),
                             ctx.seed, dev)
        state = task.TrainState(0, params, task.adam_init(params))
        steps: list = []

        def one_step(keep=None):
            nonlocal state
            t0 = time.monotonic()
            b = loader.next_batch()
            t1 = time.monotonic()
            arrays = task.batch_to_device(b, dev)
            if keep is not None:
                keep.append(arrays)
            state, metrics = task.train_step(state, arrays, cfg)
            steps.append({"t0": t0, "t1": time.monotonic(), "load_s": t1 - t0, "windows": int(b.x.shape[0]),
                          "loss": metrics["loss"]})
            return metrics

        n_check = int(tr["check"]["steps"])
        p0 = TC.clone(params)
        check_batches: list = []
        losses, mu1, p3 = [], None, None
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
    finally:
        loader.close()
    rec = {"model": "wavernn", "steps": win["steps"], "steps_traced": win["steps_traced"],
           "conf": ctx.conf_sections, "window_s": win["window_s"], "train_step_ms": win["train_step_ms"]}
    if "trace" in win:
        rec["trace"] = win["trace"]
    state = None
    vals = CMP.readings(ctx.conf_sections, p0, check_batches, dev, {"losses": losses, "mu1": mu1, "params3": p3})
    control = (CMP.readings(ctx.conf_sections, p0, check_batches, dev, None, control=True)
               if getattr(ctx, "control", False) else None)
    checks = CMP.judge(tr["check"]["limits"], vals)
    failed = sum(1 for s in rec["steps"] if not math.isfinite(s["loss"]))
    return {"attempted": len(rec["steps"]), "failed": failed,
            "e2e": {"setup_s": setup_s, "train_step_ms": rec["train_step_ms"]}, "record": rec,
            "device": win["device"], "checks": checks, "breakdown": win["breakdown"], "readings": vals,
            "control": control}
