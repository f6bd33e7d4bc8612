"""HiFi-GAN V1 training: ``train.hifigan_task.train_step`` in a loop, on the
segments that the port's C++ window sampler (``data/native_loader.py``
``NativeSegmentLoader``: worker threads and a prefetch ring) draws from a
16-bit PCM corpus that set-up makes from the seed.

Set-up makes the corpus in memory, starts the loader, makes the weights
and the spectral norm's ``u`` on the card from the seed (``weights``) and
drives the one training state through its first steps on the window's own
feed and call; the reference (``compare/train_hifigan.py``) follows those
steps on the segments they were fed.  The window and the device trace are
the other training cells' (``drivers/train_common.py``).  With ``--trace
1`` the port's spans are on from before set-up, the device trace is
``benchmark.spans.SpanTrace``, and the record keeps the spans, the
program's counters and the trace's record, as
``drivers/train_tacotron_lsa.py`` keeps them; a program without spans
leaves them empty, and the readers that need them return None.
"""

from __future__ import annotations

import dataclasses
import math
import time

import numpy as np

from .. import core, portcfg
from .. import spans as SP
from ..compare import train_hifigan as CMP
from ..weights import leaves_with_paths
from . import train_common as TC

SECTIONS = ("hifigan", "hifigan_train")


def sections(conf: dict, patch: dict | None) -> dict:
    """The configuration's ``audio``, ``hifigan`` and ``hifigan_train``
    sections with ``patch`` applied: what the reference and the work
    counters read."""
    return {s: portcfg.section(conf, s, patch) for s in ("audio",) + SECTIONS}


def port_config(conf: dict, patch: dict | None = None):
    """``portcfg.build`` and, besides, the ``hifigan`` and
    ``hifigan_train`` sections set on the port's ``Config``."""
    cfg = portcfg.build(conf, patch)
    tup = lambda v: tuple(tup(x) for x in v) if isinstance(v, list) else v
    for sec in SECTIONS:
        vals = {k: tup(v) for k, v in portcfg.section(conf, sec, patch).items()}
        cfg = dataclasses.replace(cfg, **{sec: dataclasses.replace(getattr(cfg, sec), **vals)})
    return cfg


def corpus(traffic: dict, seed: int) -> list:
    """The utterances' int16 PCM: lengths in seconds from the mix's fixed
    multiset (its ``shape_seed``) in an order the run's seed draws, samples
    Gaussian at ``sigma`` of full scale, clipped, drawn in one call."""
    c = traffic["corpus"]
    n, sr = int(c["utterances"]), int(c["sample_rate"])
    shape = np.random.default_rng(int(c["shape_seed"]))
    secs = np.clip(shape.lognormal(math.log(c["seconds_median"]), c["seconds_sigma"], n),
                   c["seconds_min"], c["seconds_max"])
    run = np.random.default_rng([int(seed), 17])
    lens = np.rint(run.permutation(secs) * sr).astype(np.int64)
    flat = np.clip(np.rint(run.standard_normal(int(lens.sum()), dtype=np.float32) * (c["sigma"] * 32767.0)),
                   -32768, 32767).astype(np.int16)
    return np.split(flat, np.cumsum(lens)[:-1])


def weights(cfg, seed: int, dev):
    """(params, sn) of the port's tree on ``dev``, filled from one seeded
    generator on the device, by ``models.py``'s init rules: uniform within
    1/sqrt(fan_in) (torch's default) for every weight and bias but the
    generator's upsampling, ResBlock and output weights, which are drawn at
    normal(0, 0.01)'s standard deviation (uniform within 0.01 x sqrt(3));
    each weight norm's ``g`` is ``|v|``; ``u`` a unit vector."""
    import torch

    from tacotronv2_wavernn_chinese_tpu_torch.models import hifigan as H

    params, sn = H.init_hifigan(0, cfg.hifigan, "meta")
    tree = {"params": params, "sn": sn}
    items = list(leaves_with_paths(tree))
    gen = torch.Generator(device=dev)
    gen.manual_seed(int(seed) % (2**63))
    flat = torch.rand(sum(t.numel() for _, t in items), generator=gen, device=dev).mul_(2.0).sub_(1.0)
    out, off = {}, 0
    for path, t in items:
        out[path], off = flat[off: off + t.numel()].view(t.shape), off + t.numel()

    def fill(node, path):
        if isinstance(node, dict) and ("v" in node or "w" in node):
            w = node.get("v", node.get("w"))
            fan = w.shape[1] * math.prod(w.shape[2:])
            small = path[:2] == ("params", "gen") and path[2] != "conv_pre"
            bound = 0.01 * math.sqrt(3.0) if small else 1.0 / math.sqrt(fan)
            wk = "v" if "v" in node else "w"
            leaf = {wk: out[path + (wk,)].mul_(bound), "b": out[path + ("b",)].mul_(1.0 / math.sqrt(fan))}
            if "g" in node:
                leaf["g"] = torch.linalg.vector_norm(leaf["v"], dim=tuple(range(1, w.dim())), keepdim=True)
            return leaf
        if isinstance(node, dict):
            return {k: fill(v, path + (k,)) for k, v in node.items()}
        if isinstance(node, list):
            return [fill(v, path + (i,)) for i, v in enumerate(node)]
        return torch.nn.functional.normalize(out[path], dim=0, eps=1e-12)  # a u vector

    filled = fill(tree, ())
    return filled["params"], filled["sn"]


def run(ctx) -> dict:
    if not ctx.trace:
        return _run(ctx)
    from tacotronv2_wavernn_chinese_tpu_torch.utils import metrics as M

    traces = []

    class Trace(SP.SpanTrace):
        def __init__(self, workdir):
            super().__init__(workdir)
            traces.append(self)

    M.enable()
    saved = core.DeviceTrace
    core.DeviceTrace = Trace
    try:
        out = _run(ctx)
        rec = out["record"]
        rec["spans"] = M.drain()
    finally:
        core.DeviceTrace = saved
        M.enable(False)
    rec["program_counters"] = {k: dict(v) for k, v in M.counters().items()}
    if traces and traces[-1].t1 is not None:
        rec.update(traces[-1].record())
    return out


def _run(ctx) -> dict:
    from tacotronv2_wavernn_chinese_tpu_torch.data.native_loader import NativeSegmentLoader
    from tacotronv2_wavernn_chinese_tpu_torch.train import hifigan_task as task

    tr = ctx.traffic
    cfg = port_config(ctx.conf, ctx.patch)
    conf = sections(ctx.conf, ctx.patch)
    ht = cfg.hifigan_train
    dev = ctx.device
    audio = corpus(tr, ctx.seed)
    loader = NativeSegmentLoader(audio, ht.segment_size, ht.batch_size, n_workers=int(tr["loader"]["workers"]),
                                 ring_size=int(tr["loader"]["ring"]), seed=int(ctx.seed) % 2**63)
    steps_per_epoch = max(1, loader.num_utts // ht.batch_size)
    try:
        params, sn = weights(cfg, ctx.seed, dev)
        state = task.from_params(params, sn)
        steps: list = []

        def one_step(keep=None):
            nonlocal state
            t0 = time.monotonic()
            b = loader.next_batch()
            t1 = time.monotonic()
            arrays = task.batch_to_device(b, dev)
            if keep is not None:
                keep.append(arrays["audio"])
            state, metrics = task.train_step(state, arrays, cfg, steps_per_epoch)
            steps.append({"t0": t0, "t1": time.monotonic(), "load_s": t1 - t0, "rows": int(b.x.shape[0]),
                          "samples": int(b.x.shape[1]), "loss": metrics["loss_gen"], "loss_d": metrics["loss_disc"]})
            return metrics

        n_check = int(tr["check"]["steps"])
        p0, sn0 = TC.clone(params), TC.clone(sn)
        check_batches: list = []
        prog = {"loss_d": [], "loss_g": [], "params": []}
        for i in range(max(n_check, int(tr["warm_steps"]))):
            m = one_step(check_batches if i < n_check else None)
            if i < n_check:
                prog["loss_d"].append(m["loss_disc"])
                prog["loss_g"].append(m["loss_gen"])
                prog["params"].append(TC.clone({"gen": state.gen.params, **state.disc.params}))
            if i == 0:
                prog["mu1_g"] = TC.clone(state.gen.opt_state["mu"])
                prog["mu1_d"] = TC.clone(state.disc.opt_state["mu"])
            if i == n_check - 1:
                prog["sn"] = TC.clone(state.sn)
        setup_s = time.monotonic() - ctx.t_start
        win = TC.run_window(ctx, tr, one_step, steps)
    finally:
        loader.close()
    rec = {"model": "hifigan", "steps": win["steps"], "steps_traced": win["steps_traced"], "conf": conf,
           "window_s": win["window_s"], "train_step_ms": win["train_step_ms"]}
    if "trace" in win:
        rec["trace"] = win["trace"]
    state = None
    p0 = {"gen": p0["gen"], "mpd": p0["mpd"], "msd": p0["msd"]}
    vals = CMP.readings(conf, p0, sn0, check_batches, dev, prog)
    control = (CMP.readings(conf, p0, sn0, check_batches, dev, None, control=True)
               if getattr(ctx, "control", False) else None)
    checks = CMP.judge(tr["check"]["limits"], vals)
    failed = sum(1 for s in rec["steps"] if not (math.isfinite(s["loss"]) and math.isfinite(s["loss_d"])))
    return {"attempted": len(rec["steps"]), "failed": failed,
            "e2e": {"setup_s": setup_s, "train_step_ms": rec["train_step_ms"]}, "record": rec,
            "device": win["device"], "checks": checks, "breakdown": win["breakdown"], "readings": vals,
            "control": control}
