"""What decides ``correct`` in the Tacotron training cell: the reference
follows the first steps of the one training state that the window then
drives, from the same weights, on the same batches, with the same masks
(drawn again from each step's seed), and with its own clipping and Adam.

Numbers compared, each against the limit the traffic mix states:

* ``loss_gap_1``: the relative gap of the first step's loss, and
  ``loss_gap`` the widest of every step's;
* ``grad_gap``: the first step's gradient as the optimizer got it (the
  program's first Adam moment over 1 - beta1), by the worst leaf: the gap
  between the two norms of a leaf, over the reference's norm of that leaf
  or of the median leaf, whichever is larger;
* ``update_gap``: the parameters' change over the steps, by the worst leaf
  as above, over the leaves whose first reference gradient is at least a
  thousandth of the median leaf's (the others move by Adam's round-off);
  ``update_gap_median``, the same by the median leaf.  Each reading also
  names its worst leaf.

The control (``control=True``) puts the reference computed with TF32 in
the program's place.
"""

from __future__ import annotations

import math
import os

import torch

from ..reference import precision
from ..reference import tacotron as RT

SYMBOLS = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "reference", "symbols.txt")


def leaves(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from leaves(v, path + (k,))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from leaves(v, path + (i,))
    else:
        yield path, tree


def rebuild(tree, values, path=()):
    if isinstance(tree, dict):
        return {k: rebuild(v, values, path + (k,)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [rebuild(v, values, path + (i,)) for i, v in enumerate(tree)]
    return values[path]


def lr_at(tt: dict, step: int) -> float:
    """The recipe's learning rate: exponential decay from ``decay_start``,
    clipped to [final_lr, initial_lr], in float32."""
    t = torch.clamp_min(torch.tensor(float(step), dtype=torch.float32) - tt["decay_start"], 0.0)
    v = tt["initial_lr"] * tt["decay_rate"] ** (t / tt["decay_steps"])
    return float(torch.clamp(v, tt["final_lr"], tt["initial_lr"]))


def reference_steps(conf: dict, params0, batches: list, seeds: list, dev, tf32: bool = False) -> dict:
    """The steps on ``batches`` from ``params0`` -> {losses, g1 (the first
    clipped gradient by path), params (after the last step, by path)}."""
    tc, tt = conf["tacotron"], conf["tacotron_train"]
    b1, b2, eps = tt["adam_beta1"], tt["adam_beta2"], tt["adam_eps"]
    p = {path: v.detach().clone() for path, v in leaves(params0)}
    m = {k: torch.zeros_like(v) for k, v in p.items()}
    v2 = {k: torch.zeros_like(v) for k, v in p.items()}
    out = {"losses": []}
    for s, (batch, sd) in enumerate(zip(batches, seeds)):
        gen = torch.Generator(device=dev)
        gen.manual_seed(int(sd))
        with precision(tf32):
            w = {k: t.detach().requires_grad_(True) for k, t in p.items()}
            tree = rebuild(params0, w)
            B, T_in = batch["inputs"].shape
            masks = RT.draw_masks(tc, B, T_in, batch["mel_targets"].shape[1], gen)
            frames, mel, stops, stats = RT.train_forward(tree, tc, batch, masks)
            loss = RT.loss(tree, tc, batch, frames, mel, stops, tt["reg_weight"])
            keys = list(w)
            gs = torch.autograd.grad(loss, [w[k] for k in keys], allow_unused=True)
        with torch.no_grad():
            g = {k: torch.zeros_like(p[k]) if gi is None else gi for k, gi in zip(keys, gs)}
            norm = torch.sqrt(sum(torch.sum(x * x) for x in g.values()))
            if float(norm) >= tt["grad_clip_norm"]:
                g = {k: x / norm * tt["grad_clip_norm"] for k, x in g.items()}
            c = torch.tensor(float(s + 1), dtype=torch.float32)
            factor = float(torch.sqrt(1.0 - b2 ** c) / (1.0 - b1 ** c))
            lr = lr_at(tt, s)
            for (part, k), st in stats.items():
                p[(part, "layers", k, "bn", "mean")] = st["mean"]
                p[(part, "layers", k, "bn", "var")] = st["var"]
            for k in keys:
                m[k] = b1 * m[k] + (1.0 - b1) * g[k]
                v2[k] = b2 * v2[k] + (1.0 - b2) * g[k] * g[k]
                p[k] = p[k] + factor * m[k] / (torch.sqrt(v2[k]) + eps) * -lr
        if s == 0:
            out["g1"] = g
        out["losses"].append(float(loss.detach()))
    out["params"] = p
    return out


def _median(xs):
    xs = sorted(xs)
    return xs[len(xs) // 2] if xs else 0.0


def leaf_gaps(got: dict, want: dict, keys) -> dict:
    """| |got| - |want| | / max(|want|, the median leaf's |want|) of each of
    ``keys``."""
    norms = {k: float(torch.linalg.vector_norm(want[k])) for k in want}
    med = _median(list(norms.values()))
    out = {}
    for k in keys:
        g = float(torch.linalg.vector_norm(got[k]))
        d = max(norms[k], med)
        out[k] = abs(g - norms[k]) / d if d > 0 else (0.0 if g == 0 else math.inf)
    return out


def gap_summary(got: dict, want: dict, keys, name: str) -> dict:
    """The worst leaf's gap (and which leaf) and the median leaf's gap."""
    gaps = leaf_gaps(got, want, keys)
    at = max(gaps, key=gaps.get)
    return {name: gaps[at], name + "_leaf": "/".join(map(str, at)), name + "_median": _median(list(gaps.values()))}


def readings(conf: dict, params0, batches: list, seeds: list, dev, program: dict | None,
             control: bool = False) -> dict:
    """The numbers compared, for the program's steps (``program``: its
    losses, its first Adam moment ``mu1`` and its parameters after the
    steps ``params3``), or with ``control`` for the TF32 reference."""
    run = lambda tf32: reference_steps(conf, params0, batches, seeds, dev, tf32)
    return compare_steps(run, params0, program, conf["tacotron_train"]["adam_beta1"], control)


def compare_steps(run, params0, program: dict | None, beta1: float, control: bool) -> dict:
    """The numbers compared, from ``run(tf32)`` (the reference's steps) and
    the program's steps or, with ``control``, the TF32 reference's."""
    ref = run(False)
    p0 = dict(leaves(params0))
    if control:
        c = run(True)
        losses, g1, p3 = c["losses"], c["g1"], c["params"]
    else:
        losses = program["losses"]
        g1 = {k: v / (1.0 - beta1) for k, v in leaves(program["mu1"])}
        p3 = dict(leaves(program["params3"]))
    step_gaps = [abs(a - b) / abs(b) for a, b in zip(losses, ref["losses"])]
    gnorm = {k: float(torch.linalg.vector_norm(v)) for k, v in ref["g1"].items()}
    med = _median(list(gnorm.values()))
    moving = [k for k in gnorm if gnorm[k] >= 1e-3 * med]
    d_ref = {k: ref["params"][k] - p0[k] for k in p0}
    d_got = {k: p3[k] - p0[k] for k in p0}
    return {"loss_gap_1": step_gaps[0], "loss_gap": max(step_gaps), "loss_gaps": step_gaps,
            **gap_summary(g1, ref["g1"], list(gnorm), "grad_gap"),
            **gap_summary(d_got, d_ref, moving, "update_gap"), "leaves_compared": len(moving)}


def judge(limits: dict, values: dict) -> dict:
    from ..core import check

    return {k: check(values[k], limits[k]) for k in limits if k in values}
