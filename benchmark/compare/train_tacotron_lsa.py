"""What decides ``correct`` in the location-sensitive Tacotron-2 training
cell: the comparison of ``compare/train_tacotron.py`` (the reference
follows the first steps of the one training state that the window then
drives, from the same weights, on the same batches and masks, with its own
clipping and Adam), with ``reference/tacotron_lsa.py``'s forward in place
of forward attention's.  The same numbers: ``loss_gap_1``, ``grad_gap``,
``update_gap_median`` (and the others ``compare_steps`` prints).
"""

from __future__ import annotations

import torch

from ..reference import precision
from ..reference import tacotron_lsa as RL
from . import train_tacotron as CMP

SYMBOLS = CMP.SYMBOLS
judge = CMP.judge


def reference_steps(conf: dict, params0, batches: list, seeds: list, dev, tf32: bool = False) -> dict:
    """The steps on ``batches`` from ``params0`` -> {losses, g1 (the first
    clipped gradient by path), params (after the last step, by path)}."""
    tc, tt = conf["tacotron"], conf["tacotron_train"]
    b1, b2, eps = tt["adam_beta1"], tt["adam_beta2"], tt["adam_eps"]
    p = {path: v.detach().clone() for path, v in CMP.leaves(params0)}
    m = {k: torch.zeros_like(v) for k, v in p.items()}
    v2 = {k: torch.zeros_like(v) for k, v in p.items()}
    out = {"losses": []}
    for s, (batch, sd) in enumerate(zip(batches, seeds)):
        gen = torch.Generator(device=dev)
        gen.manual_seed(int(sd))
        with precision(tf32):
            w = {k: t.detach().requires_grad_(True) for k, t in p.items()}
            tree = CMP.rebuild(params0, w)
            B, T_in = batch["inputs"].shape
            masks = RL.draw_masks(tc, B, T_in, batch["mel_targets"].shape[1], gen)
            frames, mel, stops, stats = RL.train_forward(tree, tc, batch, masks)
            loss = RL.loss(tree, tc, batch, frames, mel, stops, tt["reg_weight"])
            keys = list(w)
            gs = torch.autograd.grad(loss, [w[k] for k in keys], allow_unused=True)
        with torch.no_grad():
            g = {k: torch.zeros_like(p[k]) if gi is None else gi for k, gi in zip(keys, gs)}
            norm = torch.sqrt(sum(torch.sum(x * x) for x in g.values()))
            if float(norm) >= tt["grad_clip_norm"]:
                g = {k: x / norm * tt["grad_clip_norm"] for k, x in g.items()}
            c = torch.tensor(float(s + 1), dtype=torch.float32)
            factor = float(torch.sqrt(1.0 - b2 ** c) / (1.0 - b1 ** c))
            lr = CMP.lr_at(tt, s)
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


def readings(conf: dict, params0, batches: list, seeds: list, dev, program: dict | None,
             control: bool = False) -> dict:
    """The numbers compared, for the program's steps (``program``: its
    losses, its first Adam moment ``mu1`` and its parameters after the
    steps ``params3``), or with ``control`` for the TF32 reference."""
    run = lambda tf32: reference_steps(conf, params0, batches, seeds, dev, tf32)
    return CMP.compare_steps(run, params0, program, conf["tacotron_train"]["adam_beta1"], control)
