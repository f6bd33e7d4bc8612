"""What decides ``correct`` in the WaveRNN training cell: the reference
follows the first steps of the one training state that the window then
drives, from the same weights and on the same windows, with its own
clipping (by the global norm) and Adam (bias-corrected, epsilon outside
the root).  The numbers and their rules are the Tacotron training cell's
(``compare/train_tacotron.py``): ``loss_gap``, ``grad_gap`` and
``update_gap``.  The control puts the reference computed with TF32 in the
program's place.
"""

from __future__ import annotations

import torch

from ..reference import precision
from ..reference import wavernn as RW
from .train_tacotron import compare_steps, judge, leaves, rebuild  # noqa: F401

BETA1, BETA2, EPS = 0.9, 0.999, 1e-8  # optax.adam's defaults


def reference_steps(conf: dict, params0, batches: list, dev, tf32: bool = False) -> dict:
    wc, wt = conf["wavernn"], conf["wavernn_train"]
    b1, b2, eps = BETA1, BETA2, EPS
    p = {path: v.detach().clone() for path, v in leaves(params0)}
    m = {k: torch.zeros_like(v) for k, v in p.items()}
    v2 = {k: torch.zeros_like(v) for k, v in p.items()}
    out = {"losses": []}
    for s, batch in enumerate(batches):
        with precision(tf32):
            w = {k: t.detach().requires_grad_(True) for k, t in p.items()}
            logits, stats = RW.train_logits(rebuild(params0, w), wc, batch["x"], batch["mels"])
            loss = RW.train_loss(logits, batch["y"])
            keys = list(w)
            gs = torch.autograd.grad(loss, [w[k] for k in keys], allow_unused=True)
        with torch.no_grad():
            g = {k: torch.zeros_like(p[k]) if gi is None else gi for k, gi in zip(keys, gs)}
            norm = torch.sqrt(sum(torch.sum(x * x) for x in g.values()))
            if float(norm) >= wt["grad_clip_norm"]:
                g = {k: x / norm * wt["grad_clip_norm"] for k, x in g.items()}
            c = torch.tensor(float(s + 1), dtype=torch.float32)
            bc1 = float(1.0 - torch.tensor(b1, dtype=torch.float32) ** c)
            bc2 = float(1.0 - torch.tensor(b2, dtype=torch.float32) ** c)
            for path, st in stats.items():
                p[path + ("mean",)] = st["mean"]
                p[path + ("var",)] = st["var"]
            for k in keys:
                m[k] = b1 * m[k] + (1.0 - b1) * g[k]
                v2[k] = b2 * v2[k] + (1.0 - b2) * (g[k] * g[k])
                p[k] = p[k] + -wt["lr"] * ((m[k] / bc1) / (torch.sqrt(v2[k] / bc2) + eps))
        if s == 0:
            out["g1"] = g
        out["losses"].append(float(loss.detach()))
    out["params"] = p
    return out


def readings(conf: dict, params0, batches: list, dev, program: dict | None, control: bool = False) -> dict:
    """As ``compare.train_tacotron.readings``."""
    return compare_steps(lambda tf32: reference_steps(conf, params0, batches, dev, tf32), params0, program,
                         BETA1, control)
