"""What decides ``correct`` in the HiFi-GAN training cell: the reference
(``reference/hifigan.py``: ``train.py``'s step with torch's own weight and
spectral norm and ``torch.optim.AdamW``) follows the first steps of the one
training state that the window then drives, from the same weights and
``u`` vectors, on the same segments.

Numbers compared, each against the limit the traffic mix states:

* ``loss_gap``: the widest relative gap of the discriminators' and the
  generator's loss over the steps;
* ``grad_gap_median_d`` and ``grad_gap_median_g``: the first step's
  gradient of each network as its AdamW got it (the program's first
  moment over 1 - beta1), by the median leaf: the gap between the two
  norms of a leaf over the reference's norm of that leaf or of the median
  leaf, whichever is larger (``compare.train_tacotron.gap_summary``, which
  also gives the worst leaf's gap and name);
* ``update_gap_median``: the parameters' change from the start after each
  step, by the median leaf as above over the leaves whose first reference
  gradient is at least a thousandth of the median leaf's, the widest over
  the steps;
* ``u_gap``: the largest difference of an element of the spectral-normed
  scale's ``u`` vectors after the steps.

The control (``control=True``) puts the reference computed with TF32 in
the program's place.
"""

from __future__ import annotations

import torch

from ..reference import hifigan as RH
from ..reference import precision
from .train_tacotron import _median, gap_summary, judge, leaves  # noqa: F401


def reference_steps(conf: dict, params0, sn0, batches: list, dev, tf32: bool = False) -> dict:
    with precision(tf32):
        return RH.gan_steps(conf, params0, sn0, batches, dev)


def _as_program(ref: dict, b1: float) -> dict:
    """A reference run in the form the program's steps are handed in."""
    mu1 = {("gen",) + k: v * (1.0 - b1) for k, v in ref["grads_g"].items()}
    mu1 |= {k: v * (1.0 - b1) for k, v in ref["grads_d"].items()}
    return {"loss_d": ref["loss_d"], "loss_g": ref["loss_g"], "mu1": mu1, "params": ref["params"], "u": ref["u"]}


def program_readings(program: dict) -> dict:
    """The program's steps (``program``: its losses ``loss_d``/``loss_g``, the
    first moments ``mu1_g``/``mu1_d`` after its first step, its params
    after each step ``params`` and its ``sn`` after the last) in the form
    ``compare`` reads."""
    mu1 = {("gen",) + k: v for k, v in leaves(program["mu1_g"])} | dict(leaves(program["mu1_d"]))
    params = [dict(leaves(p)) for p in program["params"]]
    sn = program["sn"]
    u = {("convs", j): x for j, x in enumerate(sn["convs"])} | {("conv_post",): sn["conv_post"]}
    return {"loss_d": program["loss_d"], "loss_g": program["loss_g"], "mu1": mu1, "params": params, "u": u}


def compare(got: dict, ref: dict, params0, b1: float) -> dict:
    p0 = dict(leaves(params0))
    gaps = [abs(a - b) / abs(b) for key in ("loss_d", "loss_g") for a, b in zip(got[key], ref[key])]
    g1 = {k: v / (1.0 - b1) for k, v in got["mu1"].items()}
    want_g = {("gen",) + k: v for k, v in ref["grads_g"].items()}
    want_d = dict(ref["grads_d"])
    want = want_g | want_d
    gnorm = {k: float(torch.linalg.vector_norm(v)) for k, v in want.items()}
    med = _median(list(gnorm.values()))
    moving = [k for k in gnorm if gnorm[k] >= 1e-3 * med]
    upd = []
    for got_p, ref_p in zip(got["params"], ref["params"]):
        d_ref = {k: ref_p[k] - p0[k] for k in p0}
        d_got = {k: got_p[k] - p0[k] for k in p0}
        upd.append(gap_summary(d_got, d_ref, moving, "update_gap"))
    worst = max(upd, key=lambda x: x["update_gap_median"])
    u_gap = max(float(torch.max(torch.abs(got["u"][k] - ref["u"][k]))) for k in ref["u"])
    out = {"loss_gap": max(gaps), "loss_gaps": gaps,
           **{k + "_d": v for k, v in gap_summary(g1, want_d, list(want_d), "grad_gap").items()},
           **{k + "_g": v for k, v in gap_summary(g1, want_g, list(want_g), "grad_gap").items()},
           "update_gap_median": worst["update_gap_median"], "update_gap": worst["update_gap"],
           "update_gap_leaf": worst["update_gap_leaf"], "u_gap": u_gap, "leaves_compared": len(moving)}
    return out


def readings(conf: dict, params0, sn0, batches: list, dev, program: dict | None, control: bool = False) -> dict:
    """The numbers compared, for the program's steps (``program``, as
    ``program_readings`` takes them) or, with ``control``, for the
    reference computed with TF32."""
    b1 = conf["hifigan_train"]["adam_b1"]
    ref = reference_steps(conf, params0, sn0, batches, dev)
    if control:
        got = _as_program(reference_steps(conf, params0, sn0, batches, dev, tf32=True), b1)
    else:
        got = program_readings(program)
    return compare(got, ref, params0, b1)
