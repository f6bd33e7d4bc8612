"""The control: the reference computed one precision below the
configuration's (TF32 for float32 with TF32 off), put in the program's
place, has to come out not correct, while the program on the same run
comes out correct.  On the card, at full widths and a short window."""

import argparse
import time

import pytest

from benchmark import core
from benchmark import run as R

from .conftest import GL_CELL, root_of


def fails_a_limit(limits: dict, values: dict) -> bool:
    return any(not core.check(values[k], limits[k])["ok"] for k in limits if k in values)


@pytest.mark.card
@pytest.mark.parametrize("cell", ["fwd-raw10.serve-poisson", GL_CELL, "fwd-raw10.train-tacotron",
                                  "fwd-raw10.train-wavernn"])
def test_control_is_not_correct(card, cell, tmp_path):
    for seed in (2**31 + 101, 2**31 + 102, 2**31 + 103):
        ns = argparse.Namespace(workload=cell, seed=seed, seconds=4.0, trace=0, rate=None)
        workdir = tmp_path / str(seed)
        workdir.mkdir()
        ctx = R.make_context(ns, root=root_of(cell, tmp_path), workdir=str(workdir), t_start=time.monotonic())
        ctx.control = True
        out = core.driver(ctx.traffic["kind"]).run(ctx)
        limits = ctx.traffic["check"]["limits"]
        assert all(c["ok"] for c in out["checks"].values()), out["checks"]
        assert fails_a_limit(limits, out["control"]), out["control"]
