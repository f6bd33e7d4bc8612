"""The location-sensitive Tacotron-2 training cell (``shen-lsa.train-tacotron``):
on the CPU at small widths its driver runs a short window whose checks
pass, a training step that returns its state unchanged or leaves out half
its batch fails a limit, and its new readers find nothing in a record
without the program's spans.  On the card (``card``): the control fails a
limit on three seeds while the program passes, and a traced run gives a
value for each of the cell's per-layer metrics."""

import argparse
import json
import time

import pytest

from benchmark import core
from benchmark import run as R

from .conftest import TINY
from .test_bench_control import fails_a_limit

CELL = "shen-lsa.train-tacotron"
NEW_READERS = ("lsa_decoder_roofline.train", "train.backward_ms", "train.launches_per_step")


def lsa_context(seed: int, workdir: str, seconds: float = 2.0):
    """A run of the cell at small widths and a short window on the CPU."""
    args = argparse.Namespace(workload=CELL, seed=seed, seconds=seconds, trace=0, rate=None)
    ctx = R.make_context(args, device="cpu", patch=dict(TINY, tacotron_train={"batch_size": 4}), workdir=workdir,
                         t_start=time.monotonic())
    c = dict(ctx.traffic["corpus"], utterances=16, frames_median=30, frames_min=16, frames_max=48,
             frames_per_symbol=4, symbols_min=4, symbols_max=12)
    ctx.traffic = dict(ctx.traffic, corpus=c)
    return ctx


def run_line(ctx) -> dict:
    line, _ = R.run_cell(ctx)
    return json.loads(line)


def test_a_sound_run_is_correct(tmp_path):
    out = run_line(lsa_context(2**33 + 21, str(tmp_path)))
    assert out["correct"], out["checks"]
    assert set(out["checks"]) == {"loss_gap_1", "grad_gap_median", "update_gap_median"}
    assert set(out["metrics"]) == {"setup_s", "train_step_ms"} and out["attempted"] >= 1


@pytest.mark.parametrize("fault", ["unchanged", "half_batch"])
def test_a_broken_train_step_fails_a_limit(monkeypatch, fault, tmp_path):
    from tacotronv2_wavernn_chinese_tpu_torch.train import tacotron_task as task

    orig = task.train_step

    def broken(state, batch, generator, cfg, mesh=None):
        if fault == "unchanged":
            new, metrics = orig(state, batch, generator, cfg, mesh)
            return task.TrainState(new.step, state.params, new.opt_state), metrics
        return orig(state, {k: v[: v.shape[0] // 2] for k, v in batch.items()}, generator, cfg, mesh)

    monkeypatch.setattr(task, "train_step", broken)
    out = run_line(lsa_context(2**33 + 22, str(tmp_path)))
    assert not out["correct"], out["checks"]


@pytest.mark.parametrize("name", NEW_READERS)
def test_the_new_readers_find_nothing_without_spans(name):
    steps = [{"t0": 0.0, "t1": 0.1, "load_s": 0.01, "lengths": [5], "frames": [20]}]
    conf = {"tacotron": core.load_json(f"{core.HERE}/configs/tacotron2-shen-lsa.json")["tacotron"]}
    read = core.metric_reader(name)
    for rec in ({}, {"steps": steps, "conf": conf, "model": "tacotron"},
                {"steps": steps, "conf": conf, "spans": [], "program_counters": {"launches": {}}}):
        assert read(rec) is None


def test_the_roofline_reads_the_decoder_spans_of_the_steps_before_the_trace():
    from benchmark.work import lsa

    tc = core.load_json(f"{core.HERE}/configs/tacotron2-shen-lsa.json")["tacotron"]
    ms = 1_000_000

    def span(i, name, t0, t1, parent=None, dev_ms=None):
        s = {"name": name, "id": i, "parent": parent, "trace": i, "thread": 1, "ident": None, "t0": t0 * ms,
             "t1": t1 * ms, "attrs": {}}
        if dev_ms is not None:
            s["dev_ms"] = dev_ms
        return s

    steps = [{"t0": 0.0, "t1": 0.1, "lengths": [50, 60], "frames": [300, 400]},
             {"t0": 0.1, "t1": 0.2, "lengths": [20], "frames": [120], "profiled": True}]
    spans = [span(1, "train.step", 10, 90, dev_ms=80.0), span(2, "train.forward", 10, 40, 1, 30.0),
             span(3, "tacotron.decoder", 15, 35, 2, 20.0),
             span(4, "train.step", 110, 190, dev_ms=80.0), span(5, "tacotron.decoder", 115, 135, 4, 20.0)]
    rec = {"steps": steps, "conf": {"tacotron": tc}, "spans": spans}
    want = 100.0 * lsa.decode_bound_s(tc, [(300, 50), (400, 60)]) / 0.020
    assert core.metric_reader("lsa_decoder_roofline.train")(rec) == pytest.approx(want)


@pytest.mark.card
def test_control_is_not_correct(card, tmp_path):
    for seed in (2**31 + 111, 2**31 + 112, 2**31 + 113):
        ns = argparse.Namespace(workload=CELL, seed=seed, seconds=4.0, trace=0, rate=None)
        workdir = tmp_path / str(seed)
        workdir.mkdir()
        ctx = R.make_context(ns, workdir=str(workdir), t_start=time.monotonic())
        ctx.control = True
        out = core.driver(ctx.traffic["kind"]).run(ctx)
        assert all(c["ok"] for c in out["checks"].values()), out["checks"]
        assert fails_a_limit(ctx.traffic["check"]["limits"], out["control"]), out["control"]


@pytest.mark.card
def test_a_traced_run_reads_every_per_layer_metric(card, tmp_path):
    ns = argparse.Namespace(workload=CELL, seed=2**31 + 114, seconds=12.0, trace=1, rate=None)
    ctx = R.make_context(ns, workdir=str(tmp_path), t_start=time.monotonic())
    out = run_line(ctx)
    want = {m["name"] for m in core.cell_metrics(ctx.spec, CELL, True)}
    assert out["correct"] and set(out["metrics"]) == want, (out["metrics"], out["checks"])
    assert 0.0 < out["metrics"]["lsa_decoder_roofline.train"]["value"] <= 100.0
