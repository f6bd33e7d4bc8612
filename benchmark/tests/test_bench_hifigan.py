"""The HiFi-GAN V1 training cell (``hifigan-v1.train-gan``): its work count
at the published widths, its files found by name as new files, a CPU run
of its driver at small widths whose checks pass, a training step that
returns its state unchanged or leaves out half its batch failing a limit,
and its readers finding nothing without the program's spans and reading
the steps before the trace.  On the card (``card``): the control fails a
limit on three seeds while the program passes, and a traced run gives a
value for each of the cell's per-layer metrics, its shares within (0,
100]."""

import argparse
import json
import time

import pytest

from benchmark import calibrate_hifigan, core
from benchmark import run as R
from benchmark.drivers import train_hifigan as DRV
from benchmark.work import hifigan as W

from .test_bench_control import fails_a_limit

CELL = "hifigan-v1.train-gan"
NEW_READERS = ("hifigan_gen_roofline.train", "hifigan_disc_roofline.train", "hifigan_train_mfu")
TINY = {"hifigan": {"upsample_initial_channel": 32, "mpd_channels": [4, 8, 16, 32, 32],
                    "msd_channels": [16, 16, 32, 32, 64, 64, 64]},
        "hifigan_train": {"batch_size": 2, "segment_size": 2048}}


def conf():
    return core.load_json(f"{core.HERE}/configs/hifigan-v1.json")


def test_the_generator_is_307_million_multiply_adds_a_frame():
    h = conf()["hifigan"]
    assert W.generator_macs_per_frame(h) == 307_052_544
    # a step of the published batch: about 3.4 TFLOP, the generator's forward 0.31 of it
    assert 3.3e12 < W.step_flops(h, 16, 8192) < 3.5e12
    assert abs(2 * 16 * 32 * W.generator_macs_per_frame(h) - 0.314e12) < 0.01e12


def test_the_cells_files_are_found_by_name():
    spec = core.load_spec()
    cell = core.find_cell(spec, CELL)
    tr = core.load_traffic(cell["traffic"])
    c = core.load_config(spec, cell["config"])
    assert tr["kind"] == "train_hifigan" and core.driver(tr["kind"]).run is DRV.run
    assert c["reduced"] == [] and core.config_entry(spec, cell["config"])["reduced"] == []
    assert [w["name"] for w in spec["workloads"]][-1] == CELL and spec["configs"][-1]["name"] == "hifigan-v1"
    assert [m["name"] for m in spec["per_layer"]][-3:] == list(NEW_READERS)
    got = {m["name"] for m in core.cell_metrics(spec, CELL, True)}
    assert got == set(NEW_READERS) | {"train.loader_wait_ms", "idle_share.train", "train.launches_per_step"}
    assert {m["name"] for m in core.cell_metrics(spec, CELL, False)} == {"train_step_ms", "setup_s"}
    DRV.port_config(c)  # every key of its sections is a field of the port's config


def hifigan_context(seed: int, workdir: str, seconds: float = 2.0):
    args = argparse.Namespace(workload=CELL, seed=seed, seconds=seconds, trace=0, rate=None)
    ctx = R.make_context(args, device="cpu", patch=TINY, workdir=workdir, t_start=time.monotonic())
    ctx.traffic = dict(ctx.traffic, corpus=dict(ctx.traffic["corpus"], utterances=12))
    return ctx


def run_line(ctx) -> dict:
    line, _ = R.run_cell(ctx)
    return json.loads(line)


def test_a_sound_run_is_correct(tmp_path):
    out = run_line(hifigan_context(2**33 + 31, str(tmp_path)))
    assert out["correct"], out["checks"]
    assert set(out["checks"]) == set(core.load_traffic("train-hifigan")["check"]["limits"])
    assert set(out["metrics"]) == {"setup_s", "train_step_ms"} and out["attempted"] >= 1


@pytest.mark.parametrize("fault", ["unchanged", "half_batch"])
def test_a_broken_train_step_fails_a_limit(monkeypatch, fault, tmp_path):
    from tacotronv2_wavernn_chinese_tpu_torch.train import hifigan_task as task

    monkeypatch.setattr(task, "train_step", task.train_step)  # restored after the test
    calibrate_hifigan.plant(fault)
    out = run_line(hifigan_context(2**33 + 32, str(tmp_path)))
    assert not out["correct"], out["checks"]


@pytest.mark.parametrize("name", NEW_READERS)
def test_the_new_readers_find_nothing_without_spans(name):
    steps = [{"t0": 0.0, "t1": 0.3, "load_s": 0.001, "rows": 16, "samples": 8192}]
    c = {"hifigan": conf()["hifigan"]}
    read = core.metric_reader(name)
    for rec in ({}, {"steps": steps, "conf": c, "model": "hifigan"},
                {"steps": steps, "conf": c, "spans": [], "program_counters": {"launches": {}}}):
        assert read(rec) is None


def test_the_readers_read_the_spans_of_the_steps_before_the_trace():
    h = conf()["hifigan"]
    ms = 1_000_000

    def span(i, name, t0, t1, parent=None, dev_ms=None):
        s = {"name": name, "id": i, "parent": parent, "trace": i, "thread": 1, "ident": None, "t0": t0 * ms,
             "t1": t1 * ms, "attrs": {}}
        if dev_ms is not None:
            s["dev_ms"] = dev_ms
        return s

    steps = [{"t0": 0.0, "t1": 0.3, "rows": 16, "samples": 8192},
             {"t0": 0.3, "t1": 0.6, "rows": 16, "samples": 8192, "profiled": True}]
    spans = [span(1, "train.step", 10, 290, dev_ms=250.0), span(2, "train.forward", 12, 60, 1, 40.0),
             span(3, "hifigan.generator", 12, 50, 2, 30.0), span(4, "hifigan.disc_step", 60, 160, 1, 100.0),
             span(5, "hifigan.gen_step", 160, 280, 1, 110.0), span(6, "train.backward", 200, 270, 5, 60.0),
             span(7, "hifigan.generator", 220, 270, 6, 50.0),
             span(8, "train.step", 310, 590, dev_ms=250.0), span(9, "hifigan.disc_step", 360, 460, 8, 1.0)]
    rec = {"steps": steps, "conf": {"hifigan": h}, "spans": spans}
    gen = core.metric_reader("hifigan_gen_roofline.train")(rec)
    disc = core.metric_reader("hifigan_disc_roofline.train")(rec)
    mfu = core.metric_reader("hifigan_train_mfu")(rec)
    assert gen == pytest.approx(100.0 * W.generator_bound_s(h, 16, 8192) / 0.080)
    assert disc == pytest.approx(100.0 * W.disc_step_bound_s(h, 16, 8192) / 0.100)
    assert mfu == pytest.approx(100.0 * W.step_flops(h, 16, 8192) / (0.3 * core.PEAK_F32_FLOP_PER_S))
    assert 0 < gen < 100 and 0 < disc < 100 and 0 < mfu < 100


@pytest.mark.card
def test_control_is_not_correct(card, tmp_path):
    for seed in (2**31 + 121, 2**31 + 122, 2**31 + 123):
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
    ns = argparse.Namespace(workload=CELL, seed=2**31 + 124, seconds=12.0, trace=1, rate=None)
    ctx = R.make_context(ns, workdir=str(tmp_path), t_start=time.monotonic())
    out = run_line(ctx)
    want = {m["name"] for m in core.cell_metrics(ctx.spec, CELL, True)}
    assert out["correct"] and set(out["metrics"]) == want, (out["metrics"], out["checks"])
    for name in NEW_READERS:
        assert 0.0 < out["metrics"][name]["value"] <= 100.0, name
