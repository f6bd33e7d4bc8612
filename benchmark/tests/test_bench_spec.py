"""BENCHMARK.json against the benchmark's contract (names, units, keys,
bounds), and the harness finding each cell, mix, configuration and metric
by name, including ones added as new files only."""

import json
import os
import re
import shutil

import pytest

from benchmark import core

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")


def spec():
    return core.load_spec()


def line_ok(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_top_level_keys_and_limits():
    s = spec()
    assert set(s) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert 1 <= len(s["paths"]) <= 16 and all(PATH.match(p) and not p.startswith("/") for p in s["paths"])
    assert 1 <= len(s["command"]) <= 32 and all(line_ok(w) for w in s["command"])
    assert isinstance(s["run_seconds"], int) and 1 <= s["run_seconds"] <= 51
    assert len(json.dumps(s)) <= 64 * 1024


def test_configs():
    s = spec()
    used = {c["config"] for c in s["workloads"]}
    files = set()
    for c in s["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and c["name"] in used and line_ok(c["source"]) and line_ok(c["why"])
        assert any(c["file"].startswith(p + "/") for p in s["paths"]) and c["file"] not in files
        files.add(c["file"])
        assert len(c["reduced"]) <= 16 and all(NAME.match(k) for k in c["reduced"])
        conf = core.load_json(os.path.join(core.ROOT, c["file"]))
        assert conf["name"] == c["name"] and conf["reduced"] == c["reduced"]


def test_workloads():
    s = spec()
    names = [w["name"] for w in s["workloads"]]
    assert len(names) == len(set(names)) and 1 <= len(names) <= 24
    pairs = [(w["config"], w["traffic"]) for w in s["workloads"]]
    assert len(pairs) == len(set(pairs))
    for w in s["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"]) and w["chips"] in (1, 4) and line_ok(w["why"])
        tr = core.load_traffic(w["traffic"])
        assert os.path.exists(os.path.join(core.HERE, "drivers", tr["kind"] + ".py"))
    assert sum(w["chips"] == 4 for w in s["workloads"]) <= max(1, len(names) // 4)


def test_metrics():
    s = spec()
    e2e = {m["name"]: m for m in s["end_to_end"]}
    names = [m["name"] for m in s["end_to_end"] + s["per_layer"]]
    assert len(names) == len(set(names))
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    cells = {w["name"] for w in s["workloads"]}
    for m in s["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    layers = {}
    for m in s["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert line_ok(m["layer"]) and m["moves"] in e2e
        for c in m.get("workloads", cells):
            assert c in cells and c in e2e[m["moves"]].get("workloads", cells)
        core.metric_reader(m["name"])  # found by name
        layers.setdefault(m["layer"].lower(), set()).add(m["layer"])
    assert all(len(v) == 1 for v in layers.values())
    for m in s["end_to_end"] + s["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for c in cells:
        got = [m["name"] for m in core.cell_metrics(s, c, False)]
        assert "setup_s" in got and len(got) >= 2 and core.cell_metrics(s, c, True)


def test_roofline_and_mfu_names():
    for m in spec()["per_layer"]:
        if "roofline" in m["name"] or "mfu" in m["name"] or "share" in m["name"]:
            assert m["unit"] == "%"


def test_a_new_cell_mix_and_metric_are_files_only(tmp_path, monkeypatch):
    """A later change adds a cell, a mix and a metric by adding files and
    entries; the harness loads them without an edit to any file."""
    root = tmp_path / "checkout"
    shutil.copytree(core.HERE, root / "benchmark", ignore=shutil.ignore_patterns("__pycache__"))
    s = spec()
    s["workloads"].append({"name": "fwd-raw10.serve-dummy", "config": "tacotron2-fwd-wavernn-raw10",
                           "traffic": "serve-dummy", "chips": 1, "why": "a dummy"})
    s["per_layer"].append({"name": "dummy.rows", "unit": "rows", "better": "higher", "source": "program_counter",
                           "layer": "device", "moves": "request_p95_ms", "workloads": ["fwd-raw10.serve-dummy"]})
    (root / "BENCHMARK.json").write_text(json.dumps(s))
    mix = dict(core.load_traffic("serve-poisson-wavernn"), rate_per_s=1.5)
    (root / "benchmark" / "traffic" / "serve-dummy.json").write_text(json.dumps(mix))
    (root / "benchmark" / "metrics" / "dummy.rows.py").write_text("def read(rec):\n    return 42.0\n")
    sp = core.load_spec(str(root))
    cell = core.find_cell(sp, "fwd-raw10.serve-dummy")
    assert core.load_traffic(cell["traffic"], str(root))["rate_per_s"] == 1.5
    assert core.load_config(sp, cell["config"], str(root))["vocoder"] == "wavernn"
    assert core.metric_reader("dummy.rows", str(root))({}) == 42.0
    assert [m["name"] for m in core.cell_metrics(sp, cell["name"], True)][-1] == "dummy.rows"
    with pytest.raises(core.BenchError):
        core.find_cell(sp, "no-such-cell")
