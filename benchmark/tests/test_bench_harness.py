"""The harness refuses to run without a card, and nothing it loads
brings in JAX or the JAX package."""

import glob
import json
import os
import subprocess
import sys

from benchmark import core


def test_forbidden_names_compare_the_top_level_whole():
    mods = ["jax", "jax.numpy", "jaxlib.xla", "flax", "tacotronv2_wavernn_chinese_tpu.models",
            "tacotronv2_wavernn_chinese_tpu_torch.models", "jaxtyping", "numpy"]
    assert core.forbidden_modules(mods) == ["flax", "jax", "jax.numpy", "jaxlib.xla",
                                            "tacotronv2_wavernn_chinese_tpu.models"]


def test_import_check_in_a_fresh_interpreter():
    metrics = sorted(os.path.basename(p)[:-3] for p in glob.glob(os.path.join(core.HERE, "metrics", "*.py")))
    drivers = sorted(os.path.basename(p)[:-3] for p in glob.glob(os.path.join(core.HERE, "drivers", "*.py"))
                     if not p.endswith("__init__.py"))
    code = f"""
import sys, json
sys.path.insert(0, {core.ROOT!r})
from benchmark import core, run, calibrate, traffic_gen, weights, portcfg, work
from benchmark.compare import serve, train_tacotron
from benchmark.reference import tacotron, wavernn, griffin_lim, audio, rng, frontend
for d in {drivers!r}:
    core.driver(d)
for m in {metrics!r}:
    core.metric_reader(m)
import tacotronv2_wavernn_chinese_tpu_torch.serving.server, tacotronv2_wavernn_chinese_tpu_torch.train.tacotron_task
print(json.dumps(core.forbidden_modules()))
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=300,
                         env=dict(os.environ, JAX_PLATFORMS="cpu"))
    assert out.returncode == 0, out.stderr
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


def test_reference_imports_nothing_of_the_program():
    for path in glob.glob(os.path.join(core.HERE, "reference", "*.py")):
        text = open(path, encoding="utf-8").read()
        assert "tacotronv2_wavernn_chinese_tpu" not in text and "import jax" not in text, path


def test_no_card_no_result(card_absent):
    out = subprocess.run([sys.executable, os.path.join(core.HERE, "run.py"), "--workload",
                          "fwd-raw10.serve-poisson", "--seed", str(2**31 + 5), "--seconds", "1", "--trace", "0"],
                         capture_output=True, text=True, timeout=300, cwd=core.ROOT)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
    assert "torch.cuda.is_available() is false" in out.stderr


def test_checkout_without_the_program_gives_no_result(tmp_path):
    import shutil

    shutil.copytree(core.HERE, tmp_path / "benchmark", ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(core.ROOT, "BENCHMARK.json"), tmp_path / "BENCHMARK.json")
    out = subprocess.run([sys.executable, "benchmark/run.py", "--workload", "fwd-raw10.serve-poisson", "--seed",
                          "3", "--seconds", "1", "--trace", "0"], capture_output=True, text=True, timeout=300,
                         cwd=tmp_path)
    assert out.returncode != 0 and out.stdout.strip() == ""
