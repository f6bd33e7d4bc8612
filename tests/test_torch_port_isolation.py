"""The PyTorch port stands alone: importing any of its modules loads neither
JAX nor the JAX package, its frontend dictionaries are byte-identical
copies, and its entry points refuse to drop to the CPU silently."""

import filecmp
import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = "tacotronv2_wavernn_chinese_tpu_torch"

# One subprocess (the test process has JAX loaded) checks both: after
# importing every module of the port, neither JAX nor the JAX package is
# loaded; then the entry points, with no GPU and no device="cpu", raise.
_PROBE = f"""
import importlib, pkgutil, sys
import {PORT} as pkg
names = []
for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + "."):
    importlib.import_module(m.name)
    names.append(m.name)
bad = sorted(k for k in sys.modules if k == "jax" or k.startswith("jax.")
             or k == "tacotronv2_wavernn_chinese_tpu" or k.startswith("tacotronv2_wavernn_chinese_tpu."))
print(len(names))
print(",".join(bad))
from {PORT}.config import default_config
from {PORT}.infer.synthesizer import Synthesizer
from {PORT}.serving.export import load_exported
from {PORT}.train.tacotron_train import run_training
from {PORT}.utils.checkpoints import init_tacotron
cfg = default_config()
errors = 0
for call in (lambda: Synthesizer(cfg, init_tacotron(0, cfg.tacotron)),
             lambda: load_exported("does-not-matter"),
             lambda: run_training(cfg, "train.txt", "mels", "logs-never-written")):
    try:
        call()
    except RuntimeError as e:
        errors += "CUDA" in str(e)
print(errors)
"""


@pytest.fixture(scope="module")
def probe():
    env = dict(os.environ, PYTHONPATH=REPO, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run([sys.executable, "-c", _PROBE], capture_output=True, text=True, env=env,
                         cwd=REPO, timeout=300)
    assert out.returncode == 0, out.stderr
    return out.stdout.splitlines()


def test_port_imports_no_jax(probe):
    n, bad = int(probe[0]), probe[1]
    assert n >= 28  # every module of both slices was imported
    assert bad == "", f"the port loaded {bad}"


@pytest.mark.parametrize(
    "name", ["symbols.txt", "char_pinyin.tsv", "phrase_pinyin.tsv", "phrase_overrides.tsv"]
)
def test_frontend_data_is_byte_identical(name):
    a = os.path.join(REPO, "tacotronv2_wavernn_chinese_tpu", "frontend", "data", name)
    b = os.path.join(REPO, PORT, "frontend", "data", name)
    assert filecmp.cmp(a, b, shallow=False)


def test_entry_points_raise_without_gpu(probe):
    """The synthesizer, the artifact loader and the trainer each raise
    instead of dropping to the CPU."""
    assert probe[2] == "3"


def test_chip_smoke_fails_without_card():
    out = subprocess.run([sys.executable, os.path.join(REPO, "chip_smoke.py")], capture_output=True,
                         text=True, cwd=REPO, timeout=300,
                         env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout
