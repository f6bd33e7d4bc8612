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
print(int("tacotronv2_wavernn_chinese_tpu_torch.utils.precision" in names))
from {PORT}.config import default_config
from {PORT}.data.preprocess import process_corpus
from {PORT}.dsp.spectrogram import MelPipeline
from {PORT}.infer.gta import generate_gta
from {PORT}.infer.wavernn_gen import gen_from_mel
from {PORT}.infer.synthesizer import Synthesizer
from {PORT}.serving.export import load_exported
from {PORT}.train.tacotron_train import run_training
from {PORT}.train import wavernn_train
from {PORT}.models.wavernn import generate_mol
from {PORT}.data.native_loader import NativeVocoderLoader, build_library
from {PORT}.utils.checkpoints import init_tacotron, init_wavernn
import numpy as np
cfg = default_config()
errors = 0
for call in (lambda: Synthesizer(cfg, init_tacotron(0, cfg.tacotron)),
             lambda: load_exported("does-not-matter"),
             lambda: run_training(cfg, "train.txt", "mels", "logs-never-written"),
             lambda: wavernn_train.run_training(cfg, "gta.txt", "gta", "logs-never-written"),
             lambda: MelPipeline(cfg.audio),
             lambda: process_corpus(cfg, "t.txt", "wavs", "never-written"),
             lambda: generate_gta(cfg, init_tacotron(0, cfg.tacotron), "m.txt", "d", "never-written"),
             lambda: gen_from_mel(cfg, init_wavernn(0, cfg.wavernn), np.zeros((4, 80), np.float32), "x.wav")):
    try:
        call()
    except RuntimeError as e:
        errors += "CUDA" in str(e)
print(errors)
# the MOL loop runs where its params are (no device of its own to resolve)
mol = default_config().override("wavernn.mode=MOL")
print(tuple(generate_mol(init_wavernn(0, mol.wavernn), mol.wavernn, np.zeros((1, 5, 80), np.float32)).shape))
print(callable(build_library) and hasattr(NativeVocoderLoader, "available"))
print(sum("{PORT}." + m in names for m in ("frontend.english", "models.wavernn_deepmind", "utils.display")))
print(sum("{PORT}." + m in names for m in ("parallel", "parallel.distributed", "parallel.mesh", "parallel.generate",
                                          "parallel.tp")))
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
    assert n >= 53  # every module of the port was imported, utils/precision.py among them
    assert probe[2] == "1"
    assert probe[6] == "3"  # and the English frontend, the DeepMind WaveRNN and the display helpers
    assert probe[7] == "5"  # and parallel/ (package, distributed, mesh, generate, tp)
    assert bad == "", f"the port loaded {bad}"


@pytest.mark.parametrize(
    "name", ["symbols.txt", "char_pinyin.tsv", "phrase_pinyin.tsv", "phrase_overrides.tsv"]
)
def test_frontend_data_is_byte_identical(name):
    a = os.path.join(REPO, "tacotronv2_wavernn_chinese_tpu", "frontend", "data", name)
    b = os.path.join(REPO, PORT, "frontend", "data", name)
    assert filecmp.cmp(a, b, shallow=False)


def test_entry_points_raise_without_gpu(probe):
    """The synthesizer, the artifact loader, the Tacotron trainer, the
    WaveRNN trainer, the mel pipeline, preprocessing, GTA and the WaveRNN
    generator each raise instead of dropping to the CPU."""
    assert probe[3] == "8"


def test_new_entry_points_import_alone(probe):
    """``generate_mol`` runs on CPU params without JAX (1 fold x 275
    samples) and the native loader's binding imports without building."""
    assert probe[4] == "(1, 275)"
    assert probe[5] == "True"


def test_chip_smoke_fails_without_card():
    out = subprocess.run([sys.executable, os.path.join(REPO, "chip_smoke.py")], capture_output=True,
                         text=True, cwd=REPO, timeout=300,
                         env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout
