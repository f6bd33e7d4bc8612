"""The port's training data path and training loop: the loader gives the JAX
package's batches on the same corpus, ``run_training`` on the CPU trains,
checkpoints (at exactly each interval) and resumes, and a NaN loss aborts
the run."""

import dataclasses
import os
import sys

import numpy as np
import pytest

from tacotronv2_wavernn_chinese_tpu.config import default_config as jax_default_config
from tacotronv2_wavernn_chinese_tpu.data.loader import TacotronDataset as JaxDataset
from tacotronv2_wavernn_chinese_tpu.data.preprocess import read_metadata as jax_read_metadata
from tacotronv2_wavernn_chinese_tpu_torch.config import default_config
from tacotronv2_wavernn_chinese_tpu_torch.data.loader import (
    TacotronDataset, read_metadata, write_synthetic_corpus,
)
from tacotronv2_wavernn_chinese_tpu_torch.train import tacotron_task as task
from tacotronv2_wavernn_chinese_tpu_torch.train import tacotron_train as TR
from tacotronv2_wavernn_chinese_tpu_torch.utils.checkpoints import CheckpointManager
from tacotronv2_wavernn_chinese_tpu_torch.utils.metrics import read_scalars

OVERRIDE = "tacotron_train.batch_size=3,tacotron_train.batches_per_group=2"


def _tiny(**train):
    cfg = default_config().override(OVERRIDE)
    tac = dataclasses.replace(
        cfg.tacotron, embedding_dim=32, enc_conv_channels=32, enc_conv_layers=2,
        encoder_lstm_units=16, attention_dim=16, attention_filters=8, attention_kernel=7,
        prenet_layers=(32, 32), decoder_lstm_units=32, postnet_channels=32, postnet_layers=2,
    )
    return dataclasses.replace(cfg, tacotron=tac,
                               tacotron_train=dataclasses.replace(cfg.tacotron_train, **train))


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    d = tmp_path_factory.mktemp("corpus")
    return str(d), write_synthetic_corpus(str(d), 13, (5, 30), (20, 70), seed=3)


def test_loader_matches_jax(corpus):
    d, meta = corpus
    rows = read_metadata(meta)
    assert rows == jax_read_metadata(meta) and len(rows) == 13
    assert all(len(r) == 6 for r in rows)
    tds = TacotronDataset(rows, d, default_config().override(OVERRIDE))
    jds = JaxDataset(jax_read_metadata(meta), d, jax_default_config().override(OVERRIDE))
    n = 0
    for seed in (0, 1):
        for tb, jb in zip(tds.batches(epoch_seed=seed), jds.batches(epoch_seed=seed), strict=True):
            for f in ("inputs", "input_lengths", "mel_targets", "stop_targets", "target_lengths",
                      "loss_frames"):
                np.testing.assert_array_equal(getattr(tb, f), getattr(jb, f), err_msg=f)
            assert tb.indices == jb.indices
            n += 1
    assert n == 8  # 13 utterances, batches of 3, remainder dropped, 2 epochs
    assert tds.padding_stats([0]) == jds.padding_stats([0])


def test_run_training_checkpoints_and_resumes(corpus, tmp_path):
    d, meta = corpus
    cfg = _tiny(checkpoint_interval=2)
    logs = []
    st = TR.run_training(cfg, meta, d, str(tmp_path), total_steps=3, device="cpu", log=logs.append)
    assert st.step == 3
    mgr = CheckpointManager(os.path.join(str(tmp_path), "taco_pretrained"))
    assert mgr.all_steps() == [2, 3]
    assert os.path.exists(tmp_path / "eval" / "step-2-align.png") or not _has_matplotlib()
    rows = read_scalars(str(tmp_path / "scalars.jsonl"))
    assert [r["step"] for r in rows] == [1, 2, 3] and all(np.isfinite(r["loss"]) for r in rows)
    logs.clear()
    st2 = TR.run_training(cfg, meta, d, str(tmp_path), total_steps=5, device="cpu", log=logs.append)
    assert "restored checkpoint at step 3" in logs
    assert st2.step == 5 and st2.opt_state["count"] == 5
    saved = mgr.restore("cpu", step=3)
    assert saved["step"] == 3 and saved["opt_state"]["count"] == 3


def _has_matplotlib():
    try:
        import matplotlib  # noqa: F401
    except ImportError:
        return False
    return True


def test_cli_runs_on_the_cpu(corpus, tmp_path, monkeypatch):
    d, meta = corpus
    monkeypatch.setattr(TR, "default_config", lambda: _tiny())
    monkeypatch.setattr(sys, "argv", ["tacotron_train", "--metadata", meta, "--mel-dir", d, "--log-dir",
                                      str(tmp_path), "--steps", "2", "--no-render", "--device", "cpu"])
    TR.main()
    assert CheckpointManager(os.path.join(str(tmp_path), "taco_pretrained")).latest_step() == 2


def test_nan_loss_raises_loss_explosion(corpus, tmp_path, monkeypatch):
    d, meta = corpus
    real = task.train_step

    def nan_step(*a, **kw):
        state, metrics = real(*a, **kw)
        return state, dict(metrics, loss=float("nan"))

    monkeypatch.setattr(task, "train_step", nan_step)
    with pytest.raises(TR.LossExplosion):
        TR.run_training(_tiny(), meta, d, str(tmp_path), total_steps=3, device="cpu", log=lambda m: None)


@pytest.mark.parametrize("interval,total", [(2, 5), (2, 4)])
def test_checkpoints_land_on_every_interval(corpus, tmp_path, interval, total):
    """One step per batch: a checkpoint at every multiple of
    ``checkpoint_interval`` and at the end, across epochs, and at no other
    step."""
    d, meta = corpus
    logs = []
    st = TR.run_training(_tiny(checkpoint_interval=interval), meta, d, str(tmp_path), total_steps=total,
                         device="cpu", render_eval=False, log=logs.append)
    assert st.step == st.opt_state["count"] == total
    multiples = list(range(interval, total + 1, interval))
    assert [m for m in logs if m.startswith("saved checkpoint")] == [f"saved checkpoint at step {s}"
                                                                      for s in multiples]
    steps = CheckpointManager(os.path.join(str(tmp_path), "taco_pretrained")).all_steps()
    assert steps == sorted(set(multiples) | {total})
