"""Corpus preprocessing (``data/preprocess.py``) and the GTA bridge
(``infer/gta.py``) of the port against the JAX package's on the CPU.

The corpus is three short formant-like wavs that scipy writes (one at
16 kHz, resampled on load) with a Biaobei transcript.  Tolerances
(measured in brackets):
- ``process_corpus``: equal metadata rows and audio arrays; mels within
  1e-4 normalized units [2.1e-5];
- ``generate_gta`` at prenet dropout 0 (``--override``; zoneout runs in its
  deterministic eval mode): equal labels, ground-truth mels, file names and
  metadata; predicted mels within 1e-4 [6.0e-8].
"""

from __future__ import annotations

import dataclasses
import os

import jax
import numpy as np
import pytest
from scipy.io import wavfile

from tacotronv2_wavernn_chinese_tpu.config import default_config as jax_default_config
from tacotronv2_wavernn_chinese_tpu.data import loader as JL
from tacotronv2_wavernn_chinese_tpu.data import preprocess as JP
from tacotronv2_wavernn_chinese_tpu.infer import gta as JGTA
from tacotronv2_wavernn_chinese_tpu.models import tacotron as JT
from tacotronv2_wavernn_chinese_tpu_torch.config import default_config
from tacotronv2_wavernn_chinese_tpu_torch.data import loader as PL
from tacotronv2_wavernn_chinese_tpu_torch.data import preprocess as PP
from tacotronv2_wavernn_chinese_tpu_torch.infer import gta as PGTA
from tacotronv2_wavernn_chinese_tpu_torch.models import tacotron as PT
from tacotronv2_wavernn_chinese_tpu_torch.utils.checkpoints import init_tacotron, save_params_npz

TEXTS = ["你好，欢迎使用语音合成系统。", "今天天气很好。", "这是第3个测试句子。"]
TINY = ("tacotron.embedding_dim=16,tacotron.enc_conv_channels=16,tacotron.enc_conv_layers=1,"
        "tacotron.encoder_lstm_units=8,tacotron.attention_dim=8,tacotron.attention_filters=4,"
        "tacotron.attention_kernel=5,tacotron.prenet_layers=(8,8),tacotron.decoder_lstm_units=8,"
        "tacotron.postnet_channels=8,tacotron.postnet_layers=1,tacotron.dropout_rate=0.0")


def formant_wav(seconds: float, sr: int, seed: int) -> np.ndarray:
    """A voiced-like signal: harmonics of a gliding f0 shaped by two formant
    peaks, a syllable envelope and silence at both ends."""
    rng = np.random.default_rng(seed)
    t = np.arange(int(seconds * sr)) / sr
    f0 = 110 + 40 * rng.uniform() + 20 * np.sin(2 * np.pi * 1.3 * t)
    phase = 2 * np.pi * np.cumsum(f0) / sr
    formants = rng.uniform([500, 1200], [800, 2200])
    y = sum(np.sin(k * phase) * sum(np.exp(-((k * f0 - f) / 150.0) ** 2) for f in formants) for k in range(1, 30))
    y *= 0.5 + 0.5 * np.sin(2 * np.pi * 3.0 * t) ** 2
    y = y / np.abs(y).max() * 0.6
    pad = np.zeros(int(0.2 * sr))
    return np.concatenate([pad, y + 0.002 * rng.standard_normal(len(y)), pad]).astype(np.float32)


def write_corpus(root: str, lengths=(0.6, 1.1, 0.8), rates=(22050, 16000, 22050)) -> tuple:
    wav_dir = os.path.join(root, "Wave")
    os.makedirs(wav_dir, exist_ok=True)
    lines = []
    for i, (text, sec, sr) in enumerate(zip(TEXTS, lengths, rates)):
        index = f"{i + 1:06d}"
        wavfile.write(os.path.join(wav_dir, f"{index}.wav"), sr, (formant_wav(sec, sr, i) * 32767).astype(np.int16))
        lines += [f"{index}\t{text}", "\tpinyin line of the corpus"]
    transcript = os.path.join(root, "000001-000003.txt")
    with open(transcript, "w", encoding="utf-8") as f:
        f.write("\n".join(lines) + "\n")
    return transcript, wav_dir


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """The corpus preprocessed by both packages."""
    root = str(tmp_path_factory.mktemp("corpus"))
    transcript, wav_dir = write_corpus(root)
    out_j, out_p = os.path.join(root, "jax"), os.path.join(root, "port")
    rows_j = JP.process_corpus(jax_default_config(), transcript, wav_dir, out_j, bucket_batch=2, log=lambda m: None)
    rows_p = PP.process_corpus(default_config(), transcript, wav_dir, out_p, bucket_batch=2, log=lambda m: None,
                               device="cpu")
    return transcript, wav_dir, out_j, out_p, rows_j, rows_p


def test_parse_and_condition_match_jax(corpus):
    transcript, wav_dir = corpus[:2]
    ju, pu = JP.parse_biaobei(transcript, wav_dir), PP.parse_biaobei(transcript, wav_dir)
    assert [dataclasses.astuple(u) for u in pu] == [dataclasses.astuple(u) for u in ju]
    assert len(pu) == 3
    for u in pu:
        a, b = JP.condition_wav(jax_default_config().audio, u.wav_path), PP.condition_wav(default_config().audio, u.wav_path)
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)
    assert PP.condition_wav(default_config().audio, os.path.join(wav_dir, "missing.wav")) is None


def test_process_corpus_matches_jax(corpus):
    _, _, out_j, out_p, rows_j, rows_p = corpus
    assert rows_p == rows_j and len(rows_p) == 3
    for audio, mel, n_samples, n_frames, _, _ in rows_p:
        a_j, a_p = np.load(os.path.join(out_j, audio)), np.load(os.path.join(out_p, audio))
        np.testing.assert_array_equal(a_p, a_j)
        assert a_p.shape == (n_samples,) and n_samples == n_frames * 275
        m_j, m_p = np.load(os.path.join(out_j, mel)), np.load(os.path.join(out_p, mel))
        assert m_p.shape == (n_frames, 80) and m_p.dtype == np.float32
        assert np.abs(m_p - m_j).max() <= 1e-4


def test_metadata_round_trip_and_cli(corpus, tmp_path):
    transcript, wav_dir, _, out_p, _, rows_p = corpus
    path = str(tmp_path / "train.txt")
    PP.write_metadata(rows_p, path)
    assert PP.read_metadata is PL.read_metadata
    assert PP.read_metadata(path) == [[str(x) for x in r] for r in rows_p]
    out = str(tmp_path / "cli")
    meta = PP.main(["--transcript", transcript, "--wav-dir", wav_dir, "--out-dir", out, "--device", "cpu",
                    "--num-shards", "2", "--shard-index", "1"])
    assert meta.endswith("train.txt.1") and PP.read_metadata(meta) == [[str(x) for x in rows_p[1]]]


def test_sequential_batches_match_jax(corpus):
    _, _, out_j, out_p, rows_j, _ = corpus
    meta = [[str(x) for x in r] for r in rows_j]
    cfg = default_config()
    jb = list(JL.TacotronDataset(meta, out_j, jax_default_config()).sequential_batches(2))
    pb = list(PL.TacotronDataset(meta, out_p, cfg).sequential_batches(2))
    assert len(pb) == len(jb) == 2
    for a, b in zip(pb, jb):
        assert a.indices == b.indices
        for f in ("inputs", "input_lengths", "stop_targets", "target_lengths", "loss_frames"):
            np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
        np.testing.assert_allclose(a.mel_targets, b.mel_targets, atol=1e-4)


@pytest.fixture(scope="module")
def gta(corpus, tmp_path_factory):
    _, _, out_j, _, rows_j, _ = corpus
    root = str(tmp_path_factory.mktemp("gta"))
    meta = os.path.join(root, "train.txt")
    JP.write_metadata(rows_j, meta)
    jcfg = jax_default_config().override(TINY)
    params = jax.jit(lambda k: JT.init_tacotron(k, jcfg.tacotron))(jax.random.PRNGKey(3))
    params = jax.device_get(params)
    npz = os.path.join(root, "taco.npz")
    save_params_npz(npz, params)
    gj = JGTA.generate_gta(jcfg, params, meta, out_j, os.path.join(root, "jax"), batch_size=2, log=lambda m: None)
    gp = PGTA.main(["--metadata", meta, "--data-dir", out_j, "--out-dir", os.path.join(root, "port"),
                    "--params-npz", npz, "--batch-size", "2", "--override", TINY, "--device", "cpu"])
    return root, meta, npz, params, gj, gp


def test_generate_gta_matches_jax(gta):
    root, _, _, _, gj, gp = gta
    with open(gj, encoding="utf-8") as f:
        lines_j = f.read().splitlines()
    with open(gp, encoding="utf-8") as f:
        lines_p = f.read().splitlines()
    assert lines_p == lines_j and len(lines_p) == 3
    for line in lines_p:
        wav, gt, pred, _ = line.split("|")
        lab_j, lab_p = np.load(os.path.join(root, "jax", wav)), np.load(os.path.join(root, "port", wav))
        assert lab_p.dtype == np.int16
        np.testing.assert_array_equal(lab_p, lab_j)
        np.testing.assert_array_equal(np.load(os.path.join(root, "port", gt)), np.load(os.path.join(root, "jax", gt)))
        p_j, p_p = np.load(os.path.join(root, "jax", pred)), np.load(os.path.join(root, "port", pred))
        assert p_p.shape == p_j.shape and p_p.min() >= 0.0 and p_p.max() <= 1.0
        assert np.abs(p_p - p_j).max() <= 1e-4


def test_gta_shards_merge_to_the_whole(gta, corpus):
    root, meta, _, params, _, gp = gta
    out = os.path.join(root, "sharded")
    cfg = default_config().override(TINY)
    for i in range(2):
        PGTA.generate_gta(cfg, params, meta, corpus[2], out, batch_size=2, shard_index=i, num_shards=2,
                          log=lambda m: None, device="cpu")
    merged = PGTA.merge_shards(out, 2)
    with open(merged, encoding="utf-8") as f:
        got = f.read().splitlines()
    with open(gp, encoding="utf-8") as f:
        whole = f.read().splitlines()
    assert sorted(got) == sorted(whole)
    for line in got:
        pred = line.split("|")[2]
        np.testing.assert_allclose(np.load(os.path.join(out, pred)), np.load(os.path.join(root, "port", pred)),
                                   atol=1e-5)


def test_gta_with_the_cbhg_head(gta, corpus, tmp_path, monkeypatch):
    """A predict_linear model (the fixture's weights plus a head) runs the
    head in GTA's eval forward, once per batch, and writes the predicted
    mels of the same model without it."""
    root, meta, _, params, _, gp = gta
    cfg = default_config().override(TINY + ",tacotron.predict_linear=true,tacotron.cbhg_kernels=4,"
                                    "tacotron.cbhg_conv_channels=8,tacotron.cbhg_projection=8,"
                                    "tacotron.cbhg_highway_units=8,tacotron.cbhg_rnn_units=8")
    head = init_tacotron(1, cfg.tacotron)
    params = dict(params, cbhg=head["cbhg"], linear_projection=head["linear_projection"])
    calls = []
    real = PT.apply_cbhg
    monkeypatch.setattr(PT, "apply_cbhg", lambda *a: calls.append(real(*a).shape) or real(*a))
    path = PGTA.generate_gta(cfg, params, meta, corpus[2], str(tmp_path), batch_size=2, log=lambda m: None,
                             device="cpu")
    assert [c[-1] for c in calls] == [1025, 1025]
    with open(path, encoding="utf-8") as f, open(gp, encoding="utf-8") as g:
        lines = f.read().splitlines()
        assert lines == g.read().splitlines()
    for line in lines:
        pred = line.split("|")[2]
        np.testing.assert_array_equal(np.load(os.path.join(str(tmp_path), pred)),
                                      np.load(os.path.join(root, "port", pred)))
