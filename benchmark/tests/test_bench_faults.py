"""A run on the CPU at small widths, with the harness's look for a card
skipped: sound, it comes out correct; with the timed path broken
underneath (a token, a frame or a pronunciation altered where it is
produced, a decoder
whose state never moves, a training step that returns its state unchanged
or that leaves out half of its batch), ``correct`` comes out false."""

import pytest

from benchmark import run as R

from .conftest import tiny_context

SERVE, TRAIN = "fwd-raw10.serve-poisson", "fwd-raw10.train-tacotron"


def correct(ctx) -> tuple:
    import json

    line, _ = R.run_cell(ctx)
    out = json.loads(line)
    return out["correct"], {k: v["value"] for k, v in out["checks"].items()}


@pytest.mark.parametrize("cell", [SERVE, TRAIN, "fwd-gl.serve-poisson", "fwd-raw10.train-wavernn"])
def test_sound_run_is_correct(cell, tmp_path):
    ok, checks = correct(tiny_context(cell, 2**31 + 3, str(tmp_path)))
    assert ok, checks


def test_altered_token_is_caught(monkeypatch, tmp_path):
    from tacotronv2_wavernn_chinese_tpu_torch.ops import wavernn_kernel as WK

    orig = WK.sample_labels

    def broken(cond, w, seed, greedy=False):
        labels = orig(cond, w, seed, greedy).clone()
        labels[7] = (labels[7] + 5) % w["wfc3"].shape[0]
        return labels

    monkeypatch.setattr(WK, "sample_labels", broken)
    ok, checks = correct(tiny_context(SERVE, 2**31 + 4, str(tmp_path)))
    assert not ok and checks["vocoder_gap"] > 0


@pytest.mark.parametrize("fault", ["frame", "stale"])
def test_broken_decoder_is_caught(monkeypatch, fault, tmp_path):
    from tacotronv2_wavernn_chinese_tpu_torch.models import tacotron as T

    orig = T.decode_autoregressive

    def broken(params, cfg, memory, mem_mask, seeds, max_iters=None):
        frames, stops, aligns, lens = orig(params, cfg, memory, mem_mask, seeds, max_iters)
        frames = frames.clone()
        if fault == "frame":
            frames[:, 3] += 0.01
        else:  # a decoder whose state never moves: every step repeats the first
            frames[:] = frames[:, :1]
        return frames, stops, aligns, lens

    monkeypatch.setattr(T, "decode_autoregressive", broken)
    ok, checks = correct(tiny_context("fwd-gl.serve-poisson", 2**31 + 5, str(tmp_path)))
    assert not ok and checks["decoder_gap"] > 1e-3


@pytest.mark.parametrize("fault", ["unchanged", "half_batch"])
def test_broken_train_step_is_caught(monkeypatch, fault, tmp_path):
    from tacotronv2_wavernn_chinese_tpu_torch.train import tacotron_task as task

    orig = task.train_step

    def broken(state, batch, generator, cfg, mesh=None):
        if fault == "unchanged":
            new, metrics = orig(state, batch, generator, cfg, mesh)
            return task.TrainState(new.step, state.params, new.opt_state), metrics
        half = {k: v[: v.shape[0] // 2] for k, v in batch.items()}
        return orig(state, half, generator, cfg, mesh)

    monkeypatch.setattr(task, "train_step", broken)
    ok, checks = correct(tiny_context(TRAIN, 2**31 + 6, str(tmp_path)))
    assert not ok, checks


@pytest.mark.parametrize("fault", ["crossfade", "pcm"])
def test_altered_answer_is_caught(monkeypatch, fault, tmp_path):
    import numpy as np

    if fault == "crossfade":
        from tacotronv2_wavernn_chinese_tpu_torch.models import wavernn as W

        orig = W.xfade_and_unfold
        monkeypatch.setattr(W, "xfade_and_unfold", lambda y, overlap: orig(y, overlap) * np.float32(0.999))
        key = "crossfade_gap"
    else:
        from tacotronv2_wavernn_chinese_tpu_torch.serving import server as SRV

        orig = SRV.wav_to_base64

        def broken(wav, sr):
            w = np.array(wav, np.float32, copy=True)
            w[len(w) // 2] += 0.5
            return orig(w, sr)

        monkeypatch.setattr(SRV, "wav_to_base64", broken)
        key = "pcm_gap"
    ok, checks = correct(tiny_context(SERVE, 2**31 + 8, str(tmp_path)))
    assert not ok and checks[key] > 0


def test_altered_pronunciation_is_caught(monkeypatch, tmp_path):
    """A valid but wrong reading (one tone changed) from the G2P."""
    import re

    from tacotronv2_wavernn_chinese_tpu_torch.infer import synthesizer as SY

    orig = SY.get_pyin

    def broken(text, *args, **kw):
        pyin, norm = orig(text, *args, **kw)
        return re.sub(r"([a-z])([1-4])", lambda m: m.group(1) + str(int(m.group(2)) % 4 + 1), pyin, count=1), norm

    monkeypatch.setattr(SY, "get_pyin", broken)
    ok, checks = correct(tiny_context("fwd-gl.serve-poisson", 2**31 + 9, str(tmp_path)))
    assert not ok and checks["g2p_mismatch"] > 0
