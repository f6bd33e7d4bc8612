"""The Tacotron loader's read-ahead on the card: its batches come out in
pinned memory, ``batch_to_device`` copies them without blocking into the
tensors the pageable path gives, a batch's host arrays stay as they were
while the next three are copied, a training step on a read-ahead batch is
the step on the synchronous assembly of the same rows, and a training run
leaves no thread of the loader's pool behind."""

import dataclasses
import gc
import threading
import time

import numpy as np
import pytest
import torch

from tacotronv2_wavernn_chinese_tpu_torch.config import default_config
from tacotronv2_wavernn_chinese_tpu_torch.data import loader as DL
from tacotronv2_wavernn_chinese_tpu_torch.train import tacotron_task as TT
from tacotronv2_wavernn_chinese_tpu_torch.train import tacotron_train as TR
from tacotronv2_wavernn_chinese_tpu_torch.utils import tree_leaves
from tacotronv2_wavernn_chinese_tpu_torch.utils.checkpoints import init_tacotron

SMALL = dict(embedding_dim=16, enc_conv_channels=16, enc_conv_layers=2, encoder_lstm_units=16, attention_dim=16,
             attention_filters=4, attention_kernel=7, prenet_layers=(16, 16), decoder_lstm_units=32,
             postnet_channels=16, postnet_layers=2, attention_mode="lsa")


def _cfg(**train):
    cfg = default_config()
    return dataclasses.replace(cfg, tacotron=dataclasses.replace(cfg.tacotron, **SMALL),
                               tacotron_train=dataclasses.replace(cfg.tacotron_train, batch_size=4,
                                                                  batches_per_group=2, **train))


@pytest.fixture
def corpus(tmp_path):
    d = str(tmp_path / "corpus")
    return d, DL.write_synthetic_corpus(d, 19, (5, 30), (20, 70), seed=4)


def _pageable(batch):
    return dataclasses.replace(batch, **{f: getattr(batch, f).copy() for f in TR.BATCH_FIELDS}, pinned=None)


def _pool_threads():
    return [t for t in threading.enumerate() if t.name.startswith("tacotron-loader")]


@pytest.mark.card
def test_read_ahead_batches_are_pinned_and_copy_as_the_pageable_path(card, corpus):
    ds = DL.TacotronDataset(DL.read_metadata(corpus[1]), corpus[0], _cfg())
    gen = ds.batches(0)
    held = next(gen)
    assert held.pinned is not None and list(held.pinned) == list(TR.BATCH_FIELDS)
    for f in TR.BATCH_FIELDS:
        t = held.pinned[f]
        assert t.is_pinned() and getattr(held, f).ctypes.data == t.data_ptr(), f
    saved = _pageable(held)
    on_card = TR.batch_to_device(held, card)
    copied = [TR.batch_to_device(next(gen), card) for _ in range(3)]  # not synchronised: copies in flight
    torch.cuda.synchronize()
    for f in TR.BATCH_FIELDS:
        np.testing.assert_array_equal(getattr(held, f), getattr(saved, f), err_msg=f)
    plain = TR.batch_to_device(saved, card)
    for f in TR.BATCH_FIELDS:
        assert on_card[f].is_cuda and on_card[f].dtype == plain[f].dtype and torch.equal(on_card[f], plain[f]), f
    assert all(c["mel_targets"].is_cuda for c in copied)
    gen.close()


@pytest.mark.card
def test_a_step_on_a_read_ahead_batch_is_the_step_on_the_synchronous_batch(card, corpus):
    cfg = _cfg()
    ds = DL.TacotronDataset(DL.read_metadata(corpus[1]), corpus[0], cfg)
    gen = ds.batches(5)
    ahead = next(gen)
    gen.close()
    sync = ds._make_batch(ds.plan(5)[0], *ds._multiples(None, None))
    assert ahead.pinned is not None and sync.pinned is None

    def step(batch):
        params = init_tacotron(3, cfg.tacotron, device=card)
        state = TT.TrainState(0, params, TT.adam_init(params))
        g = torch.Generator(device=card).manual_seed(77)
        state, metrics = TT.train_step(state, TR.batch_to_device(batch, card), g, cfg)
        return metrics["loss"], tree_leaves(state.params)

    loss_a, params_a = step(ahead)
    loss_s, params_s = step(sync)
    assert abs(loss_a - loss_s) <= 1e-6 * abs(loss_s)
    for a, b in zip(params_a, params_s):
        assert float((a - b).abs().max()) <= 1e-6 * max(float(b.abs().max()), 1e-30)


@pytest.mark.card
def test_a_training_run_leaves_no_loader_thread(card, corpus, tmp_path):
    before = set(_pool_threads())
    # 4 batches an epoch: the first epoch ends whole, the second is cut at step 6
    state = TR.run_training(_cfg(), corpus[1], corpus[0], str(tmp_path / "logs"), total_steps=6, render_eval=False,
                            log=lambda *_: None, device=card)
    assert state.step == 6
    gc.collect()
    end = time.monotonic() + 1.0
    while set(_pool_threads()) - before and time.monotonic() < end:
        time.sleep(0.01)
    assert not set(_pool_threads()) - before
