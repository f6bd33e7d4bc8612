"""The Tacotron loader's read-ahead (``data/loader.py`` ``TacotronDataset.batches``):
its batches are, byte for byte and in order, the synchronous assembly
(``_make_batch``) of the epoch's ``plan``; a batch it handed out stays as
it was while later ones are assembled; an epoch that ends, or is cut
short, stops its worker thread; a bad mel file raises at the batch that needed it; the
``loader`` counter and the ``data.wait`` / ``data.load`` spans agree with
what was consumed.  CPU only: the pinned path is in ``tests_card``."""

import os
import shutil
import threading
import time

import numpy as np
import pytest

from tacotronv2_wavernn_chinese_tpu_torch.config import default_config
from tacotronv2_wavernn_chinese_tpu_torch.data import loader as DL
from tacotronv2_wavernn_chinese_tpu_torch.utils import metrics as M

OVERRIDE = "tacotron_train.batch_size=3,tacotron_train.batches_per_group=2"
FIELDS = ("inputs", "input_lengths", "mel_targets", "stop_targets", "target_lengths", "loss_frames")


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("corpus"))
    return d, DL.write_synthetic_corpus(d, 23, (5, 30), (20, 70), seed=3)


def _dataset(d, meta):
    return DL.TacotronDataset(DL.read_metadata(meta), d, default_config().override(OVERRIDE))


def _same(a, b):
    for f in FIELDS:
        x, y = getattr(a, f), getattr(b, f)
        assert x.dtype == y.dtype and x.shape == y.shape and x.tobytes() == y.tobytes(), f
    assert a.indices == b.indices


def _gone(threads, timeout=1.0):
    """Whether every one of ``threads`` has left ``threading.enumerate()``
    within ``timeout`` seconds."""
    end = time.monotonic() + timeout
    while time.monotonic() < end:
        if not set(threads) & set(threading.enumerate()):
            return True
        time.sleep(0.01)
    return False


def _new_loader_threads(before):
    """The loader's worker threads alive now that were not in ``before``."""
    return [t for t in threading.enumerate() if t.name == "tacotron-loader" and t not in before]


def _f64_fortran_copy(d, meta, dst):
    """The corpus with every third mel stored as float64 and every third
    (shifted) in Fortran order: the files ``np.load`` reads, not
    ``readinto``."""
    shutil.copytree(d, dst)
    for i, row in enumerate(DL.read_metadata(meta)):
        path = os.path.join(dst, row[1])
        mel = np.load(path)
        if i % 3 == 0:
            np.save(path, mel.astype(np.float64))
        elif i % 3 == 1:
            np.save(path, np.asfortranarray(mel))
    return dst


CASES = {
    "seed0": dict(seed=0),
    "seed7_batch4": dict(seed=7, batch_size=4),
    "seed1_batch5_remainder_kept": dict(seed=1, batch_size=5, drop_remainder=False),
    "seed2_subset": dict(seed=2, indices=[20, 3, 17, 8, 11, 0, 5, 14, 9, 22, 1]),
    "seed4_subset_remainder_kept": dict(seed=4, batch_size=4, indices=[2, 4, 6, 8, 10, 12, 14, 16, 18, 19],
                                        drop_remainder=False),
    "seed3_batch1": dict(seed=3, batch_size=1),
    "seed5_multiples_8_16": dict(seed=5, input_multiple=8, mel_multiple=16),
    "seed6_float64_and_fortran_files": dict(seed=6, files="f64_fortran"),
}


@pytest.mark.parametrize("case", list(CASES), ids=list(CASES))
def test_read_ahead_batches_are_the_synchronous_assembly_in_order(corpus, tmp_path, case):
    kw = dict(CASES[case])
    d, meta = corpus
    if kw.pop("files", None):
        d = _f64_fortran_copy(d, meta, str(tmp_path / "mixed"))
    ds = _dataset(d, meta)
    seed = kw.pop("seed")
    bs, indices, keep = kw.pop("batch_size", None), kw.pop("indices", None), kw.pop("drop_remainder", True)
    plan = ds.plan(seed, bs, indices, keep)
    got = list(ds.batches(seed, bs, indices, drop_remainder=keep, **kw))
    assert len(got) == len(plan) > 0
    multiples = ds._multiples(kw.get("input_multiple"), kw.get("mel_multiple"))
    for batch, rows in zip(got, plan):
        _same(batch, ds._make_batch(rows, *multiples))
        assert batch.pinned is None  # no CUDA here: plain arrays
    if not keep:
        assert sum(len(b.indices) for b in got) == len(indices if indices is not None else ds.train_indices)
    assert sorted(i for b in got for i in b.indices) == sorted(i for rows in plan for i in rows)


def test_a_batch_is_unchanged_after_the_next_three_are_assembled(corpus):
    ds = _dataset(*corpus)
    gen = ds.batches(11)
    held = next(gen)
    saved = {f: getattr(held, f).copy() for f in FIELDS}
    later = [next(gen) for _ in range(3)]
    time.sleep(0.05)  # and whatever the workers assemble beyond them
    for f in FIELDS:
        np.testing.assert_array_equal(getattr(held, f), saved[f], err_msg=f)
        assert not any(np.shares_memory(getattr(held, f), getattr(b, f)) for b in later), f
    gen.close()


def _close(gen):
    gen.close()


def _drop(gen):
    pass  # the test's ``del`` drops the last reference


def _raise_in_consumer(gen):
    with pytest.raises(RuntimeError, match="consumer"):
        for _ in gen:
            raise RuntimeError("the consumer failed")


def _exhaust(gen):
    for _ in gen:
        pass


@pytest.mark.parametrize("end", [_close, _drop, _raise_in_consumer, _exhaust],
                         ids=["close", "garbage", "consumer_raises", "epoch_ends"])
def test_an_epoch_ended_or_cut_short_stops_its_worker(corpus, end):
    ds = _dataset(*corpus)
    before = set(threading.enumerate())
    gen = ds.batches(0)
    next(gen)
    threads = _new_loader_threads(before)
    assert len(threads) == 1 and threads[0].is_alive()
    end(gen)
    del gen
    assert _gone(threads)
    gen = ds.batches(1)  # a second epoch starts a thread of its own, and stops it alike
    next(gen)
    next(gen)
    threads = _new_loader_threads(before)
    assert len(threads) == 1
    gen.close()
    assert _gone(threads)


def _remove(path):
    os.remove(path)


def _truncate(path):
    with open(path, "r+b") as f:
        f.truncate(os.path.getsize(path) - 4)


@pytest.mark.parametrize("fault, error, match", [(_remove, FileNotFoundError, "No such file"),
                                                 (_truncate, ValueError, "shorter than its .npy header")],
                         ids=["missing", "truncated"])
def test_a_bad_mel_raises_in_the_consumer_at_its_batch(corpus, tmp_path, fault, error, match):
    d, meta = corpus
    d = str(shutil.copytree(d, tmp_path / "gappy"))
    ds = _dataset(d, meta)
    plan = ds.plan(0)
    bad = plan[2][1]
    fault(os.path.join(d, ds.rows[bad][1]))
    before = set(threading.enumerate())
    gen = ds.batches(0)
    for rows in plan[:2]:
        assert next(gen).indices == rows
    threads = _new_loader_threads(before)
    with pytest.raises(error, match=match) as caught:
        next(gen)
    assert ds.rows[bad][1] in str(caught.value)
    with pytest.raises(StopIteration):
        next(gen)
    assert _gone(threads)


def test_the_counter_and_spans_agree_with_what_was_consumed(corpus):
    ds = _dataset(*corpus)
    M.enable()
    M.drain()
    before = dict(DL.LOADER)
    try:
        gen = ds.batches(3)
        n = 5
        for i in range(n):
            next(gen)
            if i == 2:
                time.sleep(0.1)  # the workers catch up: the next batches are ready
        gen.close()
        spans = M.drain()
    finally:
        M.enable(False)
    got = {k: DL.LOADER[k] - before[k] for k in before}
    waits = [s for s in spans if s["name"] == "data.wait"]
    loads = [s for s in spans if s["name"] == "data.load"]
    assert got["batches"] == n and got["ready"] >= 1  # the batch after the sleep was ready
    assert len(waits) == n - got["ready"]
    waited = sum(s["t1"] - s["t0"] for s in waits)
    assert waited <= got["wait_ns"] <= waited + 5_000_000 * len(waits)
    me = threading.get_native_id()
    assert all(s["thread"] == me for s in waits)
    assert n <= len(loads) <= n + DL.AHEAD and all(s["thread"] != me and s["attrs"]["rows"] == 3 for s in loads)
