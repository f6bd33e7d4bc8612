"""Length-bucketed batch loader for acoustic-model training and the
vocoder's random training windows (a copy of the JAX package's
``data/loader.py``, which uses only numpy, without ``batch_shapes``, whose
compile prewarm has no counterpart here; plus ``read_metadata`` from its
``data/preprocess.py``).

Replaces the reference's feeder-thread + tf.FIFOQueue(8)
(tacotron/feeder.py:14-168) with *static-shape* padded batches: within each
shuffled group, examples are sorted by mel length (bucketing) and split into
batches, then batch order is shuffled (feeder.py:95-100).  Pad lengths are
rounded up to configurable multiples, so a run meets a small, finite set of
batch shapes.

Read-ahead.  ``TacotronDataset.batches`` plans the whole epoch first (the
same shuffle, groups, sort and batch order as the JAX loader), then
assembles its batches on a worker thread of its own, up to ``AHEAD``
batches beyond the one the consumer holds.  A batch is two calls into a
C++ row reader (``csrc/tacotron_reader.cc``, built with g++ at first
use), each spreading the rows over ``THREADS`` threads with the
interpreter lock released: the rows' ``.npy`` headers, then the arrays
filled (each mel read from its file straight into place, pads, stop
targets, the symbol ids encoded once when the dataset was built).  So the
thread launching the device's work meets a handful of lock hand-offs a
batch, not the thousands a Python row loop makes.  On a CUDA machine the
arrays are views of pinned tensors (``TacotronBatch.pinned``) that
``train.tacotron_train.batch_to_device`` copies without blocking.  The
thread ends with its epoch: closing the generator early (or dropping it)
drops the pending batches and stops it; a worker's exception is raised in
the consumer at the batch that needed it.  Spans: ``data.load`` on the
worker thread, ``data.wait`` in the consumer while a batch was not ready;
counters: ``LOADER``.

Padding conventions (feeder.py:49-57,140-161): inputs pad 0 (the ``_``
symbol), mels pad -max_abs_value, stop targets are 0 for frames < len-1 and
1.0 from the final frame onward; target length rounds up to a multiple of r.
"""

from __future__ import annotations

import ctypes
import os
import queue
import threading
import time
from collections import deque
from dataclasses import dataclass

import numpy as np

from ..config import Config
from ..frontend import default_symbols
from ..utils import round_up as _round_up
from ..utils.metrics import span

AHEAD = 2  # batches assembled beyond the one the consumer holds
# Threads reading one batch's rows: half the cores, up to 8, leaving the
# rest to the trainer's own threads (the one launching the device's work,
# autograd's, the CUDA runtime's).  On the card's 8-core host 4 read a
# batch of 32 rows in about 5 ms, 8 in 7-8 ms, with no gain in the step.
THREADS = max(1, min(8, (os.cpu_count() or 2) // 2))
READER_SOURCE = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "csrc", "tacotron_reader.cc")
_READER = None  # the built row reader (``_reader``)

# The read-ahead's counters (``utils.metrics.counters()["loader"]``):
# batches handed out, those handed out with no wait, and the consumer's
# total wait in ns.
LOADER = {"batches": 0, "ready": 0, "wait_ns": 0}


@dataclass
class TacotronBatch:
    inputs: np.ndarray  # [B, T_in] int32
    input_lengths: np.ndarray  # [B] int32
    mel_targets: np.ndarray  # [B, T_out, M] float32
    stop_targets: np.ndarray  # [B, T_out] float32
    target_lengths: np.ndarray  # [B] int32
    # per-example copy of the batch-max mel length rounded to r — the frame
    # count the REFERENCE pads to (feeder.py:49-57).  Frames beyond it exist
    # only for shape bucketing and are excluded from the unmasked
    # loss so bucketing cannot dilute the training objective.  (Residual
    # bucket effect: the postnet's +/-10-frame receptive field and its
    # train-mode BN statistics still see the bucket-pad decoder frames; the
    # pre-postnet and stop streams are exactly reference-shaped.)
    loss_frames: np.ndarray  # [B] int32
    indices: list  # metadata row indices (for GTA bookkeeping)
    # the pinned tensors the arrays above are views of (the read-ahead on a
    # CUDA machine), by field name; None for pageable arrays
    pinned: dict | None = None


class TacotronDataset:
    """Metadata-backed dataset with deterministic epoch shuffling."""

    def __init__(
        self,
        metadata_rows: list[list[str]],
        mel_dir: str,
        cfg: Config,
        test_size: int | None = None,
    ):
        self.cfg = cfg
        self.mel_dir = mel_dir
        self.symbols = default_symbols()
        self.rows = list(metadata_rows)
        tc = cfg.tacotron_train
        if tc.clip_mels_length:
            self.rows = [r for r in self.rows if int(r[3]) <= tc.max_mel_frames]
        # held-out split (reference uses all data for train, feeder.py:45;
        # we keep an explicit eval split available but default tiny)
        rng = np.random.RandomState(tc.data_seed)
        order = rng.permutation(len(self.rows))
        n_test = test_size if test_size is not None else 0
        self.test_indices = sorted(order[:n_test].tolist())
        self.train_indices = sorted(order[n_test:].tolist())
        self._ids = [np.asarray(self.symbols.encode(r[5]), np.int32) for r in self.rows]
        self._ids_len = np.array([len(i) for i in self._ids], np.int64)
        self._ids_start = np.cumsum(self._ids_len) - self._ids_len
        self._ids_flat = np.concatenate(self._ids) if self._ids else np.zeros(0, np.int32)
        self._paths = [os.fsencode(os.path.join(mel_dir, r[1])) for r in self.rows]

    def _multiples(self, input_multiple, mel_multiple):
        tc = self.cfg.tacotron_train
        return (
            input_multiple if input_multiple is not None else tc.input_pad_multiple,
            mel_multiple if mel_multiple is not None else tc.mel_pad_multiple,
        )

    def example(self, row_idx: int):
        mel = np.load(os.path.join(self.mel_dir, self.rows[row_idx][1]))
        return self._ids[row_idx], mel.astype(np.float32)

    def plan(self, epoch_seed: int, batch_size: int | None = None, indices: list[int] | None = None,
             drop_remainder: bool = True) -> list[list[int]]:
        """One epoch's batches as row indices, in order: shuffled, grouped
        by ``batches_per_group``, each group sorted by mel length and split,
        the group's batches shuffled."""
        bs = batch_size or self.cfg.tacotron_train.batch_size
        idx = list(indices if indices is not None else self.train_indices)
        rng = np.random.RandomState(epoch_seed)
        rng.shuffle(idx)
        group = bs * self.cfg.tacotron_train.batches_per_group
        out = []
        for gstart in range(0, len(idx), group):
            gidx = idx[gstart : gstart + group]
            # bucket: sort group members by mel length
            gidx.sort(key=lambda i: int(self.rows[i][3]))
            batches = [gidx[i : i + bs] for i in range(0, len(gidx), bs)]
            if drop_remainder:
                batches = [b for b in batches if len(b) == bs]
            rng.shuffle(batches)
            out += batches
        return out

    def batches(
        self,
        epoch_seed: int,
        batch_size: int | None = None,
        indices: list[int] | None = None,
        input_multiple: int | None = None,
        mel_multiple: int | None = None,
        drop_remainder: bool = True,
    ):
        """Yield TacotronBatch for one epoch (``plan``'s batches in its
        order), assembled ahead on a worker thread of the epoch's own
        (module docstring).  Pad multiples default to the config knobs
        (tacotron_train.input_pad_multiple / mel_pad_multiple)."""
        import torch

        multiples = self._multiples(input_multiple, mel_multiple)
        plan = iter(self.plan(epoch_seed, batch_size, indices, drop_remainder))
        worker = _Worker(torch.cuda.is_available(), _reader())
        pending: deque = deque()
        try:
            while True:
                while len(pending) <= AHEAD and (rows := next(plan, None)) is not None:
                    pending.append(_Job(self, worker, rows, *multiples))
                    worker.submit(pending[-1])
                if not pending:
                    break
                yield pending.popleft().take()
        finally:
            for job in pending:
                job.dropped = True
            worker.stop()

    def _assemble(self, rows: list, input_multiple: int, mel_multiple: int, worker: _Worker) -> TacotronBatch:
        """``_make_batch``'s batch, on the worker thread: the rows' mel
        headers, then the arrays (pinned on a CUDA machine) filled by the
        C++ reader, each call on ``THREADS`` threads outside the interpreter
        lock; a file that is not a C-order float32 ``.npy`` is loaded here."""
        lib, B = worker.lib, len(rows)
        paths = (ctypes.c_char_p * B)(*(self._paths[i] for i in rows))
        T, M, offset = (np.empty(B, np.int64) for _ in range(3))
        err = np.empty(B, np.int32)
        lib.tr_probe(B, paths, T.ctypes.data, M.ctypes.data, offset.ctypes.data, err.ctypes.data, THREADS)
        _raise_row_error(err, paths)
        loaded = (ctypes.c_void_p * B)()
        mels_in_memory = [np.ascontiguousarray(np.load(os.fsdecode(paths[k])), np.float32)
                          for k in np.flatnonzero(offset < 0)]
        for k, mel in zip(np.flatnonzero(offset < 0), mels_in_memory):
            T[k], M[k] = mel.shape
            loaded[k] = mel.ctypes.data
        if (M != M[0]).any():
            raise ValueError(f"mels of {M[0]} and {M[M != M[0]][0]} channels in one batch (rows {rows})")
        r = self.cfg.tacotron.outputs_per_step
        lens, starts = self._ids_len[rows], self._ids_start[rows]
        max_in = _round_up(int(lens.max()), input_multiple)
        ref_out = _round_up(int(T.max()), r)
        max_out = _round_up(ref_out, mel_multiple)
        shapes = {"inputs": ((B, max_in), np.int32), "input_lengths": ((B,), np.int32),
                  "mel_targets": ((B, max_out, int(M[0])), np.float32), "stop_targets": ((B, max_out), np.float32),
                  "target_lengths": ((B,), np.int32), "loss_frames": ((B,), np.int32)}
        made = {k: _host_array(shape, dtype, worker.pin) for k, (shape, dtype) in shapes.items()}
        a = {k: arr for k, (arr, _) in made.items()}
        lib.tr_fill(B, paths, offset.ctypes.data, T.ctypes.data, loaded, int(M[0]), max_out,
                    -self.cfg.audio.max_abs_value, ref_out, self._ids_flat.ctypes.data, starts.ctypes.data,
                    lens.ctypes.data, max_in, *(a[k].ctypes.data for k in _FILL_ORDER), err.ctypes.data, THREADS)
        _raise_row_error(err, paths)
        pinned = {k: t for k, (_, t) in made.items()} if worker.pin else None
        return TacotronBatch(**a, indices=list(rows), pinned=pinned)

    def _make_batch(self, row_indices, input_multiple: int, mel_multiple: int):
        cfg = self.cfg
        r = cfg.tacotron.outputs_per_step
        examples = [self.example(i) for i in row_indices]
        max_in = _round_up(max(len(e[0]) for e in examples), input_multiple)
        ref_out = _round_up(max(e[1].shape[0] for e in examples), r)
        max_out = _round_up(ref_out, mel_multiple)
        B = len(examples)
        M = examples[0][1].shape[1]
        pad_value = -cfg.audio.max_abs_value
        inputs = np.zeros((B, max_in), np.int32)
        input_lengths = np.zeros((B,), np.int32)
        mels = np.full((B, max_out, M), pad_value, np.float32)
        stops = np.ones((B, max_out), np.float32)
        target_lengths = np.zeros((B,), np.int32)
        for i, (ids, mel) in enumerate(examples):
            T = mel.shape[0]
            inputs[i, : len(ids)] = ids
            input_lengths[i] = len(ids)
            mels[i, :T] = mel
            stops[i, : T - 1] = 0.0
            target_lengths[i] = T
        loss_frames = np.full((B,), ref_out, np.int32)
        return TacotronBatch(
            inputs, input_lengths, mels, stops, target_lengths, loss_frames, list(row_indices)
        )

    def padding_stats(
        self,
        epoch_seeds,
        batch_size: int | None = None,
        indices: list[int] | None = None,
        input_multiple: int | None = None,
        mel_multiple: int | None = None,
    ) -> dict:
        """Measured padding waste of the bucketed batches, from metadata
        lengths only (no mel loads), over ``plan``'s batches.

        Three numbers matter, because the padded frames have three different
        costs: ``frac_pad_mel`` is ALL decoder frames beyond each example's
        true length (compute that pays no loss — the loss is masked to
        ``loss_frames``); ``frac_pad_mel_bucket`` is only the frames the
        shape-bucketing multiples add beyond the reference's own
        pad-to-batch-max-rounded-to-r (feeder.py:49-57) — the part this
        framework's static-shape design is responsible for; and
        ``frac_pad_inputs`` is the same for encoder tokens.  The trainer
        logs these at startup."""
        input_multiple, mel_multiple = self._multiples(input_multiple, mel_multiple)
        r = self.cfg.tacotron.outputs_per_step
        real_f = ref_f = pad_f = real_t = pad_t = 0
        n_batches = 0
        for seed in epoch_seeds:
            for b in self.plan(seed, batch_size, indices):
                n_batches += 1
                in_len = [len(self._ids[i]) for i in b]
                mel_len = [int(self.rows[i][3]) for i in b]
                max_in = _round_up(max(in_len), input_multiple)
                ref_out = _round_up(max(mel_len), r)
                max_out = _round_up(ref_out, mel_multiple)
                real_f += sum(mel_len)
                ref_f += len(b) * ref_out
                pad_f += len(b) * max_out
                real_t += sum(in_len)
                pad_t += len(b) * max_in
        if pad_f == 0:
            return {"n_batches": 0}
        return {
            "n_batches": n_batches,
            "frac_pad_mel": round(1.0 - real_f / pad_f, 4),
            "frac_pad_mel_bucket": round(1.0 - ref_f / pad_f, 4),
            "frac_pad_inputs": round(1.0 - real_t / pad_t, 4),
        }

    def sequential_batches(self, batch_size: int, indices=None, input_multiple: int | None = None,
                           mel_multiple: int | None = None):
        """In-order batches over the corpus (GTA generation / eval)."""
        idx = list(indices if indices is not None else range(len(self.rows)))
        im, mm = self._multiples(input_multiple, mel_multiple)
        for s in range(0, len(idx), batch_size):
            yield self._make_batch(idx[s : s + batch_size], im, mm)


def _host_array(shape, dtype, pin: bool):
    """(array, its pinned tensor or None): fresh memory that the batch's
    rows overwrite whole; ``dtype`` np.int32 or np.float32."""
    if not pin:
        return np.empty(shape, dtype), None
    import torch

    t = torch.empty(shape, dtype={np.int32: torch.int32, np.float32: torch.float32}[dtype], pin_memory=True)
    return t.numpy(), t


def _reader():
    """The C++ row reader (``csrc/tacotron_reader.cc``), built with g++
    at first use."""
    global _READER
    if _READER is None:
        from .native_loader import build_library

        lib = ctypes.CDLL(build_library(READER_SOURCE))
        p, ptrs = ctypes.c_void_p, ctypes.POINTER(ctypes.c_char_p)
        lib.tr_probe.restype = lib.tr_fill.restype = None
        lib.tr_probe.argtypes = [ctypes.c_int, ptrs, p, p, p, p, ctypes.c_int]
        lib.tr_fill.argtypes = [ctypes.c_int, ptrs, p, p, ctypes.POINTER(ctypes.c_void_p), ctypes.c_int64,
                                ctypes.c_int64, ctypes.c_float, ctypes.c_int32, p, p, p, ctypes.c_int64,
                                p, p, p, p, p, p, p, ctypes.c_int]
        _READER = lib
    return _READER


# the arrays in ``tr_fill``'s order of arguments
_FILL_ORDER = ("mel_targets", "stop_targets", "inputs", "input_lengths", "target_lengths", "loss_frames")


def _raise_row_error(err: np.ndarray, paths) -> None:
    """The first failed row's error: OSError by its errno, ValueError for
    a file shorter than its header says."""
    bad = np.flatnonzero(err)
    if bad.size:
        e, path = int(err[bad[0]]), os.fsdecode(paths[bad[0]])
        if e < 0:
            raise ValueError(f"{path}: shorter than its .npy header says")
        raise OSError(e, os.strerror(e), path)


class _Worker:
    """The thread that assembles one epoch's batches, in the order they
    were asked for; ``stop`` lets it end after the batches queued before."""

    def __init__(self, pin: bool, lib):
        self.pin, self.lib = pin, lib
        self._q: queue.SimpleQueue = queue.SimpleQueue()
        self.thread = threading.Thread(target=self._run, args=(self._q,), name="tacotron-loader", daemon=True)
        self.thread.start()

    def submit(self, job: _Job) -> None:
        self._q.put(job)

    @staticmethod
    def _run(q) -> None:
        while True:
            job = q.get()
            if job is None:
                return
            job.run()
            del job  # an idle thread keeps no batch, and no dataset, alive

    def stop(self) -> None:
        self._q.put(None)


class _Job:
    """One batch for the worker (``run``) and the consumer (``take``)."""

    def __init__(self, ds: TacotronDataset, worker: _Worker, rows: list, input_multiple: int, mel_multiple: int):
        self.ds, self.worker, self.rows = ds, worker, list(rows)
        self.multiples = (input_multiple, mel_multiple)
        self.done = threading.Event()
        self.dropped = False
        self.batch = self.error = None

    def run(self) -> None:
        if self.dropped:
            return
        try:
            with span("data.load", rows=len(self.rows)):
                self.batch = self.ds._assemble(self.rows, *self.multiples, self.worker)
        except Exception as e:  # raised in the consumer at this batch
            self.error = e
        self.done.set()

    def take(self) -> TacotronBatch:
        """The batch, once assembled (counted in ``LOADER``; a wait is
        timed by the ``data.wait`` span)."""
        ready = self.done.is_set()
        if not ready:
            t0 = time.monotonic_ns()
            with span("data.wait", rows=len(self.rows)):
                self.done.wait()
            LOADER["wait_ns"] += time.monotonic_ns() - t0
        if self.error is not None:
            raise self.error
        LOADER["batches"] += 1
        LOADER["ready"] += ready
        return self.batch


@dataclass
class VocoderBatch:
    x: np.ndarray  # [B, seq_len] float32 previous samples in [-1, 1]
    y: np.ndarray  # [B, seq_len] int32 target mu-law labels
    mels: np.ndarray  # [B, seq_frames + 2*pad, M] float32 unit-range mels


class VocoderDataset:
    """WaveRNN training windows (reference wavernn/utils/dataset.py:18-133).

    Metadata rows: ``wav.npy|gt_mel.npy|pred_mel.npy|text``.  Training reads
    the Tacotron-predicted (GTA) mel — column 2 (dataset.py:70) — and a
    random ``seq_len``-sample window per example per step.  Utterances
    shorter than one window are filtered; a fixed-seed test set is held out
    (dataset.py:81-85).
    """

    def __init__(self, metadata_rows: list[list[str]], data_dir: str, cfg: Config):
        self.cfg = cfg
        self.dir = data_dir
        wc = cfg.wavernn_train
        hop = cfg.audio.hop_size
        self.seq_len = wc.seq_len_hops * hop
        self.seq_frames = wc.seq_len_hops
        self.pad = cfg.wavernn.pad
        min_frames = self.seq_frames + 2 * self.pad + 2
        self.rows = [r for r in metadata_rows if self._frames_of(r) >= min_frames]
        rng = np.random.RandomState(wc.seed)
        order = rng.permutation(len(self.rows))
        n_test = min(wc.test_samples, max(0, len(self.rows) - 1))
        self.test_indices = sorted(order[:n_test].tolist())
        self.train_indices = sorted(order[n_test:].tolist())

    def _frames_of(self, row) -> int:
        mel = np.load(os.path.join(self.dir, row[2]), mmap_mode="r")
        return mel.shape[0]

    def example(self, row_idx: int):
        """Returns (labels [T_samples] int, mel [T_frames, M] float)."""
        row = self.rows[row_idx]
        labels = np.load(os.path.join(self.dir, row[0]))
        mel = np.load(os.path.join(self.dir, row[2]))
        return labels, mel.astype(np.float32)

    def collate(self, row_indices, rng: np.random.RandomState) -> VocoderBatch:
        """Random-window crop per example (reference collate_vocoder,
        dataset.py:107-133): pick a mel window of ``seq_frames + 2*pad``
        starting at least ``pad`` frames in, take the matching
        ``seq_len + 1`` samples, and split into (x, y)."""
        hop = self.cfg.audio.hop_size
        bits = self.cfg.audio.bits
        xs, ys, ms = [], [], []
        for i in row_indices:
            labels, mel = self.example(i)
            # window start bounded by BOTH the mel and the label stream, so a
            # labels file shorter than the mel implies never forces padding
            max_start = min(
                mel.shape[0] - (self.seq_frames + 2 * self.pad),
                (len(labels) - self.seq_len - 1) // hop,
            )
            start = rng.randint(self.pad, max(self.pad, max_start) + 1)
            m = mel[start - self.pad: start + self.seq_frames + self.pad]
            if m.shape[0] < self.seq_frames + 2 * self.pad:
                m = np.pad(m, ((0, self.seq_frames + 2 * self.pad - m.shape[0]), (0, 0)))
            # label window starts exactly at the center-frame boundary
            sig_start = start * hop
            sig = labels[sig_start: sig_start + self.seq_len + 1]
            if len(sig) < self.seq_len + 1:
                # last-resort pad with mu-law SILENCE (mid class), not class 0
                # which expands to a -1.0 full-scale burst
                sig = np.pad(sig, (0, self.seq_len + 1 - len(sig)), constant_values=2 ** (bits - 1))
            xs.append(sig[:-1])
            ys.append(sig[1:])
            ms.append(m)
        x = np.stack(xs).astype(np.float32)
        x = 2.0 * x / (2 ** bits - 1.0) - 1.0  # label_2_float (dsp.py:8-9)
        return VocoderBatch(x, np.stack(ys).astype(np.int32), np.stack(ms))

    def batches(self, epoch_seed: int, batch_size: int | None = None, indices=None):
        bs = batch_size or self.cfg.wavernn_train.batch_size
        idx = list(indices if indices is not None else self.train_indices)
        rng = np.random.RandomState(epoch_seed)
        rng.shuffle(idx)
        for s in range(0, len(idx) - bs + 1, bs):
            yield self.collate(idx[s: s + bs], rng)


def read_metadata(path: str) -> list[list[str]]:
    """Rows of a ``|``-separated metadata file
    (``audio|mel|samples|frames|text|pyin``)."""
    with open(path, encoding="utf-8") as f:
        return [line.strip().split("|") for line in f if line.strip()]


def write_synthetic_corpus(out_dir: str, n: int, symbols_range=(40, 150), frames_range=(200, 600),
                           seed: int = 0, num_mels: int = 80) -> str:
    """A corpus of ``n`` random utterances for smoke runs and tests: random
    valid symbol strings (no pad/EOS) and random mels in [-4, 4], written
    as ``mel-<i>.npy`` beside a ``train.txt`` metadata file
    (``audio|mel|samples|frames|text|pyin``).  Returns the metadata path."""
    sym = default_symbols()
    usable = [s for s in sym.symbols if s not in (sym.symbols[sym.pad_id], sym.symbols[sym.eos_id])]
    rng = np.random.default_rng(seed)
    os.makedirs(out_dir, exist_ok=True)
    rows = []
    for i in range(n):
        n_sym = int(rng.integers(symbols_range[0], symbols_range[1] + 1))
        n_frames = int(rng.integers(frames_range[0], frames_range[1] + 1))
        pyin = " ".join(rng.choice(usable, n_sym))
        mel = rng.uniform(-4.0, 4.0, (n_frames, num_mels)).astype(np.float32)
        np.save(os.path.join(out_dir, f"mel-{i}.npy"), mel, allow_pickle=False)
        rows.append(f"audio-{i}.npy|mel-{i}.npy|{n_frames * 275}|{n_frames}|utt{i}|{pyin}")
    path = os.path.join(out_dir, "train.txt")
    with open(path, "w", encoding="utf-8") as f:
        f.write("\n".join(rows) + "\n")
    return path
