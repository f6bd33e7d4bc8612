"""Length-bucketed batch loader for acoustic-model training and the
vocoder's random training windows (a copy of the JAX package's
``data/loader.py``, which uses only numpy, without ``batch_shapes``, whose
compile prewarm has no counterpart here; plus ``read_metadata`` from its
``data/preprocess.py``).

Replaces the reference's feeder-thread + tf.FIFOQueue(8)
(tacotron/feeder.py:14-168) with a synchronous numpy iterator producing
*static-shape* padded batches: within each shuffled group, examples are
sorted by mel length (bucketing) and split into batches, then batch order is
shuffled (feeder.py:95-100).  Pad lengths are rounded up to configurable
multiples, so a run meets a small, finite set of batch shapes.

Padding conventions (feeder.py:49-57,140-161): inputs pad 0 (the ``_``
symbol), mels pad -max_abs_value, stop targets are 0 for frames < len-1 and
1.0 from the final frame onward; target length rounds up to a multiple of r.
"""

from __future__ import annotations

import os
from dataclasses import dataclass

import numpy as np

from ..config import Config
from ..frontend import default_symbols
from ..utils import round_up as _round_up
from ..utils.metrics import span


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

    def _multiples(self, input_multiple, mel_multiple):
        tc = self.cfg.tacotron_train
        return (
            input_multiple if input_multiple is not None else tc.input_pad_multiple,
            mel_multiple if mel_multiple is not None else tc.mel_pad_multiple,
        )

    def example(self, row_idx: int):
        row = self.rows[row_idx]
        ids = np.asarray(self.symbols.encode(row[5]), np.int32)
        mel = np.load(os.path.join(self.mel_dir, row[1]))
        return ids, mel.astype(np.float32)

    def batches(
        self,
        epoch_seed: int,
        batch_size: int | None = None,
        indices: list[int] | None = None,
        input_multiple: int | None = None,
        mel_multiple: int | None = None,
        drop_remainder: bool = True,
    ):
        """Yield TacotronBatch for one epoch (bucketed + batch-shuffled).
        Pad multiples default to the config knobs
        (tacotron_train.input_pad_multiple / mel_pad_multiple)."""
        cfg = self.cfg
        input_multiple, mel_multiple = self._multiples(input_multiple, mel_multiple)
        bs = batch_size or cfg.tacotron_train.batch_size
        idx = list(indices if indices is not None else self.train_indices)
        rng = np.random.RandomState(epoch_seed)
        rng.shuffle(idx)
        group = bs * cfg.tacotron_train.batches_per_group
        for gstart in range(0, len(idx), group):
            gidx = idx[gstart : gstart + group]
            # bucket: sort group members by mel length
            gidx.sort(key=lambda i: int(self.rows[i][3]))
            batches = [gidx[i : i + bs] for i in range(0, len(gidx), bs)]
            if drop_remainder:
                batches = [b for b in batches if len(b) == bs]
            rng.shuffle(batches)
            for bidx in batches:
                with span("data.load", rows=len(bidx)):
                    batch = self._make_batch(bidx, input_multiple, mel_multiple)
                yield batch

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
        lengths only (no mel loads) — replays the exact shuffle+bucket
        logic of ``batches``.

        Three numbers matter, because the padded frames have three different
        costs: ``frac_pad_mel`` is ALL decoder frames beyond each example's
        true length (compute that pays no loss — the loss is masked to
        ``loss_frames``); ``frac_pad_mel_bucket`` is only the frames the
        shape-bucketing multiples add beyond the reference's own
        pad-to-batch-max-rounded-to-r (feeder.py:49-57) — the part this
        framework's static-shape design is responsible for; and
        ``frac_pad_inputs`` is the same for encoder tokens.  The trainer
        logs these at startup."""
        cfg = self.cfg
        input_multiple, mel_multiple = self._multiples(input_multiple, mel_multiple)
        bs = batch_size or cfg.tacotron_train.batch_size
        r = cfg.tacotron.outputs_per_step
        idx_base = list(indices if indices is not None else self.train_indices)
        in_len = {i: len(self.symbols.encode(self.rows[i][5])) for i in idx_base}
        mel_len = {i: int(self.rows[i][3]) for i in idx_base}
        group = bs * cfg.tacotron_train.batches_per_group
        real_f = ref_f = pad_f = real_t = pad_t = 0
        n_batches = 0
        for seed in epoch_seeds:
            idx = list(idx_base)
            np.random.RandomState(seed).shuffle(idx)
            for gstart in range(0, len(idx), group):
                gidx = idx[gstart : gstart + group]
                gidx.sort(key=lambda i: mel_len[i])
                for s in range(0, len(gidx), bs):
                    b = gidx[s : s + bs]
                    if len(b) != bs:  # drop_remainder (training default)
                        continue
                    n_batches += 1
                    max_in = _round_up(max(in_len[i] for i in b), input_multiple)
                    ref_out = _round_up(max(mel_len[i] for i in b), r)
                    max_out = _round_up(ref_out, mel_multiple)
                    real_f += sum(mel_len[i] for i in b)
                    ref_f += bs * ref_out
                    pad_f += bs * max_out
                    real_t += sum(in_len[i] for i in b)
                    pad_t += bs * max_in
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
