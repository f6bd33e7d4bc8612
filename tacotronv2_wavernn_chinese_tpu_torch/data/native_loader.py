"""ctypes binding to the native C++ window sampler of the vocoder trainers.

The C++ engine (``csrc/vocoder_loader.cc`` in the package) replaces the
reference's framework-runtime data paths (TF FIFOQueue feeder thread
feeder.py:70-72, torch DataLoader workers dataset.py:90-95): a worker pool
samples random training windows from the corpus buffers and keeps a
prefetch ring full, so ``next_batch()`` is a memcpy — no Python-side
sampling on the step path and no GIL contention with the device loop.
``NativeWindowLoader`` takes the buffers and the window's geometry (its
hops, the hop and the mel pad) as arguments; ``NativeVocoderLoader`` reads
WaveRNN's labels and GTA mels for it from a metadata file and ``cfg``, and
``NativeSegmentLoader`` hands it HiFi-GAN's 16-bit PCM (segments at random
sample offsets, scaled by each utterance's peak gain, no mels).

Build.  ``build_library`` compiles the source with ``g++`` and
``CXX_FLAGS`` into ``build/native_loader/<hash of the source and
flags>/libvocoder_loader.so`` at the repository root, at first use (the
Tacotron loader's row reader, ``csrc/tacotron_reader.cc``, is built the
same way, into ``libtacotron_reader.so``); nothing is built when this
module is imported.  ``NativeVocoderLoader.available()`` says whether the
library builds and loads; ``VocoderDataset.batches`` remains the
pure-Python path.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from typing import Iterator

import numpy as np

from ..config import Config
from ..utils.metrics import span
from .loader import VocoderBatch

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
SOURCE = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "csrc", "vocoder_loader.cc")
BUILD_ROOT = os.path.join(_REPO, "build", "native_loader")
CXX_FLAGS = ["-O3", "-march=native", "-std=c++17", "-fPIC", "-Wall", "-pthread", "-shared"]

_lock = threading.Lock()
_lib = None


def library_path(source: str = SOURCE) -> str:
    h = hashlib.sha256()
    with open(source, "rb") as f:
        h.update(f.read())
    h.update(" ".join(CXX_FLAGS).encode())
    name = "lib" + os.path.splitext(os.path.basename(source))[0] + ".so"
    return os.path.join(BUILD_ROOT, h.hexdigest()[:16], name)


def build_library(source: str = SOURCE) -> str:
    """Compile ``source`` (the vocoder loader, or the Tacotron loader's row
    reader ``csrc/tacotron_reader.cc``) if its library is missing;
    returns its path.  Raises RuntimeError with the compiler's output when
    g++ fails, and FileNotFoundError when there is no g++."""
    path = library_path(source)
    if os.path.exists(path):
        return path
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    out = subprocess.run(["g++", *CXX_FLAGS, "-o", tmp, source], capture_output=True, text=True)
    if out.returncode != 0:
        raise RuntimeError(f"g++ failed for {source}:\n{out.stdout}{out.stderr}")
    os.replace(tmp, path)
    return path


def _load_lib():
    """The bound library, built on first use; None when it cannot be built."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        try:
            lib = ctypes.CDLL(build_library())
        except (RuntimeError, OSError):
            return None
        i64p = ctypes.POINTER(ctypes.c_int64)
        lib.vl_create.restype = ctypes.c_void_p
        lib.vl_create.argtypes = [
            ctypes.POINTER(ctypes.c_int16), ctypes.POINTER(ctypes.c_float),
            i64p, i64p, i64p, i64p,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_uint64, ctypes.POINTER(ctypes.c_float),
        ]
        lib.vl_next_batch.restype = ctypes.c_int  # 1 ok, 0 destroyed while waiting
        lib.vl_next_batch.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_float),
            ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_float),
        ]
        lib.vl_num_utts.restype = ctypes.c_int
        lib.vl_num_utts.argtypes = [ctypes.c_void_p]
        lib.vl_request_stop.restype = None
        lib.vl_request_stop.argtypes = [ctypes.c_void_p]
        lib.vl_destroy.restype = None
        lib.vl_destroy.argtypes = [ctypes.c_void_p]
        lib.vl_preemphasis.restype = None
        lib.vl_preemphasis.argtypes = [
            ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_float),
            ctypes.c_int64, ctypes.c_float,
        ]
        lib.vl_mulaw_encode.restype = None
        lib.vl_mulaw_encode.argtypes = [
            ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_int16),
            ctypes.c_int64, ctypes.c_int,
        ]
        _lib = lib
        return lib


def _ptr(a: np.ndarray, ctype):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


class NativeWindowLoader:
    """Owns the corpus buffers and the C++ loader handle.  ``labels``: one
    int16 stream per utterance; ``mels``: one [frames, n_mels] float32
    array per utterance, or None (no mels: each utterance then counts
    ``len(labels) // hop`` frames); ``gains``: one float per utterance, the
    factor each sample is taken as a float with (16-bit PCM), or None for
    WaveRNN's mu-law labels.  A window is ``seq_hops`` hops of ``hop``
    samples starting at least ``pad`` frames in, with its ``seq_hops + 2 x
    pad`` frames of mel."""

    @staticmethod
    def available() -> bool:
        return _load_lib() is not None

    def __init__(self, labels: list, mels: list | None, *, batch: int, seq_hops: int, hop: int, pad: int,
                 n_mels: int, bits: int, gains=None, n_workers: int = 2, ring_size: int = 8, seed: int = 1234):
        lib = _load_lib()
        if lib is None:
            raise RuntimeError("native loader unavailable (g++ missing or the build failed)")
        self._lib = lib
        self.batch = batch
        self.seq_len = seq_hops * hop
        self.mel_win = seq_hops + 2 * pad if mels is not None else 0
        self.n_mels = n_mels if mels is not None else 0

        labels = [np.asarray(a, np.int16) for a in labels]
        lens = [len(a) for a in labels]
        frames = [m.shape[0] for m in mels] if mels is not None else [n // hop for n in lens]
        # keep references alive for the lifetime of the handle
        self._labels = np.concatenate(labels) if labels else np.zeros(0, np.int16)
        self._mels = (np.concatenate([np.asarray(m, np.float32) for m in mels], axis=0).reshape(-1)
                      if mels else np.zeros(1, np.float32))
        offs = lambda ns: np.concatenate([[0], np.cumsum(ns)[:-1]]) if ns else np.zeros(0)
        self._meta = tuple(np.asarray(x, np.int64) for x in (offs(lens), lens, offs(frames), frames))
        self._gains = None if gains is None else np.ascontiguousarray(gains, np.float32)
        if self._gains is not None and self._gains.shape != (len(labels),):
            raise ValueError(f"{self._gains.shape} gains for {len(labels)} utterances")
        if mels is not None and len(mels) != len(labels):
            raise ValueError(f"{len(mels)} mels for {len(labels)} utterances")

        # serializes C calls so close() can wait out an in-flight next_batch
        self._call_lock = threading.Lock()
        self._h = lib.vl_create(
            _ptr(self._labels, ctypes.c_int16),
            _ptr(self._mels, ctypes.c_float),
            *(_ptr(a, ctypes.c_int64) for a in self._meta),
            len(labels), self.n_mels, pad, seq_hops, hop, batch, bits,
            n_workers, ring_size, seed,
            None if self._gains is None else _ptr(self._gains, ctypes.c_float),
        )
        if not self._h:
            raise RuntimeError("no utterance long enough for one training window")

    @property
    def num_utts(self) -> int:
        return self._lib.vl_num_utts(self._h)

    def next_batch(self) -> VocoderBatch:
        x = np.empty((self.batch, self.seq_len), np.float32)
        y = np.empty((self.batch, self.seq_len), np.int32)
        m = np.empty((self.batch, self.mel_win, self.n_mels), np.float32)
        with self._call_lock, span("data.load", rows=self.batch):
            if not self._h:
                raise RuntimeError("native loader closed")
            ok = self._lib.vl_next_batch(
                self._h, _ptr(x, ctypes.c_float), _ptr(y, ctypes.c_int32), _ptr(m, ctypes.c_float)
            )
        if not ok:
            raise RuntimeError("native loader closed while waiting for a batch")
        return VocoderBatch(x, y, m)

    def __iter__(self) -> Iterator[VocoderBatch]:
        while True:
            yield self.next_batch()

    def close(self) -> None:
        h = getattr(self, "_h", None)
        if not h:
            return
        # wake any consumer blocked inside vl_next_batch, wait for it to
        # leave the C call (lock), then free — never delete under a sleeper
        self._lib.vl_request_stop(h)
        with self._call_lock:
            self._h = None
        self._lib.vl_destroy(h)


class NativeVocoderLoader(NativeWindowLoader):
    """WaveRNN's windows: each row's mu-law labels (column 0) and GTA mel
    (column 2), as ``VocoderDataset`` reads them, at ``cfg``'s geometry."""

    def __init__(
        self,
        metadata_rows: list[list[str]],
        data_dir: str,
        cfg: Config,
        n_workers: int = 2,
        ring_size: int = 8,
        seed: int = 1234,
        indices: list[int] | None = None,
    ):
        rows = metadata_rows if indices is None else [metadata_rows[i] for i in indices]
        labels = [np.load(os.path.join(data_dir, r[0])) for r in rows]
        mels = [np.load(os.path.join(data_dir, r[2])).astype(np.float32) for r in rows]
        wc = cfg.wavernn_train
        super().__init__(labels, mels, batch=wc.batch_size, seq_hops=wc.seq_len_hops, hop=cfg.audio.hop_size,
                         pad=cfg.wavernn.pad, n_mels=cfg.audio.num_mels, bits=cfg.audio.bits, n_workers=n_workers,
                         ring_size=ring_size, seed=seed)


def peak_gains(audio: list) -> np.ndarray:
    """The factor that takes each utterance's int16 samples to floats peak-
    normalised to 0.95 (``meldataset.py``: ``normalize(audio / 32768) *
    0.95``); 1/32768 for a silent one."""
    peaks = np.array([np.abs(np.asarray(a, np.int32)).max(initial=0) for a in audio], np.float64)
    return np.where(peaks > 0, 0.95 / np.maximum(peaks, 1), 1.0 / 32768).astype(np.float32)


class NativeSegmentLoader(NativeWindowLoader):
    """HiFi-GAN's segments: ``segment`` samples of each utterance's 16-bit
    PCM at a random sample offset, as floats peak-normalised to 0.95
    (``peak_gains``), ``batch`` of them a batch, every utterance once an
    epoch; ``next_batch().x`` is the [batch, segment] audio."""

    def __init__(self, audio: list, segment: int, batch: int, n_workers: int = 2, ring_size: int = 8,
                 seed: int = 1234):
        super().__init__(audio, None, batch=batch, seq_hops=segment, hop=1, pad=0, n_mels=0, bits=16,
                         gains=peak_gains(audio), n_workers=n_workers, ring_size=ring_size, seed=seed)


def preemphasis_native(x: np.ndarray, k: float) -> np.ndarray:
    """C++ preemphasis y[t] = x[t] - k x[t-1] (scipy.signal.lfilter [1, -k])."""
    lib = _load_lib()
    if lib is None:
        raise RuntimeError("native library unavailable")
    x = np.ascontiguousarray(x, np.float32)
    y = np.empty_like(x)
    lib.vl_preemphasis(_ptr(x, ctypes.c_float), _ptr(y, ctypes.c_float), x.size, k)
    return y


def mulaw_encode_native(x: np.ndarray, mu: int) -> np.ndarray:
    """C++ mu-law encode to labels in [0, mu) (``mu`` is the class count)."""
    lib = _load_lib()
    if lib is None:
        raise RuntimeError("native library unavailable")
    x = np.ascontiguousarray(x, np.float32)
    out = np.empty(x.shape, np.int16)
    lib.vl_mulaw_encode(_ptr(x, ctypes.c_float), _ptr(out, ctypes.c_int16), x.size, mu)
    return out
