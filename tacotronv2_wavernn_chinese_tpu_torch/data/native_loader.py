"""ctypes binding to the native C++ vocoder batch sampler.

The C++ engine (``native/vocoder_loader.cc`` at the repository root)
replaces the reference's framework-runtime data paths (TF FIFOQueue feeder
thread feeder.py:70-72, torch DataLoader workers dataset.py:90-95): a
worker pool samples random training windows from the corpus buffers and
keeps a prefetch ring full, so ``next_batch()`` is a memcpy — no
Python-side sampling on the step path and no GIL contention with the
device loop.

Build.  ``build_library`` compiles the source with ``g++`` and the flags of
``native/Makefile`` into ``build/native_loader/<hash of the source and
flags>/libvocoder_loader.so`` beside the package (never under ``native/``),
at first use; nothing is built when this module is imported.
``NativeVocoderLoader.available()`` says whether the library builds and
loads; ``VocoderDataset.batches`` remains the pure-Python path.
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
SOURCE = os.path.join(_REPO, "native", "vocoder_loader.cc")
BUILD_ROOT = os.path.join(_REPO, "build", "native_loader")
CXX_FLAGS = ["-O3", "-march=native", "-std=c++17", "-fPIC", "-Wall", "-pthread", "-shared"]

_lock = threading.Lock()
_lib = None


def library_path() -> str:
    h = hashlib.sha256()
    with open(SOURCE, "rb") as f:
        h.update(f.read())
    h.update(" ".join(CXX_FLAGS).encode())
    return os.path.join(BUILD_ROOT, h.hexdigest()[:16], "libvocoder_loader.so")


def build_library() -> str:
    """Compile the loader if its library is missing; returns its path.
    Raises RuntimeError with the compiler's output when g++ fails, and
    FileNotFoundError when there is no g++."""
    path = library_path()
    if os.path.exists(path):
        return path
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    out = subprocess.run(["g++", *CXX_FLAGS, "-o", tmp, SOURCE], capture_output=True, text=True)
    if out.returncode != 0:
        raise RuntimeError(f"g++ failed for {SOURCE}:\n{out.stdout}{out.stderr}")
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
            ctypes.c_uint64,
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


class NativeVocoderLoader:
    """Owns the corpus buffers + the C++ loader handle.  Reads each row's
    GTA mel (column 2), as ``VocoderDataset`` does."""

    @staticmethod
    def available() -> bool:
        return _load_lib() is not None

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
        lib = _load_lib()
        if lib is None:
            raise RuntimeError("native loader unavailable (g++ missing or the build failed)")
        self._lib = lib
        wc = cfg.wavernn_train
        self.batch = wc.batch_size
        self.seq_len = wc.seq_len_hops * cfg.audio.hop_size
        self.mel_win = wc.seq_len_hops + 2 * cfg.wavernn.pad
        self.n_mels = cfg.audio.num_mels

        rows = metadata_rows if indices is None else [metadata_rows[i] for i in indices]
        labels_list, mels_list = [], []
        label_offs, label_lens, mel_offs, mel_frames = [], [], [], []
        lo = mo = 0
        for r in rows:
            lab = np.load(os.path.join(data_dir, r[0])).astype(np.int16)
            mel = np.load(os.path.join(data_dir, r[2])).astype(np.float32)
            labels_list.append(lab)
            mels_list.append(mel)
            label_offs.append(lo)
            label_lens.append(len(lab))
            mel_offs.append(mo)
            mel_frames.append(mel.shape[0])
            lo += len(lab)
            mo += mel.shape[0]
        # keep references alive for the lifetime of the handle
        self._labels = np.concatenate(labels_list) if labels_list else np.zeros(0, np.int16)
        self._mels = (np.concatenate(mels_list, axis=0).reshape(-1) if mels_list
                      else np.zeros(0, np.float32))
        self._meta = tuple(np.asarray(x, np.int64) for x in (label_offs, label_lens, mel_offs, mel_frames))

        # serializes C calls so close() can wait out an in-flight next_batch
        self._call_lock = threading.Lock()
        self._h = lib.vl_create(
            _ptr(self._labels, ctypes.c_int16),
            _ptr(self._mels, ctypes.c_float),
            *(_ptr(a, ctypes.c_int64) for a in self._meta),
            len(rows), self.n_mels, cfg.wavernn.pad, wc.seq_len_hops,
            cfg.audio.hop_size, self.batch, cfg.audio.bits,
            n_workers, ring_size, seed,
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
