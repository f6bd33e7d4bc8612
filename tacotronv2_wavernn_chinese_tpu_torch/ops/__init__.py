"""Hand-written CUDA kernels (the two autoregressive loops of serving and
the teacher-forced decoder core of training, forward and backward), plus
what they share: the build, the launch counters and the random generator.

Build.  The sources under ``csrc/`` are compiled at first use with ``nvcc``
for ``sm_90a`` into plain-C shared libraries (one per ``.cu`` file, all
compiled in parallel) and bound with ctypes.  The outputs go to
``build/torch_kernels/<hash of the sources>/`` beside the package, so an
edited source triggers a rebuild and an unchanged one is loaded as is.
Nothing is built or imported from CUDA when this module is imported.

Counters.  ``LAUNCHES[name]`` is incremented by a wrapper exactly where it
launches its kernel; the plain versions never touch it.

Random bits.  ``hash_bits(seed, row, step, lane)`` is a counter-based
32-bit hash (three rounds of the murmur3 finalizer over seed, row and step,
then one over the lane): the same function is written in ``csrc/rng.cuh``
and here in int64 torch arithmetic masked to 32 bits, so a kernel and its
plain version draw identical bits.  Each draw depends only on its own
(seed, row, step, lane), so a row's randomness never depends on the rows
it was batched with.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading

import torch

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_ROOT = os.path.join(os.path.dirname(_PKG_DIR), "build", "torch_kernels")
SOURCES = ("wavernn_sample.cu", "tacotron_decode.cu", "tacotron_train_fwd.cu", "tacotron_train_bwd.cu")
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v",
]

LAUNCHES = {"wavernn_sample": 0, "tacotron_decode": 0, "tacotron_train_fwd": 0, "tacotron_train_bwd": 0}

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}
BUILD_INFO: dict = {}


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


# ---------------------------------------------------------------------------
# build and load
# ---------------------------------------------------------------------------


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    path = os.path.join(home, "bin", "nvcc")
    if os.path.exists(path):
        return path
    raise RuntimeError("nvcc was not found (PATH, CUDA_HOME, /usr/local/cuda): the CUDA kernels cannot be built")


def _source_hash() -> str:
    h = hashlib.sha256()
    for name in sorted(os.listdir(CSRC_DIR)):
        if name.endswith((".cu", ".cuh")):
            h.update(name.encode())
            with open(os.path.join(CSRC_DIR, name), "rb") as f:
                h.update(f.read())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def build_all() -> dict:
    """Compile every kernel source that has no library yet (one nvcc per
    source, all started together).  Returns {source: path to .so}.
    Raises with the compiler's output when a build fails."""
    import time

    with _lock:
        out_dir = os.path.join(BUILD_ROOT, _source_hash())
        os.makedirs(out_dir, exist_ok=True)
        paths = {s: os.path.join(out_dir, s.replace(".cu", ".so")) for s in SOURCES}
        todo = [s for s in SOURCES if not os.path.exists(paths[s])]
        t0 = time.time()
        procs = {}
        nvcc = _nvcc() if todo else None
        for s in todo:
            tmp = f"{paths[s]}.{os.getpid()}.tmp"
            cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, os.path.join(CSRC_DIR, s)]
            procs[s] = (tmp, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
        logs, failed = {}, []
        for s, (tmp, p) in procs.items():
            out, _ = p.communicate()
            logs[s] = out
            with open(paths[s] + ".log", "w") as f:
                f.write(out)
            if p.returncode != 0:
                failed.append(s)
            else:
                os.replace(tmp, paths[s])
        if failed:
            raise RuntimeError(
                "nvcc failed for " + ", ".join(failed) + ":\n" + "\n".join(logs[s] for s in failed)
            )
        BUILD_INFO.update(dir=out_dir, built=todo, seconds=time.time() - t0, logs=logs)
        return paths


_ARGTYPES = {
    "wavernn_sample_launch": [ctypes.c_void_p] * 20 + [ctypes.c_int] * 8 + [ctypes.c_uint32, ctypes.c_void_p],
    "wavernn_sample_smem_bytes": [ctypes.c_int] * 5,
    "wavernn_sample_scratch_floats": [ctypes.c_int] * 4,
    # the cluster-grid kernels take their device pointers as one host array,
    # then the barrier counter
    "tacotron_decode_launch": [ctypes.c_void_p] * 2 + [ctypes.c_int] * 20 + [ctypes.c_float] * 4
    + [ctypes.c_uint32, ctypes.c_void_p],
    "tacotron_decode_smem_bytes": [ctypes.c_int] * 13,
    "tacotron_decode_scratch_floats": [ctypes.c_int] * 13,
    "tacotron_decode_clusters": [],
    "tacotron_train_fwd_launch": [ctypes.c_void_p] * 2 + [ctypes.c_int] * 11 + [ctypes.c_float, ctypes.c_void_p],
    "tacotron_train_bwd_launch": [ctypes.c_void_p] * 2 + [ctypes.c_int] * 11 + [ctypes.c_float, ctypes.c_void_p],
    "tacotron_train_fwd_smem_bytes": [ctypes.c_int] * 9,
    "tacotron_train_bwd_smem_bytes": [ctypes.c_int] * 9,
    "tacotron_train_bwd_scratch_floats": [ctypes.c_int] * 8,
    "tacotron_train_fwd_clusters": [],
    "tacotron_train_bwd_clusters": [],
}


def load(source: str) -> ctypes.CDLL:
    """The ctypes handle of one kernel library, built on first use."""
    if source in _libs:
        return _libs[source]
    paths = build_all()
    lib = ctypes.CDLL(paths[source])
    for fn, argtypes in _ARGTYPES.items():
        if hasattr(lib, fn):
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
    _libs[source] = lib
    return lib


def check_launch(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with cudaError {err}")


def ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def stream_ptr(device: torch.device) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


def require_f32_contiguous(name: str, t: torch.Tensor, device: torch.device, shape=None) -> None:
    """Wrapper-side argument checks: the kernels take f32, contiguous,
    same-device tensors of the stated shape."""
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != torch.float32:
        raise TypeError(f"{name} has dtype {t.dtype}, the kernel takes float32")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {tuple(shape)}")


# ---------------------------------------------------------------------------
# the shared counter-based generator (plain version of csrc/rng.cuh)
# ---------------------------------------------------------------------------

_M32 = 0xFFFFFFFF


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """(x * c) mod 2^32 for 0 <= x < 2^32 without int64 overflow."""
    lo = x * (c & 0xFFFF)
    hi = ((x * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _M32


def _fmix32(h: torch.Tensor) -> torch.Tensor:
    h = h ^ (h >> 16)
    h = _mul32(h, 0x85EBCA6B)
    h = h ^ (h >> 13)
    h = _mul32(h, 0xC2B2AE35)
    return h ^ (h >> 16)


def hash_bits(seed, row, step, lane) -> torch.Tensor:
    """uint32 random bits (held in int64) for broadcastable int64 tensors
    (seed, row, step, lane) — bit-identical to ``rng_bits`` in rng.cuh."""
    k = _fmix32((seed & _M32) ^ 0x9E3779B9)
    k = _fmix32(k ^ (row & _M32))
    k = _fmix32(k ^ (step & _M32))
    return _fmix32((k + _mul32(lane & _M32, 0x9E3779B9)) & _M32)


def keep_threshold(rate: float) -> int:
    """Dropout keeps a unit when its bits are below this: (1-rate) * 2^32."""
    return int((1.0 - rate) * 4294967295.0)


def gumbel_from_bits(bits: torch.Tensor) -> torch.Tensor:
    """uint32 bits -> standard Gumbel noise (f32): the high 23 bits become a
    uniform in [1, 2) through the exponent trick, then (0, 1]."""
    f = ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32) - 1.0
    u = torch.clamp_min(f, 1e-9)
    return -torch.log(-torch.log(u))
