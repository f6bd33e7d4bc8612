"""The plain reference: the published models' equations in plain PyTorch
and NumPy, written for this benchmark from the model descriptions, to
judge what the port serves and trains.  It imports neither JAX, nor the
JAX package, nor the port, and takes no weights, tables or packed data
from the program: it is handed the benchmark's own weights and inputs and
the program's outputs, and works everything else out again.

``precision(tf32)`` selects IEEE float32 (the configurations' precision)
or TF32 matrix products and convolutions (the control, one step below).
"""

from __future__ import annotations

import contextlib

import torch


@contextlib.contextmanager
def precision(tf32: bool = False):
    """float32 with TF32 off (the default), or TF32 on (the control)."""
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved
