"""The multi-process runtime: one process per card, joined by
``torch.distributed``.

The JAX package's counterpart calls ``jax.distributed.initialize``, after
which one GSPMD mesh spans every process's devices.  Here each rank is one
process driving one card (``cuda:LOCAL_RANK``), as ``torchrun`` starts
them; the collectives are NCCL's on the card and gloo's on the CPU.  A
single process (no launcher, or a world of 1) runs without a process group
and every helper below answers as rank 0 of 1.

Launch (each rank trains on its own card)::

    torchrun --nproc-per-node N -m tacotronv2_wavernn_chinese_tpu_torch.train.tacotron_train ...
"""

from __future__ import annotations

import os

import torch
import torch.distributed as dist


def initialize(coordinator_address: str | None = None, num_processes: int | None = None,
               process_id: int | None = None, backend: str | None = None, device=None) -> None:
    """Join the process group (a no-op for one process or when already joined).

    With ``coordinator_address`` ("host:port", or an init URL such as
    ``file:///path``), ``num_processes`` and ``process_id`` given, those are
    used; with none, the launcher's environment (``RANK``, ``WORLD_SIZE``,
    ``LOCAL_RANK``, ``MASTER_ADDR``/``MASTER_PORT``), and no launcher means
    one process.  The backend is NCCL, on ``cuda:LOCAL_RANK`` (made the
    current device); gloo only when ``backend="gloo"`` is named or
    ``device`` is the CPU.  A CUDA run without NCCL raises: it never
    switches to gloo or to the CPU on its own."""
    if num_processes is not None and num_processes <= 1:
        return
    if dist.is_available() and dist.is_initialized():
        return
    if coordinator_address is None:
        world = int(os.environ.get("WORLD_SIZE", "1"))
        if world <= 1:
            return
        rank = int(os.environ["RANK"])
        init_method = "env://"
    else:
        if num_processes is None or process_id is None:
            raise ValueError("coordinator_address needs num_processes and process_id")
        world, rank = int(num_processes), int(process_id)
        init_method = coordinator_address if "://" in coordinator_address else f"tcp://{coordinator_address}"
    if not dist.is_available():
        raise RuntimeError("this torch build has no torch.distributed")
    on_cpu = device is not None and torch.device(device).type == "cpu"
    backend = backend or ("gloo" if on_cpu else "nccl")
    if not on_cpu:
        if not torch.cuda.is_available():
            raise RuntimeError(f"rank {rank} of {world}: no CUDA device is available; pass device='cpu' "
                               "to run the ranks on the CPU over gloo")
        local = int(os.environ.get("LOCAL_RANK", rank % torch.cuda.device_count()))
        torch.cuda.set_device(local)
    if backend == "nccl" and not dist.is_nccl_available():
        raise RuntimeError("NCCL is not available in this torch build; a CUDA run does not fall back to gloo "
                           "(name backend='gloo' to ask for it)")
    dist.init_process_group(backend, init_method=init_method, world_size=world, rank=rank)


def initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def host_shard() -> tuple[int, int]:
    """(rank, world size); (0, 1) without a process group."""
    if not initialized():
        return 0, 1
    return dist.get_rank(), dist.get_world_size()


def is_primary() -> bool:
    """True on the rank that writes checkpoints, logs and artifacts."""
    return host_shard()[0] == 0


def primary_log(log):
    """``log`` on rank 0; a no-op on the other ranks."""
    return log if is_primary() else (lambda *args, **kwargs: None)


def barrier() -> None:
    if initialized():
        dist.barrier()


def build_kernels(device) -> None:
    """Build the CUDA kernels on rank 0 first, then load them everywhere:
    the other ranks wait at a barrier and find the libraries built (the
    build's per-process temporary files and atomic renames keep a
    concurrent build safe too, but N ranks would run N nvcc each)."""
    if torch.device(device).type != "cuda":
        return
    from .. import ops

    if is_primary():
        ops.build_all()
    barrier()
    ops.build_all()


def shutdown() -> None:
    if initialized():
        dist.destroy_process_group()
