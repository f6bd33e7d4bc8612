"""Sequence-parallel vocoder generation: an utterance's folds sharded over
the ranks.

``models.wavernn.fold_with_overlap`` turns one utterance's time axis into
a batch of overlapping folds (reference fatchord_version.py:293-340); here
that fold axis is split over a mesh axis, so N cards run the sample loop
(K1, ``ops/wavernn_kernel.py``) on N blocks of folds at once.  Folds are
independent by construction (2 x overlap conditioning frames each), so
generation exchanges nothing; each rank's sampling seed is folded with its
index (``fold_seed``, as the JAX package's ``fold_in(key, axis_index)``) so
the shards draw different noise.

The crossfade-unfold runs sharded too (``xfade_and_unfold_sharded``): each
rank fades its folds and overlap-adds them into its contiguous chunk, and
the one boundary tail a rank's last fold leaves for the next rank's first
travels by an all-gather of the ranks' last tails (the JAX package sends it
with ``ppermute``; an all-gather works on NCCL and on gloo alike, whose
send/recv take no CUDA tensor).  The stitched waveform is then gathered,
and every rank returns it.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable

import numpy as np
import torch

from ..config import WaveRNNGenConfig, WaveRNNModelConfig
from ..models import wavernn as W
from ..ops import hash_bits
from . import mesh as PM


def pad_folds_to_multiple(folds: np.ndarray, n: int) -> tuple[np.ndarray, int]:
    """Pad the fold axis up to a multiple of ``n`` (the extra folds repeat
    the last; they are generated, then dropped) -> (folds, original count)."""
    return W.bucket_folds(folds, n), folds.shape[0]


def fold_seed(seed: int, index: int) -> int:
    """The sampling seed of shard ``index``: the seed's and the index's
    bits mixed by the kernels' counter hash (``ops.hash_bits``)."""
    t = lambda v: torch.tensor(int(v) & 0xFFFFFFFF, dtype=torch.int64)
    return int(hash_bits(t(seed), t(index), t(0), t(0)))


def generate_folds_sharded(
    params: Any,
    model_cfg: WaveRNNModelConfig,
    mesh: PM.Mesh,
    folds,  # [B, T_mel_fold, M], the whole fold batch, B divisible by the axis size
    seed: int = 0,
    bits: int = 10,
    apply_mu_law: bool = True,
    axis: str = "data",
    generate_fn: Callable | None = None,
    greedy: bool = False,
) -> torch.Tensor:
    """This rank's block of folds through the sample loop -> its wav folds
    [B / n, L] on the params' device.  ``generate_fn`` defaults to the
    config's loop (K1 for RAW on the card), run at ``fold_seed(seed, rank
    index)``."""
    n, i = mesh.shape[axis], mesh.coords[axis]
    local = PM.shard_rows(folds, n, i)
    gen = generate_fn or W.default_generate_fn(model_cfg, greedy)
    return gen(params, model_cfg, local, fold_seed(seed, i), bits, apply_mu_law)


def _fades(overlap: int, length: int, device) -> torch.Tensor:
    """Per-sample factors of a fold: the equal-power fade-in over its first
    ``overlap`` samples (half silence, then sqrt(0.5 (1 + t))), the fade-out
    over its last, 1 between (reference fatchord_version.py:342-405)."""
    silence_len = overlap // 2
    fade_len = overlap - silence_len
    t = np.linspace(-1.0, 1.0, fade_len, dtype=np.float32)
    f = np.ones(length, np.float32)
    if overlap:
        f[:overlap] = np.concatenate([np.zeros(silence_len, np.float32), np.sqrt(0.5 * (1.0 + t))])
        f[length - overlap:] = np.concatenate([np.ones(silence_len, np.float32), np.sqrt(0.5 * (1.0 - t))])
    return torch.as_tensor(f, device=device)


def xfade_and_unfold_sharded(
    wav_local: torch.Tensor,  # [B / n, target + 2*overlap], this rank's folds
    overlap: int,
    n_folds: int,
    mesh: PM.Mesh,
    axis: str = "data",
) -> np.ndarray:
    """The equal-power crossfade of folds sharded over ``axis`` (the math of
    ``models.wavernn.xfade_and_unfold``), stitched on the folds' device.

    Each rank fades its folds, zeroes those past ``n_folds`` (bucketing
    pads, so they never bleed into the audible tail), and overlap-adds them
    into its chunk; the tail of each rank's last fold is added to the next
    rank's first fold.  Returns the whole waveform ``[B * (target +
    overlap) + overlap]`` on every rank, in numpy."""
    n, i = mesh.shape[axis], mesh.coords[axis]
    Bl, L = wav_local.shape
    stride = L - overlap
    gi = i * Bl + torch.arange(Bl, device=wav_local.device)
    y = wav_local.float() * (gi < n_folds)[:, None] * _fades(overlap, L, wav_local.device)
    bodies = y[:, :stride].clone()
    tails = y[:, stride:]  # fold b's tail overlaps fold b + 1's head
    all_tails = PM.gather_rows(tails[-1:].contiguous(), mesh, axis)  # [n, overlap]: every rank's last tail
    if overlap:
        prev = all_tails[i - 1:i] if i > 0 else torch.zeros_like(tails[:1])
        bodies[:, :overlap] += torch.cat([prev, tails[:-1]], dim=0)
    chunks = PM.gather_rows(bodies.reshape(-1), mesh, axis)
    # the final tail: the last fold's when nothing was padded; with pads the
    # real tail already sits in the first pad fold's chunk, and this is zeros
    return torch.cat([chunks, all_tails[-1]]).cpu().numpy()


def generate_distributed(
    params: Any,
    model_cfg: WaveRNNModelConfig,
    gen_cfg: WaveRNNGenConfig,
    mesh: PM.Mesh,
    mel: np.ndarray,  # [T_mel, M] unit mel, one utterance
    seed: int = 0,
    bits: int = 10,
    apply_mu_law: bool = True,
    axis: str = "data",
    device_crossfade: bool = True,
) -> np.ndarray:
    """Batched-fold generation of one utterance with its folds sharded over
    ``axis`` -> wav [T_mel * hop], on every rank.

    With ``device_crossfade`` the folds are bucketed to a multiple of
    lcm(8, n) and the crossfade runs sharded (``xfade_and_unfold_sharded``);
    otherwise ``models.wavernn.generate`` folds, buckets and crossfades on
    the host around a sharded ``generate_fn`` whose folds are gathered."""
    n = mesh.shape[axis]
    if device_crossfade:
        hop = model_cfg.total_upsample
        if gen_cfg.target % hop or gen_cfg.overlap % hop:
            raise ValueError("target and overlap must be multiples of the hop size")
        wave_len = mel.shape[0] * hop
        folds, n_folds = W.fold_with_overlap(np.asarray(mel, np.float32), gen_cfg.target // hop,
                                             gen_cfg.overlap // hop)
        folds = np.stack([W.pad_mel_for_generation(f, model_cfg.pad) for f in folds])
        folds = W.bucket_folds(folds, multiple=math.lcm(8, n))
        dev = params["fc3"]["w"].device
        wav_local = generate_folds_sharded(params, model_cfg, mesh, torch.as_tensor(folds, device=dev), seed,
                                           bits, apply_mu_law, axis)
        wav = xfade_and_unfold_sharded(wav_local, gen_cfg.overlap, n_folds, mesh, axis)[:wave_len]
        return W._fade_out(wav, wave_len, hop)

    def sharded_fn(p, cfg_, folds, seed_, bits_, mu_law):
        padded, n_orig = pad_folds_to_multiple(folds.cpu().numpy(), n)
        local = generate_folds_sharded(p, cfg_, mesh, torch.as_tensor(padded, device=folds.device), seed_, bits_,
                                       mu_law, axis)
        return PM.gather_rows(local, mesh, axis)[:n_orig]

    gen_cfg = dataclasses.replace(gen_cfg, batched=True)
    return W.generate(params, model_cfg, gen_cfg, mel, seed, bits, apply_mu_law, generate_fn=sharded_fn)
