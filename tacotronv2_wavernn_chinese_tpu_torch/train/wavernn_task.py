"""WaveRNN training: the recipe, the loss and the train step (the state,
the optimizer and the step skeleton are ``train/optim.py``'s).

Recipe per reference wavernn_train.py:20-153, as the JAX package's
``train/wavernn_task.py`` runs it: optax's ``clip_by_global_norm(4.0)``
then ``adam(1e-4)`` (bias-corrected m̂ / (√v̂ + 1e-8), not the TF-1 rule of
the Tacotron side), cross-entropy over mu-law classes (RAW) or the
discretized-logistic NLL (MOL).  The step count travels with the state, and
the BatchNorm running statistics come from the forward and take no Adam
step (``optax.apply_updates(new_params, updates)``; their gradients are
zero, so their updates are too).  The step returns a new params tree.

Precision: every step runs in full f32 (``utils.precision.fp32_precision``):
TF32 is off for matmuls and for cuDNN's convolutions and GRUs, set through
torch's per-operator flags, scoped to the step and restored after it,
never set at import.  The step's gradients are piecewise smooth: a ReLU of
fc1 or fc2 whose pre-activation lies within ~1e-6 of zero can land on the
other side under another f32 rounding, and each such unit moves its
layers' weight gradients by one position's term of a mean over B x 1,375
positions.  Two f32 implementations of the step therefore agree to
rounding only on one activation pattern (chip_smoke.py pins the CPU's
ReLUs to the card's; tools/torch_wavernn_step_precision.py measures both
readings).  On that pattern f32 sits ~2e-6 of max|g| from float64 on
varied mels, but ~1e-4 on near-constant ones (an untrained Tacotron's GTA
output): BatchNorm after conv_in then makes conv_in's weight gradient a
small difference of large terms, on the CPU as on the card.  Adam's
first step turns a gradient element's sign into ±lr, so a near-zero
element whose sign differs between two devices (or between this port and
JAX) moves by up to 2 lr; the tests hold params at the Tacotron optimizer
tests' tolerance where the gradients agree.

Parallel (``train_step(..., mesh=...)``): over a mesh's ``data`` axis each
rank steps on its rows of the global batch, with the MelResNet's BatchNorm
statistics, the loss (the mean over equal windows: each rank's mean
divided by the rank count is its share) and the gradients (one flat
all-reduce before the clip) global; over a ``model`` axis of
``parallel.tp.make_mesh_2d`` the state holds ``parallel.tp``'s column
blocks and the step runs ``parallel.tp.layers``.
"""

from __future__ import annotations

import torch

from ..config import Config
from ..models import wavernn as W
from ..parallel import mesh as PM
from ..parallel import tp as TP
from ..utils import precision as P
from ..utils.checkpoints import init_wavernn
from ..utils.metrics import span
from ..utils.precision import fp32_precision
from .optim import TrainState, adam_init, grads_of, optax_rule, optimizer_step, readback


def init_state(seed: int, cfg: Config, device) -> TrainState:
    params = init_wavernn(seed, cfg.wavernn, cfg.audio.num_mels, cfg.audio.bits, device=device)
    return TrainState(0, params, adam_init(params))


def loss_fn(params, cfg: Config, batch: dict, train: bool = True, layers: dict | None = None):
    """-> (loss, (params with the forward's BN statistics, logits)).  Under
    ``mixed_precision`` the forward runs on bf16 weights (BN statistics
    f32; ``utils/precision.py``), the returned params are the merged f32
    master and the loss is taken on f32 logits.  ``layers`` replaces the
    forward's ``dense``/``gru`` (``parallel.tp.layers``)."""
    master = params
    if cfg.wavernn_train.mixed_precision:
        params = P.cast_params(params)
    logits, new_params = W.forward(params, cfg.wavernn, batch["x"], batch["mels"], train, **(layers or {}))
    if cfg.wavernn_train.mixed_precision:
        new_params = P.merge_master(master, new_params)
        logits = logits.float()
    loss = W.wavernn_loss(logits, batch["y"], mode=cfg.wavernn.mode, bits=cfg.audio.bits)
    return loss, (new_params, logits)


def compute_grads(params, cfg: Config, batch: dict, mesh=None):
    """Loss, the params with the forward's BN statistics, and the gradient
    of every leaf (zeros for the BN statistics).  With a ``mesh`` whose
    ``data`` axis holds a process group (``parallel/mesh.py``), ``batch`` is
    this rank's rows and the loss and gradients returned are the global
    batch's; with one whose ``model`` axis spans several ranks the sharded
    leaves (and their gradients) are this rank's column blocks."""
    with PM.data_parallel(mesh):
        layers = TP.layers(mesh) if TP.model_parallel(mesh) else None

        def share_of(leaves):  # the global mean over equal windows is the sum of the shares
            loss, (new_params, _) = loss_fn(leaves, cfg, batch, True, layers)
            return loss / PM.batch_shards(), new_params

        share, new_params, grads = grads_of(share_of, params)
        if PM.batch_sharded():
            share, grads = PM.batch_sum(share.detach()), PM.batch_sum_tree(grads)
    return share.detach(), new_params, grads


def apply_gradients(state: TrainState, new_params, grads, cfg: Config, norm: torch.Tensor | None = None):
    """Clip, optax's Adam, then ``new_params + updates``
    (``optim.optimizer_step``) -> (new state, grad norm).  ``norm`` is the
    gradients' global norm where the tree alone does not give it
    (tensor-parallel blocks)."""
    wc = cfg.wavernn_train
    return optimizer_step(state, new_params, grads, wc.grad_clip_norm, optax_rule, wc.lr, norm=norm)


def train_step(state: TrainState, batch: dict, cfg: Config, mesh=None):
    """One optimization step in full f32 -> (new state, {"loss", "grad_norm"}
    as floats).  ``batch`` holds tensors x [B, T] float, y [B, T] int and
    mels [B, T/hop + 2*pad, M] on the params' device: with a ``mesh``, this
    rank's rows over its ``data`` axis (``parallel/mesh.py``), and over a
    ``model`` axis ``state`` holds ``parallel.tp.place_wavernn_state``'s
    blocks."""
    x = batch["x"]
    with fp32_precision(), span("train.step", device=True, anchor=True, step=state.step, rows=int(x.shape[0]),
                                T=int(x.shape[1])):
        loss, new_params, grads = compute_grads(state.params, cfg, batch, mesh)
        norm = TP.global_norm(grads, mesh) if TP.model_parallel(mesh) else None
        new_state, norm = apply_gradients(state, new_params, grads, cfg, norm)
        metrics = readback({"loss": loss, "grad_norm": norm})
    return new_state, metrics


def eval_step(params, batch: dict, cfg: Config) -> dict:
    """Eval-mode loss (running BN statistics, no gradients)."""
    with fp32_precision(), torch.no_grad():
        loss, _ = loss_fn(params, cfg, batch, train=False)
    return {"loss": float(loss)}


def batch_to_device(batch, device) -> dict:
    """A ``VocoderBatch`` (numpy) -> the step's tensors on ``device``."""
    t = lambda a: torch.as_tensor(a).to(device)
    with span("data.to_device"):
        return {"x": t(batch.x), "y": t(batch.y).long(), "mels": t(batch.mels)}

