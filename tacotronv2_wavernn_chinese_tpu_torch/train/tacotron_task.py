"""Tacotron training: the recipe, the loss and the train step (the state,
the optimizer and the step skeleton are ``train/optim.py``'s).

Optimization recipe per reference tacotron.py:255-313: Adam(0.9, 0.999,
1e-6) with TF-1 epsilon semantics, exponential LR decay from
``decay_start`` clipped to [final_lr, initial_lr], global-norm-1.0 gradient
clipping.  Fine-tune mode freezes embedding + encoder (reference
tacotron.py:167-169).

One step: teacher-forced forward (the decoder core through K3 on the card
where ``models.tacotron.core_route`` allows, else the eager step loop) +
loss, autograd backward (K4 on the kernel route), clipping, Adam, and the
BN moving statistics of the forward written back, as the JAX package's
``optax.apply_updates(new_params, updates)`` does.  The step returns a new
params tree (tensors are not updated in place).  ``mixed_precision``
casts the weights to bf16 inside the loss (``utils/precision.py``).  The
train and eval steps run in full f32 (``utils.precision.fp32_precision``:
no TF32 in cuDNN's convolutions or in the CBHG head's GRUs).

Data parallel (``train_step(..., mesh=...)``, ``parallel/mesh.py``): each
rank steps on its rows of the global batch; the masks are drawn for the
global batch and sharded, the loss's denominators, the BatchNorm
statistics, the gradients (one flat all-reduce before the clip) and the
metrics are global, so every rank applies the one-process step's update.
"""

from __future__ import annotations

import math

import torch

from ..config import Config
from ..models import tacotron as T
from ..parallel import mesh as PM
from ..utils import precision as P
from ..utils.checkpoints import init_tacotron
from ..utils.metrics import span
from .optim import TrainState, adam_init, grads_of, optimizer_step, readback, tf1_rule

FROZEN_TOP = ("embedding", "enc_convs", "enc_lstm_fw", "enc_lstm_bw")


def lr_schedule(cfg: Config):
    """step -> learning rate, computed in f32 like the JAX schedule."""
    tc = cfg.tacotron_train

    def lr(step: int) -> float:
        t = torch.clamp_min(torch.tensor(float(step), dtype=torch.float32) - tc.decay_start, 0.0)
        v = tc.initial_lr * tc.decay_rate ** (t / tc.decay_steps)
        return float(torch.clamp(v, tc.final_lr, tc.initial_lr))

    return lr


def teacher_forcing_schedule(cfg: Config, step: int) -> float:
    """Teacher-forcing ratio at ``step``: constant, or cosine decay from the
    initial to the final ratio (reference helpers.py:153-186).  A Python
    float, so a ratio of 1 keeps the batched route (``T.core_route``)."""
    tc = cfg.tacotron_train
    if tc.teacher_forcing_mode == "constant":
        return float(tc.teacher_forcing_ratio)
    if tc.teacher_forcing_final_ratio is not None:
        alpha = float(tc.teacher_forcing_final_ratio) / float(tc.teacher_forcing_init_ratio)
    else:
        assert tc.teacher_forcing_decay_alpha is not None, (
            "scheduled teacher forcing needs final_ratio or decay_alpha"
        )
        alpha = float(tc.teacher_forcing_decay_alpha)
    t = min(max(float(step) - tc.teacher_forcing_start_decay, 0.0), float(tc.teacher_forcing_decay_steps))
    cosine = 0.5 * (1.0 + math.cos(math.pi * t / tc.teacher_forcing_decay_steps))
    return tc.teacher_forcing_init_ratio * ((1.0 - alpha) * cosine + alpha)


def init_state(seed: int, cfg: Config, device) -> TrainState:
    params = init_tacotron(seed, cfg.tacotron, device=device)
    return TrainState(0, params, adam_init(params))


def _reg_weight(cfg: Config) -> float:
    tc = cfg.tacotron_train
    w = tc.reg_weight
    if tc.scale_regularization:
        m = cfg.audio.max_abs_value  # reference tacotron.py:237-241
        w *= 1.0 / (2.0 * m) if cfg.audio.symmetric_mels else 1.0 / m
    return w


def loss_fn(params, cfg: Config, batch: dict, generator: torch.Generator, train: bool = True,
            teacher_forcing_ratio: float = 1.0, rand=None):
    """-> (loss, (aux, params with updated BN statistics, TacotronOutput)).
    Under ``mixed_precision`` the forward runs on bf16 weights
    (``utils/precision.py``), the returned params are the merged f32 master,
    the loss is taken in f32, and its L2 term over the master."""
    tc = cfg.tacotron_train
    master = params
    if tc.mixed_precision:
        params = P.cast_params(params)
    out, new_params = T.forward_teacher_forced(
        params, cfg.tacotron, batch["inputs"], batch["input_lengths"], batch["mel_targets"], train,
        rand=rand, generator=generator, teacher_forcing_ratio=teacher_forcing_ratio,
        fused_decoder=tc.fused_decoder,
    )
    if tc.mixed_precision:
        new_params = P.merge_master(master, new_params)
        out = P.cast_to_float32(out)
    with span("tacotron.loss", device=True):
        loss, aux = T.tacotron_loss(
            out, batch["mel_targets"], batch["stop_targets"], batch["target_lengths"],
            new_params if tc.mixed_precision else params, cfg.tacotron,
            reg_weight=_reg_weight(cfg), mask_decoder=tc.mask_decoder, stop_pos_weight=tc.stop_pos_weight,
            linear_targets=batch.get("linear_targets"), sample_rate=cfg.audio.sample_rate,
            loss_frames=batch.get("loss_frames"),
        )
    return loss, (aux, new_params, out)


def compute_grads(params, cfg: Config, batch: dict, generator: torch.Generator, step: int, rand=None,
                  mesh=None):
    """Loss and gradient of every params leaf (zeros where the loss does not
    depend on it, as for the BN moving statistics), at the teacher-forcing
    ratio the schedule gives ``step``; the masks are ``rand`` or drawn from
    ``generator``.

    With a ``mesh`` whose ``data`` axis holds a process group (``parallel/
    mesh.py``), ``batch`` is this rank's rows: the masks are the global
    batch's (drawn, or ``rand`` given for it) cut to those rows, and the
    returned loss, aux terms and gradients are the global batch's, equal on
    every rank."""
    with PM.data_parallel(mesh):
        ratio = teacher_forcing_schedule(cfg, step)
        sharded, shards = PM.batch_sharded(), PM.batch_shards()
        if sharded:
            if rand is None:
                inputs, mels = batch["inputs"], batch["mel_targets"]
                rand = T.draw_train_rand(params, cfg.tacotron, inputs.shape[0] * shards, inputs.shape[1],
                                         mels.shape[1], generator, True, ratio)
            rand = T.shard_train_rand(rand, PM.batch_index(), shards)
        loss, (aux, new_params, _), grads = grads_of(
            lambda leaves: loss_fn(leaves, cfg, batch, generator, True, ratio, rand=rand), params)
        if sharded:  # the ranks' shares summed: the global loss, terms and gradients
            names = list(aux)
            aux = dict(zip(names, PM.batch_sum(torch.stack([aux[k].detach().reshape(()) for k in names]))))
            loss, grads = aux["loss"], PM.batch_sum_tree(grads)
    return loss.detach(), aux, new_params, grads


def apply_gradients(state: TrainState, new_params, grads, cfg: Config):
    """Clip, TF-1 Adam, fine-tune freeze, then ``new_params + updates``
    (``optim.optimizer_step``).  Returns (new state, grad norm, lr)."""
    tc = cfg.tacotron_train
    lr = lr_schedule(cfg)(state.step)
    new_state, norm = optimizer_step(state, new_params, grads, tc.grad_clip_norm, tf1_rule, lr, tc.adam_beta1,
                                     tc.adam_beta2, tc.adam_eps, frozen=FROZEN_TOP if tc.fine_tune else ())
    return new_state, norm, lr


def train_step(state: TrainState, batch: dict, generator: torch.Generator, cfg: Config, mesh=None):
    """One optimization step -> (new state, metrics of floats).  The step's
    masks are drawn from ``generator``.  With a ``mesh`` (``compute_grads``),
    ``batch`` is this rank's rows of the global batch and ``generator`` is
    seeded alike on every rank."""
    inputs, mels = batch["inputs"], batch["mel_targets"]
    with P.fp32_precision(), span("train.step", device=True, anchor=True, step=state.step,
                                  rows=int(inputs.shape[0]), T_in=int(inputs.shape[1]), T=int(mels.shape[1])):
        _, aux, new_params, grads = compute_grads(state.params, cfg, batch, generator, state.step, mesh=mesh)
        new_state, norm, lr = apply_gradients(state, new_params, grads, cfg)
        metrics = readback(dict(aux, grad_norm=norm))
    metrics["lr"] = lr
    return new_state, metrics


def eval_step(params, batch: dict, cfg: Config, generator: torch.Generator):
    """Teacher-forced eval (no gradients): aux losses + outputs."""
    with P.fp32_precision(), torch.no_grad():
        _, (aux, _, out) = loss_fn(params, cfg, batch, generator, train=False)
    return aux, out
