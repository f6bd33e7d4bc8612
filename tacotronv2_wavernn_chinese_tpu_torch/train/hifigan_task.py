"""HiFi-GAN training: the state, the two-phase GAN step and the batch (the
optimizer and the step skeleton are ``train/optim.py``'s).

Recipe per jik876/hifi-gan ``train.py``: the input mel and the loss mel of
each segment are computed on the device (``dsp.spectrogram.hifigan_mel``,
the input's up to ``fmax``, the loss's up to ``fmax_for_loss``, None being
half the sample rate), then in this order

1. the generator's forward on the input mel, and the loss mel of its audio;
2. the discriminator step: both discriminators on the real audio and on the
   generated audio detached, the LSGAN discriminator loss, its gradient and
   the discriminators' AdamW;
3. the generator step, through the *updated* discriminators: the mel L1
   loss x ``mel_loss_weight``, feature matching x ``fm_loss_weight`` and
   the LSGAN generator loss, its gradient and the generator's AdamW.

Each AdamW is ``optim.adam`` with ``optax_rule`` (epsilon outside the root,
as torch's) and decoupled decay, with no clipping; the learning rate is
``learning_rate x lr_decay ** epoch``.  In step 3 the discriminators'
weights are constants (their gradients there are dropped by ``train.py``
before they are used), so their forward on the real audio runs without a
graph, and the backward runs in two calls: from the loss to the generated
audio, then from it through the generator (``hifigan.generator``), which
gives the same gradient and a span of the generator's own backward.  The
spectral-norm vector ``u`` advances at each of the four calls of the first
scale's discriminator.  One host read a step (``optim.readback``), in full
f32 (``utils.precision.fp32_precision``).

Spans: ``train.step`` (the root), ``hifigan.mel``, ``train.forward`` >
``hifigan.generator``, ``hifigan.disc_step`` and ``hifigan.gen_step``
(each with ``train.forward``, ``train.backward`` and
``train.optimizer``), ``train.readback``.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

import torch
import torch.nn.functional as F

from ..config import Config, HiFiGANConfig
from ..dsp.spectrogram import hifigan_mel, mel_basis
from ..models import hifigan as H
from ..utils import tree_leaves, tree_map
from ..utils.metrics import span
from ..utils.precision import fp32_precision
from .optim import TrainState, adam_init, grads_of, optax_rule, optimizer_step, readback


@dataclass
class HiFiGANState:
    step: int
    gen: TrainState  # the generator's params and AdamW state
    disc: TrainState  # {"mpd", "msd"} and theirs
    sn: dict  # the spectral-normed scale's ``u`` vectors


def init_state(seed: int, cfg: Config, device) -> HiFiGANState:
    params, sn = H.init_hifigan(seed, cfg.hifigan, device)
    return from_params(params, sn)


def from_params(params: dict, sn: dict, step: int = 0) -> HiFiGANState:
    """A fresh optimizer state for ``params`` ({"gen", "mpd", "msd"})."""
    disc = {"mpd": params["mpd"], "msd": params["msd"]}
    return HiFiGANState(step, TrainState(step, params["gen"], adam_init(params["gen"])),
                        TrainState(step, disc, adam_init(disc)), sn)


@functools.lru_cache(maxsize=8)
def _basis(sample_rate: int, n_fft: int, num_mels: int, fmin: float, fmax: float, device: str) -> torch.Tensor:
    return torch.as_tensor(mel_basis(sample_rate, n_fft, num_mels, fmin, fmax), device=device)


def mel(hc: HiFiGANConfig, audio: torch.Tensor, loss: bool = False) -> torch.Tensor:
    """The input mel (up to ``fmax``) or, with ``loss``, the loss mel (up to
    ``fmax_for_loss``) of [B, samples] audio -> [B, num_mels, frames]."""
    fmax = hc.fmax if not loss else (hc.sample_rate / 2 if hc.fmax_for_loss is None else hc.fmax_for_loss)
    basis = _basis(hc.sample_rate, hc.n_fft, hc.num_mels, float(hc.fmin), float(fmax), str(audio.device))
    return hifigan_mel(audio, basis, hc.n_fft, hc.hop_size, hc.win_size)


def lr_at(cfg: Config, step: int, steps_per_epoch: int | None) -> float:
    """``learning_rate x lr_decay ** epoch`` (``ExponentialLR`` stepped each
    epoch); without ``steps_per_epoch`` the first epoch's."""
    ht = cfg.hifigan_train
    epoch = step // steps_per_epoch if steps_per_epoch else 0
    return ht.learning_rate * ht.lr_decay**epoch


def _adamw(ts: TrainState, grads, cfg: Config, lr: float) -> TrainState:
    ht = cfg.hifigan_train
    new, _ = optimizer_step(ts, ts.params, grads, None, optax_rule, lr, ht.adam_b1, ht.adam_b2, ht.adam_eps,
                            weight_decay=ht.weight_decay)
    return new


def train_step(state: HiFiGANState, batch: dict, cfg: Config, steps_per_epoch: int | None = None):
    """One GAN step in full f32 -> (new state, {"loss_disc", "loss_gen",
    "mel_error"} as floats).  ``batch["audio"]`` is [B, segment] float on
    the params' device."""
    hc, ht = cfg.hifigan, cfg.hifigan_train
    y = batch["audio"]
    lr = lr_at(cfg, state.step, steps_per_epoch)
    with fp32_precision(), span("train.step", device=True, anchor=True, step=state.step, rows=int(y.shape[0]),
                                T=int(y.shape[1])):
        with span("hifigan.mel", device=True):
            mel_in, mel_real = mel(hc, y), mel(hc, y, loss=True)
        g_leaves = tree_map(lambda p: p.detach().requires_grad_(True), state.gen.params)
        with span("train.forward", device=True):
            with span("hifigan.generator", device=True):
                fake = H.generator(g_leaves, hc, mel_in)
            with span("hifigan.mel", device=True):
                mel_fake = mel(hc, fake.squeeze(1), loss=True)
        real = y.unsqueeze(1)

        with span("hifigan.disc_step", device=True):
            fake_d = fake.detach()

            def disc_loss(dp):
                r_mpd, _ = H.mpd(dp["mpd"], real)
                f_mpd, _ = H.mpd(dp["mpd"], fake_d)
                r_msd, _, sn = H.msd(dp["msd"], state.sn, real)
                f_msd, _, sn = H.msd(dp["msd"], sn, fake_d)
                return H.discriminator_loss(r_msd, f_msd) + H.discriminator_loss(r_mpd, f_mpd), sn

            loss_d, sn, d_grads = grads_of(disc_loss, state.disc.params)
            disc = _adamw(state.disc, d_grads, cfg, lr)

        with span("hifigan.gen_step", device=True):
            dp = disc.params
            with span("train.forward", device=True):
                with torch.no_grad():
                    _, fm_r_mpd = H.mpd(dp["mpd"], real)
                f_mpd, fm_f_mpd = H.mpd(dp["mpd"], fake)
                with torch.no_grad():
                    _, fm_r_msd, sn = H.msd(dp["msd"], sn, real)
                f_msd, fm_f_msd, sn = H.msd(dp["msd"], sn, fake)
                mel_error = F.l1_loss(mel_real, mel_fake)
                fm = H.feature_loss(fm_r_msd, fm_f_msd) + H.feature_loss(fm_r_mpd, fm_f_mpd)
                loss_g = (H.generator_loss(f_msd) + H.generator_loss(f_mpd) + ht.fm_loss_weight * fm
                          + ht.mel_loss_weight * mel_error)
            with span("train.backward", device=True):
                (g_fake,) = torch.autograd.grad(loss_g, fake)
                with span("hifigan.generator", device=True):
                    gs = iter(torch.autograd.grad(fake, tree_leaves(g_leaves), grad_outputs=g_fake))
            gen = _adamw(state.gen, tree_map(lambda _: next(gs), g_leaves), cfg, lr)

        metrics = readback({"loss_disc": loss_d, "loss_gen": loss_g, "mel_error": mel_error})
    return HiFiGANState(state.step + 1, gen, disc, sn), metrics


def batch_to_device(batch, device) -> dict:
    """A ``VocoderBatch`` of segments (``data.native_loader.NativeSegmentLoader``)
    -> {"audio": [B, segment]} on ``device``."""
    with span("data.to_device"):
        return {"audio": torch.as_tensor(batch.x).to(device)}
