"""HiFi-GAN V1 as published (Kong et al. 2020; jik876/hifi-gan
``models.py``, ``meldataset.py`` and ``train.py``), in plain torch modules:
the generator, the multi-period and multi-scale discriminators with
``torch.nn.utils.weight_norm`` and ``spectral_norm`` themselves, the mel
(``torch.stft`` with no centring after a reflect pad), the three losses,
and one whole GAN step with ``torch.optim.AdamW`` on each network, the
discriminators' step first and the generator's through the updated
discriminators.

The modules are built at a configuration's widths (the ``hifigan``
section; the discriminators' widths and groups are fields there too) and
loaded from the benchmark's params tree: a weight-normed convolution's
{"g", "v", "b"} are its ``weight_g``, ``weight_v`` and ``bias``, a
spectral-normed one's {"w", "b"} its ``weight_orig`` and ``bias``, and the
first scale's ``u`` vectors (``sn``) its ``weight_u`` buffers.

Departures from the published code:
* ``init_weights`` is not run: the weights are the benchmark's.  (In
  ``models.py`` it writes normal(0, 0.01) into each weight-normed module's
  ``weight`` after ``weight_norm`` was applied, a tensor the next call
  recomputes from ``g`` and ``v``.)
* The discriminators' gradients of the generator's loss, which
  ``train.py`` computes and then discards with ``optim_d.zero_grad()``,
  are not computed: their weights are held constant in that backward.
* The learning rate is the first epoch's (``ExponentialLR`` decays it once
  an epoch, and the compared steps lie in the first).
"""

from __future__ import annotations

import warnings

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.nn.utils import spectral_norm, weight_norm

LRELU_SLOPE = 0.1


def get_padding(kernel_size, dilation=1):
    return int((kernel_size * dilation - dilation) / 2)


# ---------------------------------------------------------------------------
# the mel (meldataset.py)
# ---------------------------------------------------------------------------


def _hz_to_mel(f):
    f = np.asarray(f, np.float64)
    f_sp, min_log_hz = 200.0 / 3, 1000.0
    logstep = np.log(6.4) / 27.0
    return np.where(f >= min_log_hz, min_log_hz / f_sp + np.log(np.maximum(f, 1e-10) / min_log_hz) / logstep, f / f_sp)


def _mel_to_hz(m):
    m = np.asarray(m, np.float64)
    f_sp, min_log_hz = 200.0 / 3, 1000.0
    min_log_mel, logstep = min_log_hz / f_sp, np.log(6.4) / 27.0
    return np.where(m >= min_log_mel, min_log_hz * np.exp(logstep * (m - min_log_mel)), f_sp * m)


def librosa_mel_fn(sr, n_fft, n_mels, fmin, fmax):
    """``librosa.filters.mel`` (Slaney scale, Slaney area norm)."""
    fft = np.linspace(0, sr / 2, 1 + n_fft // 2)
    hz = _mel_to_hz(np.linspace(_hz_to_mel(fmin), _hz_to_mel(fmax), n_mels + 2))
    fdiff = np.diff(hz)
    ramps = np.subtract.outer(hz, fft)
    weights = np.zeros((n_mels, len(fft)))
    for i in range(n_mels):
        weights[i] = np.maximum(0, np.minimum(-ramps[i] / fdiff[i], ramps[i + 2] / fdiff[i + 1]))
    weights *= (2.0 / (hz[2:n_mels + 2] - hz[:n_mels]))[:, None]
    return weights.astype(np.float32)


def mel_spectrogram(y, n_fft, num_mels, sampling_rate, hop_size, win_size, fmin, fmax):
    """[B, T] -> [B, num_mels, frames], as ``meldataset.mel_spectrogram``
    with ``center=False``."""
    mel = torch.from_numpy(librosa_mel_fn(sampling_rate, n_fft, num_mels, fmin, fmax)).to(y.device)
    window = torch.hann_window(win_size).to(y.device)
    pad = int((n_fft - hop_size) / 2)
    y = F.pad(y.unsqueeze(1), (pad, pad), mode="reflect").squeeze(1)
    spec = torch.stft(y, n_fft, hop_length=hop_size, win_length=win_size, window=window, center=False,
                      normalized=False, onesided=True, return_complex=True)
    spec = torch.sqrt(torch.view_as_real(spec).pow(2).sum(-1) + 1e-9)
    return torch.log(torch.clamp(torch.matmul(mel, spec), min=1e-5))


def mels(h: dict, y, loss: bool):
    fmax = h["fmax"] if not loss else (h["sample_rate"] / 2 if h["fmax_for_loss"] is None else h["fmax_for_loss"])
    return mel_spectrogram(y, h["n_fft"], h["num_mels"], h["sample_rate"], h["hop_size"], h["win_size"],
                           h["fmin"], fmax)


# ---------------------------------------------------------------------------
# models.py
# ---------------------------------------------------------------------------


def _wn(m):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", FutureWarning)
        return weight_norm(m)


class ResBlock1(nn.Module):
    def __init__(self, channels, kernel_size=3, dilation=(1, 3, 5)):
        super().__init__()
        self.convs1 = nn.ModuleList([_wn(nn.Conv1d(channels, channels, kernel_size, 1, dilation=d,
                                                   padding=get_padding(kernel_size, d))) for d in dilation])
        self.convs2 = nn.ModuleList([_wn(nn.Conv1d(channels, channels, kernel_size, 1, dilation=1,
                                                   padding=get_padding(kernel_size, 1))) for _ in dilation])

    def forward(self, x):
        for c1, c2 in zip(self.convs1, self.convs2):
            xt = F.leaky_relu(x, LRELU_SLOPE)
            xt = c1(xt)
            xt = F.leaky_relu(xt, LRELU_SLOPE)
            xt = c2(xt)
            x = xt + x
        return x


class Generator(nn.Module):
    def __init__(self, h):
        super().__init__()
        self.num_kernels = len(h["resblock_kernel_sizes"])
        self.num_upsamples = len(h["upsample_rates"])
        ch0 = h["upsample_initial_channel"]
        self.conv_pre = _wn(nn.Conv1d(h["num_mels"], ch0, 7, 1, padding=3))
        self.ups = nn.ModuleList()
        for i, (u, k) in enumerate(zip(h["upsample_rates"], h["upsample_kernel_sizes"])):
            self.ups.append(_wn(nn.ConvTranspose1d(ch0 // (2**i), ch0 // (2 ** (i + 1)), k, u, padding=(k - u) // 2)))
        self.resblocks = nn.ModuleList()
        for i in range(len(self.ups)):
            ch = ch0 // (2 ** (i + 1))
            for k, d in zip(h["resblock_kernel_sizes"], h["resblock_dilation_sizes"]):
                self.resblocks.append(ResBlock1(ch, k, d))
        self.conv_post = _wn(nn.Conv1d(ch, 1, 7, 1, padding=3))

    def forward(self, x):
        x = self.conv_pre(x)
        for i in range(self.num_upsamples):
            x = F.leaky_relu(x, LRELU_SLOPE)
            x = self.ups[i](x)
            xs = None
            for j in range(self.num_kernels):
                if xs is None:
                    xs = self.resblocks[i * self.num_kernels + j](x)
                else:
                    xs += self.resblocks[i * self.num_kernels + j](x)
            x = xs / self.num_kernels
        x = F.leaky_relu(x)
        x = self.conv_post(x)
        return torch.tanh(x)


class DiscriminatorP(nn.Module):
    def __init__(self, period, chans, kernel_size=5, stride=3):
        super().__init__()
        self.period = period
        c = (1,) + tuple(chans)
        self.convs = nn.ModuleList([_wn(nn.Conv2d(c[j], c[j + 1], (kernel_size, 1),
                                                  (stride if j < len(chans) - 1 else 1, 1),
                                                  padding=(get_padding(5, 1), 0))) for j in range(len(chans))])
        self.conv_post = _wn(nn.Conv2d(c[-1], 1, (3, 1), 1, padding=(1, 0)))

    def forward(self, x):
        fmap = []
        b, c, t = x.shape
        if t % self.period != 0:
            n_pad = self.period - (t % self.period)
            x = F.pad(x, (0, n_pad), "reflect")
            t = t + n_pad
        x = x.view(b, c, t // self.period, self.period)
        for layer in self.convs:
            x = layer(x)
            x = F.leaky_relu(x, LRELU_SLOPE)
            fmap.append(x)
        x = self.conv_post(x)
        fmap.append(x)
        return torch.flatten(x, 1, -1), fmap


class MultiPeriodDiscriminator(nn.Module):
    def __init__(self, h):
        super().__init__()
        self.discriminators = nn.ModuleList([DiscriminatorP(p, h["mpd_channels"]) for p in (2, 3, 5, 7, 11)])

    def forward(self, y, y_hat):
        y_d_rs, y_d_gs, fmap_rs, fmap_gs = [], [], [], []
        for d in self.discriminators:
            y_d_r, fmap_r = d(y)
            y_d_g, fmap_g = d(y_hat)
            y_d_rs.append(y_d_r)
            fmap_rs.append(fmap_r)
            y_d_gs.append(y_d_g)
            fmap_gs.append(fmap_g)
        return y_d_rs, y_d_gs, fmap_rs, fmap_gs


MSD_KERNELS = (15, 41, 41, 41, 41, 41, 5)
MSD_STRIDES = (1, 2, 2, 4, 4, 1, 1)
MSD_GROUPS = (1, 4, 16, 16, 16, 16, 1)


class DiscriminatorS(nn.Module):
    def __init__(self, chans, groups, use_spectral_norm=False):
        super().__init__()
        norm_f = _wn if not use_spectral_norm else spectral_norm
        c = (1,) + tuple(chans)
        self.convs = nn.ModuleList([norm_f(nn.Conv1d(c[j], c[j + 1], k, s, groups=g, padding=k // 2))
                                    for j, (k, s, g) in enumerate(zip(MSD_KERNELS, MSD_STRIDES, groups))])
        self.conv_post = norm_f(nn.Conv1d(c[-1], 1, 3, 1, padding=1))

    def forward(self, x):
        fmap = []
        for layer in self.convs:
            x = layer(x)
            x = F.leaky_relu(x, LRELU_SLOPE)
            fmap.append(x)
        x = self.conv_post(x)
        fmap.append(x)
        return torch.flatten(x, 1, -1), fmap


class MultiScaleDiscriminator(nn.Module):
    def __init__(self, h):
        super().__init__()
        ch, g = h["msd_channels"], MSD_GROUPS
        self.discriminators = nn.ModuleList([DiscriminatorS(ch, g, use_spectral_norm=True), DiscriminatorS(ch, g),
                                             DiscriminatorS(ch, g)])
        self.meanpools = nn.ModuleList([nn.AvgPool1d(4, 2, padding=2), nn.AvgPool1d(4, 2, padding=2)])

    def forward(self, y, y_hat):
        y_d_rs, y_d_gs, fmap_rs, fmap_gs = [], [], [], []
        for i, d in enumerate(self.discriminators):
            if i != 0:
                y = self.meanpools[i - 1](y)
                y_hat = self.meanpools[i - 1](y_hat)
            y_d_r, fmap_r = d(y)
            y_d_g, fmap_g = d(y_hat)
            y_d_rs.append(y_d_r)
            fmap_rs.append(fmap_r)
            y_d_gs.append(y_d_g)
            fmap_gs.append(fmap_g)
        return y_d_rs, y_d_gs, fmap_rs, fmap_gs


def feature_loss(fmap_r, fmap_g):
    loss = 0
    for dr, dg in zip(fmap_r, fmap_g):
        for rl, gl in zip(dr, dg):
            loss += torch.mean(torch.abs(rl - gl))
    return loss * 2


def discriminator_loss(disc_real_outputs, disc_generated_outputs):
    loss = 0
    for dr, dg in zip(disc_real_outputs, disc_generated_outputs):
        loss += torch.mean((1 - dr) ** 2) + torch.mean(dg**2)
    return loss


def generator_loss(disc_outputs):
    loss = 0
    for dg in disc_outputs:
        loss += torch.mean((1 - dg) ** 2)
    return loss


# ---------------------------------------------------------------------------
# the params tree <-> the modules
# ---------------------------------------------------------------------------


def _conv_leaves(m, path):
    """(path, tensor) of a normed convolution's leaves in the tree."""
    if hasattr(m, "weight_g"):
        return [(path + ("g",), m.weight_g), (path + ("v",), m.weight_v), (path + ("b",), m.bias)]
    return [(path + ("w",), m.weight_orig), (path + ("b",), m.bias)]


def leaves_of(gen: Generator, mpd: MultiPeriodDiscriminator, msd: MultiScaleDiscriminator):
    """{path: parameter} of the generator and of the discriminators, by the
    paths of the params tree."""
    g = _conv_leaves(gen.conv_pre, ("conv_pre",)) + _conv_leaves(gen.conv_post, ("conv_post",))
    for i, m in enumerate(gen.ups):
        g += _conv_leaves(m, ("ups", i))
    for i, rb in enumerate(gen.resblocks):
        for name in ("convs1", "convs2"):
            for j, m in enumerate(getattr(rb, name)):
                g += _conv_leaves(m, ("resblocks", i, name, j))
    d = []
    for top, disc in (("mpd", mpd), ("msd", msd)):
        for i, sub in enumerate(disc.discriminators):
            for j, m in enumerate(sub.convs):
                d += _conv_leaves(m, (top, i, "convs", j))
            d += _conv_leaves(sub.conv_post, (top, i, "conv_post"))
    return dict(g), dict(d)


def u_buffers(msd: MultiScaleDiscriminator) -> dict:
    sub = msd.discriminators[0]
    return {("convs", j): m.weight_u for j, m in enumerate(sub.convs)} | {("conv_post",): sub.conv_post.weight_u}


def _leaf(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def build(h: dict, params: dict, sn: dict, dev):
    """The three modules at ``h``'s widths on ``dev``, loaded from
    ``params`` ({"gen", "mpd", "msd"}) and ``sn``, in training mode."""
    with torch.device(dev):
        gen, mpd, msd = Generator(h), MultiPeriodDiscriminator(h), MultiScaleDiscriminator(h)
    g, d = leaves_of(gen, mpd, msd)
    with torch.no_grad():
        for path, p in g.items():
            p.copy_(_leaf(params["gen"], path))
        for path, p in d.items():
            p.copy_(_leaf(params, path))
        for path, u in u_buffers(msd).items():
            u.copy_(_leaf(sn, path))
    return gen.train(), mpd.train(), msd.train()


# ---------------------------------------------------------------------------
# train.py's step
# ---------------------------------------------------------------------------


def gan_steps(conf: dict, params0: dict, sn0: dict, batches: list, dev, keep_grads: bool = True) -> dict:
    """``train.py``'s steps on ``batches`` ([B, segment] audio) from
    ``params0`` and ``sn0`` -> {loss_d, loss_g (one a step), grads_d, grads_g
    (the first step's, by path), params (by path, after each step), u (by
    path, after the last)}."""
    h, t = conf["hifigan"], conf["hifigan_train"]
    gen, mpd, msd = build(h, params0, sn0, dev)
    g_leaves, d_leaves = leaves_of(gen, mpd, msd)
    adamw = lambda ps: torch.optim.AdamW(ps, t["learning_rate"], betas=(t["adam_b1"], t["adam_b2"]),
                                         eps=t["adam_eps"], weight_decay=t["weight_decay"], foreach=False)
    optim_g, optim_d = adamw(list(g_leaves.values())), adamw(list(d_leaves.values()))
    out = {"loss_d": [], "loss_g": [], "params": []}
    for s, audio in enumerate(batches):
        y = audio.unsqueeze(1)
        x, y_mel = mels(h, audio, False), mels(h, audio, True)
        y_g_hat = gen(x)
        y_g_hat_mel = mels(h, y_g_hat.squeeze(1), True)

        optim_d.zero_grad()
        y_df_hat_r, y_df_hat_g, _, _ = mpd(y, y_g_hat.detach())
        loss_disc_f = discriminator_loss(y_df_hat_r, y_df_hat_g)
        y_ds_hat_r, y_ds_hat_g, _, _ = msd(y, y_g_hat.detach())
        loss_disc_s = discriminator_loss(y_ds_hat_r, y_ds_hat_g)
        loss_disc_all = loss_disc_s + loss_disc_f
        loss_disc_all.backward()
        optim_d.step()

        optim_g.zero_grad()
        for p in d_leaves.values():
            p.requires_grad_(False)
        loss_mel = F.l1_loss(y_mel, y_g_hat_mel) * t["mel_loss_weight"]
        y_df_hat_r, y_df_hat_g, fmap_f_r, fmap_f_g = mpd(y, y_g_hat)
        y_ds_hat_r, y_ds_hat_g, fmap_s_r, fmap_s_g = msd(y, y_g_hat)
        loss_fm_f = feature_loss(fmap_f_r, fmap_f_g) * (t["fm_loss_weight"] / 2)
        loss_fm_s = feature_loss(fmap_s_r, fmap_s_g) * (t["fm_loss_weight"] / 2)
        loss_gen_f = generator_loss(y_df_hat_g)
        loss_gen_s = generator_loss(y_ds_hat_g)
        loss_gen_all = loss_gen_s + loss_gen_f + loss_fm_s + loss_fm_f + loss_mel
        loss_gen_all.backward()
        optim_g.step()
        for p in d_leaves.values():
            p.requires_grad_(True)

        if s == 0 and keep_grads:
            out["grads_d"] = {k: p.grad.detach().clone() for k, p in d_leaves.items()}
            out["grads_g"] = {k: p.grad.detach().clone() for k, p in g_leaves.items()}
        out["loss_d"].append(float(loss_disc_all.detach()))
        out["loss_g"].append(float(loss_gen_all.detach()))
        out["params"].append({("gen",) + k: p.detach().clone() for k, p in g_leaves.items()}
                             | {k: p.detach().clone() for k, p in d_leaves.items()})
    out["u"] = {k: u.detach().clone() for k, u in u_buffers(msd).items()}
    return out
