"""HiFi-GAN V1 (Kong, Kim and Bae 2020, §2 and Appendix A; the layer
equations of jik876/hifi-gan ``models.py``) over plain params trees.

* The generator: a 7-wide input convolution, then per stage a leaky ReLU
  (slope 0.1), a transposed convolution that upsamples by the stage's rate,
  and a multi-receptive-field fusion: the mean of three ResBlock1s (kernels
  3, 7, 11; dilations 1, 3, 5, each followed by an undilated convolution,
  with a residual), then ``F.leaky_relu``'s default slope (0.01), a 7-wide
  output convolution and ``tanh``.  Every convolution is weight-normed.
* The multi-period discriminator: per period the waveform, reflect-padded
  to a multiple of it, viewed as [B, 1, T/p, p], five (5, 1) convolutions
  (stride 3 but the last) and a (3, 1) output convolution, weight-normed.
* The multi-scale discriminator: three of the same stack of 1-D
  convolutions (grouped 41-wide ones among them), the first spectral-normed
  on the raw audio, the other two weight-normed on audio average-pooled
  once and twice (``AvgPool1d(4, 2, padding=2)``).

Leaves.  A weight-normed convolution is {"g", "v", "b"}: its weight is
``g * v / |v|``, the norm taken over every axis but the first
(``torch.nn.utils.weight_norm(dim=0)``), which for a transposed
convolution's [in, out, k] weight is per *input* channel.  A
spectral-normed one is {"w", "b"}, and its power-iteration vector ``u`` is
state beside the params (``sn``), advanced once each time the
discriminator is called (``torch.nn.utils.spectral_norm`` in training),
with ``u`` and ``v`` held constant in the gradient.  ``HIFIGAN`` counts
the samples the generator made and the power iterations run.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from ..config import HiFiGANConfig

LRELU_SLOPE = 0.1
MPD_PERIODS = (2, 3, 5, 7, 11)
MPD_KERNEL, MPD_STRIDE = 5, 3
# the multi-scale discriminator's kernels, strides and groups (its widths are config fields)
MSD_KERNELS = (15, 41, 41, 41, 41, 41, 5)
MSD_STRIDES = (1, 2, 2, 4, 4, 1, 1)
MSD_GROUPS = (1, 4, 16, 16, 16, 16, 1)

# samples generated and spectral-norm power iterations run, since the process started
HIFIGAN = {"samples": 0, "sn_power_iters": 0}


def get_padding(kernel: int, dilation: int = 1) -> int:
    return (kernel * dilation - dilation) // 2


# ---------------------------------------------------------------------------
# normed weights
# ---------------------------------------------------------------------------


def wn_weight(p: dict) -> torch.Tensor:
    """``g * v / |v|`` with the norm over every axis of ``v`` but the first."""
    v = p["v"]
    return v * (p["g"] / torch.linalg.vector_norm(v, dim=tuple(range(1, v.dim())), keepdim=True))


def sn_weight(w: torch.Tensor, u: torch.Tensor, eps: float = 1e-12):
    """One power iteration from ``u`` on ``w`` viewed as [out, -1], then
    ``w / sigma`` with sigma = u'·(W v') and u', v' constants -> (weight,
    u')."""
    mat = w.reshape(w.shape[0], -1)
    with torch.no_grad():
        v = F.normalize(torch.mv(mat.t(), u), dim=0, eps=eps)
        u = F.normalize(torch.mv(mat, v), dim=0, eps=eps)
    return w / torch.dot(u, torch.mv(mat, v)), u


# ---------------------------------------------------------------------------
# initialisation
# ---------------------------------------------------------------------------


class _Draw:
    """Leaves drawn on the CPU from one seeded generator, then moved to
    ``device``; on the ``meta`` device only their shapes."""

    def __init__(self, seed: int, device):
        self.device = torch.device(device)
        self.gen = torch.Generator().manual_seed(int(seed) % 2**63)

    def _out(self, t: torch.Tensor) -> torch.Tensor:
        return t.to(self.device)

    @staticmethod
    def _bound(shape) -> float:
        """torch's default init of a convolution and its bias: uniform within
        1/sqrt(fan_in), fan_in = shape[1] x the kernel's size (for a
        transposed convolution's [in, out, k] weight too)."""
        return 1.0 / math.sqrt(shape[1] * math.prod(shape[2:]))

    def _uniform(self, shape, bound: float) -> torch.Tensor:
        return (torch.rand(shape, generator=self.gen) * 2.0 - 1.0) * bound

    def wn(self, shape, n_bias: int, std: float | None = None) -> dict:
        """A weight-normed convolution: ``v`` of torch's default init or
        normal(0, std), ``g = |v|``, a bias of ``n_bias``."""
        if self.device.type == "meta":
            e = lambda *s: torch.empty(s, device="meta")
            return {"g": e(shape[0], *[1] * (len(shape) - 1)), "v": e(*shape), "b": e(n_bias)}
        v = (torch.randn(shape, generator=self.gen) * std if std is not None
             else self._uniform(shape, self._bound(shape)))
        g = torch.linalg.vector_norm(v, dim=tuple(range(1, v.dim())), keepdim=True)
        b = self._uniform(n_bias, self._bound(shape))
        return {"g": self._out(g), "v": self._out(v), "b": self._out(b)}

    def sn(self, shape) -> tuple:
        """A spectral-normed convolution of torch's default init and its
        ``u``, normal draws normalised -> (leaf, u)."""
        if self.device.type == "meta":
            e = lambda *s: torch.empty(s, device="meta")
            return {"w": e(*shape), "b": e(shape[0])}, e(shape[0])
        w = self._uniform(shape, self._bound(shape))
        b = self._uniform(shape[0], self._bound(shape))
        u = F.normalize(torch.randn(shape[0], generator=self.gen), dim=0, eps=1e-12)
        return {"w": self._out(w), "b": self._out(b)}, self._out(u)


def _conv_wn(d: _Draw, out: int, inp: int, k, groups: int = 1, std: float | None = None) -> dict:
    return d.wn((out, inp // groups, *(k if isinstance(k, tuple) else (k,))), out, std)


def init_hifigan(seed: int, cfg: HiFiGANConfig, device="cpu"):
    """(params {"gen", "mpd", "msd"}, sn state) of random weights.  As
    ``models.py``: torch's default init, except normal(0, 0.01) for the
    upsampling, ResBlock and output convolutions of the generator; each
    weight norm's ``g`` is ``|v|``, so the weight starts at ``v``."""
    d = _Draw(seed, device)
    ch = cfg.upsample_initial_channel
    gen = {"conv_pre": _conv_wn(d, ch, cfg.num_mels, 7), "ups": [], "resblocks": []}
    for i, (u, k) in enumerate(zip(cfg.upsample_rates, cfg.upsample_kernel_sizes)):
        cin, cout = ch // 2**i, ch // 2 ** (i + 1)
        # a transposed convolution's weight is [in, out, k]
        gen["ups"].append(d.wn((cin, cout, k), cout, std=0.01))
    for i in range(len(cfg.upsample_rates)):
        c = ch // 2 ** (i + 1)
        for k, dil in zip(cfg.resblock_kernel_sizes, cfg.resblock_dilation_sizes):
            gen["resblocks"].append({"convs1": [_conv_wn(d, c, c, k, std=0.01) for _ in dil],
                                     "convs2": [_conv_wn(d, c, c, k, std=0.01) for _ in dil]})
    gen["conv_post"] = _conv_wn(d, 1, ch // 2 ** len(cfg.upsample_rates), 7, std=0.01)

    mpd = []
    for _ in MPD_PERIODS:
        chans = (1,) + tuple(cfg.mpd_channels)
        mpd.append({"convs": [_conv_wn(d, chans[j + 1], chans[j], (MPD_KERNEL, 1)) for j in range(len(chans) - 1)],
                    "conv_post": _conv_wn(d, 1, chans[-1], (3, 1))})
    msd, sn = [], None
    chans = (1,) + tuple(cfg.msd_channels)
    for scale in range(3):
        if scale == 0:
            convs, us = [], []
            for j, (k, g) in enumerate(zip(MSD_KERNELS, MSD_GROUPS)):
                p, u = d.sn((chans[j + 1], chans[j] // g, k))
                convs.append(p)
                us.append(u)
            post, u_post = d.sn((1, chans[-1], 3))
            msd.append({"convs": convs, "conv_post": post})
            sn = {"convs": us, "conv_post": u_post}
        else:
            msd.append({"convs": [_conv_wn(d, chans[j + 1], chans[j], k, g)
                                  for j, (k, g) in enumerate(zip(MSD_KERNELS, MSD_GROUPS))],
                        "conv_post": _conv_wn(d, 1, chans[-1], 3)})
    return {"gen": gen, "mpd": mpd, "msd": msd}, sn


# ---------------------------------------------------------------------------
# the generator
# ---------------------------------------------------------------------------


def _conv1d(p: dict, x: torch.Tensor, **kw) -> torch.Tensor:
    return F.conv1d(x, wn_weight(p), p["b"], **kw)


def resblock1(p: dict, x: torch.Tensor, kernel: int, dilations) -> torch.Tensor:
    for c1, c2, dil in zip(p["convs1"], p["convs2"], dilations):
        xt = F.leaky_relu(x, LRELU_SLOPE)
        xt = _conv1d(c1, xt, padding=get_padding(kernel, dil), dilation=dil)
        xt = F.leaky_relu(xt, LRELU_SLOPE)
        xt = _conv1d(c2, xt, padding=get_padding(kernel, 1))
        x = xt + x
    return x


def generator(gp: dict, cfg: HiFiGANConfig, mel: torch.Tensor) -> torch.Tensor:
    """[B, num_mels, frames] -> [B, 1, frames x prod(upsample_rates)]."""
    x = _conv1d(gp["conv_pre"], mel, padding=3)
    nk = len(cfg.resblock_kernel_sizes)
    for i, (u, k) in enumerate(zip(cfg.upsample_rates, cfg.upsample_kernel_sizes)):
        x = F.leaky_relu(x, LRELU_SLOPE)
        up = gp["ups"][i]
        x = F.conv_transpose1d(x, wn_weight(up), up["b"], stride=u, padding=(k - u) // 2)
        xs = None
        for j, (kk, dil) in enumerate(zip(cfg.resblock_kernel_sizes, cfg.resblock_dilation_sizes)):
            r = resblock1(gp["resblocks"][i * nk + j], x, kk, dil)
            xs = r if xs is None else xs + r
        x = xs / nk
    x = F.leaky_relu(x)
    x = torch.tanh(_conv1d(gp["conv_post"], x, padding=3))
    HIFIGAN["samples"] += x.numel()
    return x


# ---------------------------------------------------------------------------
# the discriminators: each returns (scores [B, -1], feature maps)
# ---------------------------------------------------------------------------


def period_disc(p: dict, x: torch.Tensor, period: int):
    """One period's discriminator on [B, 1, T]."""
    b, c, t = x.shape
    if t % period:
        x = F.pad(x, (0, period - t % period), "reflect")
        t = x.shape[-1]
    x = x.view(b, c, t // period, period)
    fmap = []
    n = len(p["convs"])
    for j, cp in enumerate(p["convs"]):
        x = F.conv2d(x, wn_weight(cp), cp["b"], stride=(MPD_STRIDE if j < n - 1 else 1, 1),
                     padding=(get_padding(MPD_KERNEL, 1), 0))
        x = F.leaky_relu(x, LRELU_SLOPE)
        fmap.append(x)
    x = F.conv2d(x, wn_weight(p["conv_post"]), p["conv_post"]["b"], padding=(1, 0))
    fmap.append(x)
    return torch.flatten(x, 1, -1), fmap


def mpd(params: list, y: torch.Tensor):
    """The multi-period discriminator on [B, 1, T] -> (scores, fmaps), one
    entry a period."""
    outs = [period_disc(p, y, per) for p, per in zip(params, MPD_PERIODS)]
    return [o for o, _ in outs], [f for _, f in outs]


def scale_disc(p: dict, x: torch.Tensor, sn: dict | None = None):
    """One scale's discriminator on [B, 1, T]; with ``sn`` (its ``u``
    vectors) spectral-normed -> (scores, fmap, the advanced ``sn``)."""
    fmap, new_u = [], []
    for j, (cp, k, s, g) in enumerate(zip(p["convs"], MSD_KERNELS, MSD_STRIDES, MSD_GROUPS)):
        if sn is None:
            w = wn_weight(cp)
        else:
            w, u = sn_weight(cp["w"], sn["convs"][j])
            new_u.append(u)
        x = F.leaky_relu(F.conv1d(x, w, cp["b"], stride=s, padding=k // 2, groups=g), LRELU_SLOPE)
        fmap.append(x)
    post = p["conv_post"]
    if sn is None:
        w = wn_weight(post)
    else:
        w, u_post = sn_weight(post["w"], sn["conv_post"])
        sn = {"convs": new_u, "conv_post": u_post}
        HIFIGAN["sn_power_iters"] += 1
    x = F.conv1d(x, w, post["b"], padding=1)
    fmap.append(x)
    return torch.flatten(x, 1, -1), fmap, sn


def msd(params: list, sn: dict, y: torch.Tensor):
    """The multi-scale discriminator on [B, 1, T] -> (scores, fmaps, the
    advanced ``sn`` of the first scale)."""
    outs, fmaps = [], []
    for i, p in enumerate(params):
        if i:
            y = F.avg_pool1d(y, 4, 2, padding=2)
        o, f, new_sn = scale_disc(p, y, sn if i == 0 else None)
        if i == 0:
            sn = new_sn
        outs.append(o)
        fmaps.append(f)
    return outs, fmaps, sn


# ---------------------------------------------------------------------------
# losses (LSGAN, feature matching)
# ---------------------------------------------------------------------------


def discriminator_loss(real: list, fake: list) -> torch.Tensor:
    return sum(torch.mean((1.0 - dr) ** 2) + torch.mean(dg**2) for dr, dg in zip(real, fake))


def generator_loss(fake: list) -> torch.Tensor:
    return sum(torch.mean((1.0 - dg) ** 2) for dg in fake)


def feature_loss(fmap_r: list, fmap_g: list) -> torch.Tensor:
    """The sum of mean |r - g| over every discriminator's feature maps (x 2
    is the caller's ``fm_loss_weight``)."""
    return sum(torch.mean(torch.abs(rl - gl)) for dr, dg in zip(fmap_r, fmap_g) for rl, gl in zip(dr, dg))
