"""Discretized mixture-of-logistics (MOL) loss and sampling.

The JAX package's ``ops/distribution.py`` (the reference's r9y9 port,
wavernn/utils/distribution.py:6-123), used by WaveRNN's MOL mode.  Plain
PyTorch over [B, T]; sampling takes an explicit ``torch.Generator``, or
injected draws (the mixture's Gumbel noise and the logistic's uniform), so
tests can feed in another framework's draws.

``torch.where`` backpropagates through both branches, so every branch is
kept finite wherever it is not taken: the log of the bin mass goes through
``clamp(cdf_delta, 1e-12)``, never ``log(cdf_delta)``.
"""

from __future__ import annotations

import math

import torch

LOG_SCALE_MIN = float(math.log(1e-14))  # -32.236...


def _softplus(x: torch.Tensor) -> torch.Tensor:
    """jax.nn.softplus: logaddexp(x, 0) (torch's softplus switches to x above 20)."""
    return torch.logaddexp(x, torch.zeros_like(x))


def log_sum_exp(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """Numerically stable log-sum-exp (reference distribution.py:6-12)."""
    m = torch.amax(x, dim=dim, keepdim=True)
    return m.squeeze(dim) + torch.log(torch.sum(torch.exp(x - m), dim=dim))


def discretized_mix_logistic_loss(
    y_hat: torch.Tensor,  # [B, T, 3*num_mixtures] (logit_probs, means, log_scales)
    y: torch.Tensor,  # [B, T] targets in [-1, 1]
    num_classes: int = 65536,
    log_scale_min: float = LOG_SCALE_MIN,
    reduce: bool = True,
) -> torch.Tensor:
    """NLL of the discretized logistic mixture (reference distribution.py:15-69)."""
    nr_mix = y_hat.shape[-1] // 3
    logit_probs = y_hat[..., :nr_mix]
    means = y_hat[..., nr_mix:2 * nr_mix]
    log_scales = torch.clamp_min(y_hat[..., 2 * nr_mix:], log_scale_min)

    yy = y[..., None]
    centered = yy - means  # [B, T, M]
    inv_stdv = torch.exp(-log_scales)
    half = 1.0 / (num_classes - 1)
    plus_in = inv_stdv * (centered + half)
    cdf_plus = torch.sigmoid(plus_in)
    min_in = inv_stdv * (centered - half)
    cdf_min = torch.sigmoid(min_in)

    log_cdf_plus = plus_in - _softplus(plus_in)  # log CDF at the -1 edge
    log_one_minus_cdf_min = -_softplus(min_in)  # log (1 - CDF) at the +1 edge
    cdf_delta = cdf_plus - cdf_min
    mid_in = inv_stdv * centered
    log_pdf_mid = mid_in - log_scales - 2.0 * _softplus(mid_in)

    inner = torch.where(
        cdf_delta > 1e-5,
        torch.log(torch.clamp_min(cdf_delta, 1e-12)),
        log_pdf_mid - math.log((num_classes - 1) / 2.0),
    )
    log_probs = torch.where(
        yy < -0.999,
        log_cdf_plus,
        torch.where(yy > 0.999, log_one_minus_cdf_min, inner),
    )
    log_probs = log_probs + torch.log_softmax(logit_probs, dim=-1)
    nll = -log_sum_exp(log_probs, dim=-1)  # [B, T]
    return torch.mean(nll) if reduce else nll


def draw_noise(shape, nr_mix: int, generator: torch.Generator, device=None):
    """One draw of the sampler's noise for ``shape`` = [B, T]: (standard
    Gumbel [B, T, nr_mix], uniform in [1e-5, 1 - 1e-5] [B, T])."""
    device = generator.device if device is None else device
    tiny = torch.finfo(torch.float32).tiny
    g = torch.rand(tuple(shape) + (nr_mix,), generator=generator, device=device)
    gumbel = -torch.log(-torch.log(torch.clamp_min(g, tiny)))
    u = torch.rand(tuple(shape), generator=generator, device=device)
    return gumbel, 1e-5 + u * (1.0 - 2e-5)


def sample_from_discretized_mix_logistic(
    y_hat: torch.Tensor,  # [B, T, 3*num_mixtures]
    generator: torch.Generator | None = None,
    log_scale_min: float = LOG_SCALE_MIN,
    gumbel: torch.Tensor | None = None,  # [B, T, num_mixtures]
    u: torch.Tensor | None = None,  # [B, T] in (0, 1)
) -> torch.Tensor:
    """Draw samples (reference distribution.py:72-123) -> [B, T] in [-1, 1].

    The mixture is the Gumbel-max of its logits (JAX ``random.categorical``);
    the sample is the logistic's inverse CDF at ``u``.  ``gumbel`` and ``u``
    replace the generator's draws when given."""
    nr_mix = y_hat.shape[-1] // 3
    logit_probs = y_hat[..., :nr_mix]
    if gumbel is None or u is None:
        g_draw, u_draw = draw_noise(y_hat.shape[:-1], nr_mix, generator, y_hat.device)
        gumbel = g_draw if gumbel is None else gumbel
        u = u_draw if u is None else u
    sel = torch.argmax(logit_probs + gumbel.to(y_hat), dim=-1, keepdim=True)  # [B, T, 1]
    means = torch.gather(y_hat[..., nr_mix:2 * nr_mix], -1, sel)[..., 0]
    log_scales = torch.clamp_min(torch.gather(y_hat[..., 2 * nr_mix:], -1, sel)[..., 0], log_scale_min)
    u = u.to(y_hat)
    x = means + torch.exp(log_scales) * (torch.log(u) - torch.log1p(-u))
    return torch.clamp(x, -1.0, 1.0)
