"""WaveRNN (fatchord's RAW variant, Kalchbrenner et al. 2018 as the
lturing recipe configures it) in plain PyTorch and NumPy: the conditioning
network, the batched-fold split and crossfade, and the teacher-forced
logits of the sample loop.

Weights are a nested dict with ``[in, out]`` matrices; GRU leaves ``wi``
[in, 3H], ``wh`` [H, 3H], ``bi``, ``bh`` with gates (r, z, n) and
n = tanh(x wi_n + bi_n + r (h wh_n + bh_n)); BatchNorm has eps 1e-5.
"""

from __future__ import annotations

import warnings

import numpy as np
import torch
import torch.nn.functional as F

from . import rng


def conv_valid(p, x):
    """[B, T, C_in] * w [W, C_in, C_out], no padding."""
    y = F.conv1d(x.transpose(1, 2), p["w"].permute(2, 1, 0)).transpose(1, 2)
    return y + p["b"] if "b" in p else y


def bn_eval(p, x, eps=1e-5):
    return (x - p["mean"]) / torch.sqrt(p["var"] + eps) * p["scale"] + p["bias"]


def melresnet(p, mels, stats: dict | None = None):
    """[B, T, 80] -> [B, T - 2 pad, res_out]: a width-(2 pad + 1) input
    convolution, BatchNorm, ReLU, residual blocks of two 1x1 convolutions
    with BatchNorm, and a 1x1 output convolution.  With ``stats`` (a dict)
    BatchNorm runs in train mode and each layer's running statistics are
    recorded there by path."""
    def bn(q, x, path):
        if stats is None:
            return bn_eval(q, x)
        y, stats[("resnet",) + path] = bn_train(q, x)
        return y

    x = torch.relu(bn(p["bn_in"], conv_valid(p["conv_in"], mels), ("bn_in",)))
    for k, bp in enumerate(p["blocks"]):
        y = torch.relu(bn(bp["bn1"], conv_valid(bp["conv1"], x), ("blocks", k, "bn1")))
        x = x + bn(bp["bn2"], conv_valid(bp["conv2"], y), ("blocks", k, "bn2"))
    return conv_valid(p["conv_out"], x)


def stretch_smooth(x, taps, scale: int):
    """Nearest-neighbour stretch by ``scale`` along time, then a depthwise
    SAME smoothing with one taps vector shared by every channel."""
    C = x.shape[-1]
    x = torch.repeat_interleave(x, scale, dim=1).transpose(1, 2)
    k = taps[None, None, :].expand(C, 1, taps.shape[0])
    return F.conv1d(x, k, padding=taps.shape[0] // 2, groups=C).transpose(1, 2)


def conditioning(p, cfg, mels, stats: dict | None = None):
    """Unit mels [B, T + 2 pad, 80] -> (upsampled mels, aux), each
    [B, T * hop, .]; ``stats`` as ``melresnet``'s."""
    hop = int(np.prod(cfg["upsample_factors"]))
    aux = torch.repeat_interleave(melresnet(p["resnet"], mels, stats), hop, dim=1)
    x = mels
    for taps, s in zip(p["upsample"]["kernels"], cfg["upsample_factors"]):
        x = stretch_smooth(x, taps, s)
    cut = cfg["pad"] * hop
    return x[:, cut: x.shape[1] - cut], aux


def trunk(p, cfg, prev, mels_up, aux):
    """The previous samples ``prev`` [B, T] in [-1, 1] and the conditioning
    -> (h, a3, a4): the I projection and both GRUs with their residuals,
    and the aux slices the output layers read."""
    a1, a2, a3, a4 = torch.split(aux, cfg["res_out_dims"] // 4, dim=-1)
    h = torch.cat([prev[..., None], mels_up, a1], dim=-1) @ p["I"]["w"] + p["I"]["b"]
    h = gru(p["gru1"], h) + h
    h = gru(p["gru2"], torch.cat([h, a2], dim=-1)) + h
    return h, a3, a4


def out_layers(p, h, a3, a4):
    """fc1 and fc2 (ReLU, each fed its aux slice), then fc3: the logits."""
    y = torch.relu(torch.cat([h, a3], dim=-1) @ p["fc1"]["w"] + p["fc1"]["b"])
    y = torch.relu(torch.cat([y, a4], dim=-1) @ p["fc2"]["w"] + p["fc2"]["b"])
    return y @ p["fc3"]["w"] + p["fc3"]["b"]


def gru(p, x):
    """A GRU over [B, T, in] from zeros -> [B, T, H]: ``torch.nn.GRU``
    (cuDNN on the card) run on the tree's own tensors, so gradients reach
    them."""
    H = p["wh"].shape[0]
    shell = torch.nn.GRU(x.shape[-1], H, batch_first=True, device="meta")
    weights = {"weight_ih_l0": p["wi"].t().contiguous(), "weight_hh_l0": p["wh"].t().contiguous(),
               "bias_ih_l0": p["bi"], "bias_hh_l0": p["bh"]}
    with warnings.catch_warnings():
        warnings.filterwarnings("ignore", message="RNN module weights are not part")
        return torch.func.functional_call(shell, weights, (x,))[0]


def label_to_float(labels, bits: int):
    return 2.0 * labels.to(torch.float32) / (2**bits - 1.0) - 1.0


def mu_law_expand(labels, bits: int):
    mu = 2**bits - 1
    x = 2.0 * labels.to(torch.float32) / mu - 1.0
    return torch.sign(x) / mu * ((1.0 + mu) ** torch.abs(x) - 1.0)


def unit_mel(mel: np.ndarray, max_abs: float) -> np.ndarray:
    """Acoustic mels in [-max_abs, max_abs] -> the vocoder's [0, 1]."""
    return np.clip((mel + max_abs) / (2.0 * max_abs), 0.0, 1.0)


def fold(x: np.ndarray, target: int, overlap: int) -> np.ndarray:
    """[T, C] -> overlapping folds [n, target + 2 overlap, C], the tail
    zero-padded (fatchord's fold_with_overlap)."""
    total = x.shape[0]
    n = max(0, (total - overlap) // (target + overlap))
    rem = total - (n * (overlap + target) + overlap)
    if rem != 0 or n == 0:
        n += 1
        x = np.concatenate([x, np.zeros((target + 2 * overlap - rem,) + x.shape[1:], x.dtype)])
    return np.stack([x[i * (target + overlap): i * (target + overlap) + target + 2 * overlap] for i in range(n)])


def crossfade(y: np.ndarray, overlap: int) -> np.ndarray:
    """Folds [n, target + 2 overlap] -> [T]: an equal-power crossfade after
    half the overlap of silence (fatchord's xfade_and_unfold)."""
    n, length = y.shape
    target = length - 2 * overlap
    sil = overlap // 2
    t = np.linspace(-1.0, 1.0, overlap - sil, dtype=np.float64)
    fin = np.concatenate([np.zeros(sil), np.sqrt(0.5 * (1.0 + t))])
    fout = np.concatenate([np.ones(sil), np.sqrt(0.5 * (1.0 - t))])
    y = y.astype(np.float64).copy()
    if overlap:
        y[:, :overlap] *= fin
        y[:, -overlap:] *= fout
    out = np.zeros(n * (target + overlap) + overlap, np.float64)
    for i in range(n):
        out[i * (target + overlap): i * (target + overlap) + length] += y[i]
    return out.astype(np.float32)


def fade_out(wav: np.ndarray, hop: int) -> np.ndarray:
    """A linear fade over the last 20 hops."""
    wav = np.array(wav, np.float32, copy=True)
    n = 20 * hop
    if wav.shape[0] > n:
        wav[-n:] *= np.linspace(1.0, 0.0, n, dtype=np.float32)
    return wav


def fold_mels(mel: np.ndarray, cfg, gen, max_abs: float) -> np.ndarray:
    """A served mel [T, 80] -> the unit-range folds the sample loop reads,
    each edge-padded by ``pad`` frames: [n, target / hop + 2 overlap / hop
    + 2 pad, 80]."""
    hop = int(np.prod(cfg["upsample_factors"]))
    folds = fold(unit_mel(np.asarray(mel, np.float32), max_abs), gen["target"] // hop, gen["overlap"] // hop)
    pad = cfg["pad"]
    return np.stack([np.pad(f, ((pad, pad), (0, 0)), mode="edge") for f in folds]).astype(np.float32)


def hidden(p, cfg, folds: torch.Tensor, labels: torch.Tensor, bits: int):
    """Teacher-forced on the served labels: the conditioning and both GRUs
    over unit-mel folds [n, frames, 80] and labels [n, T] -> (h, a3, a4),
    what the output layers read at every step."""
    mels_up, aux = conditioning(p, cfg, folds)
    prev = torch.cat([labels.new_zeros(labels.shape[0], 1, dtype=torch.float32),
                      label_to_float(labels[:, :-1], bits)], dim=1)
    return trunk(p, cfg, prev, mels_up, aux)


def perturbed_logits(p, hid, s: int, e: int, seed: int, fold0: int, bits: int, sampled: bool = True):
    """The logits of steps [s, e) [n, e - s, classes], plus the sampling
    noise: fold f's noise at step t is Gumbel(bits(seed, f, t, class)),
    where f counts from ``fold0``, the first fold's index in the served
    call's fold batch (no noise when ``sampled`` is false)."""
    h, a3, a4 = hid
    dev = h.device
    z = out_layers(p, h[:, s:e], a3[:, s:e], a4[:, s:e])
    if sampled:
        n = h.shape[0]
        classes = torch.arange(2**bits, device=dev, dtype=torch.int64)[None, None, :]
        fidx = torch.arange(fold0, fold0 + n, device=dev, dtype=torch.int64)[:, None, None]
        t = torch.arange(s, e, device=dev, dtype=torch.int64)[None, :, None]
        z = z + rng.gumbel(rng.bits(torch.tensor(int(seed) & rng.M32, device=dev), fidx, t, classes))
    return z


def gap_below_best(z: torch.Tensor, chosen: torch.Tensor) -> torch.Tensor:
    """How far the chosen class's (perturbed) logit lies below the best."""
    return z.max(dim=-1).values - torch.gather(z, -1, chosen.long()[..., None])[..., 0]


# ---------------------------------------------------------------------------
# training: the teacher-forced forward on a batch of windows
# ---------------------------------------------------------------------------


def bn_train(p, x, eps=1e-5, momentum=0.9):
    """BatchNorm in train mode: batch statistics over every position
    (biased variance) -> (y, the running mean and the unbiased running
    variance updated with momentum 1 - ``momentum``)."""
    dims = tuple(range(x.dim() - 1))
    n = x.numel() // x.shape[-1]
    mean = x.mean(dim=dims)
    var = ((x - mean) ** 2).mean(dim=dims)
    new = {"mean": (momentum * p["mean"] + (1 - momentum) * mean).detach(),
           "var": (momentum * p["var"] + (1 - momentum) * var * (n / (n - 1))).detach()}
    return (x - mean) / torch.sqrt(var + eps) * p["scale"] + p["bias"], new


def train_logits(p, cfg, x, mels):
    """Windows' previous samples ``x`` [B, T] in [-1, 1] and unit mels
    [B, T / hop + 2 pad, 80] -> (logits [B, T, classes], {path: running
    statistics})."""
    stats = {}
    mels_up, aux = conditioning(p, cfg, mels, stats)
    return out_layers(p, *trunk(p, cfg, x, mels_up, aux)), stats


def train_loss(logits, y):
    """Cross-entropy over the mu-law classes, the mean over every sample."""
    return -torch.log_softmax(logits, dim=-1).gather(-1, y[..., None].long()).mean()
