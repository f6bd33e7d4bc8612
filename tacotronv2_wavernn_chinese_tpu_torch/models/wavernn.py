"""WaveRNN vocoder (fatchord RAW variant), inference: mel -> waveform.

The conditioning network (MelResNet + upsample) runs as batched torch ops
over a whole (folded) utterance; the serial sample loop is
``ops.wavernn_kernel``: the CUDA kernel on the card, its plain version on
the CPU.  Generation splits an utterance's time axis into overlapping
folds (reference fold_with_overlap, fatchord_version.py:293-340) that
become the batch axis of the loop; folding, crossfade and fade-out run in
numpy on the host.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ..config import WaveRNNGenConfig, WaveRNNModelConfig
from ..dsp.mulaw import label_2_float, mu_law_expand
from ..ops import wavernn_kernel as K
from ..utils import round_up
from . import layers as L

Params = dict


# ---------------------------------------------------------------------------
# conditioning network: MelResNet + upsample
# ---------------------------------------------------------------------------


def melresnet(params: Params, mels: torch.Tensor) -> torch.Tensor:
    """[B, T_mel, M] -> [B, T_mel - 2*pad, res_out_dims], eval mode.

    BatchNorm uses the torch eps 1e-5: the vocoder is a torch model in the
    reference (nn.BatchNorm1d, fatchord_version.py:18-36), unlike the TF
    acoustic side (1e-3)."""
    p = params["resnet"]
    bn = lambda pp, x: L.batchnorm(pp, x, eps=1e-5)
    x = torch.relu(bn(p["bn_in"], L.conv1d_valid(p["conv_in"], mels)))
    for bp in p["blocks"]:
        y = torch.relu(bn(bp["bn1"], L.conv1d_valid(bp["conv1"], x)))
        y = bn(bp["bn2"], L.conv1d_valid(bp["conv2"], y))
        x = x + y
    return L.conv1d_valid(p["conv_out"], x)


def _stretch_smooth(x: torch.Tensor, taps: torch.Tensor, scale: int) -> torch.Tensor:
    """Nearest-repeat upsample by ``scale`` along time, then a depthwise
    SAME smoothing conv with one shared taps vector.  x: [B, T, C]."""
    C = x.shape[-1]
    x = torch.repeat_interleave(x, scale, dim=1).transpose(1, 2)  # [B, C, T*s]
    k = taps[None, None, :].expand(C, 1, taps.shape[0])
    return F.conv1d(x, k, padding=taps.shape[0] // 2, groups=C).transpose(1, 2)


def upsample(params: Params, cfg: WaveRNNModelConfig, mels: torch.Tensor):
    """[B, T_mel, M] -> (mels_up [B, (T_mel-2*pad)*hop, M],
                         aux    [B, (T_mel-2*pad)*hop, res_out])
    (reference UpsampleNetwork.forward, fatchord_version.py:82-89)."""
    total = cfg.total_upsample
    aux = torch.repeat_interleave(melresnet(params, mels), total, dim=1)
    x = mels
    for taps, s in zip(params["upsample"]["kernels"], cfg.upsample_factors):
        x = _stretch_smooth(x, taps, s)
    indent = cfg.pad * total
    x = x[:, indent: x.shape[1] - indent, :]
    return x, aux


def precompute_conditioning(params: Params, cfg: WaveRNNModelConfig, mels: torch.Tensor) -> torch.Tensor:
    """The conditioning the sample loop reads, for all folds and steps at
    once: [T, B, 208] time-major (mel 80 | a1 | a2 | a3 | a4).  Unlike the
    JAX scan path, the I projection of mel+a1 runs inside the loop, so the
    loop reads 208 floats per fold and step instead of rnn_dims + 96."""
    mels_up, aux = upsample(params, cfg, mels)
    return torch.cat([mels_up, aux], dim=-1).transpose(0, 1).contiguous()


def _generate(params: Params, cfg: WaveRNNModelConfig, mels, bits: int, apply_mu_law: bool, sample):
    """Conditioning for [B, T_mel, M] unit mels (padded by ``pad``), then
    ``sample(cond, packed_weights)`` -> labels [T, B] -> [B, T] float wav."""
    K.check_supported(cfg, mels.shape[-1])
    n_fc3 = params["fc3"]["w"].shape[1]
    if n_fc3 != 2**bits:
        raise ValueError(f"bits={bits} implies {2 ** bits} mu-law classes but fc3 has {n_fc3}")
    mels = torch.as_tensor(mels, dtype=torch.float32, device=params["fc3"]["w"].device)
    cond = precompute_conditioning(params, cfg, mels)
    labels = sample(cond, K.pack_weights(params, cfg)).t()  # [B, T]
    return mu_law_expand(labels, bits) if apply_mu_law else label_2_float(labels, bits)


def generate_scan(
    params: Params,
    cfg: WaveRNNModelConfig,
    mels,
    seed: int = 0,
    bits: int = 10,
    apply_mu_law: bool = True,
    greedy: bool = False,
    noise: torch.Tensor | None = None,
) -> torch.Tensor:
    """The plain sample loop -> [B, T] float wav in [-1, 1].  ``noise``
    [T, B, classes] replaces the generator's Gumbel draws."""
    return _generate(params, cfg, mels, bits, apply_mu_law,
                     lambda cond, w: K.sample_labels_plain(cond, w, seed, greedy, noise=noise))


def generate_kernel(
    params: Params,
    cfg: WaveRNNModelConfig,
    mels,
    seed: int = 0,
    bits: int = 10,
    apply_mu_law: bool = True,
    greedy: bool = False,
) -> torch.Tensor:
    """``generate_scan`` through the sample-loop wrapper: the CUDA kernel
    for params on the card, the plain version for params on the CPU.  The
    default ``generate_fn`` of ``generate``/``generate_batch``."""
    return _generate(params, cfg, mels, bits, apply_mu_law,
                     lambda cond, w: K.sample_labels(cond, w, seed, greedy))


# ---------------------------------------------------------------------------
# fold / unfold (numpy, host)
# ---------------------------------------------------------------------------


def fold_with_overlap(x: np.ndarray, target: int, overlap: int):
    """Split [T, C] conditioning into overlapping folds [n_folds, target+2*ov, C]
    (reference fatchord_version.py:293-340).  Returns (folds, n_folds)."""
    total = x.shape[0]
    num_folds = max(0, (total - overlap) // (target + overlap))
    extended = num_folds * (overlap + target) + overlap
    remaining = total - extended
    if remaining != 0 or num_folds == 0:
        num_folds += 1
        padding = target + 2 * overlap - remaining
        x = np.concatenate([x, np.zeros((padding,) + x.shape[1:], x.dtype)], axis=0)
    folds = np.stack(
        [x[i * (target + overlap): i * (target + overlap) + target + 2 * overlap] for i in range(num_folds)]
    )
    return folds, num_folds


def xfade_and_unfold(y: np.ndarray, overlap: int) -> np.ndarray:
    """Equal-power crossfade of folds [n, target+2*ov] -> [T]
    (reference fatchord_version.py:342-405)."""
    num_folds, length = y.shape
    target = length - 2 * overlap
    silence_len = overlap // 2
    fade_len = overlap - silence_len
    t = np.linspace(-1.0, 1.0, fade_len, dtype=np.float64)
    fade_in = np.sqrt(0.5 * (1.0 + t))
    fade_out = np.sqrt(0.5 * (1.0 - t))
    fin = np.concatenate([np.zeros(silence_len), fade_in])
    fout = np.concatenate([np.ones(silence_len), fade_out])
    y = y.astype(np.float64).copy()
    if overlap:
        y[:, :overlap] *= fin
        y[:, -overlap:] *= fout
    total = num_folds * (target + overlap) + overlap
    unfolded = np.zeros(total, np.float64)
    for i in range(num_folds):
        start = i * (target + overlap)
        unfolded[start: start + length] += y[i]
    return unfolded.astype(np.float32)


def bucket_folds(folds: np.ndarray, multiple: int = 8) -> np.ndarray:
    """Pad the fold axis up to a multiple by repeating the last fold;
    callers drop the extras."""
    n = folds.shape[0]
    n_pad = round_up(n, multiple)
    if n_pad != n:
        folds = np.concatenate([folds, np.repeat(folds[-1:], n_pad - n, axis=0)], axis=0)
    return folds


def pad_mel_for_generation(mel: np.ndarray, pad: int) -> np.ndarray:
    """Edge-value pad ``pad`` frames each side so upsample's VALID trims
    line up with the utterance."""
    return np.pad(mel, ((pad, pad), (0, 0)), mode="edge")


def _fade_out(wav: np.ndarray, wave_len: int, hop: int) -> np.ndarray:
    """20-hop linear fade-out tail (reference fatchord_version.py:255-258)."""
    wav = np.array(wav, np.float32, copy=True)
    fade_len = 20 * hop
    if wave_len > fade_len:
        wav[-fade_len:] *= np.linspace(1.0, 0.0, fade_len, dtype=np.float32)
    return wav


def generate(
    params: Params,
    model_cfg: WaveRNNModelConfig,
    gen_cfg: WaveRNNGenConfig,
    mel: np.ndarray,
    seed: int = 0,
    bits: int = 10,
    apply_mu_law: bool = True,
    generate_fn=None,
) -> np.ndarray:
    """Batched-fold generation for ONE utterance -> wav [T_mel * hop]."""
    return generate_batch(params, model_cfg, gen_cfg, [mel], seed, bits, apply_mu_law, generate_fn)[0]


def generate_batch(
    params: Params,
    model_cfg: WaveRNNModelConfig,
    gen_cfg: WaveRNNGenConfig,
    mels: list,
    seed: int = 0,
    bits: int = 10,
    apply_mu_law: bool = True,
    generate_fn=None,
) -> list:
    """Vocode many utterances in one sample-loop call: all utterances'
    folds form one fold batch, then each utterance is crossfade-unfolded
    from its own slice.  ``gen_cfg.batched=False`` makes each utterance one
    whole fold, padded to a shared 64-frame-bucketed length."""
    hop = model_cfg.total_upsample
    if gen_cfg.batched and (gen_cfg.target % hop or gen_cfg.overlap % hop):
        raise ValueError("target and overlap must be multiples of the hop size")
    t_frames = gen_cfg.target // hop
    ov_frames = gen_cfg.overlap // hop

    all_folds, counts, lens = [], [], []
    if gen_cfg.batched:
        for mel in mels:
            folds, n = fold_with_overlap(np.asarray(mel, np.float32), t_frames, ov_frames)
            all_folds.append(np.stack([pad_mel_for_generation(f, model_cfg.pad) for f in folds]))
            counts.append(n)
            lens.append(mel.shape[0] * hop)
    else:
        T_max = round_up(max(m.shape[0] for m in mels), 64)
        for mel in mels:
            mel = np.asarray(mel, np.float32)
            lens.append(mel.shape[0] * hop)
            mel = np.pad(mel, ((0, T_max - mel.shape[0]), (0, 0)), mode="edge")
            all_folds.append(pad_mel_for_generation(mel, model_cfg.pad)[None])
            counts.append(1)
    stacked = bucket_folds(np.concatenate(all_folds, axis=0))

    gen = generate_fn or generate_kernel
    mels_t = torch.as_tensor(stacked, device=params["fc3"]["w"].device)
    wav_folds = gen(params, model_cfg, mels_t, seed, bits, apply_mu_law).cpu().numpy()

    out, offset = [], 0
    for n, wave_len in zip(counts, lens):
        if gen_cfg.batched:
            wav = xfade_and_unfold(wav_folds[offset: offset + n], gen_cfg.overlap)[:wave_len]
        else:
            wav = wav_folds[offset][:wave_len]
        out.append(_fade_out(wav, wave_len, hop))
        offset += n
    return out
