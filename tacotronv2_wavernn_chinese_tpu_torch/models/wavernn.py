"""WaveRNN vocoder (fatchord RAW and MOL variants): mel -> waveform, and
the teacher-forced training forward.

The conditioning network (MelResNet + upsample) runs as batched torch ops
over a whole (folded) utterance.  The RAW serial sample loop is
``ops.wavernn_kernel``: the CUDA kernel on the card, its plain version on
the CPU.  The MOL loop (``generate_mol``) is plain PyTorch on every device:
the JAX package sends MOL to its ``lax.scan`` path, never to the Pallas
kernel (its ``select_generate_fn`` and ``wavernn_kernel.supported``).
Generation splits an utterance's time axis into overlapping folds
(reference fold_with_overlap, fatchord_version.py:293-340) that become the
batch axis of the loop; folding, crossfade and fade-out run in numpy on the
host.

Training (``forward``, ``wavernn_loss``): the two GRU recurrences run
through torch's fused GRU (cuDNN on the card) with the params tree's
weights, one call per layer over the whole window.  The JAX package runs
them as ``lax.scan`` in XLA, not in Pallas; a Python loop over the 1,375
samples of a window would issue tens of thousands of launches a step.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

from ..config import WaveRNNGenConfig, WaveRNNModelConfig
from ..dsp.mulaw import label_2_float, mu_law_expand
from ..ops import distribution as D
from ..ops import wavernn_kernel as K
from ..utils import round_up, tree_leaves
from ..utils.metrics import span
from . import layers as L

Params = dict


def check_vocoder_supported(cfg: WaveRNNModelConfig, num_mels: int = 80) -> None:
    """Raise for a vocoder this package cannot run on every device: RAW
    goes through the sample-loop kernel's envelope, MOL through the plain
    loop (any geometry)."""
    if cfg.mode == "RAW":
        K.check_supported(cfg, num_mels)
    elif cfg.mode != "MOL":
        raise ValueError(f"unknown WaveRNN mode {cfg.mode!r}")


def _check_fc3(params: Params, cfg: WaveRNNModelConfig, bits: int) -> None:
    """fc3's width must be 2**bits mu-law classes (RAW) or 30 mixture
    parameters, 10 x (logit, mean, log scale) (MOL; JAX ``init_wavernn``)."""
    n_fc3 = params["fc3"]["w"].shape[1]
    want = 2**bits if cfg.mode == "RAW" else 30
    if n_fc3 != want:
        what = f"bits={bits} implies {want} mu-law classes" if cfg.mode == "RAW" else f"MOL implies {want} outputs"
        raise ValueError(f"{what} but fc3 has {n_fc3}")


# ---------------------------------------------------------------------------
# conditioning network: MelResNet + upsample
# ---------------------------------------------------------------------------


def _melresnet(params: Params, mels: torch.Tensor, bn):
    """MelResNet (reference fatchord_version.py:13-48) with BatchNorm ``bn(p,
    x) -> (y, new p)``: [B, T_mel, M] -> ([B, T_mel - 2*pad, res_out],
    new resnet params)."""
    p = params["resnet"]
    x, bn_in = bn(p["bn_in"], L.conv1d_valid(p["conv_in"], mels))
    x = torch.relu(x)
    blocks = []
    for bp in p["blocks"]:
        y, bn1 = bn(bp["bn1"], L.conv1d_valid(bp["conv1"], x))
        y, bn2 = bn(bp["bn2"], L.conv1d_valid(bp["conv2"], torch.relu(y)))
        x = x + y
        blocks.append(dict(bp, bn1=bn1, bn2=bn2))
    return L.conv1d_valid(p["conv_out"], x), dict(p, bn_in=bn_in, blocks=blocks)


def melresnet(params: Params, mels: torch.Tensor) -> torch.Tensor:
    """[B, T_mel, M] -> [B, T_mel - 2*pad, res_out_dims], eval mode.

    BatchNorm uses the torch eps 1e-5: the vocoder is a torch model in the
    reference (nn.BatchNorm1d, fatchord_version.py:18-36), unlike the TF
    acoustic side (1e-3)."""
    return _melresnet(params, mels, lambda pp, x: (L.batchnorm(pp, x, eps=1e-5), pp))[0]


def melresnet_train(params: Params, mels: torch.Tensor):
    """Train mode -> (features, resnet params with the new BN statistics):
    torch's BatchNorm1d defaults, batch statistics, running averages with
    momentum 0.1 (new = 0.9 old + 0.1 batch) of the mean and the unbiased
    variance (JAX ``melresnet`` with ``unbiased_ema=True``)."""
    bn = lambda pp, x: L.batchnorm_train(pp, x, momentum=0.9, eps=1e-5, unbiased_ema=True)
    return _melresnet(params, mels, bn)


def _stretch_smooth(x: torch.Tensor, taps: torch.Tensor, scale: int) -> torch.Tensor:
    """Nearest-repeat upsample by ``scale`` along time, then a depthwise
    SAME smoothing conv with one shared taps vector.  x: [B, T, C]."""
    C = x.shape[-1]
    x = torch.repeat_interleave(x, scale, dim=1).transpose(1, 2)  # [B, C, T*s]
    k = taps[None, None, :].expand(C, 1, taps.shape[0])
    return F.conv1d(x, k, padding=taps.shape[0] // 2, groups=C).transpose(1, 2)


def _upsample_mels(params: Params, cfg: WaveRNNModelConfig, mels: torch.Tensor) -> torch.Tensor:
    """The mel path: stretch + smooth per scale, then trim ``pad*hop`` each side."""
    x = mels
    for taps, s in zip(params["upsample"]["kernels"], cfg.upsample_factors):
        x = _stretch_smooth(x, taps, s)
    indent = cfg.pad * cfg.total_upsample
    return x[:, indent: x.shape[1] - indent, :]


def upsample(params: Params, cfg: WaveRNNModelConfig, mels: torch.Tensor):
    """[B, T_mel, M] -> (mels_up [B, (T_mel-2*pad)*hop, M],
                         aux    [B, (T_mel-2*pad)*hop, res_out])
    (reference UpsampleNetwork.forward, fatchord_version.py:82-89), eval mode."""
    aux = torch.repeat_interleave(melresnet(params, mels), cfg.total_upsample, dim=1)
    return _upsample_mels(params, cfg, mels), aux


def upsample_train(params: Params, cfg: WaveRNNModelConfig, mels: torch.Tensor):
    """``upsample`` in train mode -> (mels_up, aux, params with the new BN
    statistics)."""
    feats, resnet = melresnet_train(params, mels)
    aux = torch.repeat_interleave(feats, cfg.total_upsample, dim=1)
    return _upsample_mels(params, cfg, mels), aux, dict(params, resnet=resnet)


# ---------------------------------------------------------------------------
# teacher-forced forward and loss (training)
# ---------------------------------------------------------------------------


# the GRU over a window (``layers.gru_scan``), under the name
# tools/torch_wavernn_step_precision.py calls
gru_sequence = L.gru_scan


def forward(params: Params, cfg: WaveRNNModelConfig, x: torch.Tensor, mels: torch.Tensor, train: bool,
            dense=L.dense, gru=L.gru_scan):
    """Teacher-forced forward -> (logits [B, T, fc3 width], params with the
    new BN statistics in train mode, else ``params``).

    ``x`` [B, T] holds the previous samples as floats in [-1, 1], ``mels``
    [B, T/hop + 2*pad, M] the unit-range mels (reference
    fatchord_version.py:131-167).  ``dense`` computes I and fc1-fc3 and
    ``gru`` the two GRUs (``parallel.tp.layers`` gives their
    tensor-parallel versions)."""
    aux_d = cfg.res_out_dims // 4
    if train:
        mels_up, aux, new_params = upsample_train(params, cfg, mels)
    else:
        (mels_up, aux), new_params = upsample(params, cfg, mels), params
    a1, a2, a3, a4 = torch.split(aux, aux_d, dim=-1)
    h = dense(params["I"], torch.cat([x[..., None], mels_up, a1], dim=-1))  # [B, T, rnn]
    with span("wavernn.gru", device=True, layer=1):
        h = gru(params["gru1"], h) + h
    with span("wavernn.gru", device=True, layer=2):
        h = gru(params["gru2"], torch.cat([h, a2], dim=-1)) + h
    h = torch.relu(dense(params["fc1"], torch.cat([h, a3], dim=-1)))
    h = torch.relu(dense(params["fc2"], torch.cat([h, a4], dim=-1)))
    return dense(params["fc3"], h), new_params


def wavernn_loss(logits: torch.Tensor, targets: torch.Tensor, mode: str = "RAW", bits: int = 10) -> torch.Tensor:
    """RAW: cross-entropy over mu-law classes (reference wavernn_train.py:82).
    MOL: discretized mixture-of-logistics NLL on float targets in [-1, 1];
    integer labels are mapped by ``label_2_float`` (reference
    wavernn_train.py:78-80)."""
    if mode == "MOL":
        y = targets.to(torch.float32)
        if not torch.is_floating_point(targets):
            y = label_2_float(targets, bits)
        return D.discretized_mix_logistic_loss(logits, y)
    logp = torch.log_softmax(logits, dim=-1)
    return -torch.mean(torch.gather(logp, -1, targets[..., None].long()))


def num_params(params: Params) -> int:
    return sum(int(t.numel()) for t in tree_leaves(params))


# ---------------------------------------------------------------------------
# autoregressive generation
# ---------------------------------------------------------------------------


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
    _check_fc3(params, cfg, bits)
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


def generate_mol(
    params: Params,
    cfg: WaveRNNModelConfig,
    mels,
    seed: int = 0,
    bits: int = 10,
    apply_mu_law: bool = True,
    gumbel: torch.Tensor | None = None,
    u: torch.Tensor | None = None,
) -> torch.Tensor:
    """The MOL sample loop (JAX ``generate_scan``'s MOL branch) in plain
    PyTorch on the params' device -> [B, T] float wav in [-1, 1].

    The conditioning and the mel + a1 part of the I projection are computed
    for all steps at once; each step runs I, GRU1, GRU2, fc1-fc3 and draws
    one sample from the mixture, which is fed back as a float.  The draws,
    ``gumbel`` [T, B, mixtures] and ``u`` [T, B], are made before the loop
    from a generator seeded ``seed`` on the params' device, unless both are
    given.
    ``bits`` only checks fc3's width and ``apply_mu_law`` is unused: MOL
    samples floats (the ``generate_fn`` signature of ``generate_batch``)."""
    _check_fc3(params, cfg, bits)
    dev = params["fc3"]["w"].device
    mels = torch.as_tensor(mels, dtype=torch.float32, device=dev)
    mels_up, aux = upsample(params, cfg, mels)
    a1, a2, a3, a4 = (a.transpose(0, 1) for a in torch.split(aux, cfg.res_out_dims // 4, dim=-1))
    w_i = params["I"]["w"]  # [(1 + M + aux), rnn]; row 0 multiplies the sample
    i_cond = (torch.cat([mels_up, a1.transpose(0, 1)], dim=-1) @ w_i[1:] + params["I"]["b"]).transpose(0, 1)
    T, B, H = i_cond.shape
    nr_mix = params["fc3"]["w"].shape[1] // 3
    if gumbel is None or u is None:
        gen = torch.Generator(device=dev)
        gen.manual_seed(int(seed))
        gumbel, u = D.draw_noise((T, B), nr_mix, gen, dev)
    g1, g2 = params["gru1"], params["gru2"]
    h1 = i_cond.new_zeros(B, H)
    h2 = i_cond.new_zeros(B, H)
    x = i_cond.new_zeros(B)
    out = i_cond.new_empty(T, B)
    for t in range(T):
        xt = x[:, None] * w_i[0] + i_cond[t]
        h1 = L.gru_step_from_gates(g1, xt @ g1["wi"] + g1["bi"], h1)
        xt = xt + h1
        h2 = L.gru_step_from_gates(g2, torch.cat([xt, a2[t]], dim=-1) @ g2["wi"] + g2["bi"], h2)
        xt = xt + h2
        y = torch.relu(L.dense(params["fc1"], torch.cat([xt, a3[t]], dim=-1)))
        y = torch.relu(L.dense(params["fc2"], torch.cat([y, a4[t]], dim=-1)))
        logits = L.dense(params["fc3"], y)
        x = D.sample_from_discretized_mix_logistic(logits, gumbel=gumbel[t], u=u[t])
        out[t] = x
    return out.t()


def default_generate_fn(cfg: WaveRNNModelConfig, greedy: bool = False):
    """The sample loop of ``cfg.mode``: MOL -> ``generate_mol`` (greedy does
    not apply: MOL always samples), RAW -> ``generate_kernel``."""
    if cfg.mode == "MOL":
        return generate_mol
    return functools.partial(generate_kernel, greedy=greedy) if greedy else generate_kernel


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
    whole fold, padded to a shared 64-frame-bucketed length.
    ``generate_fn`` defaults to the loop of the config's mode
    (``default_generate_fn``)."""
    hop = model_cfg.total_upsample
    if gen_cfg.batched and (gen_cfg.target % hop or gen_cfg.overlap % hop):
        raise ValueError("target and overlap must be multiples of the hop size")
    t_frames = gen_cfg.target // hop
    ov_frames = gen_cfg.overlap // hop

    with span("vocode.prepare", device=True):
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
        gen = generate_fn or default_generate_fn(model_cfg)
        mels_t = torch.as_tensor(stacked, device=params["fc3"]["w"].device)

    with span("vocode.k1", device=True, folds=int(stacked.shape[0]), samples=sum(lens)):
        wav_t = gen(params, model_cfg, mels_t, seed, bits, apply_mu_law)

    with span("vocode.unfold", device=True):
        wav_folds = wav_t.cpu().numpy()
        out, offset = [], 0
        for n, wave_len in zip(counts, lens):
            if gen_cfg.batched:
                wav = xfade_and_unfold(wav_folds[offset: offset + n], gen_cfg.overlap)[:wave_len]
            else:
                wav = wav_folds[offset][:wave_len]
            out.append(_fade_out(wav, wave_len, hop))
            offset += n
    return out
