"""The WaveRNN RAW sample loop: CUDA kernel wrapper and its plain version.

``sample_labels`` runs the whole serial loop (csrc/wavernn_sample.cu, one
launch) for a batch of folds; ``sample_labels_plain`` is the same function
in plain PyTorch with the same arguments and the same random generator.
For a CUDA tensor the wrapper launches the kernel or raises; only a CPU
tensor goes to the plain version.

Inputs are the packed conditioning ``cond`` [T, B, 208] (time-major:
upsampled mel 80 | a1 | a2 | a3 | a4, 32 each) and the weights of
``pack_weights`` (f32, transposed to [out, in], inputs padded to a multiple
of 4).  The output is int32 mu-law labels [T, B].
"""

from __future__ import annotations

import torch

from ..config import WaveRNNModelConfig
from ..dsp.mulaw import label_2_float
from . import (
    LAUNCHES, check_launch, gumbel_from_bits, hash_bits, load, ptr, require_f32_contiguous,
    stream_ptr,
)

NUM_MELS = 80
AUX = 32
COND_W = NUM_MELS + 4 * AUX  # 208
XI_W = 116  # [x, mel, a1] = 113, padded to a multiple of 4
_A2, _A3, _A4 = NUM_MELS + AUX, NUM_MELS + 2 * AUX, NUM_MELS + 3 * AUX

WEIGHT_ORDER = (
    "w_i", "b_i", "wi1", "bi1", "wh1", "bh1", "wi2", "bi2", "wh2", "bh2",
    "wfc1", "bfc1", "wfc2", "bfc2", "wfc3", "bfc3",
)


def check_supported(cfg: WaveRNNModelConfig, num_mels: int = 80) -> None:
    """Raise for geometries the kernel does not take (RAW mode, 80 mels,
    aux 32, widths that are multiples of 4)."""
    if cfg.mode != "RAW":
        raise NotImplementedError(
            f"WaveRNN mode {cfg.mode!r} is not ported yet (ROADMAP.md, queue item 5: MOL)"
        )
    if num_mels != NUM_MELS or cfg.res_out_dims // 4 != AUX:
        raise NotImplementedError(
            f"the sample-loop kernel takes 80 mels and aux 32, got {num_mels} mels and "
            f"aux {cfg.res_out_dims // 4} (ROADMAP.md, queue item 1: the kernel redesign)"
        )
    if cfg.rnn_dims % 4 or cfg.fc_dims % 4:
        raise NotImplementedError("the sample-loop kernel needs rnn_dims and fc_dims divisible by 4")


def pack_weights(params: dict, cfg: WaveRNNModelConfig) -> dict:
    """Model params ([in, out] layout) -> the kernel's layout."""
    t = lambda a: a.t().contiguous()
    wi = params["I"]["w"]  # [1 + mel + a1, rnn]: row 0 multiplies the sample
    w_i = torch.nn.functional.pad(wi.t(), (0, XI_W - wi.shape[0])).contiguous()
    return {
        "w_i": w_i, "b_i": params["I"]["b"].contiguous(),
        "wi1": t(params["gru1"]["wi"]), "bi1": params["gru1"]["bi"].contiguous(),
        "wh1": t(params["gru1"]["wh"]), "bh1": params["gru1"]["bh"].contiguous(),
        "wi2": t(params["gru2"]["wi"]), "bi2": params["gru2"]["bi"].contiguous(),
        "wh2": t(params["gru2"]["wh"]), "bh2": params["gru2"]["bh"].contiguous(),
        "wfc1": t(params["fc1"]["w"]), "bfc1": params["fc1"]["b"].contiguous(),
        "wfc2": t(params["fc2"]["w"]), "bfc2": params["fc2"]["b"].contiguous(),
        "wfc3": t(params["fc3"]["w"]), "bfc3": params["fc3"]["b"].contiguous(),
    }


def sample_labels(cond: torch.Tensor, w: dict, seed: int, greedy: bool = False) -> torch.Tensor:
    """The sample loop -> labels [T, B] int32.  CUDA: one kernel launch;
    CPU: ``sample_labels_plain``."""
    if cond.device.type == "cpu":
        return sample_labels_plain(cond, w, seed, greedy)
    if cond.device.type != "cuda":
        raise NotImplementedError(f"no sample-loop kernel for device {cond.device}")
    dev = cond.device
    T, B, cw = cond.shape
    if cw != COND_W:
        raise ValueError(f"cond must be [T, B, {COND_W}], got {tuple(cond.shape)}")
    H = w["wh1"].shape[1]
    FC = w["wfc3"].shape[1]
    NC = w["wfc3"].shape[0]
    shapes = {
        "w_i": (H, XI_W), "b_i": (H,), "wi1": (3 * H, H), "bi1": (3 * H,), "wh1": (3 * H, H),
        "bh1": (3 * H,), "wi2": (3 * H, H + AUX), "bi2": (3 * H,), "wh2": (3 * H, H),
        "bh2": (3 * H,), "wfc1": (FC, H + AUX), "bfc1": (FC,), "wfc2": (FC, FC + AUX),
        "bfc2": (FC,), "wfc3": (NC, FC), "bfc3": (NC,),
    }
    require_f32_contiguous("cond", cond, dev)
    for k in WEIGHT_ORDER:
        require_f32_contiguous(k, w[k], dev, shapes[k])
    if H % 4 or FC % 4:
        raise NotImplementedError("the sample-loop kernel needs rnn and fc widths divisible by 4")
    labels = torch.empty((T, B), dtype=torch.int32, device=dev)
    if T == 0 or B == 0:
        return labels
    lib = load("wavernn_sample.cu")
    with torch.cuda.device(dev):
        err = lib.wavernn_sample_launch(
            ptr(cond), *[ptr(w[k]) for k in WEIGHT_ORDER], ptr(labels),
            T, B, H, FC, NC, int(bool(greedy)), int(seed) & 0xFFFFFFFF, stream_ptr(dev),
        )
    LAUNCHES["wavernn_sample"] += 1
    check_launch(err, "wavernn_sample")
    return labels


def _gru(gi: torch.Tensor, gh: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
    H = h.shape[-1]
    r = torch.sigmoid(gi[:, :H] + gh[:, :H])
    z = torch.sigmoid(gi[:, H:2 * H] + gh[:, H:2 * H])
    n = torch.tanh(gi[:, 2 * H:] + r * gh[:, 2 * H:])
    return (1.0 - z) * n + z * h


def sample_labels_plain(
    cond: torch.Tensor,
    w: dict,
    seed: int,
    greedy: bool = False,
    noise: torch.Tensor | None = None,
    return_gaps: bool = False,
):
    """Plain PyTorch version of the kernel -> labels [T, B] int32.

    ``noise`` [T, B, classes] replaces the generator's Gumbel draws (tests
    inject another framework's draws).  ``return_gaps`` also returns the
    per-step gap between the two largest perturbed logits [T, B], which
    says where a one-ulp difference could flip a label."""
    T, B, _ = cond.shape
    dev = cond.device
    H = w["wh1"].shape[1]
    NC = w["wfc3"].shape[0]
    bits = NC.bit_length() - 1
    h1 = cond.new_zeros(B, H)
    h2 = cond.new_zeros(B, H)
    x = cond.new_zeros(B)
    pad = cond.new_zeros(B, XI_W - 1 - NUM_MELS - AUX)
    folds = torch.arange(B, device=dev, dtype=torch.int64)[:, None]
    classes = torch.arange(NC, device=dev, dtype=torch.int64)[None, :]
    seed_t = torch.tensor(int(seed) & 0xFFFFFFFF, dtype=torch.int64, device=dev)
    labels = torch.empty((T, B), dtype=torch.int32, device=dev)
    gaps = torch.empty((T, B), dtype=torch.float32, device=dev) if return_gaps else None
    for t in range(T):
        c = cond[t]
        xi = torch.cat([x[:, None], c[:, :_A2], pad], dim=-1)
        xt = xi @ w["w_i"].t() + w["b_i"]
        h1 = _gru(xt @ w["wi1"].t() + w["bi1"], h1 @ w["wh1"].t() + w["bh1"], h1)
        xt = xt + h1
        gi2 = torch.cat([xt, c[:, _A2:_A3]], dim=-1) @ w["wi2"].t() + w["bi2"]
        h2 = _gru(gi2, h2 @ w["wh2"].t() + w["bh2"], h2)
        xt = xt + h2
        y = torch.relu(torch.cat([xt, c[:, _A3:_A4]], dim=-1) @ w["wfc1"].t() + w["bfc1"])
        y = torch.relu(torch.cat([y, c[:, _A4:]], dim=-1) @ w["wfc2"].t() + w["bfc2"])
        logits = y @ w["wfc3"].t() + w["bfc3"]
        if noise is not None:
            logits = logits + noise[t].to(logits)
        elif not greedy:
            logits = logits + gumbel_from_bits(hash_bits(seed_t, folds, t, classes))
        label = torch.argmax(logits, dim=-1)
        if return_gaps:
            top2 = torch.topk(logits, 2, dim=-1).values
            gaps[t] = top2[:, 0] - top2[:, 1]
        labels[t] = label.to(torch.int32)
        x = label_2_float(label, bits)
    return (labels, gaps) if return_gaps else labels
