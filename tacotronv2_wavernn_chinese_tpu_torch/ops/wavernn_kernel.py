"""The WaveRNN RAW sample loop: CUDA kernel wrapper and its plain version.

``sample_labels`` runs the whole serial loop (csrc/wavernn_sample.cu, one
cooperative launch) for a batch of folds; ``sample_labels_plain`` is the
same function in plain PyTorch with the same arguments and the same random
generator.  For a CUDA tensor the wrapper launches the kernel or raises;
only a CPU tensor goes to the plain version.

Inputs are the packed conditioning ``cond`` [T, B, 208] (time-major:
upsampled mel 80 | a1 | a2 | a3 | a4, 32 each) and the weights of
``pack_weights`` (f32, transposed to [out, in], inputs padded to a multiple
of 4).  The output is int32 mu-law labels [T, B].

The kernel is one grid of ``K1Plan.blocks`` blocks, about one per SM, all
resident at once.  Block k owns ceil-division slices of every layer's
output columns (hidden units of GRU1, GRU2 and the I projection, fc1/fc2
columns, logits) and keeps those weight rows in its shared memory for the
whole loop.  A step is five phases, each ended by a grid barrier: GRU1
(after merging the previous step's per-block argmax partials into the
fed-back sample), GRU2, fc1, fc2, and fc3 with the argmax partials and the
next step's conditioning part of the I projection.  Every phase stages its
input vectors for a tile of ``fold_tile`` folds in shared memory and loops
over tiles.  ``k1_plan`` computes that layout term for term as the ``.cu``
does; the wrapper sizes the launch from it and checks it against the
library's own numbers.
"""

from __future__ import annotations

import dataclasses

import torch

from ..config import WaveRNNModelConfig
from ..dsp.mulaw import label_2_float
from ..utils import metrics as M
from . import (
    LAUNCHES, check_launch, gumbel_from_bits, hash_bits, load, ptr, require_f32_contiguous,
    stream_ptr,
)

NUM_MELS = 80
AUX = 32
COND_W = NUM_MELS + 4 * AUX  # 208
XI_W = 116  # [x, mel, a1] = 113, padded to a multiple of 4
COND_I = NUM_MELS + AUX  # 112: the I projection's conditioning inputs
_A2, _A3, _A4 = NUM_MELS + AUX, NUM_MELS + 2 * AUX, NUM_MELS + 3 * AUX

SMEM_LIMIT = 232448  # bytes of shared memory one block may use on sm_90
FOLD_TILES = (16, 8, 4)  # tried in this order; the first that fits is taken
BARRIERS_PER_STEP = 5

WEIGHT_ORDER = (
    "w_i", "b_i", "wi1", "bi1", "wh1", "bh1", "wi2", "bi2", "wh2", "bh2",
    "wfc1", "bfc1", "wfc2", "bfc2", "wfc3", "bfc3",
)


def check_supported(cfg: WaveRNNModelConfig, num_mels: int = 80) -> None:
    """Raise for geometries the kernel does not take (RAW mode, 80 mels,
    aux 32, widths that are multiples of 4)."""
    if cfg.mode != "RAW":
        raise NotImplementedError(
            f"the sample-loop kernel is RAW only; WaveRNN mode {cfg.mode!r} samples through "
            "models.wavernn.generate_mol, as the JAX package sends MOL to its scan path "
            "(ROADMAP.md, queue item 8: a MOL sample-loop kernel)"
        )
    if num_mels != NUM_MELS or cfg.res_out_dims // 4 != AUX:
        raise NotImplementedError(
            f"the sample-loop kernel takes 80 mels and aux 32, got {num_mels} mels and "
            f"aux {cfg.res_out_dims // 4} (ROADMAP.md, queue item 4: the kernel's next steps)"
        )
    if cfg.rnn_dims % 4 or cfg.fc_dims % 4:
        raise NotImplementedError("the sample-loop kernel needs rnn_dims and fc_dims divisible by 4")


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _pad4(a: int) -> int:
    return (a + 3) & ~3


@dataclasses.dataclass(frozen=True)
class K1Plan:
    """The grid of the sample-loop kernel: ``blocks`` blocks; block k owns
    hidden units (and I projection columns) [k*units, (k+1)*units), fc1/fc2
    columns [k*fc_cols, ...) and logits [k*logits, ...), each range cut at
    the layer's width."""

    H: int
    FC: int
    NC: int
    blocks: int
    fold_tile: int
    units: int
    fc_cols: int
    logits: int
    smem_bytes: int

    def ranges(self, layer: str) -> list[range]:
        """Each block's output columns of ``layer`` (I, gru1, gru2, fc1,
        fc2, fc3); a GRU's unit j stands for its rows j, H+j and 2H+j."""
        width, per = {
            "I": (self.H, self.units), "gru1": (self.H, self.units), "gru2": (self.H, self.units),
            "fc1": (self.FC, self.fc_cols), "fc2": (self.FC, self.fc_cols), "fc3": (self.NC, self.logits),
        }[layer]
        return [range(min(k * per, width), min((k + 1) * per, width)) for k in range(self.blocks)]

    def scratch_floats(self, B: int) -> int:
        """Floats of the global exchange scratch: h1, h2 [2, B, H]; x1, x2,
        xt_cond [B, H]; y1, y2 [B, FC]; argmax partials [B, blocks] x 2."""
        return B * (7 * self.H + 2 * self.FC + 2 * self.blocks)


def k1_plan(H: int, FC: int, NC: int, n_sm: int, fold_tile: int) -> K1Plan:
    """The layout of the kernel on a card with ``n_sm`` SMs: blocks =
    ceil(H / ceil(H / n_sm)), ceil-division column ranges, and the shared
    memory of one block (csrc/wavernn_sample.cu ``make_layout``, term for
    term).  Whether it fits is ``choose_k1_plan``'s question."""
    units = _cdiv(H, n_sm)
    G = _cdiv(H, units)
    cH, cF, cN = units, _cdiv(FC, G), _cdiv(NC, G)
    KA, KB = H + AUX, FC + AUX
    weights = (cH * COND_I + H + 3 * cH * H + 3 * cH * H + 3 * cH * KA + 3 * cH * H
               + cF * KA + cF * KB + cN * FC)
    stage = fold_tile * max(2 * H, KA + H, KB, FC + COND_I)
    out = fold_tile * max(6 * cH, cF, cN + cH)
    floats = weights + stage + out + _pad4(13 * cH + 2 * cF + cN) + _pad4(fold_tile)
    return K1Plan(H, FC, NC, G, fold_tile, cH, cF, cN, 4 * floats)


def choose_k1_plan(H: int, FC: int, NC: int, n_sm: int) -> K1Plan:
    """The plan with the largest fold tile of ``FOLD_TILES`` whose shared
    memory fits one block; raises NotImplementedError when none does."""
    for ft in FOLD_TILES:
        plan = k1_plan(H, FC, NC, n_sm, ft)
        if plan.smem_bytes <= SMEM_LIMIT:
            return plan
    raise NotImplementedError(
        f"the sample-loop kernel's weight slices do not fit shared memory at rnn {H}, fc {FC}, "
        f"{NC} classes on {n_sm} SMs ({plan.smem_bytes} bytes per block at fold tile {plan.fold_tile}, "
        f"limit {SMEM_LIMIT}) (ROADMAP.md, queue item 4: bf16 weights)"
    )


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
    """The sample loop -> labels [T, B] int32.  CUDA: one cooperative
    kernel launch; CPU: ``sample_labels_plain``."""
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
    plan = choose_k1_plan(H, FC, NC, torch.cuda.get_device_properties(dev).multi_processor_count)
    if (BARRIERS_PER_STEP * T + 1) * plan.blocks >= 2**32:
        raise ValueError(f"{T} steps overflow the kernel's 32-bit barrier counter")
    labels = torch.empty((T, B), dtype=torch.int32, device=dev)
    if T == 0 or B == 0:
        return labels
    lib = load("wavernn_sample.cu")
    G, FT = plan.blocks, plan.fold_tile
    if (lib.wavernn_sample_smem_bytes(G, H, FC, NC, FT) != plan.smem_bytes
            or lib.wavernn_sample_scratch_floats(B, G, H, FC) != plan.scratch_floats(B)):
        raise RuntimeError("k1_plan and csrc/wavernn_sample.cu disagree on the kernel's layout")
    scratch = torch.zeros(plan.scratch_floats(B), dtype=torch.float32, device=dev)
    counter = torch.zeros(1, dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        err = lib.wavernn_sample_launch(
            ptr(cond), *[ptr(w[k]) for k in WEIGHT_ORDER], ptr(labels), ptr(scratch), ptr(counter),
            T, B, H, FC, NC, G, FT, int(bool(greedy)), int(seed) & 0xFFFFFFFF, stream_ptr(dev),
        )
    LAUNCHES["wavernn_sample"] += 1
    M.stamp("k1")
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
