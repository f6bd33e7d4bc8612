"""The Tacotron-2 autoregressive decode: CUDA kernel wrapper and its plain
version.

``decode_autoregressive_kernel`` runs the whole decode to ``max_iters``
(csrc/tacotron_decode.cu, one launch, whole-batch early exit);
``decode_autoregressive_plain`` is the same function in plain PyTorch, a
loop over ``models.tacotron.decoder_step`` with the same random generator.
Both take (params, cfg, memory [B, T_in, V], mem_mask [B, T_in],
seeds [B], max_iters) and return (frames [B, T, 80], stops [B, T],
aligns [B, T, T_in], stop_len [B]).  For a CUDA tensor the wrapper
launches the kernel or raises; only a CPU tensor goes to the plain version.

Scope: forward attention, r = 1, no anti-repeat, no smoothing, two prenet
layers.  Everything else raises NotImplementedError (ROADMAP.md, queue
item 4).

Randomness: the prenet dropout of row b at step t draws
``hash_bits(seeds[b], 0, t, lane)`` with lanes [0, p1) for the first layer
and [p1, p1 + p2) for the second, so a row's dropout depends only on its
own seed and the step.
"""

from __future__ import annotations

import torch

from ..config import TacotronModelConfig
from . import (
    LAUNCHES, check_launch, hash_bits, keep_threshold, load, ptr, require_f32_contiguous,
    stream_ptr,
)

NUM_MELS = 80
STOP_FILL = 1e4  # stop logit written for steps after every row is done

WEIGHT_ORDER = (
    "pre_w1", "pre_b1", "pre_w2", "pre_b2", "l1", "l1_b", "l2", "l2_b",
    "wq", "w_comb", "b_comb", "att_v", "att_b", "proj", "proj_b",
)


def row_seeds(seeds, batch: int, device) -> torch.Tensor:
    """Per-row seeds as int32 [B] (Python ints wrap to 32 bits), the form
    both the kernel and the plain version read."""
    if isinstance(seeds, torch.Tensor):
        s = seeds.to(device=device, dtype=torch.int64)
    else:
        s = torch.as_tensor([int(v) for v in seeds], dtype=torch.int64, device=device)
    s = ((s & 0xFFFFFFFF) ^ 0x80000000) - 0x80000000
    if tuple(s.shape) != (batch,):
        raise ValueError(f"seeds must be [B]={batch}, got {tuple(s.shape)}")
    return s.to(torch.int32).contiguous()


def check_supported(cfg: TacotronModelConfig) -> None:
    """Raise for the decoder configurations the kernel does not run yet."""
    from ..models.attention import check_supported as check_attention

    check_attention(cfg)
    if cfg.outputs_per_step != 1:
        raise NotImplementedError(
            f"outputs_per_step={cfg.outputs_per_step}: only r=1 is ported "
            "(ROADMAP.md, queue item 6: r up to 6)"
        )
    if len(cfg.prenet_layers) != 2:
        raise NotImplementedError("the decoder kernel takes exactly two prenet layers")


def stop_lengths(stops: torch.Tensor, max_iters: int) -> torch.Tensor:
    """First frame whose stop sigmoid passes 0.5 (exclusive), else
    max_iters (reference tacotron_synthesize.py:105)."""
    finished = torch.sigmoid(stops) > 0.5
    idx = torch.argmax(finished.to(torch.int32), dim=-1)
    return torch.where(finished.any(dim=-1), idx, torch.full_like(idx, max_iters)).to(torch.int32)


def pack_weights(params: dict, cfg: TacotronModelConfig) -> dict:
    """Model params -> the kernel's layout: every dense transposed to
    [out, in]; the frame, stop and mu projections stacked into one [82, u+V]
    matrix over the input [out2 | context]; the location conv and location
    dense combined into one [taps, A] filter."""
    from ..models.attention import combined_location_weights

    att = params["attention"]
    V = params["frame_projection"]["w"].shape[0] - cfg.decoder_lstm_units
    mu_w = att["mu_layer"]["w"]  # rows [context (V); query (u)]
    w_comb, b_comb = combined_location_weights(att)
    t = lambda a: a.t().contiguous()
    proj = torch.cat(
        [params["frame_projection"]["w"], params["stop_projection"]["w"],
         torch.cat([mu_w[V:], mu_w[:V]], dim=0)], dim=1,
    )
    proj_b = torch.cat(
        [params["frame_projection"]["b"], params["stop_projection"]["b"], att["mu_layer"]["b"]]
    )
    layers = params["prenet"]["layers"]
    return {
        "pre_w1": t(layers[0]["w"]), "pre_b1": layers[0]["b"].contiguous(),
        "pre_w2": t(layers[1]["w"]), "pre_b2": layers[1]["b"].contiguous(),
        "l1": t(params["dec_lstm1"]["w"]), "l1_b": params["dec_lstm1"]["b"].contiguous(),
        "l2": t(params["dec_lstm2"]["w"]), "l2_b": params["dec_lstm2"]["b"].contiguous(),
        "wq": t(att["query_layer"]["w"]),
        "w_comb": w_comb.contiguous(), "b_comb": b_comb.contiguous(),
        "att_v": att["v"].contiguous(), "att_b": att["b"].contiguous(),
        "proj": t(proj), "proj_b": proj_b.contiguous(),
    }


def decode_autoregressive_kernel(params, cfg: TacotronModelConfig, memory, mem_mask, seeds, max_iters: int):
    """The whole decode.  CUDA: one kernel launch; CPU: the plain version."""
    check_supported(cfg)
    if memory.device.type == "cpu":
        return decode_autoregressive_plain(params, cfg, memory, mem_mask, seeds, max_iters)
    if memory.device.type != "cuda":
        raise NotImplementedError(f"no decoder kernel for device {memory.device}")
    from ..models.attention import precompute_keys

    dev = memory.device
    B, T_in, V = memory.shape
    u = cfg.decoder_lstm_units
    A = cfg.attention_dim
    p1, p2 = cfg.prenet_layers
    taps = cfg.attention_kernel
    for name, n in (("prenet widths", p1), ("prenet widths", p2), ("decoder_lstm_units", u),
                    ("encoder width", V), ("attention_dim", A)):
        if n % 4:
            raise NotImplementedError(f"the decoder kernel needs {name} divisible by 4, got {n}")
    w = pack_weights(params, cfg)
    keys = precompute_keys(params["attention"], memory).contiguous()
    memory = memory.contiguous()
    mem_mask = mem_mask.to(torch.float32).contiguous()
    seeds = row_seeds(seeds, B, dev)
    shapes = {
        "pre_w1": (p1, NUM_MELS), "pre_b1": (p1,), "pre_w2": (p2, p1), "pre_b2": (p2,),
        "l1": (4 * u, p2 + V + u), "l1_b": (4 * u,), "l2": (4 * u, 2 * u), "l2_b": (4 * u,),
        "wq": (A, u), "w_comb": (taps, A), "b_comb": (A,), "att_v": (A,), "att_b": (A,),
        "proj": (NUM_MELS + 2, u + V), "proj_b": (NUM_MELS + 2,),
    }
    require_f32_contiguous("keys", keys, dev, (B, T_in, A))
    require_f32_contiguous("memory", memory, dev, (B, T_in, V))
    require_f32_contiguous("mem_mask", mem_mask, dev, (B, T_in))
    for k in WEIGHT_ORDER:
        require_f32_contiguous(k, w[k], dev, shapes[k])

    frames = torch.empty((max_iters, B, NUM_MELS), dtype=torch.float32, device=dev)
    stops = torch.empty((max_iters, B), dtype=torch.float32, device=dev)
    aligns = torch.empty((max_iters, B, T_in), dtype=torch.float32, device=dev)
    if max_iters > 0 and B > 0:
        lib = load("tacotron_decode.cu")
        per_row = lib.tacotron_decode_scratch_floats(T_in, A, V, u, p1, p2)
        scratch = torch.empty((B * per_row,), dtype=torch.float32, device=dev)
        rate = float(cfg.dropout_rate)
        with torch.cuda.device(dev):
            err = lib.tacotron_decode_launch(
                ptr(keys), ptr(memory), ptr(mem_mask), ptr(seeds),
                *[ptr(w[k]) for k in WEIGHT_ORDER],
                ptr(frames), ptr(stops), ptr(aligns), ptr(scratch),
                B, T_in, A, V, u, p1, p2, taps, int(max_iters),
                float(cfg.zoneout_rate), 1.0 - float(cfg.zoneout_rate), 1.0 - rate,
                keep_threshold(rate) if rate > 0.0 else 0xFFFFFFFF, stream_ptr(dev),
            )
        LAUNCHES["tacotron_decode"] += 1
        check_launch(err, "tacotron_decode")
    frames = frames.transpose(0, 1)
    stops = stops.transpose(0, 1)
    aligns = aligns.transpose(0, 1)
    return frames, stops, aligns, stop_lengths(stops, max_iters)


def prenet_keep_masks(seeds: torch.Tensor, step: int, p1: int, p2: int, rate: float):
    """The prenet keep-masks of one step, [B, p1] and [B, p2], from the
    shared generator (the kernel draws the same bits)."""
    s = seeds.to(torch.int64)[:, None]
    lanes = torch.arange(p1 + p2, device=seeds.device, dtype=torch.int64)[None, :]
    keep = hash_bits(s, 0, step, lanes) < keep_threshold(rate)
    return keep[:, :p1], keep[:, p1:]


def decode_autoregressive_plain(
    params, cfg: TacotronModelConfig, memory, mem_mask, seeds, max_iters: int, prenet_masks=None
):
    """Plain version of the decode kernel (the ``decoder_step`` loop).

    ``prenet_masks`` (optional): one boolean keep-mask per prenet layer,
    shaped [T, B, width], replacing the generator's draws (tests inject
    another framework's masks).  Finished rows keep advancing with real
    outputs until every row is done; later steps hold frames 0, stops 1e4
    and aligns 0, as in the kernel."""
    from ..models import attention as ATT
    from ..models import tacotron as T

    check_supported(cfg)
    B, T_in, V = memory.shape
    dev = memory.device
    p1, p2 = cfg.prenet_layers
    rate = float(cfg.dropout_rate)
    seeds = row_seeds(seeds, B, dev)
    keys = ATT.precompute_keys(params["attention"], memory)
    w_comb, b_comb = ATT.combined_location_weights(params["attention"])
    frames = memory.new_zeros(max_iters, B, NUM_MELS)
    stops = memory.new_full((max_iters, B), STOP_FILL)
    aligns = memory.new_zeros(max_iters, B, T_in)
    carry = T.init_decoder_carry(cfg, B, T_in, V, dev)
    prev = memory.new_zeros(B, NUM_MELS)
    finished = torch.zeros(B, dtype=torch.bool, device=dev)
    for t in range(max_iters):
        if bool(finished.all()):
            break
        if rate <= 0.0:
            masks = None
        elif prenet_masks is not None:
            masks = (prenet_masks[0][t].to(dev), prenet_masks[1][t].to(dev))
        else:
            masks = prenet_keep_masks(seeds, t, p1, p2, rate)
        frame, stop, align, carry = T.decoder_step(
            params, cfg, prev, carry, keys, memory, mem_mask, masks, w_comb, b_comb
        )
        frames[t], stops[t], aligns[t] = frame, stop[:, 0], align
        finished = finished | (torch.sigmoid(stop[:, 0]) > 0.5)
        prev = frame
    frames = frames.transpose(0, 1)
    stops = stops.transpose(0, 1)
    aligns = aligns.transpose(0, 1)
    return frames, stops, aligns, stop_lengths(stops, max_iters)
