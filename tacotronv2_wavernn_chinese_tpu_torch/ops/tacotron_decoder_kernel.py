"""The Tacotron-2 autoregressive decode (K2): CUDA kernel wrapper and its
plain version.

``decode_autoregressive_kernel`` runs the whole decode to ``max_iters``
(csrc/tacotron_decode.cu: one launch per row group, whole-batch early
exit); ``decode_autoregressive_plain`` is the same function in plain
PyTorch, a loop over ``models.tacotron.decoder_step`` with the same random
generator.  Both take (params, cfg, memory [B, T_in, V], mem_mask [B, T_in],
seeds [B], max_iters) and return (frames [B, T, 80], stops [B, T],
aligns [B, T, T_in], stop_len [B]).  For a CUDA tensor the wrapper
launches the kernel or raises; only a CPU tensor goes to the plain version.

The kernel is one grid of thread-block clusters (about one block per SM)
that holds every decoder weight on chip for the whole decode.  ``k2_plan``
is that grid's plan, term for term as the .cu file computes it; the wrapper
compares it with the library's own numbers before every launch.  A batch
that one launch cannot hold (more rows than the grid's, or shared memory
for the rows and positions) runs as sequential launches over equal row
groups, the last one padded by repeating a real row (``row_groups``): a
row's decode depends only on its own inputs and seed, so its stop length
and its frames up to the stop are those of one decode over all rows.

Scope: forward attention, r = 1, no anti-repeat, no smoothing, two prenet
layers, widths that are multiples of 4.  Everything else raises
NotImplementedError (ROADMAP.md, queue item 6).

Randomness: the prenet dropout of row b at step t draws
``hash_bits(seeds[b], 0, t, lane)`` with lanes [0, p1) for the first layer
and [p1, p1 + p2) for the second, so a row's dropout depends only on its
own seed and the step.
"""

from __future__ import annotations

import ctypes
import dataclasses

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


# ---------------------------------------------------------------------------
# the kernel's grid plan (csrc/tacotron_decode.cu k2_plan / k2_layout)
# ---------------------------------------------------------------------------

CLUSTER = 8  # blocks of a thread-block cluster
SMEM_LIMIT = 232448  # opt-in dynamic shared memory of one block on sm_90
NPROJ = NUM_MELS + 2  # frame | stop | mu
LDP = NPROJ + 2  # row stride of the projection partials
POSITIONS = 32  # attention positions a row block aims for (K2_POS)


def _up4(n: int) -> int:
    return (n + 3) & ~3


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _cut(i: int, per: int, n: int) -> range:
    lo = min(i * per, n)
    return range(lo, min(lo + per, n))


def widths(cfg: TacotronModelConfig, value_dim: int) -> tuple:
    """(P1, P2, U, V, A, taps): prenet widths, decoder LSTM, encoder
    (values), attention and location conv taps."""
    p1, p2 = cfg.prenet_layers
    return (p1, p2, cfg.decoder_lstm_units, value_dim, cfg.attention_dim, cfg.attention_kernel)


@dataclasses.dataclass(frozen=True)
class K2Plan:
    """The decode kernel's grid (csrc/tacotron_decode.cu ``k2_plan``):
    ``clusters`` clusters of CLUSTER blocks.  Rank q of every cluster holds
    the K-units [q*k_units, ...) on the reduction side of the gate and query
    products, the prenet-1 outputs [q*pre1_k, ...), the prenet-2 outputs
    [q*prenet_k, ...) (its pre2 K-slice of x1), the context inputs
    [q*ctx_k, ...) and the projection columns of its out2 K-units and
    context inputs; cluster c owns the gate outputs of the units
    [c*units_c, ...) (rank q merging [q*units_b, ...) of them); row b's
    attention runs on blocks_per_row blocks of cluster b // rows_per_cluster,
    ``positions`` encoder positions each."""

    B: int
    T_in: int
    dims: tuple
    clusters: int
    blocks: int
    k_units: int
    units_c: int
    units_b: int
    pre1_k: int
    prenet_k: int
    ctx_k: int
    rows_per_cluster: int
    blocks_per_row: int
    positions: int

    def k_unit_range(self, q: int) -> range:
        return _cut(q, self.k_units, self.dims[2])

    def out_units(self, c: int, q: int) -> range:
        cu = _cut(c, self.units_c, self.dims[2])
        own = _cut(q, self.units_b, len(cu))
        return range(cu.start + own.start, cu.start + own.stop)

    def pre1_range(self, q: int) -> range:
        return _cut(q, self.pre1_k, self.dims[0])

    def pre2_range(self, q: int) -> range:
        return _cut(q, self.prenet_k, self.dims[1])

    def ctx_range(self, q: int) -> range:
        return _cut(q, self.ctx_k, self.dims[3])

    def proj_inputs(self, q: int) -> list:
        """Columns of the projection input [out2 | ctx] that rank q holds."""
        U = self.dims[2]
        return list(self.k_unit_range(q)) + [U + v for v in self.ctx_range(q)]

    def row(self, k: int):
        """(row, slice) of block k's attention, row None when it has none."""
        c, q = divmod(k, CLUSTER)
        rr = q // self.blocks_per_row
        b = c * self.rows_per_cluster + rr
        return (b if rr < self.rows_per_cluster and b < self.B else None), q % self.blocks_per_row

    def position_range(self, k: int) -> range:
        b, sl = self.row(k)
        return _cut(sl, self.positions, self.T_in) if b is not None else range(0)

    def smem_floats(self) -> int:
        """Shared-memory floats of one block: ``k2_layout`` in the .cu file,
        term for term."""
        P1, P2, U, V, A, taps = self.dims
        B, Ku, Kp, Kv, ng, nT = self.B, self.k_units, self.prenet_k, self.ctx_k, 4 * self.units_c, self.positions
        LK1, LK2, LKP = _up4(Kp + Kv + Ku) + 4, _up4(2 * Ku) + 4, _up4(Ku + Kv) + 4
        LKM, LKG = _up4(NUM_MELS) + 4, _up4(P1) + 4
        weights = (ng * LK1 + ng * LK2 + Ku * A + NPROJ * LKP + self.pre1_k * LKM + Kp * LKG + _up4(taps * A)
                   + _up4(self.pre1_k) + _up4(Kp) + LDP + 2 * _up4(A))
        rows = _up4(4 * B * Ku) + B * LK1 + B * max(LKG, LKP) + B * max(ng, LDP) + B * LDP + 4 * _up4(B)
        attention = (self.rows_per_cluster * A + _up4(A) + _up4(nT + taps - 1) + 3 * _up4(nT) + _up4(V)
                     + 16 + 64)
        return weights + rows + attention

    def smem_bytes(self) -> int:
        return 4 * self.smem_floats()

    def scratch_floats(self) -> int:
        """The global exchange: g1 [B, 4U], g2 [B, 4U], ctx [B, V]."""
        P1, P2, U, V, A, taps = self.dims
        return self.B * (8 * U + V)

    def fits(self) -> bool:
        """Whether one launch takes the rows: at most CLUSTER rows per
        cluster, and one block's shared memory."""
        return self.blocks_per_row > 0 and self.smem_bytes() <= SMEM_LIMIT


def k2_plan(batch: int, t_in: int, dims: tuple, clusters: int) -> K2Plan:
    """The plan of one launch for ``clusters`` resident clusters
    (``k2_plan`` of the .cu file, term for term); ``fits`` says whether it
    launches."""
    P1, P2, U, V, A, taps = dims
    rpc = 1
    while rpc * clusters < batch:
        rpc *= 2
    bpr = 0
    if rpc <= CLUSTER:
        bpr = 1
        while bpr < CLUSTER // rpc and bpr * POSITIONS < t_in:
            bpr *= 2
    uc = _cdiv(U, clusters)
    return K2Plan(batch, t_in, tuple(dims), clusters, clusters * CLUSTER, _cdiv(U, CLUSTER), uc,
                  _cdiv(uc, CLUSTER), _cdiv(P1, CLUSTER), _cdiv(P2, CLUSTER), _cdiv(V, CLUSTER),
                  rpc, bpr, _cdiv(t_in, bpr) if bpr else 0)


def rows_per_launch(t_in: int, dims: tuple, clusters: int) -> int:
    """The most rows one launch takes at this encoder length (the grid's
    rows, and shared memory, which grows with the rows and with a block's
    positions); 0 when not even one row fits."""
    lo, hi = 0, clusters * CLUSTER  # fits() only turns false as the rows grow
    while lo < hi:
        mid = (lo + hi + 1) // 2
        if k2_plan(mid, t_in, dims, clusters).fits():
            lo = mid
        else:
            hi = mid - 1
    return lo


def row_groups(batch: int, group: int) -> list:
    """Equal row groups of at most ``group`` rows: [(start, stop, size)],
    ``size`` >= stop - start the rows of the launch (the last group padded)."""
    n = _cdiv(batch, group)
    size = _cdiv(batch, n)
    return [(i * size, min(batch, (i + 1) * size), size) for i in range(n)]


def decode_in_groups(decode_group, memory, mem_mask, seeds: torch.Tensor, group: int):
    """``decode_group(memory, mem_mask, seeds)`` over row groups of at most
    ``group`` rows, each padded by repeating its last real row (a padded
    zero row would never fire the stop token and would pin the group at
    max_iters); the results are concatenated and trimmed to the batch."""
    B = memory.shape[0]
    outs = []
    for lo, hi, size in row_groups(B, group):
        pick = torch.arange(lo, lo + size, device=memory.device).clamp_max(hi - 1)
        outs.append(decode_group(memory[pick].contiguous(), mem_mask[pick].contiguous(),
                                 seeds[pick.to(seeds.device)].contiguous()))
    return tuple(torch.cat([o[i][: hi - lo] for o, (lo, hi, _) in zip(outs, row_groups(B, group))])
                 for i in range(len(outs[0])))


_CLUSTERS: dict = {}


def card_clusters(device: torch.device) -> int:
    """Clusters of CLUSTER blocks the decode kernel keeps resident at once
    on ``device`` (one block per SM), asked of the card once per device."""
    key = torch.device(device).index or 0
    if key not in _CLUSTERS:
        with torch.cuda.device(key):
            n = load("tacotron_decode.cu").tacotron_decode_clusters()
        if n <= 0:
            raise RuntimeError(f"the decode kernel cannot keep a cluster resident (cudaError {-n})")
        _CLUSTERS[key] = n
    return _CLUSTERS[key]


def launch_group(t_in: int, dims: tuple, clusters: int) -> int:
    """Rows per launch; NotImplementedError when not even one row fits."""
    group = rows_per_launch(t_in, dims, clusters)
    if group == 0:
        raise NotImplementedError(
            f"T_in={t_in} with widths {dims} is beyond the decode kernel's envelope on a card with {clusters} "
            f"resident clusters of {CLUSTER} blocks: one row's weight slices and positions exceed a block's "
            f"shared memory (ROADMAP.md, queue item 15)"
        )
    return group


def decode_autoregressive_kernel(params, cfg: TacotronModelConfig, memory, mem_mask, seeds, max_iters: int):
    """The whole decode.  CUDA: one kernel launch per row group; CPU: the
    plain version."""
    check_supported(cfg)
    if memory.device.type == "cpu":
        return decode_autoregressive_plain(params, cfg, memory, mem_mask, seeds, max_iters)
    if memory.device.type != "cuda":
        raise NotImplementedError(f"no decoder kernel for device {memory.device}")
    from ..models.attention import precompute_keys

    dev = memory.device
    B, T_in, V = memory.shape
    dims = widths(cfg, V)
    P1, P2, U, _, A, taps = dims
    for name, n in (("prenet widths", P1), ("prenet widths", P2), ("decoder_lstm_units", U),
                    ("encoder width", V), ("attention_dim", A)):
        if n % 4:
            raise NotImplementedError(f"the decoder kernel needs {name} divisible by 4, got {n}")
    w = pack_weights(params, cfg)
    shapes = {
        "pre_w1": (P1, NUM_MELS), "pre_b1": (P1,), "pre_w2": (P2, P1), "pre_b2": (P2,),
        "l1": (4 * U, P2 + V + U), "l1_b": (4 * U,), "l2": (4 * U, 2 * U), "l2_b": (4 * U,),
        "wq": (A, U), "w_comb": (taps, A), "b_comb": (A,), "att_v": (A,), "att_b": (A,),
        "proj": (NPROJ, U + V), "proj_b": (NPROJ,),
    }
    for k in WEIGHT_ORDER:
        require_f32_contiguous(k, w[k], dev, shapes[k])
    seeds = row_seeds(seeds, B, dev)
    mem_mask = mem_mask.to(torch.float32)
    if max_iters <= 0 or B == 0:  # nothing to run
        stops = memory.new_empty((B, max(max_iters, 0)))
        return (memory.new_empty((B, stops.shape[1], NUM_MELS)), stops,
                memory.new_empty((B, stops.shape[1], T_in)), stop_lengths(stops, max_iters))
    clusters = card_clusters(dev)
    group = launch_group(T_in, dims, clusters)
    rate = float(cfg.dropout_rate)
    lib = load("tacotron_decode.cu")

    def launch(mem, mask, sd):
        Bg = mem.shape[0]
        plan = k2_plan(Bg, T_in, dims, clusters)
        lib_smem = lib.tacotron_decode_smem_bytes(Bg, T_in, *dims, clusters)
        lib_scratch = lib.tacotron_decode_scratch_floats(Bg, T_in, *dims, clusters)
        if (lib_smem, lib_scratch) != (plan.smem_bytes(), plan.scratch_floats()):
            raise RuntimeError(
                f"tacotron_decode: the library's layout ({lib_smem} bytes of shared memory, {lib_scratch} "
                f"exchange floats) differs from k2_plan ({plan.smem_bytes()}, {plan.scratch_floats()})"
            )
        keys = precompute_keys(params["attention"], mem).contiguous()
        mem = mem.contiguous()
        mask = mask.contiguous()
        require_f32_contiguous("keys", keys, dev, (Bg, T_in, A))
        require_f32_contiguous("memory", mem, dev, (Bg, T_in, V))
        require_f32_contiguous("mem_mask", mask, dev, (Bg, T_in))
        frames = torch.empty((max_iters, Bg, NUM_MELS), dtype=torch.float32, device=dev)
        stops = torch.empty((max_iters, Bg), dtype=torch.float32, device=dev)
        aligns = torch.empty((max_iters, Bg, T_in), dtype=torch.float32, device=dev)
        scratch = torch.empty((plan.scratch_floats(),), dtype=torch.float32, device=dev)
        counter = torch.zeros((1,), dtype=torch.int32, device=dev)
        tensors = [keys, mem, mask, sd, *[w[k] for k in WEIGHT_ORDER], frames, stops, aligns, scratch]
        ptrs = (ctypes.c_void_p * len(tensors))(*[t.data_ptr() for t in tensors])
        with torch.cuda.device(dev):
            err = lib.tacotron_decode_launch(
                ptrs, ptr(counter), Bg, T_in, *dims, int(max_iters), clusters,
                float(cfg.zoneout_rate), 1.0 - float(cfg.zoneout_rate), 1.0 - rate,
                keep_threshold(rate) if rate > 0.0 else 0xFFFFFFFF, stream_ptr(dev),
            )
        LAUNCHES["tacotron_decode"] += 1
        check_launch(err, "tacotron_decode")
        return frames.transpose(0, 1), stops.transpose(0, 1), aligns.transpose(0, 1)

    frames, stops, aligns = decode_in_groups(launch, memory, mem_mask, seeds, group)
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
