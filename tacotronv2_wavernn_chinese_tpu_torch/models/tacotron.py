"""Tacotron-2 acoustic model: phoneme ids -> mel spectrogram.

embedding(128) -> 3x[conv5-256 + ReLU + BN] -> BiLSTM(256/dir, zoneout 0.1)
-> decoder (prenet 256/256 with always-on dropout, 2x LSTM 256, attention
(forward by default; LSA, GMM or Graves), frame/stop projections of r
frames a step) -> 5-layer postnet -> with ``predict_linear``, the CBHG
mel->linear head (conv bank, max-pool, projections, highways, BiGRU,
1025 bins).

The encoder's BiLSTM runs as one CUDA kernel forward and one backward on
the card (``ops.tacotron_encoder_kernel``), in every mode and route.

Inference: the autoregressive decode runs as one CUDA kernel on the card
(``ops.tacotron_decoder_kernel``); ``decoder_step`` below is the step the
plain version loops over.

Training and GTA (``forward_teacher_forced``, ``tacotron_loss``): the
teacher-forced decode takes one of two routes (``core_route``).  Forward
attention without smoothing under full teacher forcing (and without
anti-repeat at eval) batches the prenet over every step before the
decoder core and the frame/stop projections after it, and the core runs
K3/K4 on the card (``ops.tacotron_trainer_kernel``).  Every other
configuration (LSA, GMM, Graves, smoothing, anti-repeat at eval,
scheduled sampling) runs an eager loop over ``decoder_step`` on every
device, the counterpart of the JAX package's ``lax.scan``: the JAX package
trains these through XLA too, not through its Pallas kernel.  On the card,
under full teacher forcing, that loop replays one captured CUDA graph a
step, forward and backward (``models.decoder_graph``).  All
randomness of one forward (encoder and postnet dropout, zoneout, prenet
dropout, GMM attention dropout, the scheduled-sampling draws) is drawn up
front into a ``TrainRand`` from an explicit ``torch.Generator``, or handed
in.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..config import TacotronModelConfig
from ..ops import tacotron_decoder_kernel as DK
from ..ops import tacotron_encoder_kernel as EK
from ..ops import tacotron_trainer_kernel as TK
from ..parallel import mesh as PM
from ..utils import precision as P
from ..utils.metrics import span
from . import attention as ATT
from . import decoder_graph as DG
from . import layers as L

Params = dict

# decoder steps decoded, by route: "kernel" and "eager" (``core_route``) for
# teacher-forced decodes, "k2" for autoregressive ones; each decode adds its
# padded step count (``utils.metrics.counters()`` hands this dict over)
DECODER_STEPS = {"kernel": 0, "eager": 0, "k2": 0}
# graphs captured and forward steps replayed from one on the eager route
# (``models.decoder_graph``; ``utils.metrics.counters()`` hands it over)
DECODER_GRAPHS = DG.DECODER_GRAPHS


def decoder_span(route: str, cfg: TacotronModelConfig, rows: int, steps: int, positions: int,
                 graphed: bool = False):
    """Count a decode of ``steps`` steps on ``route`` and open its
    ``tacotron.decoder`` span, which carries the route, the attention mode,
    the rows, the steps, the encoder positions attended over and whether
    the steps replay a CUDA graph."""
    DECODER_STEPS[route] += steps
    return span("tacotron.decoder", device=True, route=route, mode=cfg.attention_mode, rows=rows, steps=steps,
                positions=positions, graphed=graphed)


class TacotronOutput(NamedTuple):
    decoder_output: torch.Tensor  # [B, T_out, M] pre-postnet mels
    mel_outputs: torch.Tensor  # [B, T_out, M] post-postnet mels
    stop_logits: torch.Tensor  # [B, T_out]
    alignments: torch.Tensor  # [B, T_dec, T_in]
    stop_lengths: torch.Tensor | None = None  # [B] inference: frames until the stop token
    linear_outputs: torch.Tensor | None = None  # [B, T_out, 1025] the CBHG head's output


def input_mask(input_lengths: torch.Tensor, T_in: int) -> torch.Tensor:
    """[B, T_in] float 1/0 mask of valid encoder positions."""
    ar = torch.arange(T_in, device=input_lengths.device)[None, :]
    return (ar < input_lengths[:, None]).to(torch.float32)


class TrainRand(NamedTuple):
    """Every random mask one teacher-forced forward consumes (the
    counterpart of the JAX package's StepRand, for all steps at once).
    Keep-masks are boolean; None where the knob is off."""

    enc_drop: tuple | None  # per encoder conv layer, [B, T_in, C]
    enc_fw: tuple | None  # forward encoder LSTM (cell, hidden) zoneout, [T_in, B, units]
    enc_bw: tuple | None  # backward encoder LSTM, in its loop order
    pre: tuple | None  # per prenet layer, [T_dec, B, width]
    z1: tuple | None  # decoder LSTM1 (cell, hidden) zoneout, [T_dec, B, u]
    z2: tuple | None  # decoder LSTM2
    post_drop: tuple | None  # per postnet layer, [B, T_out, C]
    att: torch.Tensor | None = None  # GMM attention dropout (train), [T_dec, B, u + 2*units]
    use_gt: torch.Tensor | None = None  # scheduled sampling: feed the ground truth, [T_dec, B, 1]


# the batch dim of each TrainRand field
_RAND_BATCH_DIM = dict(enc_drop=0, enc_fw=1, enc_bw=1, pre=1, z1=1, z2=1, post_drop=0, att=1, use_gt=1)


def shard_train_rand(rand: TrainRand, index: int, shards: int) -> TrainRand:
    """Block ``index`` of ``shards`` of every mask drawn for the global
    batch (its batch dim cut into equal blocks): a data-parallel rank's
    masks, as the JAX package draws global masks and shards them."""

    def cut(v, dim):
        if v is None:
            return None
        if isinstance(v, tuple):
            return tuple(cut(m, dim) for m in v)
        return PM.shard_rows(v, shards, index, dim).contiguous()

    return TrainRand(**{f: cut(getattr(rand, f), _RAND_BATCH_DIM[f]) for f in TrainRand._fields})


def full_teacher_forcing(teacher_forcing_ratio) -> bool:
    """A static ratio >= 1: every step's input is the ground-truth frame
    (the JAX package's ``always_gt``)."""
    return isinstance(teacher_forcing_ratio, (int, float)) and teacher_forcing_ratio >= 1.0


def draw_train_rand(params: Params, cfg: TacotronModelConfig, batch: int, t_in: int, t_out: int,
                    generator: torch.Generator, train: bool = True,
                    teacher_forcing_ratio: float = 1.0) -> TrainRand:
    """All masks of one forward, drawn from ``generator`` on its device.
    The prenet dropout is always on; the scheduled-sampling draws (a row
    takes the ground truth at a step with probability ``teacher_forcing_ratio``)
    whenever the ratio is below 1; the others only in train mode."""
    B, t_dec = batch, t_out // cfg.outputs_per_step
    rate, zr = cfg.dropout_rate, cfg.zoneout_rate
    pre = L.prenet_masks(params["prenet"], rate, (t_dec, B), generator)
    keep = lambda shape, r: L.keep_mask(shape, r, generator)
    rand = TrainRand(None, None, None, pre, None, None, None)
    if train:
        pair = lambda shape: (keep(shape, zr), keep(shape, zr)) if zr > 0.0 else None
        drops = lambda n, T, C: tuple(keep((B, T, C), rate) for _ in range(n)) if rate > 0.0 else None
        att = None
        if cfg.attention_mode == "gmm":
            att = keep((t_dec, B, cfg.decoder_lstm_units + 2 * cfg.encoder_lstm_units), ATT.GMM_DROPOUT)
        rand = TrainRand(
            drops(cfg.enc_conv_layers, t_in, cfg.enc_conv_channels),
            pair((t_in, B, cfg.encoder_lstm_units)), pair((t_in, B, cfg.encoder_lstm_units)),
            pre,
            pair((t_dec, B, cfg.decoder_lstm_units)), pair((t_dec, B, cfg.decoder_lstm_units)),
            drops(cfg.postnet_layers, t_out, cfg.postnet_channels),
            att,
        )
    if not full_teacher_forcing(teacher_forcing_ratio):
        u = torch.rand((t_dec, B, 1), generator=generator, device=generator.device)
        rand = rand._replace(use_gt=u < teacher_forcing_ratio)
    return rand


def encode(params: Params, cfg: TacotronModelConfig, inputs: torch.Tensor, input_lengths: torch.Tensor):
    """[B, T_in] ids -> memory [B, T_in, 2*units], zero past each length
    (eval mode: no dropout, zoneout as EMA)."""
    return _encode(params, cfg, inputs, input_lengths, None)[0]


def encode_train(params: Params, cfg: TacotronModelConfig, inputs, input_lengths, rand: TrainRand):
    """Train-mode encoder (conv dropout, BN batch statistics, zoneout
    masks) -> (memory, enc_convs params with the updated BN statistics)."""
    return _encode(params, cfg, inputs, input_lengths, rand)


def _encode(params, cfg, inputs, input_lengths, rand):
    x = params["embedding"][inputs.long()]
    if rand is None:
        x, new_convs = L.conv_stack(params["enc_convs"], x), params["enc_convs"]
    else:
        x, new_convs = L.conv_stack_train(params["enc_convs"], x, cfg.dropout_rate, rand.enc_drop)
    memory = EK.bidirectional_lstm(params["enc_lstm_fw"], params["enc_lstm_bw"], x, input_lengths,
                                   cfg.zoneout_rate, None if rand is None else rand.enc_fw,
                                   None if rand is None else rand.enc_bw)
    return memory * input_mask(input_lengths, inputs.shape[1])[..., None], new_convs


class DecoderCarry(NamedTuple):
    c1: torch.Tensor
    h1: torch.Tensor
    c2: torch.Tensor
    h2: torch.Tensor
    att: ATT.AttentionState


def init_decoder_carry(cfg: TacotronModelConfig, batch: int, mem_len: int, value_dim: int, device=None):
    u = cfg.decoder_lstm_units
    z = lambda: torch.zeros(batch, u, device=device)
    return DecoderCarry(z(), z(), z(), z(), ATT.init_state(cfg, batch, mem_len, value_dim, device))


def projections(params: Params, proj_in: torch.Tensor):
    """The frame and stop projections as one dense over [out2, context]
    -> (frames [..., 80r], stops [..., r])."""
    w = torch.cat([params["frame_projection"]["w"], params["stop_projection"]["w"]], dim=1)
    b = torch.cat([params["frame_projection"]["b"], params["stop_projection"]["b"]])
    out = proj_in @ w + b
    n_frame = params["frame_projection"]["w"].shape[1]
    return out[..., :n_frame], out[..., n_frame:]


def decoder_step(
    params: Params,
    cfg: TacotronModelConfig,
    prev_frame: torch.Tensor | None,  # [B, M]; unused when ``pre`` is given
    carry: DecoderCarry,
    keys: torch.Tensor,
    values: torch.Tensor,
    mem_mask: torch.Tensor,
    prenet_masks=None,
    w_comb=None,
    b_comb=None,
    *,
    train: bool = False,
    zoneout_masks=None,
    att_mask=None,
    pre: torch.Tensor | None = None,
    project: bool = True,
):
    """One decoder step (reference Architecture_wrappers.py:175-218, JAX
    ``decoder_step``): prenet -> concat(context) -> 2x zoneout LSTM ->
    attention of ``cfg.attention_mode`` -> projections.  Returns (frames
    [B, 80r], stops [B, r], align [B, T_in], new carry).

    ``train`` selects the attention's training behaviour; ``zoneout_masks``
    ((cell, hidden) of LSTM1, (cell, hidden) of LSTM2) select train-mode
    zoneout, None the eval-mode EMA; ``att_mask`` is GMM's dropout
    keep-mask.  ``pre`` is the step's prenet output computed outside the
    loop (full teacher forcing), and ``project=False`` returns (out2,
    context, align, carry) for projections batched after the loop."""
    if pre is None:
        pre = L.prenet(params["prenet"], prev_frame, cfg.dropout_rate, masks=prenet_masks)
    z1, z2 = (None, None) if zoneout_masks is None else zoneout_masks
    x = torch.cat([pre, carry.att.context], dim=-1)
    c1, h1, out1 = L.zoneout_lstm_step(params["dec_lstm1"], x, carry.c1, carry.h1, cfg.zoneout_rate, masks=z1)
    c2, h2, out2 = L.zoneout_lstm_step(params["dec_lstm2"], out1, carry.c2, carry.h2, cfg.zoneout_rate,
                                       masks=z2)
    context, align, att_state = ATT.step(
        params["attention"], cfg, out2, carry.att, keys, values, mem_mask, w_comb, b_comb,
        train=train, drop_mask=att_mask,
    )
    new_carry = DecoderCarry(c1, h1, c2, h2, att_state)
    if not project:
        return out2, context, align, new_carry
    frames, stops = projections(params, torch.cat([out2, context], dim=-1))
    return frames, stops, align, new_carry


def decode_autoregressive(
    params: Params,
    cfg: TacotronModelConfig,
    memory: torch.Tensor,
    mem_mask: torch.Tensor,
    seeds,
    max_iters: int | None = None,
):
    """Dynamic-stop decode of at most T = max_iters steps -> (frames
    [B, T*r, 80], stops [B, T*r], aligns [B, T, T_in], stop_len [B] in
    frames).  CUDA tensors run the decode kernel, CPU tensors its plain
    version."""
    T = max_iters if max_iters is not None else cfg.max_iters
    return DK.decode_autoregressive_kernel(params, cfg, memory, mem_mask, seeds, T)


def apply_postnet(params: Params, cfg: TacotronModelConfig, frames: torch.Tensor) -> torch.Tensor:
    """5x tanh convs (last linear) + residual projection
    (reference modules.py:345-376, tacotron.py:115-122)."""
    acts = [torch.tanh] * (cfg.postnet_layers - 1) + [None]
    x = L.conv_stack(params["postnet"], frames, activations=acts)
    return frames + L.dense(params["postnet_projection"], x)


def apply_postnet_train(params: Params, cfg: TacotronModelConfig, frames: torch.Tensor, masks):
    """Train-mode postnet (BN batch statistics, dropout keep-masks per
    layer) -> (mels, postnet params with the updated BN statistics)."""
    acts = [torch.tanh] * (cfg.postnet_layers - 1) + [None]
    x, new_p = L.conv_stack_train(params["postnet"], frames, cfg.dropout_rate, masks, activations=acts)
    return frames + L.dense(params["postnet_projection"], x), new_p


def apply_cbhg(params: Params, cfg: TacotronModelConfig, x: torch.Tensor) -> torch.Tensor:
    """The CBHG mel->linear head in eval mode (BN moving statistics):
    mels [B, T, 80] -> linear [B, T, 1025]."""
    return _cbhg(params, cfg, x, False)[0]


def apply_cbhg_train(params: Params, cfg: TacotronModelConfig, x: torch.Tensor):
    """The head in train mode (BN batch statistics over every frame,
    padding included) -> (linear, ``cbhg`` params with the updated BN
    statistics of the bank and both projections)."""
    return _cbhg(params, cfg, x, True)


def _cbhg(params, cfg, x, train: bool):
    """JAX ``apply_cbhg``: the bank of ReLU convolutions of widths 1..K,
    each then BN; concatenated; max-pool (SAME, stride 1); ReLU(proj1)
    then BN; proj2 then BN; the residual + x; the highway input projection
    and the highways; a BiGRU whose backward direction reverses the whole
    time axis, padding included (the reference passes no input lengths to
    the post-CBHG); the linear projection."""
    p = params["cbhg"]
    bn = L.batchnorm_train if train else (lambda q, y: (L.batchnorm(q, y), q))
    outs, new_bank = [], []
    for lp in p["bank"]:
        y, nb = bn(lp["bn"], torch.relu(L.conv1d(lp["conv"], x)))
        outs.append(y)
        new_bank.append(dict(lp, bn=nb))
    y = L.max_pool_same(torch.cat(outs, dim=-1), cfg.cbhg_pool_size)
    y, nbn1 = bn(p["proj1"]["bn"], torch.relu(L.conv1d(p["proj1"]["conv"], y)))
    y, nbn2 = bn(p["proj2"]["bn"], L.conv1d(p["proj2"]["conv"], y))
    y = L.dense(p["highway_in"], y + x)
    for hp in p["highways"]:
        y = L.highway(hp, y)
    fw = L.gru_scan(p["gru_fw"], y)
    bw = torch.flip(L.gru_scan(p["gru_bw"], torch.flip(y, dims=[1])), dims=[1])
    linear = L.dense(params["linear_projection"], torch.cat([fw, bw], dim=-1))
    new_p = dict(p, bank=new_bank, proj1=dict(p["proj1"], bn=nbn1), proj2=dict(p["proj2"], bn=nbn2))
    return linear, new_p


def _clip_mel(x: torch.Tensor, cfg: TacotronModelConfig) -> torch.Tensor:
    """Output clipping (reference tacotron.py:111-112,119-122)."""
    if not cfg.clip_outputs:
        return x
    return torch.clamp(x, -4.0 - cfg.lower_bound_decay, 4.0)


def forward_inference(
    params: Params,
    cfg: TacotronModelConfig,
    inputs: torch.Tensor,
    input_lengths: torch.Tensor,
    seeds,
    max_iters: int | None = None,
) -> TacotronOutput:
    """Autoregressive inference, in full f32 (``P.fp32_precision``: no
    TF32 in cuDNN's convolutions and GRUs).  ``seeds`` [B]: row b's prenet
    dropout depends only on seeds[b], so a row decodes the same alone or
    batched.  With ``predict_linear`` the CBHG head runs on the clipped
    postnet output (``linear_outputs``)."""
    with P.fp32_precision():
        with span("tacotron.encoder", device=True):
            memory = encode(params, cfg, inputs, input_lengths)
            mem_mask = input_mask(input_lengths, inputs.shape[1])
        T = max_iters if max_iters is not None else cfg.max_iters
        with decoder_span("k2", cfg, int(inputs.shape[0]), T, int(inputs.shape[1])):
            frames, stops, aligns, stop_len = decode_autoregressive(params, cfg, memory, mem_mask, seeds, T)
        with span("tacotron.postnet", device=True):
            frames = _clip_mel(frames, cfg)
            mel_out = _clip_mel(apply_postnet(params, cfg, frames), cfg)
            linear = apply_cbhg(params, cfg, mel_out) if cfg.predict_linear else None
    return TacotronOutput(frames, mel_out, stops, aligns, stop_len, linear)


# ---------------------------------------------------------------------------
# training: teacher-forced forward and loss
# ---------------------------------------------------------------------------


def core_route(cfg: TacotronModelConfig, train: bool, teacher_forcing_ratio) -> str:
    """Which route a teacher-forced decode takes: "kernel" for forward
    attention without smoothing under full teacher forcing, in training or
    at eval without anti-repeat (the configurations K3/K4 compute, as the
    JAX package's trainer kernel does); "eager" for every other
    configuration, on every device (the JAX package's XLA scan).  K3 has no
    anti-repeat branch, so an eval decode with anti-repeat (GTA, the eval
    renders) takes the eager route; training ignores anti-repeat."""
    if (full_teacher_forcing(teacher_forcing_ratio) and cfg.attention_mode == "forward"
            and not cfg.smoothing and (train or not cfg.anti_repeat)):
        return "kernel"
    return "eager"


def _decoder_core(params, cfg, pre_all, masks, keys, memory, mem_mask, fused_decoder: str):
    """The kernel route's core: on the card only K3/K4 run it (any batch
    size the shape envelope takes); on the CPU "off" is the eager loop,
    anything else the same autograd Function with the kernels' plain
    versions."""
    B, T_in = memory.shape[0], memory.shape[1]
    if memory.device.type == "cuda":
        if fused_decoder == "off":
            raise NotImplementedError(
                "fused_decoder='off' is the kernels' plain version: on the card forward attention "
                "under full teacher forcing runs only through K3/K4 (ROADMAP.md, queue item 5)"
            )
        if not TK.train_supported(cfg):
            raise NotImplementedError(
                "the trainer kernels take two prenet layers and widths that are multiples of 4 "
                "(ROADMAP.md, queue item 5)"
            )
        clusters = TK.card_clusters(memory.device)
        if not TK.train_supported_shape(B, T_in, cfg, clusters):
            raise NotImplementedError(
                f"B={B}, T_in={T_in} is beyond the trainer kernels' envelope (T_in <= "
                f"{TK.max_t_in(B, TK.widths(cfg), clusters)} at this batch) (ROADMAP.md, queue item 5)"
            )
    if memory.device.type == "cpu" and fused_decoder == "off":
        return TK.fused_core_plain(params, cfg, pre_all, masks, keys, memory, mem_mask)
    return TK.fused_core_apply(params, cfg, pre_all, masks, keys, memory, mem_mask)


def _eager_decode(params, cfg, keys, memory, mem_mask, dec_inputs_t, train: bool, rand: TrainRand, use_gt):
    """The eager route: a loop over ``decoder_step`` (JAX
    ``decode_teacher_forced``'s scan bodies) -> (frames [T, B, 80r], stops
    [T, B, r], aligns [T, B, T_in]).  Under full teacher forcing
    (``use_gt`` None) the prenet runs batched before the loop and the
    projections after it; under scheduled sampling each step feeds a row
    its ground-truth frame where ``use_gt`` is set, else the last frame
    the model predicted at the step before (not detached: gradients flow
    through the model's own predictions, as in the JAX package), and the
    prenet and the projections run inside the step.  Under full teacher
    forcing on the card (``DG.usable``) the loop replays captured CUDA
    graphs (``DG.decode``)."""
    T, B, M = dec_inputs_t.shape
    carry = init_decoder_carry(cfg, B, memory.shape[1], memory.shape[2], memory.device)
    att = params["attention"]
    w_comb = b_comb = None
    if "location_conv" in att:  # hoisted out of the loop
        w_comb, b_comb = ATT.combined_location_weights(att)
    zone = None
    if train and cfg.zoneout_rate > 0.0:
        zone = lambda t: ((rand.z1[0][t], rand.z1[1][t]), (rand.z2[0][t], rand.z2[1][t]))
    step = lambda t, carry, frame=None, prenet_masks=None, **kw: decoder_step(
        params, cfg, frame, carry, keys, memory, mem_mask, prenet_masks, w_comb, b_comb, train=train,
        zoneout_masks=None if zone is None else zone(t),
        att_mask=None if rand.att is None or not train else rand.att[t], **kw)
    outs = []
    if use_gt is None:
        pre_all = L.prenet(params["prenet"], dec_inputs_t, cfg.dropout_rate, masks=rand.pre)
        if DG.usable(memory):
            out2, ctx, aligns = DG.decode(params, cfg, train, pre_all, None if zone is None else rand.z1 + rand.z2,
                                          None if rand.att is None or not train else rand.att, keys, memory,
                                          mem_mask, w_comb, b_comb)
        else:
            for t in range(T):
                out2, ctx, align, carry = step(t, carry, pre=pre_all[t], project=False)
                outs.append((out2, ctx, align))
            out2, ctx, aligns = (torch.stack(v) for v in zip(*outs))
        frames, stops = projections(params, torch.cat([out2, ctx], dim=-1))
        return frames, stops, aligns
    prev = dec_inputs_t.new_zeros(B, M)
    for t in range(T):
        frame_in = torch.where(use_gt[t], dec_inputs_t[t], prev)
        masks = None if rand.pre is None else tuple(m[t] for m in rand.pre)
        frames, stops, align, carry = step(t, carry, frame_in, masks)
        outs.append((frames, stops, align))
        prev = frames[:, -M:]
    return tuple(torch.stack(v) for v in zip(*outs))


def decode_teacher_forced(
    params: Params,
    cfg: TacotronModelConfig,
    memory: torch.Tensor,
    mem_mask: torch.Tensor,
    mel_targets: torch.Tensor,  # [B, T_out, M], T_out divisible by r
    train: bool,
    rand: TrainRand,
    teacher_forcing_ratio: float = 1.0,
    fused_decoder: str = "auto",
):
    """Teacher-forced decode (reference helpers.py:136-142): each step's
    input is the ground-truth frame, or under scheduled sampling (ratio
    < 1, ``rand.use_gt``) the model's own previous frame where the draw
    says so.  The route is ``core_route``'s: the kernel route batches the
    prenet before the core (K3/K4 on the card) and the projections after
    it; the eager route loops over ``decoder_step``.  Returns (frames
    [B, T_out, M], stops [B, T_out], alignments [B, T_dec, T_in])."""
    B, T_out, M = mel_targets.shape
    r = cfg.outputs_per_step
    keys = ATT.precompute_keys(params["attention"], cfg, memory)
    # <GO> zero frame, then the target frames strided by r, shifted one step
    strided = mel_targets[:, r - 1::r, :]
    dec_inputs = torch.cat([mel_targets.new_zeros(B, 1, M), strided[:, :-1, :]], dim=1)
    dec_inputs_t = dec_inputs.transpose(0, 1)
    if core_route(cfg, train, teacher_forcing_ratio) == "kernel":
        pre_all = L.prenet(params["prenet"], dec_inputs_t, cfg.dropout_rate, masks=rand.pre)
        masks = None
        if train and cfg.zoneout_rate > 0.0:
            masks = (rand.z1[0], rand.z1[1], rand.z2[0], rand.z2[1])
        out2, ctx, aligns = _decoder_core(params, cfg, pre_all, masks, keys, memory, mem_mask, fused_decoder)
        frames, stops = projections(params, torch.cat([out2, ctx], dim=-1))  # [T, B, ...]
    else:
        use_gt = None  # full teacher forcing ignores any scheduled-sampling draws
        if not full_teacher_forcing(teacher_forcing_ratio):
            use_gt = rand.use_gt
            if use_gt is None:
                raise ValueError(f"teacher_forcing_ratio={teacher_forcing_ratio} needs rand.use_gt "
                                 "(draw_train_rand draws it)")
        frames, stops, aligns = _eager_decode(params, cfg, keys, memory, mem_mask, dec_inputs_t, train, rand,
                                              use_gt)
    frames = frames.transpose(0, 1).reshape(B, T_out, M)
    stops = stops.transpose(0, 1).reshape(B, T_out)
    return frames, stops, aligns.transpose(0, 1)


def forward_teacher_forced(
    params: Params,
    cfg: TacotronModelConfig,
    inputs: torch.Tensor,
    input_lengths: torch.Tensor,
    mel_targets: torch.Tensor,
    train: bool,
    rand: TrainRand | None = None,
    generator: torch.Generator | None = None,
    teacher_forcing_ratio: float = 1.0,
    fused_decoder: str = "auto",
):
    """Teacher-forced forward -> (TacotronOutput, params with the updated
    BN statistics; eval mode returns them unchanged).  The masks (and the
    scheduled-sampling draws when ``teacher_forcing_ratio`` < 1) come from
    ``rand``, else are drawn from ``generator`` (required then).  With
    ``predict_linear`` the CBHG head runs on the clipped postnet output, in
    train mode when ``train`` (its BN statistics updated)."""
    if rand is None:
        if generator is None:
            raise ValueError("forward_teacher_forced needs rand or a torch.Generator")
        rand = draw_train_rand(params, cfg, inputs.shape[0], inputs.shape[1], mel_targets.shape[1],
                               generator, train, teacher_forcing_ratio)
    with span("tacotron.encoder", device=True):
        if train:
            memory, new_convs = encode_train(params, cfg, inputs, input_lengths, rand)
        else:
            memory, new_convs = encode(params, cfg, inputs, input_lengths), params["enc_convs"]
        mem_mask = input_mask(input_lengths, inputs.shape[1])
    route = core_route(cfg, train, teacher_forcing_ratio)
    graphed = route == "eager" and full_teacher_forcing(teacher_forcing_ratio) and DG.usable(memory)
    with decoder_span(route, cfg, int(inputs.shape[0]), mel_targets.shape[1] // cfg.outputs_per_step,
                      int(inputs.shape[1]), graphed):
        frames, stops, aligns = decode_teacher_forced(
            params, cfg, memory, mem_mask, mel_targets, train, rand, teacher_forcing_ratio, fused_decoder,
        )
    with span("tacotron.postnet", device=True):
        frames = _clip_mel(frames, cfg)
        if train:
            mel_out, new_post = apply_postnet_train(params, cfg, frames, rand.post_drop)
        else:
            mel_out, new_post = apply_postnet(params, cfg, frames), params["postnet"]
        mel_out = _clip_mel(mel_out, cfg)
        new_params = dict(params, enc_convs=new_convs, postnet=new_post)
        linear = None
        if cfg.predict_linear:
            if train:
                linear, new_params["cbhg"] = apply_cbhg_train(params, cfg, mel_out)
            else:
                linear = apply_cbhg(params, cfg, mel_out)
    return TacotronOutput(frames, mel_out, stops, aligns, None, linear), new_params


def tacotron_loss(
    out: TacotronOutput,
    mel_targets: torch.Tensor,
    stop_targets: torch.Tensor,
    target_lengths: torch.Tensor,
    params: Params,
    cfg: TacotronModelConfig,
    reg_weight: float = 1e-6,
    mask_decoder: bool = False,
    stop_pos_weight: float = 1.0,
    linear_targets: torch.Tensor | None = None,
    sample_rate: int = 22050,
    loss_frames: torch.Tensor | None = None,
):
    """before/after MSE + stop cross-entropy + L2 (reference
    tacotron.py:195-253) -> (loss, aux dict).  ``mask_decoder`` takes the
    masked variants (modules.py:403-485, the only branch that weights the
    positive stop class); ``loss_frames`` [B] drops the frames past each
    batch's reference length (bucket padding).

    With ``linear_targets`` [B, T, F] and the head's ``linear_outputs``,
    the linear L1 term (half over every bin, half over the bins below 2
    kHz, ``int(2000 / (sample_rate / 2) * F)``) is added as ``aux["linear"]``,
    with the JAX package's quirks: under ``mask_decoder`` both halves
    divide by the full-band ``sum(mask) * F`` (modules.py:457-485); under
    ``loss_frames`` the low-band half divides by ``n * n_priority``.

    Inside a data-parallel step (``train.tacotron_task.compute_grads``
    with a mesh) the batch is this rank's rows and the loss its share of
    the global batch's: every count in a denominator is summed over the
    ranks, the means and the L2 term divide by the rank count, and the
    shares sum to the one-process loss."""
    T = mel_targets.shape[1]
    shards = PM.batch_shards()
    ar = torch.arange(T, device=mel_targets.device)[None, :]
    M = mel_targets.shape[-1]
    if mask_decoder:
        m3 = (ar < target_lengths[:, None]).to(torch.float32)[..., None]
        denom = PM.batch_sum(torch.sum(m3)) * M
        before = torch.sum(((out.decoder_output - mel_targets) ** 2) * m3) / denom
        after = torch.sum(((out.mel_outputs - mel_targets) ** 2) * m3) / denom
        ce = _weighted_sigmoid_ce(stop_targets, out.stop_logits, stop_pos_weight) * m3[..., 0]
        stop_loss = torch.sum(ce) / torch.clamp_min(PM.batch_sum(torch.sum((ce != 0).to(torch.float32))), 1.0)
    elif loss_frames is None:
        before = torch.mean((out.decoder_output - mel_targets) ** 2) / shards
        after = torch.mean((out.mel_outputs - mel_targets) ** 2) / shards
        stop_loss = torch.mean(_weighted_sigmoid_ce(stop_targets, out.stop_logits, 1.0)) / shards
    else:
        fmask = (ar < loss_frames[:, None]).to(torch.float32)
        n = torch.clamp_min(PM.batch_sum(torch.sum(fmask)), 1.0)
        f3 = fmask[..., None]
        before = torch.sum(((out.decoder_output - mel_targets) ** 2) * f3) / (n * M)
        after = torch.sum(((out.mel_outputs - mel_targets) ** 2) * f3) / (n * M)
        stop_loss = torch.sum(_weighted_sigmoid_ce(stop_targets, out.stop_logits, 1.0) * fmask) / n
    reg = reg_weight * l2_regularizables(params) / shards
    loss = before + after + stop_loss + reg
    aux = {"before": before, "after": after, "stop": stop_loss, "reg": reg}
    if linear_targets is not None and out.linear_outputs is not None:
        l1 = torch.abs(linear_targets - out.linear_outputs)
        Fq = linear_targets.shape[-1]
        n_priority = int(2000 / (sample_rate * 0.5) * Fq)
        if mask_decoder:
            m3 = (ar < target_lengths[:, None]).to(torch.float32)[..., None]
            denom = PM.batch_sum(torch.sum(m3)) * Fq
            linear_loss = 0.5 * torch.sum(l1 * m3) / denom + 0.5 * torch.sum((l1 * m3)[:, :, :n_priority]) / denom
        elif loss_frames is None:
            linear_loss = (0.5 * torch.mean(l1) + 0.5 * torch.mean(l1[:, :, :n_priority])) / shards
        else:
            f3 = (ar < loss_frames[:, None]).to(torch.float32)[..., None]
            n = torch.clamp_min(PM.batch_sum(torch.sum(f3)), 1.0)
            linear_loss = (0.5 * torch.sum(l1 * f3) / (n * Fq)
                           + 0.5 * torch.sum((l1 * f3)[:, :, :n_priority]) / (n * n_priority))
        loss = loss + linear_loss
        aux["linear"] = linear_loss
    aux["loss"] = loss
    return loss, aux


def _weighted_sigmoid_ce(targets, logits, pos_weight: float):
    """tf.nn.weighted_cross_entropy_with_logits."""
    log_w = 1.0 + (pos_weight - 1.0) * targets
    return (1.0 - targets) * logits + log_w * (
        torch.log1p(torch.exp(-torch.abs(logits))) + torch.relu(-logits)
    )


_L2_SKIP_TOP = {
    "embedding", "enc_lstm_fw", "enc_lstm_bw", "dec_lstm1", "dec_lstm2",
    "frame_projection", "stop_projection", "postnet_projection", "linear_projection",
}


def l2_regularizables(params: Params) -> torch.Tensor:
    """Sum of 0.5*||w||^2 over the regularized weights (reference
    tacotron.py:246-248): no biases, LSTM/GRU kernels, embeddings or
    projection layers; BN scale/bias are in, the BN moving statistics out."""
    total = 0.0

    def walk(tree, path):
        nonlocal total
        if isinstance(tree, dict):
            for k, v in tree.items():
                walk(v, path + (k,))
        elif isinstance(tree, (list, tuple)):
            for i, v in enumerate(tree):
                walk(v, path + (str(i),))
        else:
            if path[0] in _L2_SKIP_TOP:
                return
            name = path[-1]
            if "bn" in path:
                if name in ("mean", "var"):
                    return
            elif name in ("b", "bias", "v", "bi", "bh") or any("gru" in c for c in path):
                return
            total = total + 0.5 * torch.sum(tree ** 2)

    walk(params, ())
    return total
