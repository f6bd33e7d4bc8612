"""The Tacotron-2 encoder's bidirectional zoneout LSTM: two CUDA kernels
joined by a ``torch.autograd.Function``, and their plain versions.

* ``encoder_fwd`` (K5, csrc/tacotron_encoder.cu) runs the whole recurrence
  of both directions in one launch, from ``zx = x @ W_x + b`` (one
  ``torch.matmul`` over every step before it), and writes the raw new_h of
  every step at its position, plus, when a backward follows, the saves of
  ``SAVES``.
* ``encoder_bwd`` (K6) runs the reverse-time adjoint in one launch and
  writes dz, the gate pre-activations' cotangents of every step and
  direction.  ``encoder_grads`` turns dz into the gradients of x, W_x, W_h
  and b with four products over all steps and rows.
* ``EncoderLSTM`` is the autograd Function over the two and
  ``bidirectional_lstm`` the entry point; on a CUDA tensor it launches the
  kernels, on a CPU tensor it runs ``encoder_fwd_plain`` and
  ``encoder_bwd_plain``, the same recurrences in torch.
  ``bidirectional_lstm_plain`` is the same function from the plain forward
  differentiated by autograd (the reference the kernels are held against
  on the card).

What is computed (the JAX package's ``unidir_lstm`` in both directions, as
tf.nn.bidirectional_dynamic_rnn): TF LSTMCell gates (order i, j, f, o,
forget bias +1), zoneout on the carried state only (train mode: the
keep-masks of ``TrainRand.enc_fw`` / ``enc_bw``, [T, B, U], indexed by loop
step; eval mode: the EMA at the rate), the raw new_h as the output.  The
backward direction runs each row over its own length in reversed order.
A row stops at its own length and its outputs past it are zero; the
caller's multiply by the input mask made them zero before, so values and
gradients are the same at every position.

Layouts: zx and dz [B, T, 2, 4U] (direction, then gate, then unit); the
output and the per-unit saves [B, T, 2U]; W_h of both directions [2, U, 4U].

The grid (csrc/tacotron_encoder.cu): one cluster of ``CLUSTER`` blocks per
(direction, group of rows); rank q owns the units [q*ub, (q+1)*ub) and
keeps their gate columns of W_h in shared memory.  ``enc_plan`` is that
plan term for term; the wrappers compare it with the library before every
launch.  The clusters never wait on each other, so the plan spreads the
rows over as many groups as both directions can keep resident
(``card_clusters``).  Envelope (``fits``): a block's shared memory, U <= 296
at eight rows a group (B = 32 on the H100); beyond it the wrappers raise.
"""

from __future__ import annotations

import ctypes
import dataclasses

import torch

from ..utils import device_index
from ..utils import metrics as M
from . import LAUNCHES, check_launch, load, require_f32_contiguous, stream_ptr

THREADS = 512  # block size of both kernels
CLUSTER = 8  # blocks of a cluster
RMAX = 8  # rows of a group (the kernels' register tiles)
SMEM_LIMIT = 232448  # opt-in dynamic shared memory of one block on sm_90
SOURCE = "tacotron_encoder.cu"

# what K5 saves for K6, each [B, T, ...] at the row's positions: the gate
# activations (si, tj, sf, so) [.., 2, 4U]; new_c, and c and h before the
# step [.., 2U]
SAVES = ("acts", "nc", "cp", "hp")


def _up4(n: int) -> int:
    return (n + 3) & ~3


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


@dataclasses.dataclass(frozen=True)
class EncPlan:
    """The grid of both encoder kernels (``en_plan``/``en_layout`` in the
    .cu file): 2 x ``groups`` clusters of CLUSTER blocks; cluster 2g + d
    runs direction d over the rows [g*rows, (g+1)*rows); rank q owns the
    units [q*ub, (q+1)*ub).  K5 splits its product over ``ks`` K slices of
    ``kc`` units, each thread two of the block's ``ncol`` gate columns."""

    B: int
    U: int
    clusters: int
    rows: int
    groups: int
    r4: int
    ub: int
    ncol: int
    ldw: int
    np: int
    ks: int
    kc: int

    def units(self, q: int) -> range:
        lo = min(q * self.ub, self.U)
        return range(lo, min(lo + self.ub, self.U))

    def columns(self, q: int) -> list:
        """The W_h columns rank q keeps, in its shared-memory order (gate g
        of its unit j at column g*ub + j)."""
        return [g * self.U + u for g in range(4) for u in self.units(q)]

    def group_rows(self, g: int) -> range:
        lo = min(g * self.rows, self.B)
        return range(lo, min(lo + self.rows, self.B))

    def k_slice(self, s: int) -> range:
        lo = min(s * self.kc, self.U)
        return range(lo, min(lo + self.kc, self.U))

    def smem_floats(self, kind: str) -> int:
        """Shared-memory floats of one block (``en_layout``, term for term)."""
        w = self.U * self.ldw
        if kind == "fwd":
            return w + 2 * self.U * self.r4 + self.ks * self.r4 * self.ncol
        if kind == "bwd":
            return w + self.ncol * self.r4 + 2 * CLUSTER * self.ub * self.r4
        raise ValueError(kind)

    def smem_bytes(self, kind: str) -> int:
        return 4 * self.smem_floats(kind)

    def fits(self) -> bool:
        """Whether both kernels launch (``en_fits``)."""
        return (self.B >= 1 and self.U >= 1 and self.ks >= 1 and self.r4 <= RMAX
                and self.rows * self.ub <= THREADS
                and max(self.smem_bytes("fwd"), self.smem_bytes("bwd")) <= SMEM_LIMIT)


def enc_plan(batch: int, units: int, clusters: int) -> EncPlan:
    """The plan at ``batch`` rows and ``units`` per direction on a card
    that keeps ``clusters`` clusters resident: rows a group the multiple of
    four (at most RMAX, at most the batch) that spreads the batch over
    ``clusters // 2`` groups a direction."""
    per_dir = max(clusters // 2, 1)
    rows = min(_up4(_cdiv(batch, per_dir)), RMAX, batch)
    rows = max(rows, 1)
    ub = _cdiv(units, CLUSTER)
    ncol = 4 * ub
    np_ = ncol // 2
    ks = THREADS // np_ if np_ else 0
    return EncPlan(batch, units, clusters, rows, _cdiv(batch, rows), _up4(rows), ub, ncol, ncol + 8, np_, ks,
                   _cdiv(units, ks) if ks else 0)


def max_units(batch: int, clusters: int) -> int:
    """The widest LSTM (units per direction) both kernels take at this
    batch size."""
    u = 1
    while enc_plan(batch, u + 1, clusters).fits():
        u += 1
    return u


def launch_plan(batch: int, units: int, clusters: int) -> EncPlan:
    """The plan of a launch; NotImplementedError beyond the envelope."""
    plan = enc_plan(batch, units, clusters)
    if not plan.fits():
        raise NotImplementedError(
            f"encoder_lstm_units={units} at B={batch} is beyond the encoder kernels' envelope: a block keeps "
            f"its units' gate columns of W_h in shared memory, which holds U <= {max_units(batch, clusters)} "
            f"at this batch"
        )
    return plan


_CLUSTERS: dict = {}


def card_clusters(device: torch.device) -> int:
    """Clusters of CLUSTER blocks the card keeps resident at once (one
    block per SM), asked of the card once per device."""
    key = device_index(device)
    if key not in _CLUSTERS:
        with torch.cuda.device(key):
            n = load(SOURCE).tacotron_encoder_clusters()
        if n <= 0:
            raise RuntimeError(f"the encoder kernels cannot keep a cluster resident (cudaError {-n})")
        _CLUSTERS[key] = n
    return _CLUSTERS[key]


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------




def _swap_bw(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """[B, T, 2, w]: the backward direction's steps between loop and
    position order (either way)."""
    bw = torch.gather(x[:, :, 1], 1, idx[..., None].expand(-1, -1, x.shape[-1]))
    return torch.stack([x[:, :, 0], bw], dim=2)


def _plain_setup(lengths: torch.Tensor, T: int, device):
    """([B, T] position the backward direction visits at each loop step,
    [B, T] whether the step is within the row's length).  The position is
    length - 1 - s within the length and s past it (tf.reverse_sequence),
    a map that is its own inverse."""
    lengths = lengths.to(device).long().clamp(0, T)
    ar = torch.arange(T, device=device)[None, :]
    idx = lengths[:, None] - 1 - ar
    return torch.where(idx >= 0, idx, ar), ar < lengths[:, None]


def _mask_pairs(masks):
    """(cell, hidden) keep-masks of both directions, [T, B, 2, U] each."""
    return tuple(torch.stack([masks[i], masks[i + 2]], dim=2) for i in (0, 1))


def encoder_fwd_plain(zx, wh, lengths, masks, zoneout: float, save: bool):
    """Plain version of K5: (out [B, T, 2U], saves or None).  ``zx`` [B, T,
    2*4U] the input half with the bias, ``wh`` [2, U, 4U], ``masks`` (fw
    cell, fw hidden, bw cell, bw hidden) bool [T, B, U] or None (eval-mode
    EMA at ``zoneout``).  Every output and save is zero past a row's
    length."""
    B, T, G = zx.shape
    U = G // 8
    idx, active = _plain_setup(lengths, T, zx.device)
    zl = _swap_bw(zx.view(B, T, 2, 4 * U), idx)
    mk = None if masks is None else _mask_pairs(masks)
    c = zx.new_zeros(B, 2, U)
    h = zx.new_zeros(B, 2, U)
    rec = {k: [] for k in ("out", *SAVES)}
    for s in range(T):
        z = zl[:, s] + torch.einsum("bdk,dkg->bdg", h, wh)
        si = torch.sigmoid(z[..., :U])
        tj = torch.tanh(z[..., U:2 * U])
        sf = torch.sigmoid(z[..., 2 * U:3 * U] + 1.0)
        so = torch.sigmoid(z[..., 3 * U:])
        nc = sf * c + si * tj
        nh = so * torch.tanh(nc)
        if mk is not None:
            cn = torch.where(mk[0][s], nc - c, torch.zeros_like(nc)) + c
            hn = torch.where(mk[1][s], nh - h, torch.zeros_like(nh)) + h
        else:
            cn = (1.0 - zoneout) * nc + zoneout * c
            hn = (1.0 - zoneout) * nh + zoneout * h
        rec["out"].append(nh)
        if save:
            rec["acts"].append(torch.cat([si, tj, sf, so], dim=-1))
            rec["nc"].append(nc)
            rec["cp"].append(c)
            rec["hp"].append(h)
        c, h = cn, hn

    def position_order(steps):
        x = _swap_bw(torch.stack(steps, dim=1), idx)
        x = torch.where(active[:, :, None, None], x, torch.zeros_like(x))
        return x.reshape(B, T, -1)

    return position_order(rec["out"]), ({k: position_order(rec[k]) for k in SAVES} if save else None)


def encoder_bwd_plain(wh, lengths, masks, zoneout: float, saves: dict, gout):
    """Plain version of K6: the reverse-time adjoint of ``encoder_fwd_plain``
    on its saves.  ``gout`` [B, T, 2U] is the output's cotangent.  Returns
    dz [B, T, 2*4U] (zero past each length)."""
    B, T, U2 = gout.shape
    U = U2 // 2
    idx, active = _plain_setup(lengths, T, gout.device)
    loop = lambda x, w: _swap_bw(x.view(B, T, 2, w), idx)
    acts, nc_s, cp_s, g_s = loop(saves["acts"], 4 * U), loop(saves["nc"], U), loop(saves["cp"], U), loop(gout, U)
    mk = None if masks is None else _mask_pairs(masks)
    ah = gout.new_zeros(B, 2, U)
    ac = gout.new_zeros(B, 2, U)
    dz = gout.new_zeros(B, T, 2, 4 * U)
    for s in reversed(range(T)):
        a = active[:, s][:, None, None]
        si, tj, sf, so = torch.split(acts[:, s], U, dim=-1)
        nc, cprev = nc_s[:, s], cp_s[:, s]
        if mk is not None:
            kc, kh = mk[0][s].to(gout.dtype), mk[1][s].to(gout.dtype)
            zc, zh = 1.0 - kc, 1.0 - kh
        else:
            kc = kh = 1.0 - zoneout
            zc = zh = zoneout
        th = torch.tanh(nc)
        dnh = g_s[:, s] + kh * ah
        dnc = kc * ac + dnh * so * (1.0 - th * th)
        d = torch.cat([dnc * tj * si * (1.0 - si), dnc * si * (1.0 - tj * tj),
                       dnc * cprev * sf * (1.0 - sf), dnh * th * so * (1.0 - so)], dim=-1)
        d = torch.where(a, d, torch.zeros_like(d))
        ac = torch.where(a, zc * ac + dnc * sf, torch.zeros_like(ac))
        ah = torch.where(a, zh * ah, torch.zeros_like(ah)) + torch.einsum("bdg,dkg->bdk", d, wh)
        dz[:, s] = d
    return _swap_bw(dz, idx).reshape(B, T, 8 * U)


def encoder_grads(x, wx, wh, saves: dict, dz):
    """The products after K6: (dx [B, T, D], dW_x [D, 2*4U], db [2*4U],
    dW_h [2, U, 4U]) from dz [B, T, 2*4U] and the carried h before each step."""
    B, T, D = x.shape
    U = wh.shape[1]
    flat = dz.reshape(B * T, 8 * U)
    dx = (flat @ wx.t()).reshape(B, T, D)
    dwx = x.reshape(B * T, D).t() @ flat
    hp = saves["hp"].reshape(B * T, 2, U).transpose(0, 1)  # [2, BT, U]
    dwh = torch.bmm(hp.transpose(1, 2), flat.view(B * T, 2, 4 * U).transpose(0, 1))
    return dx, dwx, flat.sum(0), dwh


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------

# pointer-array slots, the .cu file's enum
_SLOTS = ("zx", "wh", "lens", "mfc", "mfh", "mbc", "mbh", "out", "acts", "nc", "cp", "hp", "gout", "dz")


def _ptrs(**tensors) -> ctypes.Array:
    return (ctypes.c_void_p * len(_SLOTS))(*[0 if tensors.get(k) is None else tensors[k].data_ptr()
                                             for k in _SLOTS])


def _cuda_plan(wh, lens32, masks, B: int, T: int, dev) -> EncPlan:
    """Checks the arguments of a launch and returns its plan; raises
    NotImplementedError for widths the kernels do not take."""
    U = wh.shape[1]
    plan = launch_plan(B, U, card_clusters(dev))
    require_f32_contiguous("W_h", wh, dev, (2, U, 4 * U))
    if lens32.device != dev or lens32.dtype != torch.int32 or tuple(lens32.shape) != (B,):
        raise ValueError(f"lengths must be int32 [{B}] on {dev}")
    if masks is not None:
        for i, m in enumerate(masks):
            if m.device != dev or m.dtype != torch.bool or not m.is_contiguous() or tuple(m.shape) != (T, B, U):
                raise ValueError(f"zoneout mask {i} must be a contiguous bool [{T}, {B}, {U}] on {dev}")
    lib = load(SOURCE)
    for kind, flag in (("fwd", 0), ("bwd", 1)):
        if lib.tacotron_encoder_smem_bytes(B, U, plan.clusters, flag) != plan.smem_bytes(kind):
            raise RuntimeError(f"enc_plan and csrc/{SOURCE} disagree on the {kind} kernel's layout")
    return plan


def encoder_fwd(zx, wh, lengths, masks, zoneout: float, save: bool):
    """K5.  CUDA: one launch; CPU: the plain version.  Returns (out [B, T,
    2U], saves or None) as ``encoder_fwd_plain``."""
    if zx.device.type == "cpu":
        return encoder_fwd_plain(zx, wh, lengths, masks, zoneout, save)
    if zx.device.type != "cuda":
        raise NotImplementedError(f"no encoder kernel for device {zx.device}")
    dev = zx.device
    B, T, G = zx.shape
    U = G // 8
    lens32 = lengths.to(device=dev, dtype=torch.int32).contiguous()
    require_f32_contiguous("zx", zx, dev, (B, T, 8 * U))
    z = lambda *shape: torch.zeros(shape, dtype=torch.float32, device=dev)
    e = lambda *shape: torch.empty(shape, dtype=torch.float32, device=dev)
    out = z(B, T, 2 * U)
    saves = {"acts": e(B, T, 8 * U), "nc": e(B, T, 2 * U), "cp": e(B, T, 2 * U), "hp": z(B, T, 2 * U)} if save else None
    if B == 0 or T == 0:
        return out, saves
    plan = _cuda_plan(wh, lens32, masks, B, T, dev)
    m = dict(zip(("mfc", "mfh", "mbc", "mbh"), masks)) if masks is not None else {}
    ptrs = _ptrs(zx=zx, wh=wh, lens=lens32, out=out, **m, **(saves or {}))
    with torch.cuda.device(dev):
        err = load(SOURCE).tacotron_encoder_fwd_launch(ptrs, B, T, U, plan.clusters, float(zoneout), stream_ptr(dev))
    LAUNCHES["tacotron_encoder_fwd"] += 1
    M.stamp("k5")
    check_launch(err, "tacotron_encoder_fwd")
    return out, saves


def encoder_bwd(wh, lengths, masks, zoneout: float, saves: dict, gout):
    """K6.  CUDA: one launch; CPU: the plain version.  Returns dz [B, T,
    2*4U] as ``encoder_bwd_plain``."""
    if gout.device.type == "cpu":
        return encoder_bwd_plain(wh, lengths, masks, zoneout, saves, gout)
    if gout.device.type != "cuda":
        raise NotImplementedError(f"no encoder kernel for device {gout.device}")
    dev = gout.device
    B, T, U2 = gout.shape
    U = U2 // 2
    dz = torch.zeros((B, T, 8 * U), dtype=torch.float32, device=dev)
    if B == 0 or T == 0:
        return dz
    lens32 = lengths.to(device=dev, dtype=torch.int32).contiguous()
    require_f32_contiguous("gout", gout, dev, (B, T, 2 * U))
    for k, w in zip(SAVES, (8, 2, 2, 2)):
        require_f32_contiguous(k, saves[k], dev, (B, T, w * U))
    plan = _cuda_plan(wh, lens32, masks, B, T, dev)
    m = dict(zip(("mfc", "mfh", "mbc", "mbh"), masks)) if masks is not None else {}
    ptrs = _ptrs(wh=wh, lens=lens32, gout=gout, dz=dz, **m, **saves)
    with torch.cuda.device(dev):
        err = load(SOURCE).tacotron_encoder_bwd_launch(ptrs, B, T, U, plan.clusters, float(zoneout), stream_ptr(dev))
    LAUNCHES["tacotron_encoder_bwd"] += 1
    M.stamp("k6")
    check_launch(err, "tacotron_encoder_bwd")
    return dz


class EncoderLSTM(torch.autograd.Function):
    """Forward: zx, then K5; backward: K6, then ``encoder_grads``.  Inputs
    after the non-differentiable (zoneout, masks, lengths): x [B, T, D] and
    the two directions' kernels [D + U, 4U] and biases [4U]."""

    @staticmethod
    def forward(ctx, zoneout, masks, lengths, x, w_fw, b_fw, w_bw, b_bw):
        D = x.shape[-1]
        wx = torch.cat([w_fw[:D], w_bw[:D]], dim=1)
        wh = torch.stack([w_fw[D:], w_bw[D:]]).contiguous()
        zx = torch.addmm(torch.cat([b_fw, b_bw]), x.reshape(-1, D), wx).view(*x.shape[:2], -1)
        save = any(ctx.needs_input_grad[3:])
        with M.span("k5", device=True):
            out, saves = encoder_fwd(zx, wh, lengths, masks, zoneout, save)
        m = list(masks) if masks is not None else []
        ctx.zoneout, ctx.n_masks = zoneout, len(m)
        if save:
            ctx.save_for_backward(x, wx, wh, lengths, *m, *[saves[k] for k in SAVES])
        return out

    @staticmethod
    def backward(ctx, g):
        x, wx, wh, lengths = ctx.saved_tensors[:4]
        k = 4 + ctx.n_masks
        masks = tuple(ctx.saved_tensors[4:k]) if ctx.n_masks else None
        saves = dict(zip(SAVES, ctx.saved_tensors[k:]))
        # autograd's device thread holds no span of the step: link to it
        with M.span("k6", device=True, parent=M.linked()):
            dz = encoder_bwd(wh, lengths, masks, ctx.zoneout, saves, g.contiguous())
        with M.span("train.encoder_grads", device=True, parent=M.linked()):
            dx, dwx, db, dwh = encoder_grads(x, wx, wh, saves, dz)
        G = wh.shape[2]
        return (None, None, None, dx, torch.cat([dwx[:, :G], dwh[0]]), db[:G],
                torch.cat([dwx[:, G:], dwh[1]]), db[G:])


def bidirectional_lstm(p_fw: dict, p_bw: dict, x, lengths, zoneout: float, masks_fw=None, masks_bw=None):
    """The encoder's BiLSTM over [B, T, D] -> [B, T, 2U] ([forward |
    backward] outputs, zero past each row's length), differentiable.
    ``p_fw``/``p_bw`` are the directions' {"w" [D + U, 4U], "b" [4U]};
    ``masks_fw``/``masks_bw`` their (cell, hidden) zoneout keep-masks
    [T, B, U] (train mode) or None (the eval-mode EMA).  CUDA tensors run
    K5/K6, CPU tensors their plain versions."""
    return EncoderLSTM.apply(float(zoneout), _masks(masks_fw, masks_bw, zoneout, x.device), lengths,
                             x.contiguous(), p_fw["w"], p_fw["b"], p_bw["w"], p_bw["b"])


def _masks(masks_fw, masks_bw, zoneout: float, device):
    """The four keep-masks as contiguous bool, or None in eval mode (or at
    rate 0, where zoneout is the identity)."""
    if masks_fw is None or zoneout <= 0.0:
        return None
    return tuple(m.to(device=device, dtype=torch.bool).contiguous() for m in (*masks_fw, *masks_bw))


def bidirectional_lstm_plain(p_fw: dict, p_bw: dict, x, lengths, zoneout: float, masks_fw=None, masks_bw=None):
    """``bidirectional_lstm`` from ``encoder_fwd_plain`` differentiated by
    autograd, on any device."""
    D = x.shape[-1]
    wx = torch.cat([p_fw["w"][:D], p_bw["w"][:D]], dim=1)
    wh = torch.stack([p_fw["w"][D:], p_bw["w"][D:]])
    zx = x @ wx + torch.cat([p_fw["b"], p_bw["b"]])
    return encoder_fwd_plain(zx, wh, lengths, _masks(masks_fw, masks_bw, zoneout, x.device), zoneout, False)[0]
