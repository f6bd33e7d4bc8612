"""Original (DeepMind-style) WaveRNN: coarse/fine dual-softmax, 16-bit.

The port of the JAX package's ``models/wavernn_deepmind.py``, the
counterpart of the reference's standalone alternative vocoder
(wavernn/models/deepmind_version.py:8-176): one GRU-like recurrence whose
R matmul is computed once and split across the (r, u, e) gates, with the
16-bit sample split into coarse (high 8 bits) and fine (low 8 bits) halves
predicted by two interleaved softmaxes; fine conditions on the
just-sampled coarse value within the same step.

Plain PyTorch on the params' device, as the JAX package runs it in XLA
(``lax.scan``, no Pallas kernel): training loops over T with the
full-rank ``h @ R``; generation splits R into coarse and fine halves per
gate (deepmind_version.py:60-83).  A categorical draw is the argmax of
the logits plus standard Gumbel noise (``jax.random.categorical``), so
``generate`` takes injected draws or makes them from a ``torch.Generator``.
"""

from __future__ import annotations

import torch

from ..utils.checkpoints import _Init
from . import layers as L

Params = dict


def init_deepmind_wavernn(seed: int, hidden: int = 896, device="cpu") -> Params:
    """Random params with the JAX init's tree and shapes (numpy draws from
    ``seed``)."""
    g = _Init(seed, device)
    half = hidden // 2
    return {
        "R": g.glorot((hidden, 3 * hidden)),  # recurrent kernel, gates (r, u, e)
        # the coarse half sees [c_{t-1}, f_{t-1}], the fine half also c_t
        "I_coarse": g.dense(2, 3 * half, bias=False),
        "I_fine": g.dense(3, 3 * half, bias=False),
        "bias_u": g.full((hidden,), 0.0),
        "bias_r": g.full((hidden,), 0.0),
        "bias_e": g.full((hidden,), 0.0),
        "O1": g.dense(half, half),
        "O2": g.dense(half, 256),
        "O3": g.dense(half, half),
        "O4": g.dense(half, 256),
    }


def _gates(params: Params, Rh: torch.Tensor, Ic: torch.Tensor, If: torch.Tensor, h: torch.Tensor):
    """Combine the recurrent and input projections into the new hidden
    state (reference deepmind_version.py:85-112)."""
    R_r, R_u, R_e = torch.chunk(Rh, 3, dim=-1)  # each [B, hidden]
    I_r, I_u, I_e = (torch.cat([c, f], dim=-1) for c, f in zip(torch.chunk(Ic, 3, dim=-1),
                                                               torch.chunk(If, 3, dim=-1)))
    r = torch.sigmoid(R_r + I_r + params["bias_r"])
    u = torch.sigmoid(R_u + I_u + params["bias_u"])
    e = torch.tanh(r * R_e + I_e + params["bias_e"])
    return u * h + (1.0 - u) * e


def _heads(params: Params, h_c: torch.Tensor, h_f: torch.Tensor):
    out_c = L.dense(params["O2"], torch.relu(L.dense(params["O1"], h_c)))
    out_f = L.dense(params["O4"], torch.relu(L.dense(params["O3"], h_f)))
    return out_c, out_f


def forward(params: Params, prev_coarse, prev_fine, cur_coarse, h):
    """One teacher-forced step -> (coarse_logits, fine_logits, new_h).

    prev_coarse / prev_fine / cur_coarse: [B] floats scaled to [0, 1]."""
    half = params["R"].shape[0] // 2
    Ic = torch.stack([prev_coarse, prev_fine], dim=-1) @ params["I_coarse"]["w"]
    If = torch.stack([prev_coarse, prev_fine, cur_coarse], dim=-1) @ params["I_fine"]["w"]
    h_new = _gates(params, h @ params["R"], Ic, If, h)
    out_c, out_f = _heads(params, h_new[:, :half], h_new[:, half:])
    return out_c, out_f, h_new


def train_forward(params: Params, coarse: torch.Tensor, fine: torch.Tensor):
    """Teacher-forced sequence forward.  coarse / fine: [B, T+1] scaled
    sample streams (previous + current) -> (coarse_logits [B, T, 256],
    fine_logits [B, T, 256])."""
    B, Tp1 = coarse.shape
    h = coarse.new_zeros(B, params["R"].shape[0])
    outs_c, outs_f = [], []
    for t in range(Tp1 - 1):
        oc, of, h = forward(params, coarse[:, t], fine[:, t], coarse[:, t + 1], h)
        outs_c.append(oc)
        outs_f.append(of)
    return torch.stack(outs_c, dim=1), torch.stack(outs_f, dim=1)


def loss(params: Params, coarse: torch.Tensor, fine: torch.Tensor) -> torch.Tensor:
    """Dual cross-entropy over the 8-bit coarse and fine classes; coarse /
    fine [B, T+1] hold class values 0..255."""
    oc, of = train_forward(params, coarse / 255.0, fine / 255.0)
    ce = lambda lg, t: -torch.mean(torch.gather(torch.log_softmax(lg, dim=-1), -1, t.long()[..., None]))
    return ce(oc, coarse[:, 1:]) + ce(of, fine[:, 1:])


def draw_gumbel(n_samples: int, batch: int, generator: torch.Generator, device=None) -> torch.Tensor:
    """Standard Gumbel noise [n_samples, 2 (coarse, fine), batch, 256] from
    ``generator``."""
    device = generator.device if device is None else device
    u = torch.rand((n_samples, 2, batch, 256), generator=generator, device=device)
    return -torch.log(-torch.log(torch.clamp_min(u, torch.finfo(torch.float32).tiny)))


def generate(params: Params, n_samples: int, generator: torch.Generator | None = None, batch: int = 1,
             gumbel: torch.Tensor | None = None) -> torch.Tensor:
    """Autoregressive generation on the params' device -> [batch, n_samples]
    float wav in [-1, 1] (reference deepmind_version.py:44-83: coarse, then
    fine conditioned on the fresh coarse sample; both fed back as c/255 and
    f/255).  A draw is argmax(logits + Gumbel); ``gumbel`` [n_samples, 2,
    batch, 256] is used as given, else drawn before the loop from
    ``generator`` (one seeded 0 when None)."""
    R = params["R"]
    dev, hidden = R.device, R.shape[0]
    half = hidden // 2
    if gumbel is None:
        if generator is None:
            generator = torch.Generator(device=dev).manual_seed(0)
        gumbel = draw_gumbel(n_samples, batch, generator, dev)
    gumbel = torch.as_tensor(gumbel, dtype=torch.float32, device=dev)
    # R's columns per gate, each split into its coarse and fine halves
    R_r, R_u, R_e = torch.chunk(R, 3, dim=-1)
    R_c = torch.cat([R_r[:, :half], R_u[:, :half], R_e[:, :half]], dim=-1)
    R_f = torch.cat([R_r[:, half:], R_u[:, half:], R_e[:, half:]], dim=-1)
    b_c, b_f = ([params[k][s] for k in ("bias_r", "bias_u", "bias_e")]
                for s in (slice(None, half), slice(half, None)))

    def half_step(Rh, I, b, h_half):
        (Rh_r, Rh_u, Rh_e), (I_r, I_u, I_e) = torch.chunk(Rh, 3, dim=-1), torch.chunk(I, 3, dim=-1)
        r = torch.sigmoid(Rh_r + I_r + b[0])
        u = torch.sigmoid(Rh_u + I_u + b[1])
        e = torch.tanh(r * Rh_e + I_e + b[2])
        return u * h_half + (1.0 - u) * e

    h = R.new_zeros(batch, hidden)
    c_prev = R.new_zeros(batch)
    f_prev = R.new_zeros(batch)
    out = R.new_empty(n_samples, batch)
    for t in range(n_samples):
        Ic = torch.stack([c_prev, f_prev], dim=-1) @ params["I_coarse"]["w"]
        h_c = half_step(h @ R_c, Ic, b_c, h[:, :half])
        out_c = L.dense(params["O2"], torch.relu(L.dense(params["O1"], h_c)))
        c_new = torch.argmax(out_c + gumbel[t, 0], dim=-1).to(torch.float32) / 255.0
        If = torch.stack([c_prev, f_prev, c_new], dim=-1) @ params["I_fine"]["w"]
        h_f = half_step(h @ R_f, If, b_f, h[:, half:])
        out_f = L.dense(params["O4"], torch.relu(L.dense(params["O3"], h_f)))
        f_new = torch.argmax(out_f + gumbel[t, 1], dim=-1).to(torch.float32) / 255.0
        h = torch.cat([h_c, h_f], dim=-1)
        out[t] = (c_new * 255.0 * 256.0 + f_new * 255.0) / 32767.5 - 1.0
        c_prev, f_prev = c_new, f_new
    return out.t()


def split_signal_16bit(x: torch.Tensor):
    """float [-1, 1] -> (coarse, fine) 8-bit streams as floats (reference
    dsp.py:97-106)."""
    unsigned = (x + 1.0) * 32767.5
    coarse = torch.floor(unsigned / 256.0)
    return coarse, unsigned - coarse * 256.0


def combine_signal(coarse: torch.Tensor, fine: torch.Tensor) -> torch.Tensor:
    return (coarse * 256.0 + fine) / 32767.5 - 1.0
