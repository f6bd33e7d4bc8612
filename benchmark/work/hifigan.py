"""Operations and bytes of HiFi-GAN V1's training step, from the widths of a
configuration's ``hifigan`` section, never from the program.

Each convolution counts out x in/groups x kernel multiply-adds an output
sample (a transposed convolution in x out x kernel an input sample), with
no biases; operations are 2 x multiply-adds.  A backward counts the
weight gradient and the input gradient at the forward's operations each,
and only those the step needs: in the discriminators' step no input
gradient of the first layers (the audio is data or detached), in the
generator's step no weight gradient of the discriminators and an input
gradient down to the audio, and in the generator no input gradient of the
mel.  Bytes: each layer's input read and output written once and its
weights read once, in float32, for each pass; AdamW reads a parameter, its
gradient and both moments and writes the parameter and both moments.
Leaky ReLUs, pooling, the mel and the losses are left out (element-wise,
a few per cent of the bytes).
"""

from __future__ import annotations

from . import bound_s

MPD_PERIODS = (2, 3, 5, 7, 11)
MPD_KERNEL, MPD_STRIDE = 5, 3
MSD_GROUPS = (1, 4, 16, 16, 16, 16, 1)
MSD_KERNELS = (15, 41, 41, 41, 41, 41, 5)
MSD_STRIDES = (1, 2, 2, 4, 4, 1, 1)
ADAMW_BYTES = 7 * 4  # a parameter: p, g, m, v read; p, m, v written


def _layer(macs: int, n_in: int, n_out: int, n_w: int) -> dict:
    return {"macs": macs, "in": n_in, "out": n_out, "w": n_w}


def generator_layers(h: dict, frames: int) -> list:
    """The generator's convolutions for one row of ``frames`` mel frames,
    first to last."""
    ch = h["upsample_initial_channel"]
    L = frames
    out = [_layer(ch * h["num_mels"] * 7 * L, h["num_mels"] * L, ch * L, ch * h["num_mels"] * 7)]
    for i, (u, k) in enumerate(zip(h["upsample_rates"], h["upsample_kernel_sizes"])):
        cin, c = ch // 2**i, ch // 2 ** (i + 1)
        out.append(_layer(cin * c * k * L, cin * L, c * L * u, cin * c * k))
        L *= u
        for kk, dil in zip(h["resblock_kernel_sizes"], h["resblock_dilation_sizes"]):
            out += [_layer(c * c * kk * L, c * L, c * L, c * c * kk)] * (2 * len(dil))
    c = ch // 2 ** len(h["upsample_rates"])
    out.append(_layer(c * 7 * L, c * L, L, c * 7))
    return out


def generator_macs_per_frame(h: dict) -> int:
    """Multiply-adds of the generator's forward a mel frame."""
    return sum(x["macs"] for x in generator_layers(h, 1))


def mpd_layers(h: dict, samples: int) -> list:
    """Each period's discriminator, one list each, for one row."""
    out = []
    chans = (1,) + tuple(h["mpd_channels"])
    for p in MPD_PERIODS:
        H = -(-samples // p)
        layers = []
        for j in range(len(chans) - 1):
            s = MPD_STRIDE if j < len(chans) - 2 else 1
            Ho = (H + 4 - MPD_KERNEL) // s + 1
            layers.append(_layer(chans[j + 1] * chans[j] * MPD_KERNEL * Ho * p, chans[j] * H * p,
                                 chans[j + 1] * Ho * p, chans[j + 1] * chans[j] * MPD_KERNEL))
            H = Ho
        layers.append(_layer(chans[-1] * 3 * H * p, chans[-1] * H * p, H * p, chans[-1] * 3))
        out.append(layers)
    return out


def msd_layers(h: dict, samples: int) -> list:
    """Each scale's discriminator, one list each, for one row (the second
    and third on audio pooled by ``AvgPool1d(4, 2, padding=2)``)."""
    out = []
    chans = (1,) + tuple(h["msd_channels"])
    L0 = samples
    for scale in range(3):
        if scale:
            L0 = L0 // 2 + 1
        L, layers = L0, []
        for j, (k, s, g) in enumerate(zip(MSD_KERNELS, MSD_STRIDES, MSD_GROUPS)):
            Lo = (L + 2 * (k // 2) - k) // s + 1
            w = chans[j + 1] * (chans[j] // g) * k
            layers.append(_layer(w * Lo, chans[j] * L, chans[j + 1] * Lo, w))
            L = Lo
        layers.append(_layer(chans[-1] * 3 * L, chans[-1] * L, L, chans[-1] * 3))
        out.append(layers)
    return out


def disc_stacks(h: dict, samples: int) -> list:
    return mpd_layers(h, samples) + msd_layers(h, samples)


def _pass(layers, rows: int, skip_first: bool = False):
    """(flops, bytes) of one pass (a forward, a weight or an input
    gradient) over ``layers``, for ``rows`` rows."""
    ls = layers[1:] if skip_first else layers
    return (2.0 * rows * sum(x["macs"] for x in ls),
            4.0 * sum(rows * (x["in"] + x["out"]) + x["w"] for x in ls))


def _add(*ws):
    return sum(w[0] for w in ws), sum(w[1] for w in ws)


def param_count(layers) -> int:
    return sum(x["w"] for x in layers)


def generator_work(h: dict, rows: int, samples: int):
    """(flops, bytes) of the generator's forward and its backward (weight
    gradients, and input gradients down to the first layer's output)."""
    g = generator_layers(h, samples // _hop(h))
    return _add(_pass(g, rows), _pass(g, rows), _pass(g, rows, skip_first=True))


def disc_step_work(h: dict, rows: int, samples: int):
    """(flops, bytes) of the discriminators' step: the forward on the real
    and on the generated audio, the weight and input gradients of both
    but the first layers' input gradients, and AdamW."""
    parts, n_w = [], 0
    for st in disc_stacks(h, samples):
        parts += [_pass(st, 2 * rows), _pass(st, 2 * rows), _pass(st, 2 * rows, skip_first=True)]
        n_w += param_count(st)
    return _add(*parts, (0.0, float(ADAMW_BYTES * n_w)))


def gen_step_disc_work(h: dict, rows: int, samples: int):
    """(flops, bytes) of the generator's step outside the generator: the
    discriminators' forward on the real and the generated audio and their
    input gradients down to the generated audio."""
    parts = []
    for st in disc_stacks(h, samples):
        parts += [_pass(st, 2 * rows), _pass(st, rows)]
    return _add(*parts)


def step_flops(h: dict, rows: int, samples: int) -> float:
    """Model operations of one whole step (the generator's AdamW is bytes
    only)."""
    return generator_work(h, rows, samples)[0] + disc_step_work(h, rows, samples)[0] + \
        gen_step_disc_work(h, rows, samples)[0]


def generator_bound_s(h: dict, rows: int, samples: int) -> float:
    return bound_s(*generator_work(h, rows, samples))


def disc_step_bound_s(h: dict, rows: int, samples: int) -> float:
    return bound_s(*disc_step_work(h, rows, samples))


def _hop(h: dict) -> int:
    n = 1
    for u in h["upsample_rates"]:
        n *= u
    return n
