"""Operations and bytes of the teacher-forced decoder with
location-sensitive attention, forward only, from the widths of a
configuration's ``tacotron`` section: what the program's
``tacotron.decoder`` span wraps in training (the attention keys, the
prenet over every step, the step loop, the frame and stop projections).

Each row counts at its own frames and symbols.  Operations are 2 x
multiply-adds; the location convolution and its dense count as the one
filter they multiply into (taps x A), the least the step needs.  Bytes:
each row's memory, mask and input frames read once, its frames, stop
logits and alignments written once, and the weights read once a decode.
"""

from __future__ import annotations

from . import NUM_MELS, bound_s


def _widths(t: dict):
    """(p1, p2 prenet, U decoder units, V memory width, A attention, taps, r)."""
    p1, p2 = t["prenet_layers"]
    return (p1, p2, t["decoder_lstm_units"], 2 * t["encoder_lstm_units"], t["attention_dim"],
            t["attention_kernel"], t["outputs_per_step"])


def step_macs(t: dict, L: int) -> int:
    """One decoder step at ``L`` symbols: the prenet, both LSTMs (input
    and recurrent products), the query, the location filter, the energies'
    v, the context and the frame and stop projections."""
    p1, p2, U, V, A, taps, r = _widths(t)
    return (NUM_MELS * p1 + p1 * p2 + (p2 + V + U) * 4 * U + 2 * U * 4 * U + U * A
            + L * (taps * A + A + V) + (U + V) * (NUM_MELS + 1) * r)


def weight_floats(t: dict) -> int:
    p1, p2, U, V, A, taps, r = _widths(t)
    return (NUM_MELS * p1 + p1 + p1 * p2 + p2 + (p2 + V + U) * 4 * U + 2 * U * 4 * U + 8 * U + U * A + V * A
            + taps * A + 3 * A + (U + V + 1) * (NUM_MELS + 1) * r)


def row_work(t: dict, frames: int, L: int):
    """(flops, bytes without the weights) of one row of ``frames`` frames
    and ``L`` symbols."""
    p1, p2, U, V, A, taps, r = _widths(t)
    T = frames // r
    flops = 2.0 * (L * V * A + T * step_macs(t, L))
    return flops, 4.0 * (L * (V + 1) + frames * NUM_MELS + T * ((NUM_MELS + 1) * r + L))


def decode_work(t: dict, rows):
    """(flops, bytes) of one decode of ``rows`` [(frames, symbols)]."""
    flops, nbytes = 0.0, 4.0 * weight_floats(t)
    for frames, L in rows:
        f, b = row_work(t, frames, L)
        flops, nbytes = flops + f, nbytes + b
    return flops, nbytes


def decode_bound_s(t: dict, rows) -> float:
    return bound_s(*decode_work(t, rows))
