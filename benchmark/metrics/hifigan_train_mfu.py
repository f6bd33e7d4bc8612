"""HiFi-GAN's whole training step's share of the card's float32 peak, in
%: the model operations of the window's steps before the device trace
(``work/hifigan.py`` ``step_flops``: the generator's forward and backward,
the discriminators' step, and the discriminators' forward and input
gradients in the generator's step) over their host seconds x 67 TFLOP/s.
Read only where the step's spans show the program ran HiFi-GAN's step
(``hifigan.gen_step``); None without them."""

from benchmark import core, spans
from benchmark.work import hifigan as W


def read(rec):
    steps, under = spans.train_steps(rec)
    if not any(s["name"] == "hifigan.gen_step" for st in steps for s in under[st["id"]]):
        return None
    h = rec["conf"]["hifigan"]
    want = [s for s in rec.get("steps") or [] if not s.get("profiled")]
    secs = sum(s["t1"] - s["t0"] for s in want)
    flops = sum(W.step_flops(h, s["rows"], s["samples"]) for s in want)
    return 100.0 * flops / (secs * core.PEAK_F32_FLOP_PER_S) if secs > 0 else None
