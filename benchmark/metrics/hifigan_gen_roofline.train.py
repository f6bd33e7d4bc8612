"""HiFi-GAN's generator against its roofline, in %: the bound time of its
forward and of its share of the generator step's backward (``work/
hifigan.py``: weight gradients, and input gradients down to the first
layer's output) over the device time (CUDA events) of the program's
``hifigan.generator`` spans of the same step (the forward, and the
backward from the generated audio to the weights), over the window's
steps before the device trace.  None without the program's spans."""

from benchmark import spans
from benchmark.work import hifigan as W


def read(rec):
    steps, under = spans.train_steps(rec)
    h = (rec.get("conf") or {}).get("hifigan")
    bound = secs = 0.0
    by_t0 = {round(s["t0"] * 1e9): s for s in rec.get("steps") or []}
    for root in steps:
        gen = [s["dev_ms"] for s in under[root["id"]] if s["name"] == "hifigan.generator" and "dev_ms" in s]
        st = next((s for t0, s in by_t0.items() if t0 <= root["t0"] <= round(s["t1"] * 1e9)), None)
        if gen and st is not None and h:
            bound += W.generator_bound_s(h, st["rows"], st["samples"])
            secs += 1e-3 * sum(gen)
    return 100.0 * bound / secs if secs > 0 else None
