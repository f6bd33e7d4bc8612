"""HiFi-GAN's discriminator step against its roofline, in %: the bound
time of the step (``work/hifigan.py``: both discriminators' forward on the
real and the generated audio, their weight and input gradients, AdamW)
over the device time (CUDA events) of the program's ``hifigan.disc_step``
span of the same step, over the window's steps before the device trace.
None without the program's spans."""

from benchmark import spans
from benchmark.work import hifigan as W


def read(rec):
    steps, under = spans.train_steps(rec)
    h = (rec.get("conf") or {}).get("hifigan")
    bound = secs = 0.0
    by_t0 = {round(s["t0"] * 1e9): s for s in rec.get("steps") or []}
    for root in steps:
        disc = [s["dev_ms"] for s in under[root["id"]] if s["name"] == "hifigan.disc_step" and "dev_ms" in s]
        st = next((s for t0, s in by_t0.items() if t0 <= root["t0"] <= round(s["t1"] * 1e9)), None)
        if disc and st is not None and h:
            bound += W.disc_step_bound_s(h, st["rows"], st["samples"])
            secs += 1e-3 * sum(disc)
    return 100.0 * bound / secs if secs > 0 else None
