"""The location-sensitive decoder against its roofline, in %: the bound
time of the forward work of each step's batch (``work/lsa.py``: every row
at its own frames and symbols) over the device time (CUDA events) of the
program's ``tacotron.decoder`` spans of the same steps, the window's steps
before the device trace.  The span wraps whatever implements the decoder,
the eager loop or a kernel.  None without the program's spans."""

from benchmark import spans
from benchmark.work import lsa


def read(rec):
    steps = [s for s in rec.get("steps") or [] if not s.get("profiled")]
    found = spans.spans_of(rec)
    roots = [s for s in found if s["name"] == "train.step"]
    if not steps or not roots:
        return None
    under = spans.below(found, roots)
    tc = rec["conf"]["tacotron"]
    bound = secs = 0.0
    for st in steps:
        lo, hi = round(st["t0"] * 1e9), round(st["t1"] * 1e9)
        root = next((r for r in roots if lo <= r["t0"] <= hi), None)
        if root is None:
            continue
        dec = [s["dev_ms"] for s in under[root["id"]] if s["name"] == "tacotron.decoder" and "dev_ms" in s]
        if dec:
            bound += lsa.decode_bound_s(tc, zip(st["frames"], st["lengths"]))
            secs += 1e-3 * sum(dec)
    return 100.0 * bound / secs if secs > 0 else None
