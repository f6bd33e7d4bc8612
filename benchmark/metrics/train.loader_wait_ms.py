"""Mean time a step of the window waited on its batch iterator (the
Tacotron dataset's ``batches``: reading, grouping and padding; the C++
vocoder loader's ``next_batch``), in ms, over the window's steps before
the device trace (the profiler slows every later launch)."""


def read(rec):
    steps = [s for s in rec.get("steps") or [] if not s.get("profiled")]
    return 1e3 * sum(s["load_s"] for s in steps) / len(steps) if steps else None
