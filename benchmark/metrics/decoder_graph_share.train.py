"""The share of the eager route's decoder steps that replayed a captured
CUDA graph, in %: the program's ``decoder_graphs["steps_replayed"]`` over
its ``decoder_steps["eager"]``, both counted over the whole run.  None
where the program has no such counter (a program without the graphed
decode) or decoded no step on the eager route."""


def read(rec):
    counters = rec.get("program_counters") or {}
    graphs, steps = counters.get("decoder_graphs"), counters.get("decoder_steps")
    if not graphs or not steps or not steps.get("eager"):
        return None
    return 100.0 * graphs["steps_replayed"] / steps["eager"]
