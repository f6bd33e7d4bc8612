"""The teacher-forced decoder core's backward (K4, ``tacotron_train_bwd_kernel``)
against its roofline, in %: the bound time of the traced steps' batches,
each row at its own frames and symbols, over K4's device time."""

from benchmark import core, work


def read(rec):
    t = rec.get("trace")
    steps = rec.get("steps_traced") or []
    if not t or not steps:
        return None
    secs = core.kernel_seconds(t["by_name"], "tacotron_train_bwd_kernel")
    if secs <= 0:
        return None
    tc = rec["conf"]["tacotron"]
    flops = nbytes = 0.0
    for s in steps:
        f, b = work.trainer_rows_work(tc, list(zip(s["frames"], s["lengths"])), backward=True)
        flops, nbytes = flops + f, nbytes + b
    return 100.0 * work.bound_s(flops, nbytes) / secs
