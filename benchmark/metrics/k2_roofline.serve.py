"""The Tacotron decode loop (K2, ``tacotron_decode_kernel``) against its
roofline, in %: the bound time of the traced calls' real rows, each at its
own symbol count and frames (no padding rows or positions), over K2's
device time in the trace."""

from benchmark import core, work


def read(rec):
    t = rec.get("trace")
    calls = rec.get("calls_traced") or []
    if not t or not calls:
        return None
    secs = core.kernel_seconds(t["by_name"], "tacotron_decode_kernel")
    if secs <= 0:
        return None
    tc = rec["conf"]["tacotron"]
    flops = nbytes = 0.0
    for c in calls:
        nbytes += work.decoder_weight_bytes(tc)
        for L, frames in zip(c["tin_rows"], c["frames_rows"]):
            f, b = work.decoder_work(tc, L, frames // tc["outputs_per_step"])
            flops, nbytes = flops + f, nbytes + b
    return 100.0 * work.bound_s(flops, nbytes) / secs
