"""The WaveRNN sample loop (K1, ``wavernn_grid_kernel``) against its
roofline, in %: the bound time of the samples the traced calls delivered
(each request's frames x hop, not the folds' overlap or padding) over K1's
device time in the trace."""

from benchmark import core, work


def read(rec):
    t = rec.get("trace")
    calls = rec.get("calls_traced") or []
    w = rec["conf"].get("wavernn")
    if not t or not calls or not w:
        return None
    secs = core.kernel_seconds(t["by_name"], "wavernn_grid_kernel")
    if secs <= 0:
        return None
    samples = sum(sum(c["samples_rows"]) for c in calls)
    flops, nbytes = work.wavernn_sample_work(w, rec["conf"]["audio"]["bits"], samples, launches=len(calls))
    return 100.0 * work.bound_s(flops, nbytes) / secs
