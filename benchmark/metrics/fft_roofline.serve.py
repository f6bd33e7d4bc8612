"""Griffin-Lim's transforms (cuFFT's kernels, every device operation
whose name holds "fft") against their roofline, in %: the larger of the
operations bound and the bytes bound of the transforms that the traced
calls' requests need at their own frames, over those kernels' device
time."""

from benchmark import core, work


def read(rec):
    t = rec.get("trace")
    calls = rec.get("calls_traced") or []
    if not t or not calls or rec["conf"].get("wavernn"):
        return None
    secs = core.kernel_seconds(t["by_name"], "fft")
    if secs <= 0:
        return None
    a = rec["conf"]["audio"]
    flops = nbytes = 0.0
    for c in calls:
        for frames in c["frames_rows"]:
            f, b = work.griffin_lim_fft_work(frames, a["n_fft"], a["griffin_lim_iters"])
            flops, nbytes = flops + f, nbytes + b
    return 100.0 * work.bound_s(flops, nbytes) / secs
