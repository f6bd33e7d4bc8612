"""The whole device call's share of the card's float32 peak, in %: the
model operations of the requests the window's calls served (the encoder,
the decoder and the postnet at each row's own length, plus the vocoder's
loop and conditioning at the delivered samples, or Griffin-Lim's
operations) over the calls' summed wall time x 67 TFLOP/s."""

from benchmark import core, work


def read(rec):
    calls = rec.get("calls", [])
    if not calls:
        return None
    conf = rec["conf"]
    tc, a, w = conf["tacotron"], conf["audio"], conf.get("wavernn")
    flops = 0.0
    for c in calls:
        for L, frames, samples in zip(c["tin_rows"], c["frames_rows"], c["samples_rows"]):
            flops += work.encoder_flops(tc, L) + work.decoder_work(tc, L, frames)[0] + work.postnet_flops(tc, frames)
            if w:
                flops += work.wavernn_sample_work(w, a["bits"], samples)[0] + work.wavernn_conditioning_flops(w, frames)
            else:
                flops += work.griffin_lim_flops(frames, a["n_fft"], a["griffin_lim_iters"])
    secs = sum(c["t1"] - c["t0"] for c in calls)
    return 100.0 * flops / (secs * core.PEAK_F32_FLOP_PER_S) if secs > 0 else None
