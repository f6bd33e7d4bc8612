"""The whole training step's share of the card's float32 peak, in %: the
model operations of the window's steps before the device trace (the
profiler slows every later launch) over their seconds x 67 TFLOP/s.  Tacotron-2: 3 x the teacher-forced forward
(encoder, decoder steps and postnet, each row at its own symbols and
frames); WaveRNN: ``work.wavernn_train_work`` of the step's windows."""

from benchmark import core, work


def read(rec):
    steps = [s for s in rec.get("steps") or [] if not s.get("profiled")]
    secs = sum(s["t1"] - s["t0"] for s in steps)
    if not steps or secs <= 0:
        return None
    conf = rec["conf"]
    if rec.get("model") == "wavernn":
        w, wt = conf["wavernn"], conf["wavernn_train"]
        flops = sum(work.wavernn_train_work(w, conf["audio"]["bits"], s["windows"], wt["seq_len_hops"])[0]
                    for s in steps)
    else:
        tc = conf["tacotron"]
        flops = sum(3.0 * work.tacotron_forward_flops(tc, L, T)
                    for s in steps for L, T in zip(s["lengths"], s["frames"]))
    return 100.0 * flops / (secs * core.PEAK_F32_FLOP_PER_S)
