"""The metric arithmetic on recorded spans, counters and traces, and the
work counters pinned to counts worked by hand at small widths."""

import math

import pytest

from benchmark import core, work

W = {"rnn_dims": 4, "fc_dims": 4, "compute_dims": 2, "res_out_dims": 8, "res_blocks": 1, "pad": 1,
     "upsample_factors": [2, 3]}
T = {"embedding_dim": 2, "enc_conv_kernel": 3, "enc_conv_channels": 4, "enc_conv_layers": 2,
     "encoder_lstm_units": 2, "attention_dim": 2, "attention_filters": 1, "attention_kernel": 3,
     "prenet_layers": [2, 2], "decoder_lstm_units": 2, "outputs_per_step": 1, "postnet_kernel": 3,
     "postnet_channels": 2, "postnet_layers": 2}


def test_wavernn_sample_work_by_hand():
    # I (1+80+2)*4=332, GRU1 2*4*12=96, GRU2 (4+2)*12+4*12=120, fc1 6*4=24, fc2 6*4=24, fc3 4*8=32
    assert work.wavernn_sample_macs(W, 3) == 628
    flops, nbytes = work.wavernn_sample_work(W, 3, samples=10, launches=2)
    assert flops == 2 * 628 * 10
    # weights 628 + 4 + 48 + 8 + 8 = 696 a launch; a sample reads 80 + 4*2 and writes 1
    assert nbytes == 4 * (696 * 2 + 10 * 89)


def test_wavernn_conditioning_by_hand():
    # a frame: (2+1)*80*2=480 + 2*1*2*2=8 + 2*8=16 -> 504; smoothing 2*80*5 + 6*80*7 = 800 + 3360
    assert work.wavernn_conditioning_flops(W, 1) == 2 * (504 + 4160)


def test_tacotron_counts_by_hand():
    # convs 3*2*4 + 3*4*4 = 72, LSTMs 2*(4+2)*8 = 96, keys 2*2*2 = 8 -> 176 a position
    assert work.encoder_flops(T, 5) == 2 * 5 * 176
    # postnet 3*80*2 + 1*3*2*2 + 2*80 = 480 + 12 + 160
    assert work.postnet_flops(T, 3) == 2 * 3 * 652
    # prenet 80*2 + 2*2 = 164, LSTMs (2+4+2)*8 + 2*2*8 = 96, context 7*4 = 28,
    # projections (2+4)*82 = 492, query 2*2 = 4, location 7*(3*2+2) = 56
    assert work.decoder_step_macs(T, 7) == 164 + 96 + 28 + 492 + 4 + 56
    flops, nbytes = work.decoder_work(T, 7, 10)
    assert flops == 2 * 840 * 10 and nbytes == 4 * (7 * (2 + 4 + 1) + 10 * (81 + 7))


def test_trainer_rows_count_weights_once():
    f1, b1 = work.trainer_work(T, 1, 5, 3, backward=False)
    f2, b2 = work.trainer_rows_work(T, [(5, 3), (5, 3)], backward=False)
    assert f2 == 2 * f1
    assert b2 == 2 * b1 - work.trainer_weight_bytes(T, False)
    fb, _ = work.trainer_work(T, 2, 5, 3, backward=True)
    assert work.trainer_rows_work(T, [(5, 3), (5, 3)], backward=True)[0] == fb


def test_griffin_lim_counts():
    f, b = work.griffin_lim_fft_work(4, 8, 2)
    assert f == 4 * 5 * 2.5 * 8 * 3 and b == 4 * 5 * 4 * (8 + 10)
    assert work.griffin_lim_flops(4, 8, 2) == 4 * 2.5 * (2 * 2.5 * 8 * 3 + 20 * 5)


def test_bound_takes_the_larger():
    assert work.bound_s(67e12, 0) == pytest.approx(1.0)
    assert work.bound_s(0, 3.35e12) == pytest.approx(1.0)


def test_reduce_trace_union_and_gaps():
    ev = [("a", 0.0, 10.0), ("b", 5.0, 10.0), ("c", 30.0, 5.0), ("void k<int>(float*)", 40.0, 10.0)]
    red = core.reduce_trace(ev, 100e-6)
    assert red["busy_s"] == pytest.approx(30e-6)
    assert red["by_name"]["a"] == pytest.approx(10e-6)
    assert [g[1] for g in red["idle_gaps"]] == pytest.approx([15e-6, 5e-6])
    assert red["idle_gaps"][0][0] == "host work after b before c"
    assert red["idle_gaps"][1][0] == "host work after c before k"
    assert core.kernel_seconds(red["by_name"], "K<") == pytest.approx(10e-6)


def test_percentile():
    assert core.percentile(list(range(1, 101)), 95) == pytest.approx(95.05)
    assert math.isinf(core.percentile([1.0, math.inf, math.inf], 95))


def rec_serve():
    calls = [{"seeds": [1, 2], "t0": 10.0, "t1": 10.5, "tin_rows": [20, 30], "frames_rows": [8, 8],
              "samples_rows": [2200, 2200]},
             {"seeds": [3], "t0": 11.0, "t1": 11.25, "tin_rows": [10], "frames_rows": [8], "samples_rows": [2200]}]
    reqs = [{"seed": 1, "due": 9.9}, {"seed": 2, "due": 9.7}, {"seed": 3, "due": 10.0}]
    return {"calls": calls, "calls_traced": calls[:1], "requests": reqs,
            "counters": {"requests": 3, "device_calls": 2},
            "trace": {"busy_s": 0.3, "window_s": 0.4, "by_name": {"wavernn_grid_kernel": 0.2,
                                                                   "tacotron_decode_kernel<0>": 0.01}},
            "conf": {"tacotron": dict(T), "wavernn": dict(W), "audio": {"bits": 3, "n_fft": 8,
                                                                          "griffin_lim_iters": 2}}}


def test_serve_readers():
    r = rec_serve()
    assert core.metric_reader("serve.batch_rows")(r) == 1.5
    assert core.metric_reader("serve.queue_ms")(r) == pytest.approx(1e3 * (0.1 + 0.3 + 1.0) / 3)
    assert core.metric_reader("serve.call_ms")(r) == pytest.approx(375.0)
    assert core.metric_reader("idle_share.serve")(r) == pytest.approx(25.0)
    f, b = work.wavernn_sample_work(W, 3, 4400, launches=1)
    assert core.metric_reader("k1_roofline.serve")(r) == pytest.approx(100 * work.bound_s(f, b) / 0.2)
    f1, b1 = work.decoder_work(T, 20, 8)
    f2, b2 = work.decoder_work(T, 30, 8)
    want = work.bound_s(f1 + f2, b1 + b2 + work.decoder_weight_bytes(T)) / 0.01
    assert core.metric_reader("k2_roofline.serve")(r) == pytest.approx(100 * want)
    assert core.metric_reader("fft_roofline.serve")(r) is None  # a WaveRNN cell runs no Griffin-Lim
    assert core.metric_reader("serve_mfu")(r) > 0


def test_readers_find_nothing_without_a_trace():
    r = rec_serve()
    del r["trace"]
    for name in ("idle_share.serve", "k1_roofline.serve", "k2_roofline.serve", "fft_roofline.serve"):
        assert core.metric_reader(name)(r) is None


def test_train_readers():
    steps = [{"t0": 0.0, "t1": 0.3, "load_s": 0.002, "lengths": [5, 7], "frames": [9, 12]},
             {"t0": 0.3, "t1": 0.6, "load_s": 0.004, "lengths": [6, 6], "frames": [10, 10]},
             {"t0": 0.6, "t1": 1.6, "load_s": 0.5, "lengths": [6, 6], "frames": [10, 10], "profiled": True}]
    r = {"model": "tacotron", "steps": steps, "steps_traced": steps[2:], "window_s": 1.6, "conf": {"tacotron": dict(T)},
         "trace": {"busy_s": 0.2, "window_s": 0.3, "by_name": {"tacotron_train_fwd_kernel": 1e-3,
                                                               "tacotron_train_bwd_kernel": 2e-3}}}
    assert core.metric_reader("train.loader_wait_ms")(r) == pytest.approx(3.0)
    assert core.metric_reader("idle_share.train")(r) == pytest.approx(100 / 3)
    f, b = work.trainer_rows_work(T, [(10, 6), (10, 6)], backward=False)
    assert core.metric_reader("k3_roofline.train")(r) == pytest.approx(100 * work.bound_s(f, b) / 1e-3)
    f, b = work.trainer_rows_work(T, [(10, 6), (10, 6)], backward=True)
    assert core.metric_reader("k4_roofline.train")(r) == pytest.approx(100 * work.bound_s(f, b) / 2e-3)
    flops = 3 * sum(work.tacotron_forward_flops(T, L, n) for L, n in [(5, 9), (7, 12), (6, 10), (6, 10)])
    assert core.metric_reader("train_mfu")(r) == pytest.approx(100 * flops / (0.6 * 67e12))
