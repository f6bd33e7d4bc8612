"""The program's spans read beside the device trace (``benchmark/spans.py``):
each span metric on a hand-made record, the clock on a synthetic trace, the
idle seconds by span, the launch attribution, and the splits."""

import os

import pytest

from benchmark import spans as SP

MS = 1_000_000  # ns in a ms


def span(i, name, t0_ms, t1_ms, parent=None, trace=None, thread=1, dev=None, **attrs):
    s = {"name": name, "id": i, "parent": parent, "trace": trace if trace is not None else i, "thread": thread,
         "ident": None, "t0": round(t0_ms * MS), "t1": round(t1_ms * MS), "attrs": attrs}
    if dev is not None:
        s["dev_t0"], s["dev_t1"] = round(dev[0] * MS), round(dev[1] * MS)
        s["dev_ms"] = dev[1] - dev[0]
    return s


def serve_rec():
    """Two calls: the first serves requests 1 and 2, the second request 3;
    a warm-up call before the window is left out."""
    sp = [
        span(90, "serve.call", 100, 200, dev=(100, 200)),  # warm-up, before the window
        span(1, "serve.request", 1000, 1500, trace=1, thread=11),
        span(2, "serve.queue", 1001, 1010, parent=1, trace=1, thread=11),
        span(3, "serve.request", 1002, 1520, trace=3, thread=12),
        span(4, "serve.queue", 1003, 1010, parent=3, trace=3, thread=12),
        span(5, "serve.call", 1010, 1400, parent=1, trace=1, thread=11, dev=(1010, 1405), rows=2),
        span(6, "synth.g2p", 1010, 1014, parent=5, trace=1, thread=11),
        span(7, "synth.decode", 1014, 1030, parent=5, trace=1, thread=11, dev=(1014, 1100)),
        span(8, "tacotron.decoder", 1016, 1020, parent=7, trace=1, thread=11, dev=(1016, 1090)),
        span(9, "synth.trim", 1030, 1101, parent=5, trace=1, thread=11),
        span(10, "vocode.k1", 1110, 1112, parent=5, trace=1, thread=11, dev=(1112, 1390)),
        span(11, "vocode.unfold", 1112, 1400, parent=5, trace=1, thread=11, dev=(1390, 1395)),
        span(12, "serve.respond", 1401, 1410, parent=1, trace=1, thread=11),
        span(13, "serve.respond", 1410, 1412, parent=1, trace=1, thread=11),
        span(14, "serve.respond", 1402, 1420, parent=3, trace=3, thread=12),
        span(20, "serve.request", 1600, 2000, trace=20, thread=13),
        span(21, "serve.call", 1610, 1900, parent=20, trace=20, thread=13, dev=(1610, 1905), rows=1),
        span(22, "synth.g2p", 1610, 1612, parent=21, trace=20, thread=13),
        span(23, "synth.decode", 1612, 1640, parent=21, trace=20, thread=13, dev=(1612, 1680)),
        span(24, "vocode.k1", 1690, 1691, parent=21, trace=20, thread=13, dev=(1700, 1890)),
        span(25, "vocode.unfold", 1691, 1900, parent=21, trace=20, thread=13, dev=(1890, 1897)),
        span(26, "serve.respond", 1901, 1905, parent=20, trace=20, thread=13),
    ]
    reqs = [{"seed": 1, "due": 0.999, "done": 1.5}, {"seed": 2, "due": 1.0, "done": 1.52},
            {"seed": 3, "due": 1.599, "done": 2.0}]
    return {"spans": sp, "requests": reqs, "calls": []}


def test_serve_metrics_by_hand():
    r = serve_rec()
    assert SP.serve_g2p_ms(r) == pytest.approx((4 + 2) / 2)
    assert SP.serve_decode_ms(r) == pytest.approx((86 + 68) / 2)
    assert SP.serve_handoff_ms(r) == pytest.approx(((1112 - 1100) + (1700 - 1680)) / 2)
    assert SP.serve_vocode_ms(r) == pytest.approx(((1395 - 1112) + (1897 - 1700)) / 2)
    assert SP.serve_call_dev_ms(r) == pytest.approx((395 + 295) / 2)
    # per answered request (trace): 9 + 2, 18, 4
    assert SP.serve_respond_ms(r) == pytest.approx((11 + 18 + 4) / 3)
    split = SP.serve_split(r)
    assert split["sum_ms"] == pytest.approx(77 + 16 + 240) and split["gap"] == pytest.approx(333 / 345 - 1)


def test_metrics_find_nothing_without_spans():
    for rec in ({"requests": serve_rec()["requests"]}, {"steps": train_rec()["steps"]}, {}):
        for name, f in SP.METRICS.items():
            assert f(rec) is None, name
    assert SP.idle_by_span({}) is None and SP.attribute_launches({}) is None
    assert SP.train_split({"steps": train_rec()["steps"]}) is None and SP.serve_split({}) is None


def test_clock_from_the_marker():
    rt = [["cudaLaunchKernel", 10.0, 5.0, 7, 1], ["cudaStreamQuery", 5000.0, 4.0, 7, 2],
          ["cudaDeviceSynchronize", 5100.0, 30.0, 7, 3]]
    c = SP.clock(rt, (1_000_000, 1_010_000))  # host 1000-1010 us
    assert c["offset_us"] == pytest.approx(5002.0 - 1005.0) and c["error_us"] == pytest.approx(5.0)
    assert SP.clock(rt[:1], (0, 1)) is None and SP.clock(rt, None) is None


class _OneExport:
    """A profiler session's stand-in: it exports once, as torch's does."""

    def __init__(self, events):
        self.events, self.saved = events, False

    def export_chrome_trace(self, path):
        import json

        assert not self.saved, "Trace is already saved."
        self.saved = True
        with open(path, "w", encoding="utf-8") as f:
            json.dump({"traceEvents": self.events}, f)


def test_span_trace_keeps_device_trace_events_from_one_export(tmp_path):
    from benchmark import core

    ev = [{"ph": "X", "cat": "kernel", "name": "k2", "ts": 30.0, "dur": 2.0, "args": {"correlation": 5}},
          {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": 20.0, "dur": 3.0, "tid": 9,
           "args": {"correlation": 5}},
          {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy DtoH", "ts": 10.0, "dur": 1.0, "args": {}},
          {"ph": "X", "cat": "cuda_runtime", "name": "cudaStreamQuery", "ts": 40.0, "dur": 2.0, "tid": 9,
           "args": {"correlation": 6}},
          {"ph": "i", "name": "marker", "ts": 1.0}]
    plain = core.DeviceTrace(str(tmp_path))
    plain.prof = _OneExport(ev)
    tr = SP.SpanTrace(str(tmp_path))
    tr.prof = _OneExport(ev)
    tr.t0, tr.t1, tr.marker = 0.0, 1e-3, (10_000, 12_000)
    assert tr.collect() == plain.collect() == [("Memcpy DtoH", 10.0, 1.0), ("k2", 30.0, 2.0)]
    assert tr.ops == [["Memcpy DtoH", 10.0, 1.0, None], ["k2", 30.0, 2.0, 5]]
    assert tr.runtime == [["cudaLaunchKernel", 20.0, 3.0, 9, 5], ["cudaStreamQuery", 40.0, 2.0, 9, 6]]
    rec = tr.record()
    assert rec["clock"]["offset_us"] == pytest.approx(41.0 - 11.0) and rec["trace_window_ns"] == [0, 1_000_000]
    assert not os.listdir(tmp_path)


def test_thread_ids_of_the_profiler():
    s = span(1, "x", 0, 1, thread=118)
    s["ident"] = 0x7FABCE322300
    assert {118, 835575040} <= SP.trace_tids(s)


def traced(rec, ops, runtime=(), offset_us=0.0, window_ms=(0, 100), error_us=1.0):
    return dict(rec, trace_ops=ops, trace_runtime=list(runtime), trace_window_ns=[
        round(window_ms[0] * MS), round(window_ms[1] * MS)], clock={
        "offset_us": offset_us, "error_us": error_us, "method": "marker"})


def test_idle_by_span_and_in_call():
    """Trace time = host + 500 us.  Device busy 10-20 and 60-70 ms of a 0-100
    ms window; a call on thread 1 at 5-50 ms with a child 30-40; thread 2
    answers at 45-80 ms."""
    sp = [span(1, "serve.call", 5, 50, thread=1), span(2, "vocode.prepare", 30, 40, parent=1, thread=1),
          span(3, "serve.respond", 45, 80, thread=2)]
    off = 500.0
    ops = [["k", 10_000 + off, 10_000, 1], ["k", 60_000 + off, 10_000, 2]]
    r = traced({"spans": sp}, ops, offset_us=off)
    got = SP.idle_by_span(r)
    # idle: 0-10, 20-60, 70-100 ms; thread 1: call 5-10, 20-30, 40-50 (minus nothing), prepare 30-40;
    # thread 2: respond 45-60, 70-80; none: 0-5, 80-100
    assert got["serve.call"] == pytest.approx(0.005 + 0.010 + 0.010)
    assert got["vocode.prepare"] == pytest.approx(0.010)
    assert got["serve.respond"] == pytest.approx(0.015 + 0.010)
    assert got["(no span)"] == pytest.approx(0.005 + 0.020)
    # only threads inside a device span: thread 2 answers outside one
    sp[0]["dev_ms"] = 45.0
    got = SP.idle_by_span(r, device_threads=True)
    assert got == pytest.approx({"serve.call": 0.025, "vocode.prepare": 0.010, "(no device span)": 0.045})
    # idle while a call was open: 5-10, 20-50 ms of 100
    assert SP.idle_in_call(r) == pytest.approx(35.0)


def test_launch_attribution_and_late_spans():
    sp = [span(1, "train.step", 0, 50, thread=7), span(2, "k4", 10, 20, parent=1, thread=9)]
    rt = [["cudaLaunchKernel", 5_000.0, 3.0, 7, 11], ["cudaLaunchKernelExC", 12_000.0, 3.0, 9, 12],
          ["cudaLaunchKernel", 60_000.0, 3.0, 7, 13]]
    ops = [["a", 5_010.0, 1.0, 11], ["b", 12_005.0, 1.0, 12], ["c", 60_010.0, 1.0, 13], ["d", 1.0, 1.0, None]]
    got = SP.attribute_launches(traced({"spans": sp}, ops, rt))
    assert got["by_span"] == {"train.step": 1, "k4": 1} and got["late"] == 0
    assert got["unattributed"] == {"no_call": 1, "no_thread": 0, "no_span": 1}
    # a clock 8 ms off puts every launch outside its span
    got = SP.attribute_launches(traced({"spans": sp}, ops, rt, offset_us=8_000.0))
    assert got["by_span"] == {} and got["unattributed"] == {"no_call": 1, "no_thread": 0, "no_span": 3}
    # an operation that starts before the span that launched it is counted late
    ops[1][1] = 9_000.0
    assert SP.attribute_launches(traced({"spans": sp}, ops, rt))["late"] == 1


def test_threads_the_profiler_names_otherwise_are_found_by_their_device_spans():
    sp = [span(1, "serve.call", 0, 50, thread=5, dev=(0, 50)), span(2, "serve.respond", 0, 50, thread=6)]
    rt = [["cudaLaunchKernel", 1_000.0 * t, 1.0, 424242, t] for t in (1, 2, 3)] + [["cudaMemcpyAsync", 70_000.0, 1.0,
                                                                                  99, 4]]
    assert SP.thread_map(SP.mapped(sp, 0.0), rt) == {424242: {5}}


def test_a_reused_thread_id_is_told_apart_by_time():
    """Two request threads, one after the other, with one ``pthread_self()``."""
    sp = [span(1, "serve.call", 0, 10, thread=5, dev=(0, 10)), span(2, "serve.call", 20, 30, thread=6, dev=(20, 30))]
    for s in sp:
        s["ident"] = 0x7F98AD7FE6C0
    tid = 1384126784
    rt = [["cudaLaunchKernel", 5_000.0, 1.0, tid, 1], ["cudaLaunchKernel", 25_000.0, 1.0, tid, 2]]
    ops = [["a", 5_010.0, 1.0, 1], ["b", 25_010.0, 1.0, 2]]
    assert SP.thread_map(SP.mapped(sp, 0.0), rt)[tid] == {5, 6}
    got = SP.attribute_launches(traced({"spans": sp}, ops, rt))
    assert got["by_span"] == {"serve.call": 2} and got["unattributed"]["no_span"] == 0


def test_launches_from_a_thread_without_spans_go_to_the_device_thread():
    """Autograd's thread outside K4: its launches count under the span the
    step's thread is in."""
    sp = [span(1, "train.step", 0, 50, thread=7, dev=(0, 50)),
          span(2, "train.backward", 10, 40, parent=1, thread=7, dev=(10, 40)),
          span(3, "k4", 20, 25, parent=2, thread=9, dev=(20, 25))]
    rt = [["cudaLaunchKernel", 15_000.0, 1.0, 9, 1], ["cudaLaunchKernel", 22_000.0, 1.0, 9, 2],
          ["cuLaunchKernel", 30_000.0, 1.0, 9, 3]]
    ops = [["a", 15_010.0, 1.0, 1], ["b", 22_010.0, 1.0, 2], ["c", 30_010.0, 1.0, 3]]
    got = SP.attribute_launches(traced({"spans": sp}, ops, rt))
    assert got["by_span"] == {"k4": 1} and got["linked"] == {"train.backward": 2}


def test_stamps_lie_after_their_launch_calls():
    sp = [span(1, "vocode.k1", 0, 10, k1=[2_030_000, 6_040_000])]
    rt = [["cudaLaunchCooperativeKernel", 2_000.0, 20.0, 7, 1], ["cudaLaunchKernel", 3_000.0, 5.0, 7, 2],
          ["cudaLaunchCooperativeKernel", 6_000.0, 25.0, 7, 3]]
    ops = [["wavernn_grid_kernel(Params)", 2_010.0, 5.0, 1], ["elementwise", 3_010.0, 1.0, 2],
           ["wavernn_grid_kernel(Params)", 6_012.0, 5.0, 3]]
    c = {"offset_us": 0.0, "error_us": 2.0}
    got = SP.stamp_check(sp, rt, ops, c, (0, 10_000_000))
    assert got["pairs"] == 2 and got["lag_us"] == pytest.approx([10.0, 15.0]) and got["violations"] == 0
    late_clock = dict(c, offset_us=-20.0)  # a clock that maps the stamps 20 us early
    assert SP.stamp_check(sp, rt, ops, late_clock, (0, 10_000_000))["violations"] == 2


def train_rec():
    steps = [{"t0": 0.000, "t1": 0.100, "load_s": 0.01}, {"t0": 0.100, "t1": 0.200, "load_s": 0.01},
             {"t0": 0.200, "t1": 0.400, "load_s": 0.01, "profiled": True}]
    sp = []
    i = 0
    for k, st in enumerate(steps):
        b = st["t0"] * 1e3
        i += 10
        sp += [span(i + 1, "data.load", b, b + 8, thread=1),
               span(i + 2, "data.to_device", b + 8, b + 10, thread=1),
               span(i, "train.step", b + 10, b + 99, thread=1, dev=(b + 10, b + 99)),
               span(i + 3, "train.forward", b + 10, b + 40, parent=i, trace=i, dev=(b + 10, b + 45)),
               span(i + 4, "train.backward", b + 40, b + 70, parent=i, trace=i, dev=(b + 45, b + 80)),
               span(i + 5, "k4", b + 50, b + 60, parent=i + 4, trace=i, thread=2, dev=(b + 50, b + 60)),
               span(i + 6, "train.optimizer", b + 70, b + 90, parent=i, trace=i, dev=(b + 80, b + 95)),
               span(i + 7, "train.readback", b + 90, b + 99, parent=i, trace=i)]
    return {"model": "tacotron", "steps": steps, "steps_traced": steps[2:], "spans": sp}


def test_train_metrics_by_hand():
    r = train_rec()
    assert SP.train_forward_ms(r) == pytest.approx(35.0)
    assert SP.train_backward_ms(r) == pytest.approx(35.0)
    assert SP.train_optimizer_ms(r) == pytest.approx(15.0)
    split = SP.train_split(r)
    assert split["host_step_ms"] == pytest.approx(100.0)
    assert split["parts_ms"]["data.load"] == pytest.approx(8.0) and split["parts_ms"]["train.readback"] == 9.0
    assert split["sum_ms"] == pytest.approx(35 + 35 + 15 + 8 + 2 + 9)
    # the traced step: host 210-299 ms; operations at 220, 250, 290 and 305 ms start, trace = host - 1 ms
    ops = [["k", 220_000.0 - 1000, 1.0, 1], ["k", 250_000.0 - 1000, 1.0, 2], ["k", 290_000.0 - 1000, 1.0, 3],
           ["k", 305_000.0 - 1000, 1.0, 4]]
    assert SP.train_launches_per_step(traced(r, ops, offset_us=-1000.0, window_ms=(200, 400))) == 3.0


@pytest.mark.card
def test_on_the_card_device_times_resolve_and_the_clock_holds(card, tmp_path):
    """Two synthesizer calls at small widths on the card, with the spans on
    and a device trace: every device span has its CUDA-event times, the
    clock's error is within 100 us, every launch stamp lies after its
    launch call on that clock, and no operation starts before the span
    that launched it."""
    import math

    from benchmark.drivers import serve_open_loop as S
    from benchmark.tests.conftest import tiny_context
    from tacotronv2_wavernn_chinese_tpu_torch.utils import metrics as M

    ctx = tiny_context("fwd-raw10.serve-poisson", 2**33 + 3, str(tmp_path), device=card)
    _, _, _, synth = S.build(ctx)
    synth.synthesize_batch(["你好，世界。"] * 2, seed=[1, 2], pad_batch=True)  # builds and loads the kernels
    SP.SpanTrace.warm()
    trace = SP.SpanTrace(str(tmp_path))
    M.enable()
    try:
        M.drain()
        trace.start()
        for seeds in ([3, 4, 5], [6]):
            synth.synthesize_batch(["今天天气很好。"] * len(seeds), seed=seeds, pad_batch=True)
        trace.stop()
        trace.collect()
        rec = dict(trace.record(), spans=M.drain())
    finally:
        M.enable(False)
    dev = [s for s in rec["spans"] if s["name"] in ("synth.decode", "vocode.k1", "vocode.unfold")]
    assert len(dev) == 6 and all(math.isfinite(s["dev_ms"]) and s["dev_ms"] > 0 for s in dev)
    c = rec["clock"]
    assert c is not None and c["error_us"] <= 100.0, c
    win = rec["trace_window_ns"]
    chk = SP.stamp_check(rec["spans"], rec["trace_runtime"], rec["trace_ops"], c, win)
    assert chk["pairs"] == 4 and chk["violations"] == 0, chk
    got = SP.attribute_launches(rec)
    assert got["late"] == 0 and got["by_span"].get("vocode.k1", 0) >= 2, got
