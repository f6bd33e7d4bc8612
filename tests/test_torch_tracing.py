"""The program's spans and counters (``utils/metrics.py``) on the CPU.

Off, a synthesis and a training step of each model record nothing and
create no span object and no CUDA event; on or off, their outputs are the
same bits; on, the spans nest as the program opens them, one trace id per
request across the handler and leader threads and one per training step,
the backward's spans included; an HTTP round trip through ``serve()``
yields the request's whole trace.  Device events are exercised with a
stand-in event class, since the CPU has none."""

import dataclasses
import json
import threading
import time
import urllib.request

import numpy as np
import pytest
import torch

from tacotronv2_wavernn_chinese_tpu_torch.config import default_config
from tacotronv2_wavernn_chinese_tpu_torch.infer.synthesizer import Synthesizer
from tacotronv2_wavernn_chinese_tpu_torch.serving import server as SRV
from tacotronv2_wavernn_chinese_tpu_torch.train import tacotron_task as TT
from tacotronv2_wavernn_chinese_tpu_torch.train import wavernn_task as WT
from tacotronv2_wavernn_chinese_tpu_torch.utils import metrics as M
from tacotronv2_wavernn_chinese_tpu_torch.utils import tree_leaves
from tacotronv2_wavernn_chinese_tpu_torch.utils.checkpoints import init_tacotron, init_wavernn

HOP = 20
TEXTS = ["你好。", "今天天气很好。", "这是第3个句子。"]


def _cfg():
    cfg = default_config()
    return dataclasses.replace(
        cfg,
        tacotron=dataclasses.replace(
            cfg.tacotron, embedding_dim=16, enc_conv_channels=16, enc_conv_layers=2, encoder_lstm_units=16,
            attention_dim=8, attention_filters=4, attention_kernel=7, prenet_layers=(16, 16),
            decoder_lstm_units=16, postnet_channels=16, postnet_layers=2,
        ),
        wavernn=dataclasses.replace(cfg.wavernn, upsample_factors=(2, 2, 5), rnn_dims=16, fc_dims=16,
                                    compute_dims=8, res_out_dims=128, res_blocks=1),
        wavernn_gen=dataclasses.replace(cfg.wavernn_gen, target=100, overlap=20),
        wavernn_train=dataclasses.replace(cfg.wavernn_train, batch_size=2, seq_len_hops=3),
        audio=dataclasses.replace(cfg.audio, hop_size=HOP, bits=8),
    )


@pytest.fixture(scope="module")
def setup():
    cfg = _cfg()
    tp = init_tacotron(0, cfg.tacotron, device="cpu")
    vp = init_wavernn(1, cfg.wavernn, cfg.audio.num_mels, cfg.audio.bits, device="cpu")
    synth = Synthesizer(cfg, tp, vp, max_iters=6, device="cpu")
    return cfg, tp, vp, synth


@pytest.fixture(autouse=True)
def tracer_off():
    """Every test starts and ends with the tracer off and drained."""
    M.enable(False)
    M.drain()
    yield
    M.enable(False)
    M.drain()


def _taco_batch(seed=0, B=2, T_in=9, T_out=8):
    rng = np.random.default_rng(seed)
    lens = np.asarray([T_out, T_out - 3], np.int32)[:B]
    b = {"inputs": rng.integers(1, 60, (B, T_in)).astype(np.int32),
         "input_lengths": np.asarray([T_in, 6], np.int32)[:B],
         "mel_targets": rng.uniform(-4, 4, (B, T_out, 80)).astype(np.float32),
         "stop_targets": (np.arange(T_out)[None] >= lens[:, None] - 1).astype(np.float32),
         "target_lengths": lens, "loss_frames": np.full((B,), T_out, np.int32)}
    return {k: torch.as_tensor(v) for k, v in b.items()}


def _voc_batch(cfg, seed=0):
    wc = cfg.wavernn_train
    T = wc.seq_len_hops * HOP
    rng = np.random.default_rng(seed)
    return WT.batch_to_device(
        type("B", (), {"x": rng.uniform(-1, 1, (wc.batch_size, T)).astype(np.float32),
                       "y": rng.integers(0, 2 ** cfg.audio.bits, (wc.batch_size, T)).astype(np.int32),
                       "mels": rng.uniform(0, 1, (wc.batch_size, wc.seq_len_hops + 2 * cfg.wavernn.pad, 80))
                       .astype(np.float32)})(), "cpu")


def _taco_step(cfg, tp):
    state = TT.TrainState(0, tp, TT.adam_init(tp))
    gen = torch.Generator().manual_seed(3)
    return TT.train_step(state, _taco_batch(), gen, cfg)


def _voc_step(cfg, vp):
    state = WT.TrainState(0, vp, WT.adam_init(vp))
    return WT.train_step(state, _voc_batch(cfg), cfg)


def _run_all(setup):
    cfg, tp, vp, synth = setup
    rows = synth.synthesize_batch(TEXTS[:2], seed=[5, 6], pad_batch=True)
    t_state, t_m = _taco_step(cfg, tp)
    v_state, v_m = _voc_step(cfg, vp)
    return rows, (t_state, t_m), (v_state, v_m)


class _Refuse:
    def __init__(self, *a, **k):
        raise AssertionError("tracing is off: nothing may be created")


def test_off_records_and_creates_nothing(setup, monkeypatch):
    monkeypatch.setattr(M, "Span", _Refuse)
    monkeypatch.setattr(torch.cuda, "Event", _Refuse)
    monkeypatch.setattr(torch.cuda, "synchronize", _Refuse)
    _run_all(setup)
    assert M.span("x", device=True) is M.OFF and not M.OFF
    assert M.current() is None and M.linked() is None
    assert M.drain() == []


def _same(a, b):
    if isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            _same(a[k], b[k])
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _same(x, y)
    elif isinstance(a, (torch.Tensor, np.ndarray)):
        assert np.array_equal(np.asarray(a), np.asarray(b))
    elif isinstance(a, (TT.TrainState,)):
        _same(tree_leaves(a.params), tree_leaves(b.params))
    else:
        assert a == b or (isinstance(a, float) and np.isnan(a) and np.isnan(b))


def test_on_or_off_gives_the_same_bits(setup):
    off = _run_all(setup)
    M.enable()
    on = _run_all(setup)
    M.enable(False)
    assert len(M.drain()) > 0
    _same([{k: r[k] for k in ("wav", "mel", "alignment", "pyin")} for r in off[0]],
          [{k: r[k] for k in ("wav", "mel", "alignment", "pyin")} for r in on[0]])
    for (s_off, m_off), (s_on, m_on) in zip(off[1:], on[1:]):
        _same(m_off, m_on)
        _same(tree_leaves(s_off.params), tree_leaves(s_on.params))


def _by_name(spans):
    out = {}
    for s in spans:
        out.setdefault(s["name"], []).append(s)
    return out


def _chain(spans, s):
    ids = {x["id"]: x for x in spans}
    names = []
    while s["parent"] is not None:
        s = ids[s["parent"]]
        names.append(s["name"])
    return names


def test_synthesis_spans_nest(setup):
    _, _, _, synth = setup
    M.enable()
    rows = synth.synthesize_batch(TEXTS, seed=[1, 2, 3], pad_batch=True)
    spans = M.drain()
    by = _by_name(spans)
    for name in ("synth.g2p", "synth.decode", "synth.trim", "vocode.prepare", "vocode.k1", "vocode.unfold",
                 "tacotron.encoder", "tacotron.decoder", "tacotron.postnet"):
        assert len(by[name]) == 1, name
    assert len({s["trace"] for s in spans}) == 6  # nothing encloses the call: each top span is a root
    dec = by["synth.decode"][0]
    assert dec["attrs"] == {"rows": 3, "padded_rows": 4, "T_in": dec["attrs"]["T_in"]}
    for name in ("tacotron.encoder", "tacotron.decoder", "tacotron.postnet"):
        assert _chain(spans, by[name][0]) == ["synth.decode"]
        assert by[name][0]["trace"] == dec["trace"]
    k1 = by["vocode.k1"][0]
    assert k1["attrs"]["folds"] % 8 == 0 and k1["attrs"]["samples"] == sum(len(r["wav"]) for r in rows)
    for s in spans:
        assert s["t0"] <= s["t1"] and "dev_ms" not in s  # no card: no device times
    order = [s["name"] for s in sorted((s for s in spans if s["parent"] is None), key=lambda s: s["t0"])]
    assert order == ["synth.g2p", "synth.decode", "synth.trim", "vocode.prepare", "vocode.k1", "vocode.unfold"]


def test_griffin_lim_spans(setup):
    cfg, tp, _, _ = setup
    synth = Synthesizer(cfg, tp, None, max_iters=6, device="cpu")
    M.enable()
    synth.synthesize_batch(TEXTS[:2], seed=0, pad_batch=True)
    names = [s["name"] for s in M.drain()]
    assert {"synth.g2p", "synth.decode", "synth.griffin_lim", "synth.trim"} <= set(names)


def test_training_step_spans_share_the_step_trace(setup):
    cfg, tp, vp, _ = setup
    M.enable()
    _taco_step(cfg, tp)
    spans = M.drain()
    by = _by_name(spans)
    step = by["train.step"][0]
    assert step["parent"] is None and step["attrs"] == {"step": 0, "rows": 2, "T_in": 9, "T": 8}
    assert {s["trace"] for s in spans} == {step["trace"]}
    want = {"train.forward": ["train.step"], "train.backward": ["train.step"], "train.optimizer": ["train.step"],
            "train.readback": ["train.step"], "tacotron.encoder": ["train.forward", "train.step"],
            "tacotron.decoder": ["train.forward", "train.step"], "tacotron.postnet": ["train.forward", "train.step"],
            "tacotron.loss": ["train.forward", "train.step"],
            "k3": ["tacotron.decoder", "train.forward", "train.step"],
            "k4": ["train.backward", "train.step"], "train.weight_grads": ["train.backward", "train.step"]}
    for name, chain in want.items():
        assert [_chain(spans, s) for s in by[name]] == [chain], name

    _voc_step(cfg, vp)
    spans = M.drain()
    by = _by_name(spans)
    step = by["train.step"][0]
    (load,) = by["data.to_device"]  # the batch's copy, before the step: a root of its own
    assert {s["trace"] for s in spans if s is not load} == {step["trace"]} and step["attrs"]["rows"] == 2
    assert [s["attrs"]["layer"] for s in by["wavernn.gru"]] == [1, 2]
    assert all(_chain(spans, s) == ["train.forward", "train.step"] for s in by["wavernn.gru"])
    assert [_chain(spans, s) for s in by["train.optimizer"]] == [["train.step"]]


def test_linked_reaches_the_step_from_another_thread():
    """Autograd's device thread has no span of its own: ``linked()`` gives
    it the innermost open span of the thread that opened the step."""
    M.enable()
    seen = {}

    def device_thread():
        assert M.current() is None
        with M.span("k4", parent=M.linked()) as sp:
            seen["k4"] = sp
            with M.span("inner") as inner:
                seen["inner_parent"] = M.linked() is inner

    with M.span("train.step", anchor=True) as step:
        with M.span("train.backward") as bwd:
            th = threading.Thread(target=device_thread)
            th.start()
            th.join(timeout=30)
    assert not th.is_alive() and seen["inner_parent"]
    assert M.linked() is None  # the anchor closed with its span
    spans = {s["name"]: s for s in M.drain()}
    assert spans["k4"]["trace"] == step.trace and spans["k4"]["parent"] == bwd.id
    assert spans["inner"]["parent"] == spans["k4"]["id"]
    assert spans["k4"]["thread"] != spans["train.step"]["thread"]


class _FakeEvent:
    """A stand-in for ``torch.cuda.Event``: it reads the host clock."""

    made = 0

    def __init__(self, enable_timing=False):
        assert enable_timing
        _FakeEvent.made += 1
        self.t = None

    def record(self):
        self.t = time.monotonic_ns()

    def elapsed_time(self, end):
        return (end.t - self.t) / 1e6


def test_device_events_come_from_a_pool_and_are_read_once(monkeypatch):
    syncs = []
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "Event", _FakeEvent)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: syncs.append(1))
    _FakeEvent.made = 0
    M.enable()
    assert len(syncs) == 1  # the clock's anchor, recorded with the device idle
    for _ in range(2):
        for i in range(5):
            with M.span("outer", device=True, i=i):
                with M.span("host"):
                    time.sleep(0.001)
        n_sync = len(syncs)
        spans = M.drain()
        assert len(syncs) == n_sync + 2  # one read, one new anchor
        outer = [s for s in spans if s["name"] == "outer"]
        assert len(outer) == 5 and all("dev_ms" not in s for s in spans if s["name"] == "host")
        for s in outer:
            assert s["dev_ms"] >= 1.0 and s["dev_t0"] <= s["dev_t1"]
            assert abs(s["dev_t0"] - s["t0"]) < 5e6 and s["dev_ms"] == pytest.approx((s["dev_t1"] - s["dev_t0"]) / 1e6, abs=1e-3)
    assert _FakeEvent.made == 11  # 1 anchor + 10 edges; the new anchor and the second round reuse them
    M.enable(False)


def test_counters_are_the_launch_counts_by_reference():
    from tacotronv2_wavernn_chinese_tpu_torch import ops
    from tacotronv2_wavernn_chinese_tpu_torch.data import loader as DL
    from tacotronv2_wavernn_chinese_tpu_torch.models import hifigan as H
    from tacotronv2_wavernn_chinese_tpu_torch.models import tacotron as T

    assert M.counters() == {"launches": ops.LAUNCHES, "decoder_steps": T.DECODER_STEPS,
                            "decoder_graphs": T.DECODER_GRAPHS, "loader": DL.LOADER, "hifigan": H.HIFIGAN}
    assert M.counters()["launches"] is ops.LAUNCHES and M.counters()["decoder_steps"] is T.DECODER_STEPS
    assert M.counters()["decoder_graphs"] is T.DECODER_GRAPHS and M.counters()["loader"] is DL.LOADER
    assert M.counters()["hifigan"] is H.HIFIGAN


def test_hifigan_step_spans_and_counters():
    """A HiFi-GAN step: one ``train.step`` trace; the generator's forward
    and its backward under ``hifigan.generator``; the two mels; each
    network's step with its forward, backward and optimizer; and the
    counters advance by the samples generated and four power iterations."""
    from tacotronv2_wavernn_chinese_tpu_torch.models import hifigan as H
    from tacotronv2_wavernn_chinese_tpu_torch.train import hifigan_task as HT

    cfg = default_config()
    cfg = dataclasses.replace(
        cfg, hifigan=dataclasses.replace(cfg.hifigan, upsample_initial_channel=16, mpd_channels=(4, 8, 8, 16, 16),
                                         msd_channels=(16, 16, 16, 16, 32, 32, 32)),
        hifigan_train=dataclasses.replace(cfg.hifigan_train, batch_size=2, segment_size=1024))
    state = HT.init_state(3, cfg, "cpu")
    audio = torch.randn(2, 1024, generator=torch.Generator().manual_seed(1)) * 0.1
    before = dict(H.HIFIGAN)
    M.enable()
    try:
        HT.train_step(state, {"audio": audio}, cfg)
        spans = M.drain()
    finally:
        M.enable(False)
    assert H.HIFIGAN == {"samples": before["samples"] + 2 * 1024, "sn_power_iters": before["sn_power_iters"] + 4}
    by = _by_name(spans)
    step = by["train.step"][0]
    assert step["parent"] is None and step["attrs"] == {"step": 0, "rows": 2, "T": 1024}
    assert {s["trace"] for s in spans} == {step["trace"]}
    assert sorted(_chain(spans, s) for s in by["hifigan.generator"]) == [
        ["train.backward", "hifigan.gen_step", "train.step"], ["train.forward", "train.step"]]
    assert sorted(_chain(spans, s) for s in by["hifigan.mel"]) == [["train.forward", "train.step"], ["train.step"]]
    for phase in ("hifigan.disc_step", "hifigan.gen_step"):
        assert [_chain(spans, s) for s in by[phase]] == [["train.step"]]
        for name in ("train.forward", "train.backward", "train.optimizer"):
            assert sum(_chain(spans, s)[0] == phase for s in by[name]) == 1, (phase, name)
    assert [_chain(spans, s) for s in by["train.readback"]] == [["train.step"]]


def test_stamp_marks_the_innermost_span():
    M.enable()
    with M.span("vocode.k1"):
        M.stamp("k1")
        M.stamp("k1")
    M.stamp("k2")  # no span open: dropped
    (s,) = M.drain()
    assert len(s["attrs"]["k1"]) == 2 and s["t0"] <= s["attrs"]["k1"][0] <= s["t1"]


def _post(port, path, payload):
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", data=json.dumps(payload).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=120) as r:
        return json.loads(r.read())


def test_http_round_trip_is_one_trace(setup):
    _, _, _, synth = setup
    httpd = SRV.serve(synth.cfg, synth, "127.0.0.1", 0)
    th = threading.Thread(target=httpd.serve_forever, daemon=True)
    th.start()
    try:
        M.enable()
        port = httpd.server_address[1]
        assert _post(port, "/generate_tts", {"text": TEXTS[1], "seed": 4})["status"] == 0
        assert _post(port, "/generate_tts_batch", {"texts": TEXTS[:2], "seed": 4})["status"] == 0
        time.sleep(0.05)  # the handler closes its span after the last byte
        spans = M.drain()
    finally:
        httpd.shutdown()
        httpd.server_close()
        th.join(timeout=30)
    reqs = [s for s in spans if s["name"] == "serve.request"]
    assert len(reqs) == 2
    one, many = sorted(reqs, key=lambda s: s["t0"])
    tr = [s for s in spans if s["trace"] == one["trace"]]
    names = [s["name"] for s in sorted(tr, key=lambda s: s["t0"])]
    assert names[:3] == ["serve.request", "serve.queue", "serve.call"]
    assert names.count("serve.respond") == 2 and names[-1] == "serve.respond"
    assert {"synth.g2p", "synth.decode", "vocode.k1", "vocode.unfold"} <= set(names)
    call = next(s for s in tr if s["name"] == "serve.call")
    assert call["attrs"] == {"rows": 1, "padded_rows": 1, "requests": [one["trace"]]}
    queue = next(s for s in tr if s["name"] == "serve.queue")
    assert queue["parent"] == one["id"] and call["parent"] == one["id"] and queue["t1"] <= call["t0"]
    assert all(one["t0"] <= s["t0"] and s["t1"] <= one["t1"] for s in tr)
    tr = [s["name"] for s in spans if s["trace"] == many["trace"]]
    assert "serve.call" in tr and tr.count("serve.respond") == 2 and "serve.queue" not in tr


def test_micro_batched_requests_keep_their_own_traces(setup):
    """Requests coalesced into one call: the call joins the first one's
    trace and lists every request's."""
    _, _, _, synth = setup
    svc = SRV.TTSService(synth.cfg, synth, max_batch=4)
    M.enable()
    svc._device.acquire()  # hold the device so that both requests queue
    out, ths = {}, []
    for i, text in enumerate(TEXTS[:2]):
        def handler(i=i, text=text):
            with M.span("serve.request") as req:
                out[i] = (req.trace, svc.generate(text, seed=i))
        ths.append(threading.Thread(target=handler))
        ths[-1].start()
    deadline = time.monotonic() + 30
    while len(svc._queue) < 2 and time.monotonic() < deadline:
        time.sleep(0.01)
    svc._device.release()
    for th in ths:
        th.join(timeout=60)
    assert all(not th.is_alive() for th in ths) and len(out) == 2
    spans = M.drain()
    (call,) = [s for s in spans if s["name"] == "serve.call"]
    assert sorted(call["attrs"]["requests"]) == sorted(t for t, _ in out.values()) and call["attrs"]["rows"] == 2
    assert call["trace"] in call["attrs"]["requests"]
    for t, _ in out.values():
        got = [s["name"] for s in spans if s["trace"] == t]
        assert "serve.queue" in got and "serve.respond" in got


def test_profiler_trace_carries_the_spans_on_its_clock(setup, tmp_path):
    """The trainers' ``--profile_dir`` trace: the spans of the profiled
    steps are "X" events on the trace's clock, each step's span holding
    that step's operations (on the CPU the trace records CPU activity)."""
    import glob

    cfg, tp, _, _ = setup
    state = TT.TrainState(0, tp, TT.adam_init(tp))
    gen = torch.Generator().manual_seed(0)
    prof = M.Profiler(str(tmp_path), start_step=1, num_steps=2)
    for i in range(3):
        prof.step(i)
        state, _ = TT.train_step(state, _taco_batch(), gen, cfg)
    prof.close()
    assert not M.TRACER.on  # put back as it was
    (path,) = glob.glob(str(tmp_path / "trace-steps-1-3.json"))
    with open(path, encoding="utf-8") as f:
        events = json.load(f)["traceEvents"]
    steps = [e for e in events if e.get("cat") == "program_span" and e["name"] == "train.step"]
    assert [e["args"]["step"] for e in steps] == [1, 2]
    mm = [e for e in events if e.get("cat") == "cpu_op" and e["name"] == "aten::mm"]
    inside = [sum(1 for o in mm if s["ts"] <= o["ts"] <= s["ts"] + s["dur"]) for s in steps]
    assert inside[0] == inside[1] > 0 and sum(inside) == len(mm)
