"""Open-loop serving: the port's HTTP server (``serving/server.py``) on a
loopback port, with its default micro-batching, fed by a client process
that sends each request of a seeded Poisson schedule at its due time.

Set-up makes the weights on the card from the seed, starts the server,
runs the program's warm-up of every batch bucket and one request over
HTTP.  The window is the schedule; each request is timed from its due time
to the last byte of its answer.  With ``--trace 1`` a device trace covers
a middle part of the window, opened and closed between two synthesizer
calls (the next call waits while it opens or closes).

Spans and counters come from this file: the service's ``Synthesizer``
instance has its ``synthesize`` / ``synthesize_batch`` wrapped at run
time, and the sampled requests' decoder frames and sample-loop labels are
kept by wrapping ``models.tacotron.decode_autoregressive`` and
``ops.wavernn_kernel.sample_labels``, without changing what they return.
"""

from __future__ import annotations

import contextlib
import json
import math
import os
import subprocess
import sys
import threading
import time

from .. import core, portcfg, traffic_gen
from ..compare import serve as CMP
from ..weights import make_params, with_stop_bias


class Capture:
    """Spans of every synthesizer call, and the served outputs of the
    requests whose seeds are in ``keep``."""

    def __init__(self, keep: list):
        self.keep_order = list(keep)
        self.keep = set(keep)
        self.calls: list = []
        self.results: dict = {}
        self.decodes: dict = {}
        self.active = False
        self.local = threading.local()
        self._restore = []
        # calls pass this gate one at a time; ``between_calls`` takes it
        # between two of them (the service's own lock is held across a
        # whole drain of its queue)
        self.gate = threading.Lock()
        self.want_gate = False

    def install(self, synth) -> None:
        from tacotronv2_wavernn_chinese_tpu_torch.models import tacotron as T
        from tacotronv2_wavernn_chinese_tpu_torch.ops import wavernn_kernel as WK

        orig_one, orig_many = synth.synthesize, synth.synthesize_batch

        def synthesize(text, out_dir=None, seed=0):
            return self._call(lambda: [orig_one(text, out_dir=out_dir, seed=seed)], [int(seed)], 1)[0]

        def synthesize_batch(texts, seed=0, pad_batch=False):
            seeds = [int(seed)] * len(texts) if isinstance(seed, int) else [int(s) for s in seed]
            rows = 1 << (len(texts) - 1).bit_length() if pad_batch else len(texts)
            return self._call(lambda: orig_many(texts, seed=seed, pad_batch=pad_batch), seeds, rows)

        synth.synthesize, synth.synthesize_batch = synthesize, synthesize_batch
        orig_dec, orig_k1 = T.decode_autoregressive, WK.sample_labels

        def decode_autoregressive(params, cfg, memory, mem_mask, seeds, max_iters=None):
            out = orig_dec(params, cfg, memory, mem_mask, seeds, max_iters)
            rec = getattr(self.local, "call", None)
            if rec is not None and rec["keep"]:
                for b, s in enumerate(rec["seeds"]):
                    if s in self.keep and s not in self.decodes:
                        self.decodes[s] = {"frames": out[0][b].clone(), "T_in": int(memory.shape[1])}
            return out

        def sample_labels(cond, w, seed, greedy=False):
            labels = orig_k1(cond, w, seed, greedy)
            rec = getattr(self.local, "call", None)
            if rec is not None and rec["keep"]:
                rec["k1"] = {"labels": labels, "seed": int(seed), "greedy": bool(greedy)}
            return labels

        T.decode_autoregressive, WK.sample_labels = decode_autoregressive, sample_labels
        self._restore = [(T, "decode_autoregressive", orig_dec), (WK, "sample_labels", orig_k1),
                         (synth, "synthesize", orig_one), (synth, "synthesize_batch", orig_many)]

    def uninstall(self) -> None:
        for obj, name, orig in self._restore:
            setattr(obj, name, orig)
        self._restore = []

    @contextlib.contextmanager
    def between_calls(self):
        """Hold the next call back until the block is done."""
        self.want_gate = True
        with self.gate:
            self.want_gate = False
            yield

    def _call(self, fn, seeds: list, rows: int):
        """``rows``: the batch the call decodes, padding rows included."""
        rec = {"seeds": seeds, "batch_rows": rows, "keep": self.active and bool(self.keep.intersection(seeds))}
        while self.want_gate:
            time.sleep(0.0005)
        with self.gate:
            self.local.call = rec
            rec["t0"] = time.monotonic()
            try:
                out = fn()
            finally:
                rec["t1"] = time.monotonic()
                self.local.call = None
        if self.active:
            rec["tin_rows"] = [len(r["pyin"].split(" ")) + 1 for r in out]
            rec["frames_rows"] = [int(r["mel"].shape[0]) for r in out]
            rec["samples_rows"] = [int(r["wav"].shape[0]) for r in out]
            if rec["keep"]:
                rec["mels_rows"] = [r["mel"] for r in out]
            for s, r in zip(seeds, out):
                if s in self.keep and s not in self.results:
                    self.results[s] = {k: r[k] for k in ("mel", "wav", "pyin")}
            self.calls.append(rec)
        return out

    def call_of(self, seed: int, holding: str) -> dict:
        """The kept call that served ``seed`` and holds ``holding``."""
        for rec in self.calls:
            if seed in rec["seeds"] and holding in rec:
                return rec
        raise KeyError(f"no kept call with {holding} served seed {seed}")


def build(ctx):
    """The port's config, the weights and the synthesizer of this cell."""
    from tacotronv2_wavernn_chinese_tpu_torch.infer.synthesizer import Synthesizer
    from tacotronv2_wavernn_chinese_tpu_torch.utils.checkpoints import init_tacotron, init_wavernn

    tr = ctx.traffic
    cfg = portcfg.build(ctx.conf, ctx.patch)
    frames = int(tr["frames"])
    tp = with_stop_bias(make_params(init_tacotron(0, cfg.tacotron, device="meta"), ctx.seed, ctx.device),
                        tr["stop_bias"])
    vp = None
    if ctx.conf["vocoder"] == "wavernn":
        tmpl = init_wavernn(0, cfg.wavernn, cfg.audio.num_mels, cfg.audio.bits, device="meta")
        vp = make_params(tmpl, ctx.seed + 1, ctx.device)
    synth = Synthesizer(cfg, tp, vp, max_iters=frames, device=ctx.device)
    return cfg, tp, vp, synth


def run(ctx) -> dict:
    import torch

    from tacotronv2_wavernn_chinese_tpu_torch.serving import server as SRV

    tr = ctx.traffic
    cfg, tp, vp, synth = build(ctx)
    hop = cfg.audio.hop_size
    samples = int(tr["frames"]) * hop
    schedule = traffic_gen.serve_schedule(tr, ctx.seed, ctx.seconds, ctx.rate)
    keep = traffic_gen.check_sample(schedule, 2 * int(tr["check"]["requests"]), ctx.seed)
    cap = Capture(keep)
    cap.install(synth)
    srv = dict(tr["server"])
    httpd = SRV.serve(cfg, synth, "127.0.0.1", 0, max_batch=srv["max_batch"], max_queue=srv["max_queue"],
                      max_batch_hard=srv["max_batch_hard"])
    th = threading.Thread(target=httpd.serve_forever, daemon=True)
    th.start()
    client = None
    try:
        service, port = httpd.service, httpd.server_address[1]
        # every batch bucket at the traffic's longest text, so the largest
        # shapes (and the allocator's blocks) exist before the window
        SRV.warmup(synth, service.max_batch_hard, text=max(schedule, key=lambda r: len(r["text"]))["text"])
        _post(port, tr["warmup_text"])
        if ctx.trace:
            core.DeviceTrace.warm()
        keep_set = set(keep)
        sched_path = os.path.join(ctx.workdir, "schedule.json")
        out_path = os.path.join(ctx.workdir, "client.json")
        t0 = time.monotonic() + float(tr.get("client_start_s", 1.0))
        with open(sched_path, "w", encoding="utf-8") as f:
            json.dump({"port": port, "t0": t0, "window_s": ctx.seconds, "timeout_s": float(tr["timeout_s"]),
                       "requests": [dict(r, keep=r["seed"] in keep_set) for r in schedule]}, f)
        n_req0, n_call0 = service.n_requests, service.n_device_calls
        cap.active = True
        client = subprocess.Popen([sys.executable, os.path.join(core.HERE, "client.py"), sched_path, out_path])
        setup_s = t0 - ctx.t_start
        trace = None
        if ctx.trace:
            trace = core.DeviceTrace(ctx.workdir)
            a = t0 + ctx.seconds * float(tr["trace_from"])
            b = min(a + float(tr["trace_seconds"]), t0 + ctx.seconds)
            _sleep_until(a)
            with cap.between_calls():
                trace.start()
            _sleep_until(b)
            with cap.between_calls():
                trace.stop()
        client.wait(timeout=ctx.seconds + float(tr["timeout_s"]) + 120)
        cap.active = False
        with open(out_path, encoding="utf-8") as f:
            cres = json.load(f)
        counters = {"requests": service.n_requests - n_req0, "device_calls": service.n_device_calls - n_call0,
                    "rejected": service.n_rejected}
    finally:
        if client is not None and client.poll() is None:
            client.kill()
            client.wait()
        httpd.shutdown()
        httpd.server_close()
        th.join(timeout=30)
        cap.uninstall()
    device = core.device_info(1) if ctx.device != "cpu" else {"platform": "cpu", "kind": "cpu", "count": 1,
                                                               "memory_peak_bytes": 0}
    results = cres["results"]
    lat, audio_s, failed = [], 0.0, 0
    t_end = t0 + ctx.seconds
    for r in results:
        ok = r["code"] == 200 and r.get("status") == 0 and r.get("samples") == samples
        if ok:
            lat.append(r["done"] - r["due"])
            if r["done"] <= t_end:
                audio_s += r["audio_s"]
        else:
            lat.append(math.inf)
            failed += 1
    p95 = core.percentile(lat, 95)
    if math.isinf(p95):  # more than 5 % failed: the tail is the wait's limit
        p95 = ctx.seconds + float(tr["timeout_s"])
    e2e = {"setup_s": setup_s, "request_p95_ms": p95 * 1e3, "audio_s_per_s": audio_s / ctx.seconds}
    rec = {"calls": cap.calls, "requests": results, "counters": counters, "conf": ctx.conf_sections, "traffic": tr,
           "window_s": ctx.seconds, "max_late_s": cres["max_late_s"], "hop": hop}
    breakdown = None
    if trace is not None:
        events = trace.collect()
        red = core.reduce_trace(events, trace.window_s)
        rec["trace"] = red
        rec["calls_traced"] = [c for c in cap.calls if trace.t0 <= c["t0"] and c["t1"] <= trace.t1]
        device.update(busy_s=red["busy_s"], window_s=red["window_s"])
        breakdown = {"device_ops": red["device_ops"], "idle_gaps": red["idle_gaps"]}
    # the comparison runs after the window, with the peak read and the server gone
    with torch.no_grad():
        texts = {r["seed"]: r["text"] for r in schedule}
        vals = CMP.readings(ctx.conf_sections, tp, vp, cap, results, samples, ctx.device, texts,
                            compare=int(tr["check"]["requests"]))
        control = CMP.readings(ctx.conf_sections, tp, vp, cap, results, samples, ctx.device, texts, control=True,
                               compare=int(tr["check"]["requests"])) if getattr(ctx, "control", False) else None
    checks = CMP.judge(tr["check"]["limits"], vals)
    checks["requests_compared"] = core.check(vals["requests_compared"], 1, larger_fails=False)
    done = sorted((r for r in results if r["code"] == 200), key=lambda r: r["due"])
    q = max(1, len(done) // 4)
    trend = [1e3 * sum(r["done"] - r["due"] for r in part) / len(part) for part in (done[:q], done[-q:])] \
        if done else [math.nan, math.nan]
    ok_lat = sorted(1e3 * x for x in lat if not math.isinf(x))
    stats = {f"p{q}": round(core.percentile(ok_lat, q), 3) for q in (50, 90, 95, 99)} if ok_lat else {}
    stats["mean"] = round(sum(ok_lat) / len(ok_lat), 3) if ok_lat else math.nan
    print(f"client ran at most {cres['max_late_s'] * 1e3:.3f} ms late; {counters}; mean latency of the "
          f"first and last quarter of answered requests {trend[0]:.1f} / {trend[1]:.1f} ms; latency ms {stats}",
          file=sys.stderr)
    return {"attempted": len(results), "failed": failed, "e2e": e2e, "record": rec, "device": device,
            "checks": checks, "breakdown": breakdown, "readings": vals, "control": control}


def _sleep_until(t: float) -> None:
    d = t - time.monotonic()
    if d > 0:
        time.sleep(d)


def _post(port: int, text: str) -> None:
    import urllib.request

    req = urllib.request.Request(f"http://127.0.0.1:{port}/generate_tts",
                                 data=json.dumps({"text": text, "seed": 1}).encode("utf-8"),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=600) as resp:
        body = json.loads(resp.read())
    if body.get("status") != 0:
        raise core.BenchError(f"the warm-up request failed: {body.get('error')}")
