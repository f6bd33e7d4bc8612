"""The program's own spans beside the device trace: one clock for both, the
traced idle time under each span, and the per-layer numbers that read the
spans.

The port records spans (``utils/metrics.py``: ``enable``, ``drain``,
``counters``) on ``time.monotonic_ns()``, with CUDA-event times for device
spans; ``core.DeviceTrace`` records the device's operations on the
profiler's clock.  ``SpanTrace`` is that trace, keeping besides its
``events`` the trace's CUDA runtime and driver calls (each launch with
the correlation id of the operation it started) and a marker for the clock;
``clock`` pairs the two clocks.  Nothing here adds a device operation to a
traced window: the marker is a stream query, which runs nothing on the
device.

A record (``rec``) that these functions read holds, besides a driver's
own keys, ``spans`` (the program's ``drain()``), ``program_counters``
(``counters()``) and, traced, ``trace_ops`` (``[name, ts_us, dur_us,
correlation]``), ``trace_runtime`` (``[name, ts_us, dur_us, tid,
correlation]``) and ``clock`` ({"offset_us", "error_us", "method"}: trace
time = host time + offset).  The metric functions return None where the
record holds no spans, as a record of a program without them does.

Nothing here imports torch at import time.
"""

from __future__ import annotations

import bisect
import os
import time
import types

from . import core

LAUNCH_STAMPS = {"k1": "wavernn_grid_kernel", "k2": "tacotron_decode_kernel",
                 "k3": "tacotron_train_fwd_kernel", "k4": "tacotron_train_bwd_kernel"}
MARKER = "cudaStreamQuery"


class SpanTrace(core.DeviceTrace):
    """``core.DeviceTrace`` that also keeps the runtime calls and a clock
    marker; its ``events`` are DeviceTrace's, unchanged."""

    def __init__(self, workdir: str):
        super().__init__(workdir)
        self.marker = None
        self.ops: list = []
        self.runtime: list = []

    def stop(self) -> None:
        import torch

        torch.cuda.synchronize()
        self.t1 = time.monotonic()
        a = time.monotonic_ns()
        torch.cuda.current_stream().query()  # a runtime call that runs nothing on the device
        self.marker = (a, time.monotonic_ns())
        self.prof.__exit__(None, None, None)

    def collect(self) -> list:
        """A profiler session exports once: the file is written here and
        DeviceTrace's own ``collect`` reads it as it reads its own."""
        path = os.path.join(self.workdir, "device_trace.json")
        self.prof.export_chrome_trace(path)
        trace = core.load_json(path)
        for e in trace.get("traceEvents", []):
            if e.get("ph") != "X":
                continue
            corr = (e.get("args") or {}).get("correlation")
            if e.get("cat") in core.DEVICE_CATS:
                self.ops.append([e["name"], float(e["ts"]), float(e.get("dur", 0.0)), corr])
            elif e.get("cat") in ("cuda_runtime", "cuda_driver"):
                self.runtime.append([e["name"], float(e["ts"]), float(e.get("dur", 0.0)), e.get("tid"), corr])
        self.ops.sort(key=lambda o: o[1])
        self.runtime.sort(key=lambda r: r[1])
        self.prof = types.SimpleNamespace(export_chrome_trace=lambda _path: None)
        return super().collect()

    def record(self) -> dict:
        """What a record keeps of this trace beside ``reduce_trace``'s."""
        return {"trace_ops": self.ops, "trace_runtime": self.runtime, "trace_window_ns": [
            round(self.t0 * 1e9), round(self.t1 * 1e9)], "clock": clock(self.runtime, self.marker)}


# ---------------------------------------------------------------------------
# one clock
# ---------------------------------------------------------------------------


def clock(runtime: list, marker) -> dict | None:
    """Trace time minus host time in us, from the marker: the last
    ``cudaStreamQuery`` in the trace, called between two host readings
    ``marker`` = (a_ns, b_ns).  The query lies inside them, so its middle
    is within half their distance of theirs: that is the error."""
    if marker is None:
        return None
    q = [r for r in runtime if r[0] == MARKER]
    if not q:
        return None
    name, ts, dur, _, _ = q[-1]
    a, b = marker
    return {"offset_us": ts + dur / 2 - (a + b) / 2e3, "error_us": (b - a) / 2e3, "method": "marker"}


def stamp_check(spans: list, runtime: list, ops: list, c: dict, window_ns) -> dict | None:
    """The clock against the program's launch stamps: a stamp is taken
    after its launch call returns, so on a right clock it lies after the
    end of that call in the trace (the i-th call that started a kernel of
    the stamp's kind is the i-th stamp in the window).  -> {"pairs",
    "lag_us": [least, most] of stamp - call end, "violations": pairs whose
    stamp lies before the call's end by more than the clock's error}."""
    lo, hi = window_ns
    start = {o[3]: o[0] for o in ops if o[3] is not None}
    lags = []
    for key, kernel in LAUNCH_STAMPS.items():
        stamps = sorted(t for s in spans for t in s["attrs"].get(key, []) if lo <= t <= hi)
        calls = [r for r in runtime if kernel in start.get(r[4], "")]
        if stamps and len(stamps) == len(calls):
            lags += [to_trace(t, c["offset_us"]) - (r[1] + r[2]) for t, r in zip(stamps, calls)]
    if not lags:
        return None
    return {"pairs": len(lags), "lag_us": [min(lags), max(lags)],
            "violations": sum(1 for x in lags if x < -c["error_us"])}


def trace_tids(span: dict) -> set:
    """The thread ids a trace may give the span's thread: the native id,
    or the profiler's, the magnitude of ``pthread_self()`` cut to a signed
    32-bit integer (read on the H100's machine: ident 0x7fabce322300 ->
    tid 835575040)."""
    out = {span["thread"]}
    ident = span.get("ident")
    if ident is not None:
        low = ident & 0xFFFFFFFF
        out |= {low, abs(low - (1 << 32) if low >= 1 << 31 else low)}
    return out


def to_trace(t_ns: int, offset_us: float) -> float:
    return t_ns / 1e3 + offset_us


# ---------------------------------------------------------------------------
# spans: trees, windows, attribution
# ---------------------------------------------------------------------------


def spans_of(rec, lo_ns=None, hi_ns=None) -> list:
    """The record's spans whose host start lies in [lo_ns, hi_ns]."""
    out = []
    for s in rec.get("spans") or []:
        if s.get("t1") is None:
            continue
        if (lo_ns is None or s["t0"] >= lo_ns) and (hi_ns is None or s["t0"] <= hi_ns):
            out.append(s)
    return out


def below(spans: list, roots: list) -> dict:
    """{root id: [spans under it, at any depth]} for ``roots``."""
    parent = {s["id"]: s["parent"] for s in spans}
    want = {r["id"] for r in roots}
    out = {r["id"]: [] for r in roots}
    for s in spans:
        p = s["parent"]
        while p is not None and p not in want:
            p = parent.get(p)
        if p is not None:
            out[p].append(s)
    return out


def innermost_at(spans: list):
    """A function t_us -> {thread: (name of its innermost open span,
    whether a device span is open on it)} over spans mapped to trace time
    (``ts0``, ``ts1``); depth is the nesting."""
    by_thread: dict = {}
    depth = _depths(spans)
    for s in spans:
        by_thread.setdefault(s["thread"], []).append((s["ts0"], s["ts1"], depth[s["id"]], s["name"], "dev_ms" in s))

    def at(t: float) -> dict:
        out = {}
        for th, items in by_thread.items():
            best, dev = None, False
            for a, b, d, n, is_dev in items:
                if a <= t < b:
                    dev = dev or is_dev
                    if best is None or d > best[0]:
                        best = (d, n)
            if best is not None:
                out[th] = (best[1], dev)
        return out

    return at


def _depths(spans: list) -> dict:
    parent = {s["id"]: s["parent"] for s in spans}
    depth = {}
    for s in spans:
        d, p = 0, s["parent"]
        while p is not None and p in parent:
            d, p = d + 1, parent[p]
        depth[s["id"]] = d
    return depth


def mapped(spans: list, offset_us: float) -> list:
    return [dict(s, ts0=to_trace(s["t0"], offset_us), ts1=to_trace(s["t1"], offset_us)) for s in spans]


def busy_union(ops: list, lo: float, hi: float) -> list:
    """The union of the device operations' intervals, clipped to [lo, hi]."""
    out = []
    for _, ts, dur, *_ in sorted(ops, key=lambda o: o[1]):
        a, b = max(ts, lo), min(ts + dur, hi)
        if b <= a:
            continue
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def idle_gaps(ops: list, lo: float, hi: float) -> list:
    gaps, end = [], lo
    for a, b in busy_union(ops, lo, hi):
        if a > end:
            gaps.append((end, a))
        end = max(end, b)
    if hi > end:
        gaps.append((end, hi))
    return gaps


def idle_by_span(rec, device_threads: bool = False) -> dict | None:
    """Traced idle seconds by the innermost span open on each thread:
    {name: s}, an idle instant counted once under each distinct name among
    the threads' innermost spans (a leader in ``vocode.prepare`` while
    another thread is in ``serve.respond`` counts under both; ten threads
    waiting in ``serve.queue`` count once), "(no span)" where no thread has
    one open.  With ``device_threads`` only threads inside a device span
    count (the thread issuing the device's work: a call's leader, the
    training loop, autograd's thread in K4), else "(no device span)".
    None without a trace, spans or clock."""
    c, ops, win = rec.get("clock"), rec.get("trace_ops"), rec.get("trace_window_ns")
    if not c or ops is None or not win:
        return None
    lo, hi = to_trace(win[0], c["offset_us"]), to_trace(win[1], c["offset_us"])
    spans = [s for s in mapped(spans_of(rec), c["offset_us"]) if s["ts1"] > lo and s["ts0"] < hi]
    if not spans:
        return None
    cuts = sorted({t for s in spans for t in (s["ts0"], s["ts1"]) if lo < t < hi})
    at = innermost_at(spans)
    none = "(no device span)" if device_threads else "(no span)"
    out: dict = {}
    for g0, g1 in idle_gaps(ops, lo, hi):
        i = bisect.bisect_right(cuts, g0)
        edges = [g0] + cuts[i:bisect.bisect_left(cuts, g1)] + [g1]
        for a, b in zip(edges, edges[1:]):
            names = {n for n, dev in at((a + b) / 2).values() if dev or not device_threads} or {none}
            for n in names:
                out[n] = out.get(n, 0.0) + (b - a) * 1e-6
    return dict(sorted(out.items(), key=lambda kv: -kv[1]))


def thread_map(spans: list, runtime: list) -> dict:
    """{trace tid: {span threads}}: the threads whose profiler id
    (``trace_tids``) is the tid (a thread's id is its ``pthread_self()``,
    which a later thread may reuse: the HTTP server starts a thread a
    request), else the thread whose device spans hold the most of that
    tid's runtime calls."""
    known: dict = {}
    for s in spans:
        for k in trace_tids(s):
            known.setdefault(k, set()).add(s["thread"])
    dev: dict = {}
    for s in spans:
        if "dev_ms" in s:
            dev.setdefault(s["thread"], []).append((s["ts0"], s["ts1"]))
    merged = {th: _merge(iv) for th, iv in dev.items()}
    calls: dict = {}
    for r in runtime:
        calls.setdefault(r[3], []).append(r[1])
    out = {}
    for tid, ts in calls.items():
        if tid in known:
            out[tid] = known[tid]
            continue
        best, n_best = None, 0
        for th, iv in merged.items():
            starts = [a for a, _ in iv]
            n = 0
            for t in ts:
                i = bisect.bisect_right(starts, t) - 1
                n += i >= 0 and t < iv[i][1]
            if n > n_best:
                best, n_best = th, n
        if best is not None:
            out[tid] = {best}
    return out


def _merge(iv: list) -> list:
    out = []
    for a, b in sorted(iv):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def attribute_launches(rec) -> dict | None:
    """Each device operation to the span that launched it: its runtime call
    (by correlation id), on the launching thread (``thread_map``), at the
    host time the clock maps it to, under that thread's innermost open
    span.  A call from a thread with no span open (autograd's thread
    outside K4) goes under ``linked``, to the innermost span of the thread
    then inside a device span.  Returns {"by_span": {name: count},
    "linked": {name: count}, "unattributed": {"no_call", "no_thread",
    "no_span": count}, "late": n, "late_examples"}; "late" counts
    operations whose span starts after the operation's device start by
    more than the clock's error."""
    c, ops, rt = rec.get("clock"), rec.get("trace_ops"), rec.get("trace_runtime")
    if not c or ops is None or rt is None:
        return None
    spans = mapped(spans_of(rec), c["offset_us"])
    if not spans:
        return None
    launch = {r[4]: r for r in rt if r[4] is not None}
    threads = thread_map(spans, rt)
    depth = _depths(spans)
    by_thread: dict = {}
    for s in spans:
        by_thread.setdefault(s["thread"], []).append(s)
    err = c.get("error_us", 0.0)
    at = innermost_at(spans)
    counts, linked, missing, late, examples = {}, {}, {"no_call": 0, "no_thread": 0, "no_span": 0}, 0, []
    for name, ts, dur, corr in ops:
        r = launch.get(corr)
        cands = threads.get(r[3]) if r else None
        if not cands:
            missing["no_call" if r is None else "no_thread"] += 1
            continue
        best = None
        for th in cands:
            for s in by_thread.get(th, []):
                if s["ts0"] <= r[1] < s["ts1"] and (best is None or depth[s["id"]] > depth[best["id"]]):
                    best = s
        if best is None:
            names = sorted(n for n, dev in at(r[1]).values() if dev)
            if names:
                linked[names[0]] = linked.get(names[0], 0) + 1
            else:
                missing["no_span"] += 1
            continue
        counts[best["name"]] = counts.get(best["name"], 0) + 1
        if best["ts0"] > ts + err:
            late += 1
            if len(examples) < 5:
                examples.append({"op": name[:60], "op_ts": ts, "call": r[0], "call_ts": r[1],
                                 "span": best["name"], "span_ts0": best["ts0"]})
    order = lambda d: dict(sorted(d.items(), key=lambda kv: -kv[1]))
    return {"by_span": order(counts), "linked": order(linked), "unattributed": missing, "late": late,
            "late_examples": examples}


# ---------------------------------------------------------------------------
# the per-layer numbers
# ---------------------------------------------------------------------------


def _serve_window(rec):
    reqs = rec.get("requests") or []
    if not reqs:
        return None, None
    return round(min(r["due"] for r in reqs) * 1e9), round(max(r.get("done", r["due"]) for r in reqs) * 1e9)


def serve_calls(rec):
    """(the window's ``serve.call`` spans, {call id: spans under it})."""
    spans = spans_of(rec, *_serve_window(rec))
    calls = [s for s in spans if s["name"] == "serve.call"]
    return calls, below(spans, calls)


def serve_g2p_ms(rec):
    """Mean host time of ``synth.g2p`` a call, in ms."""
    calls, under = serve_calls(rec)
    if not calls:
        return None
    return sum((s["t1"] - s["t0"]) / 1e6 for c in calls for s in under[c["id"]] if s["name"] == "synth.g2p") / len(calls)


def _one(spans, name):
    for s in spans:
        if s["name"] == name:
            return s
    return None


def serve_decode_ms(rec):
    """Mean device time of ``synth.decode`` a call (CUDA events), in ms."""
    calls, under = serve_calls(rec)
    xs = [_one(under[c["id"]], "synth.decode") for c in calls]
    xs = [s["dev_ms"] for s in xs if s and "dev_ms" in s]
    return sum(xs) / len(xs) if xs else None


def serve_handoff_ms(rec):
    """Mean device-timeline time from the end of ``synth.decode`` to the
    start of ``vocode.k1``, in ms: the mels' trip through the host."""
    calls, under = serve_calls(rec)
    xs = []
    for c in calls:
        d, k = _one(under[c["id"]], "synth.decode"), _one(under[c["id"]], "vocode.k1")
        if d and k and "dev_t1" in d and "dev_t0" in k:
            xs.append((k["dev_t0"] - d["dev_t1"]) / 1e6)
    return sum(xs) / len(xs) if xs else None


def serve_vocode_ms(rec):
    """Mean device-timeline time from the start of ``vocode.k1`` to the end
    of ``vocode.unfold``, in ms."""
    calls, under = serve_calls(rec)
    xs = []
    for c in calls:
        k, u = _one(under[c["id"]], "vocode.k1"), _one(under[c["id"]], "vocode.unfold")
        if k and u and "dev_t0" in k and "dev_t1" in u:
            xs.append((u["dev_t1"] - k["dev_t0"]) / 1e6)
    return sum(xs) / len(xs) if xs else None


def serve_call_dev_ms(rec):
    """Mean device time of ``serve.call`` (CUDA events), in ms."""
    calls, _ = serve_calls(rec)
    xs = [c["dev_ms"] for c in calls if "dev_ms" in c]
    return sum(xs) / len(xs) if xs else None


def serve_respond_ms(rec):
    """Mean host time of ``serve.respond`` per answered request (an
    answer's encoding and its write are two spans of its trace), in ms."""
    spans = spans_of(rec, *_serve_window(rec))
    per: dict = {}
    for s in spans:
        if s["name"] == "serve.respond":
            per[s["trace"]] = per.get(s["trace"], 0.0) + (s["t1"] - s["t0"]) / 1e6
    return sum(per.values()) / len(per) if per else None


def idle_in_call(rec):
    """Share of the traced window, in %, in which no device operation ran
    while a ``serve.call`` span was open."""
    c, ops, win = rec.get("clock"), rec.get("trace_ops"), rec.get("trace_window_ns")
    if not c or ops is None or not win:
        return None
    lo, hi = to_trace(win[0], c["offset_us"]), to_trace(win[1], c["offset_us"])
    calls = [s for s in mapped(spans_of(rec), c["offset_us"]) if s["name"] == "serve.call"]
    if not calls or hi <= lo:
        return None
    idle = 0.0
    for g0, g1 in idle_gaps(ops, lo, hi):
        for s in calls:
            idle += max(0.0, min(g1, s["ts1"]) - max(g0, s["ts0"]))
    return 100.0 * idle / (hi - lo)


def train_steps(rec, profiled: bool = False):
    """(the ``train.step`` spans of the window's steps before the trace, or
    with ``profiled`` of the traced steps; {step id: spans under it})."""
    spans = spans_of(rec)
    want = rec.get("steps_traced") if profiled else [s for s in rec.get("steps") or [] if not s.get("profiled")]
    want = want or []
    edges = sorted((round(s["t0"] * 1e9), round(s["t1"] * 1e9)) for s in want)
    steps = []
    for s in spans:
        if s["name"] != "train.step":
            continue
        i = bisect.bisect_right(edges, (s["t0"], float("inf"))) - 1
        if i >= 0 and edges[i][0] <= s["t0"] <= edges[i][1]:
            steps.append(s)
    return steps, below(spans, steps)


def _train_phase_ms(rec, name):
    steps, under = train_steps(rec)
    xs = [p["dev_ms"] for st in steps for p in under[st["id"]] if p["name"] == name and "dev_ms" in p]
    return sum(xs) / len(steps) if steps and xs else None


def train_forward_ms(rec):
    """Mean device time of ``train.forward`` a step before the trace, in ms."""
    return _train_phase_ms(rec, "train.forward")


def train_backward_ms(rec):
    """Mean device time of ``train.backward`` a step before the trace, in ms."""
    return _train_phase_ms(rec, "train.backward")


def train_optimizer_ms(rec):
    """Mean device time of ``train.optimizer`` a step before the trace, in ms."""
    return _train_phase_ms(rec, "train.optimizer")


def train_launches_per_step(rec):
    """Device operations whose start lies inside a traced step's
    ``train.step`` span (its host interval on the trace's clock), mean
    over the traced steps."""
    c, ops = rec.get("clock"), rec.get("trace_ops")
    if not c or ops is None:
        return None
    steps, _ = train_steps(rec, profiled=True)
    if not steps:
        return None
    starts = sorted(o[1] for o in ops)
    n = 0
    for s in steps:
        a, b = to_trace(s["t0"], c["offset_us"]), to_trace(s["t1"], c["offset_us"])
        n += bisect.bisect_right(starts, b) - bisect.bisect_left(starts, a)
    return n / len(steps)


METRICS = {
    "serve.g2p_ms": serve_g2p_ms, "serve.decode_ms": serve_decode_ms, "serve.handoff_ms": serve_handoff_ms,
    "serve.vocode_ms": serve_vocode_ms, "serve.respond_ms": serve_respond_ms,
    "idle_share.serve.in_call": idle_in_call, "train.forward_ms": train_forward_ms,
    "train.backward_ms": train_backward_ms, "train.optimizer_ms": train_optimizer_ms,
    "train.launches_per_step": train_launches_per_step,
}


# ---------------------------------------------------------------------------
# do the splits close?
# ---------------------------------------------------------------------------


def train_split(rec) -> dict | None:
    """The mean host step (the driver's: batch, copy, step) of the steps
    before the trace beside forward + backward + optimizer (device) + the
    host times of ``data.load``, ``data.to_device`` and ``train.readback``."""
    want = [s for s in rec.get("steps") or [] if not s.get("profiled")]
    steps, under = train_steps(rec)
    if not want or not steps:
        return None
    host_ms = 1e3 * sum(s["t1"] - s["t0"] for s in want) / len(want)
    parts = {k: _train_phase_ms(rec, k) or 0.0 for k in ("train.forward", "train.backward", "train.optimizer")}
    spans = spans_of(rec)
    lo, hi = round(want[0]["t0"] * 1e9), round(want[-1]["t1"] * 1e9)
    for k in ("data.load", "data.to_device"):
        xs = [(s["t1"] - s["t0"]) / 1e6 for s in spans if s["name"] == k and lo <= s["t0"] < hi]
        parts[k] = sum(xs) / len(want)
    parts["train.readback"] = sum((p["t1"] - p["t0"]) / 1e6 for st in steps for p in under[st["id"]]
                                  if p["name"] == "train.readback") / len(steps)
    total = sum(parts.values())
    return {"host_step_ms": host_ms, "parts_ms": parts, "sum_ms": total, "gap": total / host_ms - 1.0}


def serve_split(rec) -> dict | None:
    """decode + handoff + vocode beside the mean device time of a call."""
    vals = {k: f(rec) for k, f in (("decode", serve_decode_ms), ("handoff", serve_handoff_ms),
                                   ("vocode", serve_vocode_ms), ("call", serve_call_dev_ms))}
    if any(v is None for v in vals.values()):
        return None
    total = vals["decode"] + vals["handoff"] + vals["vocode"]
    return dict(vals, sum_ms=total, gap=total / vals["call"] - 1.0)
