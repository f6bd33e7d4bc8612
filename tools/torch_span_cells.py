"""Run one cell of the port's benchmark with the program's spans on, and read
them beside the device trace.

    python3 tools/torch_span_cells.py --workload <cell> --seed <n> --seconds <s> \
        [--trace 1] [--tracer 1] [--alternate N] [--out build/spans.jsonl] [--dump F.json.gz]

The cell runs as ``benchmark/run.py`` runs it (the same driver, weights,
traffic and comparison), with ``utils.metrics.enable()`` before its
set-up and ``benchmark.spans.SpanTrace`` as its device trace (``--trace
1``).  Afterwards the spans are drained into the run's record and read by
``benchmark/spans.py``: the ten span metrics, the traced idle seconds by
span, each device operation's launching span, the clock's offset and
error, and whether the splits close.  ``--alternate N`` (training cells)
first runs N rounds of four blocks of five steps with the spans on, off,
off, on, and prints the mean host step time of each, the spans' cost.
``--tracer 0`` runs the cell with the spans off (the benchmark's own
way), for its end-to-end metrics.  Training cells also report the host
ms of each step phase (``phase_host_ms``: the launching thread's pace)
and the Tacotron loader's read-ahead (``loader``: its hit share and
waits).  ``--dump`` writes the spans and the trace's events, to read
them again without the card.  One JSON line goes to standard output
and to ``--out``; a summary to standard error.  Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import gzip
import json
import os
import statistics
import sys
import time
import types

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BLOCK_STEPS = 5


def alternate(M, rounds: int, one_step) -> dict:
    """Mean host ms a step with the spans on and off, in rounds of on,
    off, off, on blocks."""
    times = {True: [], False: []}
    was = M.TRACER.on
    for _ in range(rounds):
        for on in (True, False, False, True):
            M.enable(on)
            t0 = time.monotonic()
            for _ in range(BLOCK_STEPS):
                one_step()
            times[on].append(1e3 * (time.monotonic() - t0) / BLOCK_STEPS)
    M.enable(was)
    on, off = statistics.mean(times[True]), statistics.mean(times[False])
    return {"on_ms": times[True], "off_ms": times[False], "on_mean_ms": on, "off_mean_ms": off,
            "cost": on / off - 1.0}


def span_cost(M, n: int = 2000) -> dict:
    """Host us of one span's entry and exit, with and without device
    events, pooled (after a drain) and fresh."""
    import torch

    out = {}
    was = M.TRACER.on
    M.enable()
    M.drain()
    for device in (False, True):
        for label in ("fresh", "pooled"):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(n):
                with M.span("cost", device=device):
                    pass
            out[f"{'device' if device else 'host'}_{label}_us"] = 1e6 * (time.perf_counter() - t0) / n
            M.drain()
    M.enable(was)
    return out


def loader_reading(rec) -> dict:
    """The Tacotron loader's read-ahead over the run: batches handed out,
    the share ready when asked for, the consumer's wait a batch (its
    ``loader`` counter), and the host ms of the ``data.wait`` and
    ``data.load`` spans a step over the steps before the trace (``data.load``
    runs on the worker thread, beside the step).  Empty for a program
    without the counter."""
    c = (rec.get("program_counters") or {}).get("loader")
    if not c or not c.get("batches"):
        return {}
    want = [s for s in rec.get("steps") or [] if not s.get("profiled")]
    lo, hi = round(want[0]["t0"] * 1e9), round(want[-1]["t1"] * 1e9)
    per_step = {k: sum((s["t1"] - s["t0"]) / 1e6 for s in rec["spans"] if s["name"] == k and lo <= s["t0"] < hi)
                / len(want) for k in ("data.wait", "data.load")}
    return {"batches": c["batches"], "ready": c["ready"], "hit_share": c["ready"] / c["batches"],
            "wait_ms_a_batch": c["wait_ns"] / 1e6 / c["batches"], "data_wait_ms_a_step": per_step["data.wait"],
            "data_load_ms_a_step": per_step["data.load"]}


def run(ctx, tracer: bool, rounds: int = 0, dump: str | None = None) -> dict:
    from benchmark import core, spans as SP
    from benchmark.drivers import train_common as TC
    from tacotronv2_wavernn_chinese_tpu_torch.utils import metrics as M

    traces = []

    class Trace(SP.SpanTrace):
        def __init__(self, workdir):
            super().__init__(workdir)
            traces.append(self)

    saved = core.DeviceTrace, TC.run_window
    cost = {}
    if rounds:
        def run_window(ctx_, tr, one_step, steps):
            cost.update(alternate(M, rounds, one_step))
            return saved[1](ctx_, tr, one_step, steps)

        TC.run_window = run_window
    core.DeviceTrace = Trace
    M.enable(tracer)
    try:
        out = core.driver(ctx.traffic["kind"]).run(ctx)
    finally:
        core.DeviceTrace, TC.run_window = saved
        M.enable(False)
    rec = out["record"]
    rec["spans"] = M.drain()
    rec["program_counters"] = {k: dict(v) for k, v in M.counters().items()}
    if traces and traces[-1].t1 is not None:
        rec.update(traces[-1].record())
    res = {"workload": ctx.cell["name"], "seed": ctx.seed, "tracer": tracer, "e2e": out["e2e"],
           "correct": all(c["ok"] for c in out["checks"].values()), "device": out["device"],
           "metrics": {k: f(rec) for k, f in SP.METRICS.items()}, "n_spans": len(rec["spans"])}
    if "trace_ops" in rec:
        win = rec["trace_window_ns"]
        res.update(clock=rec["clock"], stamp_check=SP.stamp_check(rec["spans"], rec["trace_runtime"], rec["trace_ops"], rec["clock"],
                                              win) if rec["clock"] else None,
                   idle_by_span=SP.idle_by_span(rec), idle_by_device_thread=SP.idle_by_span(rec, True),
                   launched_by=SP.attribute_launches(rec),
                   breakdown=out.get("breakdown"), busy_s=out["device"].get("busy_s"),
                   window_s=out["device"].get("window_s"))
    if rec.get("model"):
        res["split"] = SP.train_split(rec)
        steps, under = SP.train_steps(rec)
        res["spans_per_step"] = sum(len(v) + 1 for v in under.values()) / max(len(steps), 1)
        res["train_step_ms_before_trace"] = 1e3 * statistics.mean(
            s["t1"] - s["t0"] for s in rec["steps"] if not s.get("profiled"))
        phases = {}
        for st in steps:
            for p in under[st["id"]]:
                if "dev_ms" in p:
                    phases.setdefault(p["name"], []).append(p["dev_ms"])
        res["phase_dev_ms"] = {k: sum(v) / len(steps) for k, v in phases.items()}
        host = {}
        for st in steps:
            host.setdefault(st["name"], []).append((st["t1"] - st["t0"]) / 1e6)
            for p in under[st["id"]]:
                host.setdefault(p["name"], []).append((p["t1"] - p["t0"]) / 1e6)
        res["phase_host_ms"] = {k: sum(v) / len(steps) for k, v in host.items()}
        res["loader"] = loader_reading(rec)
    else:
        res["split"] = SP.serve_split(rec)
        calls, under = SP.serve_calls(rec)
        res["spans_per_call"] = sum(len(v) + 1 for v in under.values()) / max(len(calls), 1)
        res["call_host_ms"] = 1e3 * statistics.mean(c["t1"] - c["t0"] for c in rec["calls"]) if rec["calls"] else None
        phases = {}
        for c in calls:
            for p in under[c["id"]]:
                phases.setdefault(p["name"], []).append(p.get("dev_ms", (p["t1"] - p["t0"]) / 1e6))
        res["phase_ms_a_call"] = {k: sum(v) / len(calls) for k, v in phases.items()}
    if cost:
        res["alternate"] = cost
    if dump:
        keep = {k: rec[k] for k in ("spans", "trace_ops", "trace_runtime", "trace_window_ns", "clock", "model")
                if k in rec}
        keep["requests"] = [{k: r[k] for k in ("seed", "due", "done") if k in r} for r in rec.get("requests", [])]
        keep["steps"] = [{k: x[k] for k in ("t0", "t1", "profiled") if k in x} for x in rec.get("steps", [])]
        keep["steps_traced"] = [{k: x[k] for k in ("t0", "t1") if k in x} for x in rec.get("steps_traced", [])]
        with gzip.open(dump, "wt", encoding="utf-8") as f:
            json.dump(keep, f)
    if ctx.device != "cpu":
        res["span_cost"] = span_cost(M)
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=1)
    ap.add_argument("--tracer", type=int, choices=(0, 1), default=1)
    ap.add_argument("--alternate", type=int, default=0, help="rounds of on/off/off/on step blocks (training)")
    ap.add_argument("--out", default=os.path.join("build", "spans.jsonl"))
    ap.add_argument("--dump", default=None, help="write the spans and the trace's events here (.json.gz)")
    args = ap.parse_args(argv)
    sys.path.insert(0, ROOT)
    from benchmark import core, run as R

    R.set_environment(ROOT)
    cell = core.find_cell(core.load_spec(ROOT), args.workload)
    core.require_cards(int(cell["chips"]))
    ns = types.SimpleNamespace(workload=args.workload, seed=args.seed, seconds=args.seconds, trace=args.trace,
                               rate=None)
    ctx = R.make_context(ns)
    try:
        res = run(ctx, bool(args.tracer), args.alternate, args.dump)
    finally:
        import shutil

        shutil.rmtree(ctx.workdir, ignore_errors=True)
    line = json.dumps(res)
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "a", encoding="utf-8") as f:
        f.write(line + "\n")
    brief = {k: res.get(k) for k in ("workload", "seed", "tracer", "e2e", "correct", "metrics", "split", "clock",
                                      "alternate", "span_cost", "loader")}
    print(json.dumps(brief, indent=1), file=sys.stderr)
    print(line, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
