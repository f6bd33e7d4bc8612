"""What both training drivers share: the window of steps, the device trace
over a few steps in its middle, and the clone of a tree of tensors."""

from __future__ import annotations

import sys
import time

from .. import core


def run_window(ctx, tr: dict, one_step, steps: list) -> dict:
    """Steps until the window's seconds are spent; with ``ctx.trace`` a
    device trace over ``trace_steps`` steps from ``trace_from`` of the way
    in.  Once the profiler has started, every later kernel launch in the
    process costs more, so the steps from the trace on are marked
    ``profiled`` and the window's own per-layer metrics read the steps
    before it.  -> {steps, steps_traced, window_s, train_step_ms, trace,
    device, breakdown}."""
    steps.clear()
    t_win = time.monotonic()
    trace = core.DeviceTrace(ctx.workdir) if ctx.trace else None
    traced = []
    while True:
        if trace is not None and trace.t0 is None and time.monotonic() - t_win >= ctx.seconds * tr["trace_from"]:
            trace.start()
            for _ in range(int(tr["trace_steps"])):
                one_step()
                traced.append(steps[-1])
            trace.stop()
        one_step()
        if steps[-1]["t1"] - t_win >= ctx.seconds:
            break
    if traced:
        for st in steps[steps.index(traced[0]):]:
            st["profiled"] = True
    window = steps[-1]["t1"] - t_win
    device = core.device_info(1) if ctx.device != "cpu" else {"platform": "cpu", "kind": "cpu", "count": 1,
                                                                "memory_peak_bytes": 0}
    out = {"steps": list(steps), "steps_traced": traced, "window_s": window,
           "train_step_ms": 1e3 * window / len(steps), "device": device, "breakdown": None}
    if trace is not None:
        ms = lambda xs: 1e3 * sum(x["t1"] - x["t0"] for x in xs) / max(len(xs), 1)
        first = steps.index(traced[0]) if traced else len(steps)
        print(f"ms a step: {ms(steps[:first]):.1f} before the trace, {ms(traced):.1f} traced, "
              f"{ms(steps[first + len(traced):]):.1f} after", file=sys.stderr)
        red = core.reduce_trace(trace.collect(), trace.window_s)
        out["trace"] = red
        device.update(busy_s=red["busy_s"], window_s=red["window_s"])
        out["breakdown"] = {"device_ops": red["device_ops"], "idle_gaps": red["idle_gaps"]}
    return out


def clone(tree):
    if isinstance(tree, dict):
        return {k: clone(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [clone(v) for v in tree]
    return tree.detach().clone()
