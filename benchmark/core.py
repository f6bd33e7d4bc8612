"""What every cell shares: finding its files by name, the result line, the
device's description, the import check and the device trace.

Nothing in this module imports torch at import time, so the tests and the
import check can load it anywhere.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import math
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HERE = os.path.join(ROOT, "benchmark")

# top-level module names that may not be loaded in a run: JAX and the JAX
# package (the port's name begins with the latter's, so names are compared whole)
FORBIDDEN = ("jax", "jaxlib", "flax", "tacotronv2_wavernn_chinese_tpu")

# published peaks of one H100 SXM (NVIDIA data sheet): the port computes in
# float32 with TF32 off, so the operations bound uses the f32 rate
PEAK_F32_FLOP_PER_S = 67e12
PEAK_BYTES_PER_S = 3.35e12


class BenchError(RuntimeError):
    """A run that cannot give a result (no card, a missing file)."""


# ---------------------------------------------------------------------------
# files found by name
# ---------------------------------------------------------------------------


def load_json(path: str) -> dict:
    with open(path, encoding="utf-8") as f:
        return json.load(f)


def load_spec(root: str = ROOT) -> dict:
    path = os.path.join(root, "BENCHMARK.json")
    if not os.path.exists(path):
        raise BenchError(f"no BENCHMARK.json in {root}")
    return load_json(path)


def find_cell(spec: dict, name: str) -> dict:
    for cell in spec["workloads"]:
        if cell["name"] == name:
            return cell
    raise BenchError(f"no workload named {name!r} in BENCHMARK.json")


def config_entry(spec: dict, name: str) -> dict:
    for c in spec["configs"]:
        if c["name"] == name:
            return c
    raise BenchError(f"no configuration named {name!r} in BENCHMARK.json")


def load_config(spec: dict, name: str, root: str = ROOT) -> dict:
    """The configuration file of ``name``, as BENCHMARK.json points to it."""
    return load_json(os.path.join(root, config_entry(spec, name)["file"]))


def load_traffic(name: str, root: str = ROOT) -> dict:
    return load_json(os.path.join(root, "benchmark", "traffic", f"{name}.json"))


def traffic_data_path(name: str, root: str = ROOT) -> str:
    """A data file a traffic mix names (a character list, a corpus shape)."""
    return os.path.join(root, "benchmark", "traffic", name)


def driver(kind: str):
    """The driver module of a traffic mix's ``kind``."""
    return importlib.import_module(f"benchmark.drivers.{kind}")


def metric_reader(name: str, root: str = ROOT):
    """``read(record) -> float | None`` of the per-layer metric ``name``,
    from ``metrics/<name>.py`` (a name may hold dots, so it is loaded by
    path)."""
    path = os.path.join(root, "benchmark", "metrics", f"{name}.py")
    if not os.path.exists(path):
        raise BenchError(f"no reader for the metric {name!r} ({path})")
    spec = importlib.util.spec_from_file_location(f"benchmark.metrics.{name.replace('.', '__')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def cell_metrics(spec: dict, cell: str, trace: bool) -> list:
    """The metrics a run of ``cell`` reports: its end-to-end metrics with
    ``--trace 0``, its per-layer metrics with ``--trace 1``."""
    group = spec["per_layer"] if trace else spec["end_to_end"]
    return [m for m in group if "workloads" not in m or cell in m["workloads"]]


# ---------------------------------------------------------------------------
# the import check
# ---------------------------------------------------------------------------


def forbidden_modules(modules=None) -> list:
    """Loaded modules whose top-level name (before the first dot) is JAX's
    or the JAX package's, compared whole."""
    names = sys.modules if modules is None else modules
    return sorted({n for n in names if n.split(".", 1)[0] in FORBIDDEN})


# ---------------------------------------------------------------------------
# the card
# ---------------------------------------------------------------------------


def require_cards(chips: int) -> None:
    """Raise unless CUDA is there with at least ``chips`` cards."""
    import torch

    if not torch.cuda.is_available():
        raise BenchError("torch.cuda.is_available() is false: this benchmark runs on the card only")
    if torch.cuda.device_count() < chips:
        raise BenchError(f"the cell needs {chips} cards, torch sees {torch.cuda.device_count()}")


def device_info(chips: int) -> dict:
    import torch

    peak = max(torch.cuda.max_memory_allocated(i) for i in range(chips))
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": chips,
            "memory_peak_bytes": int(peak)}


# ---------------------------------------------------------------------------
# statistics
# ---------------------------------------------------------------------------


def percentile(values, q: float) -> float:
    """The q-th percentile (0-100) by linear interpolation between order
    statistics (numpy's default), over every value; inf stays inf."""
    xs = sorted(values)
    if not xs:
        return float("nan")
    pos = (len(xs) - 1) * q / 100.0
    lo = int(math.floor(pos))
    hi = min(lo + 1, len(xs) - 1)
    if math.isinf(xs[hi]) or math.isinf(xs[lo]):
        return xs[hi] if pos > lo else xs[lo]
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)


# ---------------------------------------------------------------------------
# the device trace
# ---------------------------------------------------------------------------

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


class DeviceTrace:
    """``torch.profiler`` over a window that the caller opens and closes,
    reduced to the device's operations: [(name, start_us, dur_us)] and the
    host-clock length of the window."""

    def __init__(self, workdir: str):
        self.workdir = workdir
        self.prof = None
        self.t0 = self.t1 = None
        self.events: list = []

    @staticmethod
    def warm() -> None:
        """One short session in set-up, so that the profiler's own start-up
        (CUPTI) does not fall into the window."""
        import torch

        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]):
            torch.ones(8, device="cuda").add_(1)
            torch.cuda.synchronize()

    def start(self) -> None:
        """Device activity only: recording the host's operations would slow
        the host-bound steps it measures."""
        import torch

        self.prof = torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA])
        torch.cuda.synchronize()
        self.prof.__enter__()
        self.t0 = time.monotonic()

    def stop(self) -> None:
        """Close the window; ``collect`` reads it afterwards."""
        import torch

        torch.cuda.synchronize()
        self.t1 = time.monotonic()
        self.prof.__exit__(None, None, None)

    def collect(self) -> list:
        path = os.path.join(self.workdir, "device_trace.json")
        self.prof.export_chrome_trace(path)
        with open(path, encoding="utf-8") as f:
            trace = json.load(f)
        os.remove(path)
        self.events = sorted(
            ((e["name"], float(e["ts"]), float(e.get("dur", 0.0)))
             for e in trace.get("traceEvents", [])
             if e.get("ph") == "X" and e.get("cat") in DEVICE_CATS),
            key=lambda e: e[1],
        )
        self.prof = None
        return self.events

    @property
    def window_s(self) -> float:
        return self.t1 - self.t0


def reduce_trace(events, window_s: float) -> dict:
    """busy seconds (the union of the device's operations), seconds by
    operation name, and the idle gaps between operations, each named by the
    operations on either side of it."""
    busy, by_name, gaps = 0.0, {}, []
    end, prev = None, None
    for name, ts, dur in events:
        by_name[name] = by_name.get(name, 0.0) + dur * 1e-6
        if end is None or ts >= end:
            if end is not None and ts > end:
                gaps.append((f"host work after {short(prev)} before {short(name)}", (ts - end) * 1e-6))
            busy += dur
            end, prev = ts + dur, name
        elif ts + dur > end:
            busy += ts + dur - end
            end, prev = ts + dur, name
    busy_s = busy * 1e-6
    gaps.sort(key=lambda g: -g[1])
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])
    return {"busy_s": busy_s, "window_s": window_s, "by_name": by_name,
            "device_ops": [[n, s] for n, s in ops[:10]], "idle_gaps": [[n, s] for n, s in gaps[:10]]}


def short(name) -> str:
    """A kernel's name without its template arguments and parameter list."""
    if name is None:
        return "the window's start"
    s = name
    for ch in "(<":
        s = s.split(ch, 1)[0]
    s = s.replace("void ", "").strip()
    return s[:80] or name[:80]


def kernel_seconds(by_name: dict, pattern: str) -> float:
    """Device seconds of the operations whose name holds ``pattern``
    (case-insensitive)."""
    p = pattern.lower()
    return sum(s for n, s in by_name.items() if p in n.lower())


# ---------------------------------------------------------------------------
# the result line
# ---------------------------------------------------------------------------


def result_line(correct: bool, attempted: int, failed: int, metrics: dict, device: dict,
                checks: dict, breakdown: dict | None = None) -> str:
    """The last line of standard output; ``checks`` (each compared number
    beside its limit) comes last."""
    out = {"correct": bool(correct), "attempted": int(attempted), "failed": int(failed),
           "metrics": metrics, "device": device}
    if breakdown is not None:
        out["breakdown"] = breakdown
    out["checks"] = checks
    return json.dumps(out)


def checks_text(checks: dict) -> str:
    return "\n".join(f"check {k}: {v['value']!r} limit {v['limit']!r} ({'ok' if v['ok'] else 'FAILED'})"
                     for k, v in checks.items())


def check(value: float, limit: float, larger_fails: bool = True) -> dict:
    """One compared number beside its limit; NaN fails."""
    v = float(value)
    ok = (v <= limit) if larger_fails else (v >= limit)
    return {"value": v, "limit": float(limit), "ok": bool(ok and not math.isnan(v))}
