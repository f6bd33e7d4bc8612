"""Scalar metrics logging + profiling hooks.

An append-only JSONL stream of scalars per run (in place of the
reference's TensorBoard summaries, tacotron/train.py:41-62), the embedding
projector dump, the program's spans and counters, and a ``torch.profiler``
capture of a window of training steps.  ``MetricsWriter``,
``read_scalars`` and ``dump_embedding_projector`` are copies of the JAX
package's ``utils/metrics.py``.

Spans.  ``span(name, device=False, parent=None, **attrs)`` times a piece
of the program: host start and end on ``time.monotonic_ns()``, the
enclosing span on the same thread (or ``parent``, a span of another
thread), a trace id shared by every span under one root (a request, a
training step), the thread's native id, and counts as attributes.  With
``device=True`` it also records a CUDA event at each edge on the current
stream; the events come from a pool and are read only by ``drain()``,
after one ``synchronize``, so the traced path gains no synchronisation.
Tracing is off until ``enable()``: ``span()`` then returns one shared
object that records, allocates and synchronises nothing.  ``counters()``
hands over the launch counters (``ops.LAUNCHES``), the decoder's steps
by route (``models.tacotron.DECODER_STEPS``), the eager route's CUDA
graphs (``models.tacotron.DECODER_GRAPHS``) and the Tacotron loader's
read-ahead (``data.loader.LOADER``) and HiFi-GAN's samples and power
iterations (``models.hifigan.HIFIGAN``) by reference.  Backward runs
on autograd's device thread, where no span of the step is open: the spans
there take ``parent=linked()``, the innermost open span of the thread
that opened the step (a span with ``anchor=True``).
"""

from __future__ import annotations

import itertools
import json
import os
import threading
import time
from typing import Any, Mapping


class MetricsWriter:
    """Append-only scalars.jsonl: one {"step": N, "wall": t, ...} per write."""

    def __init__(self, log_dir: str, name: str = "scalars.jsonl"):
        os.makedirs(log_dir, exist_ok=True)
        self.path = os.path.join(log_dir, name)
        self._f = open(self.path, "a", buffering=1, encoding="utf-8")
        self._t0 = time.time()

    def write(self, step: int, scalars: Mapping[str, Any]) -> None:
        row = {"step": int(step), "wall": round(time.time() - self._t0, 3)}
        for k, v in scalars.items():
            try:
                row[k] = float(v)
            except (TypeError, ValueError):
                row[k] = str(v)
        self._f.write(json.dumps(row) + "\n")

    def close(self) -> None:
        self._f.close()


def read_scalars(path: str) -> list[dict]:
    with open(path, encoding="utf-8") as f:
        return [json.loads(line) for line in f if line.strip()]


def dump_embedding_projector(embedding, symbols: list[str], out_dir: str) -> None:
    """Write the character-embedding table in TensorBoard-projector TSV
    format (embedding.tsv + metadata.tsv) — the reference logs the same
    table via the TB projector config (tacotron/train.py:26-39,220-227)."""
    import numpy as np

    os.makedirs(out_dir, exist_ok=True)
    emb = embedding.detach().cpu().numpy() if hasattr(embedding, "detach") else np.asarray(embedding)
    with open(os.path.join(out_dir, "embedding.tsv"), "w", encoding="utf-8") as f:
        for row in emb:
            f.write("\t".join(f"{v:.6f}" for v in row) + "\n")
    with open(os.path.join(out_dir, "metadata.tsv"), "w", encoding="utf-8") as f:
        for i in range(emb.shape[0]):
            label = symbols[i] if i < len(symbols) else f"sym_{i}"
            f.write(label + "\n")


class _Off:
    """The span of a tracer that is off: one shared object, false in a
    test, that records nothing."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def __bool__(self):
        return False

    def set(self, **attrs) -> None:
        pass

    def end(self) -> None:
        pass


OFF = _Off()


class Span:
    """One timed piece of the program; ``Tracer.span`` opens it, ``end``
    (or leaving its ``with`` block) closes it."""

    __slots__ = ("tracer", "name", "id", "parent", "trace", "thread", "ident", "t0", "t1", "attrs", "events",
                 "stack")

    def __enter__(self):
        self.stack = self.tracer._stack()
        self.stack.append(self)
        return self

    def __exit__(self, *exc):
        self.end()
        return False

    def set(self, **attrs) -> None:
        self.attrs.update(attrs)

    def end(self) -> None:
        tr = self.tracer
        if self.events is not None:
            e1 = tr._event()
            e1.record()
            self.events = (self.events[0], e1)
        self.t1 = time.monotonic_ns()
        if self.stack is not None:
            self.stack.remove(self)
        if tr._anchor is self:
            tr._anchor = None
        with tr._lock:
            tr._done.append(self)


class Tracer:
    """The spans of one process: ``TRACER`` below, used through the
    module's functions."""

    def __init__(self):
        self.on = False
        self._local = threading.local()
        self._done: list = []
        self._free: list = []  # pooled CUDA events
        self._ids = itertools.count(1)
        self._anchor = None  # the open span that threads without one link to
        self._ref = None  # (CUDA event, host ns): where device times are read from
        self._events = False
        self._lock = threading.Lock()

    def _stack(self) -> list:
        st = getattr(self._local, "stack", None)
        if st is None:
            st = self._local.stack = []
        return st

    def _event(self):
        try:
            return self._free.pop()
        except IndexError:
            import torch

            return torch.cuda.Event(enable_timing=True)

    def _anchor_clock(self) -> None:
        """Record the event that device times are read against, with the
        device idle, so it fires within microseconds of the host reading."""
        import torch

        torch.cuda.synchronize()
        ev = self._event()
        ev.record()
        self._ref = (ev, time.monotonic_ns())

    def enable(self, on: bool = True) -> None:
        if on and not self.on:
            import torch

            self._events = torch.cuda.is_available()
            if self._events:
                self._anchor_clock()
        self.on = bool(on)

    def span(self, name: str, device: bool = False, parent=None, anchor: bool = False, **attrs) -> Span:
        stack = self._stack()
        if parent is None and stack:
            parent = stack[-1]
        s = Span()
        s.tracer, s.name, s.id, s.attrs, s.stack = self, name, next(self._ids), attrs, None
        s.parent = parent.id if parent else None
        s.trace = parent.trace if parent else s.id
        s.thread = threading.get_native_id()
        s.ident = threading.get_ident()
        s.t1 = None
        s.events = None
        if anchor:
            self._anchor = s
        s.t0 = time.monotonic_ns()
        if device and self._events:
            e0 = self._event()
            e0.record()
            s.events = (e0, None)
        return s

    def linked(self):
        """The innermost open span of this thread, else of the thread that
        opened the open anchor span (whose innermost span is read while
        that thread waits on this one)."""
        stack = self._stack()
        if stack:
            return stack[-1]
        a = self._anchor
        if a is None:
            return None
        st = a.stack
        return st[-1] if st else a

    def stamp(self, key: str) -> None:
        stack = self._stack()
        if stack:
            stack[-1].attrs.setdefault(key, []).append(time.monotonic_ns())

    def drain(self) -> list:
        """The spans closed since the last drain, as dicts, and forget
        them.  Device times: ``dev_ms`` between the span's two events, and
        ``dev_t0`` / ``dev_t1`` its edges on the host clock in ns (read
        against an event recorded with the device idle at ``enable`` or at
        the last drain)."""
        with self._lock:
            done, self._done = self._done, []
        timed = [s for s in done if s.events is not None]
        if timed:
            import torch

            torch.cuda.synchronize()
        ref = self._ref
        out = []
        for s in done:
            d = {"name": s.name, "id": s.id, "parent": s.parent, "trace": s.trace, "thread": s.thread,
                 "ident": s.ident, "t0": s.t0, "t1": s.t1, "attrs": s.attrs}
            if s.events is not None:
                e0, e1 = s.events
                d["dev_ms"] = e0.elapsed_time(e1)
                d["dev_t0"] = ref[1] + round(ref[0].elapsed_time(e0) * 1e6)
                d["dev_t1"] = ref[1] + round(ref[0].elapsed_time(e1) * 1e6)
                self._free += [e0, e1]
            out.append(d)
        if timed and self.on:
            self._free.append(ref[0])
            self._anchor_clock()
        return out



TRACER = Tracer()


def enable(on: bool = True) -> None:
    """Turn the spans on (or off); on the card this synchronises once."""
    TRACER.enable(on)


def span(name: str, device: bool = False, parent=None, anchor: bool = False, **attrs):
    """A ``Span`` to use as a context manager (or to ``end()`` later, from
    any thread); ``OFF`` while tracing is off."""
    if not TRACER.on:
        return OFF
    return TRACER.span(name, device, parent, anchor, **attrs)


def current():
    """This thread's innermost open span (a parent to hand to another
    thread); None while tracing is off or no span is open."""
    if not TRACER.on:
        return None
    stack = TRACER._stack()
    return stack[-1] if stack else None


def linked():
    """The parent for a span on a thread that opened none of the step's
    spans (autograd's device thread); None while tracing is off."""
    return TRACER.linked() if TRACER.on else None


def stamp(key: str) -> None:
    """Append the host time to attribute ``key`` of this thread's innermost
    open span (a kernel launch site)."""
    if TRACER.on:
        TRACER.stamp(key)


def drain() -> list:
    return TRACER.drain()


def counters() -> dict:
    """The program's counters, by reference: {"launches": ops.LAUNCHES,
    "decoder_steps": models.tacotron.DECODER_STEPS, "decoder_graphs":
    models.tacotron.DECODER_GRAPHS, "loader": data.loader.LOADER,
    "hifigan": models.hifigan.HIFIGAN} (launches by kernel, decoder steps
    by route, the eager route's graphs captured and steps replayed, the
    Tacotron loader's batches handed out, those ready when asked for and
    the wait for the others in ns, HiFi-GAN's samples generated and
    spectral-norm power iterations)."""
    from ..data.loader import LOADER
    from ..models.hifigan import HIFIGAN
    from ..models.tacotron import DECODER_GRAPHS, DECODER_STEPS
    from ..ops import LAUNCHES

    return {"launches": LAUNCHES, "decoder_steps": DECODER_STEPS, "decoder_graphs": DECODER_GRAPHS,
            "loader": LOADER, "hifigan": HIFIGAN}


# ---------------------------------------------------------------------------
# a torch.profiler window with the spans on its clock
# ---------------------------------------------------------------------------


CLOCK_MARKS = ("cudaStreamQuery", "spans.clock")


def clock_offset_us(events: list, bracket: tuple) -> float | None:
    """Trace time minus host time, in us, from the trace's own record of a
    host moment: the last stream query (CUDA activity; it runs nothing on
    the device) or ``spans.clock`` annotation (CPU activity), made between
    the two host readings ``bracket`` (ns)."""
    marks = [e for e in events if e.get("ph") == "X" and e.get("name") in CLOCK_MARKS]
    if not marks:
        return None
    e = max(marks, key=lambda e: float(e["ts"]))
    return float(e["ts"]) + float(e.get("dur", 0.0)) / 2 - (bracket[0] + bracket[1]) / 2e3


def span_events(spans: list, offset_us: float, pid) -> list:
    """Chrome-trace "X" events of ``spans`` on a trace's clock, one track
    per thread of ``pid``."""
    out = []
    for s in spans:
        args = dict(s["attrs"], trace=s["trace"], id=s["id"], parent=s["parent"])
        if "dev_ms" in s:
            args["dev_ms"] = s["dev_ms"]
        out.append({"ph": "X", "cat": "program_span", "name": s["name"], "pid": pid, "tid": s["thread"],
                    "ts": s["t0"] / 1e3 + offset_us, "dur": (s["t1"] - s["t0"]) / 1e3, "args": args})
    return out


class Profiler:
    """``torch.profiler`` capture of training steps [start_step, start_step
    + num_steps): CUDA activity only (recording the host's operations
    slowed the host-bound steps it traced; on a machine without CUDA, CPU
    activity), with the program's spans of those steps written into the
    same Chrome trace as "X" events on the host's thread tracks, on the
    trace's clock, so each idle gap of the device lies under a named span.

    Usage: ``prof = Profiler(log_dir, start_step=10, num_steps=5)`` then call
    ``prof.step(step)`` once per training step; the trace lands at
    ``log_dir/trace-steps-<start>-<stop>.json``.
    """

    def __init__(self, log_dir: str | None, start_step: int = 10, num_steps: int = 5):
        self.log_dir = log_dir
        self.start_step = start_step
        self.stop_step = start_step + num_steps
        self._prof = None
        self._was_on = False

    def step(self, step: int) -> None:
        if self.log_dir is None:
            return
        if self._prof is None and step == self.start_step:
            import torch

            cuda = torch.cuda.is_available()
            acts = [torch.profiler.ProfilerActivity.CUDA if cuda else torch.profiler.ProfilerActivity.CPU]
            self._was_on = TRACER.on
            TRACER.drain()  # the trace carries the window's spans only
            enable()
            self._prof = torch.profiler.profile(activities=acts)
            self._prof.__enter__()
        elif self._prof is not None and step >= self.stop_step:
            self.close()

    def close(self) -> None:
        if self._prof is None:
            return
        import torch

        cuda = torch.cuda.is_available()
        if cuda:
            torch.cuda.synchronize()
        a = time.monotonic_ns()
        if cuda:
            torch.cuda.current_stream().query()
        else:
            with torch.profiler.record_function("spans.clock"):
                pass
        bracket = (a, time.monotonic_ns())
        self._prof.__exit__(None, None, None)
        spans = TRACER.drain()
        enable(self._was_on)
        os.makedirs(self.log_dir, exist_ok=True)
        path = os.path.join(self.log_dir, f"trace-steps-{self.start_step}-{self.stop_step}.json")
        self._prof.export_chrome_trace(path)
        self._prof = None
        with open(path, encoding="utf-8") as f:
            trace = json.load(f)
        offset = clock_offset_us(trace.get("traceEvents", []), bracket)
        if offset is not None:
            trace["traceEvents"] += span_events(spans, offset, os.getpid())
            with open(path, "w", encoding="utf-8") as f:
                json.dump(trace, f)
