"""Tacotron-2 training with location-sensitive attention: the run of
``drivers/train_tacotron.py`` (``train.tacotron_task.train_step`` on the
port's ``TacotronDataset.batches``, the window of ``train_common.py``),
judged by ``compare/train_tacotron_lsa.py`` against the LSA reference.

With ``--trace 1`` the port's spans are on from before set-up, the device
trace is ``benchmark.spans.SpanTrace`` (the device trace with the runtime
calls and a marker for the clock), and the record keeps the spans
(``drain()``), the program's counters (``counters()``) and the trace's
record, which the span readers of ``benchmark/spans.py`` read.  A program
without spans or without a counter leaves them empty, and those readers
return None.
"""

from __future__ import annotations

import contextlib

from .. import core
from .. import spans as SP
from ..compare import train_tacotron_lsa as CMP
from . import train_tacotron as TT


@contextlib.contextmanager
def _replaced(module, name: str, value):
    saved = getattr(module, name)
    setattr(module, name, value)
    try:
        yield
    finally:
        setattr(module, name, saved)


def run(ctx) -> dict:
    if not ctx.trace:
        with _replaced(TT, "CMP", CMP):
            return TT.run(ctx)
    from tacotronv2_wavernn_chinese_tpu_torch.utils import metrics as M

    traces = []

    class Trace(SP.SpanTrace):
        def __init__(self, workdir):
            super().__init__(workdir)
            traces.append(self)

    M.enable()
    try:
        with _replaced(TT, "CMP", CMP), _replaced(core, "DeviceTrace", Trace):
            out = TT.run(ctx)
        rec = out["record"]
        rec["spans"] = M.drain()
    finally:
        M.enable(False)
    rec["program_counters"] = {k: dict(v) for k, v in M.counters().items()}
    if traces and traces[-1].t1 is not None:
        rec.update(traces[-1].record())
    return out
