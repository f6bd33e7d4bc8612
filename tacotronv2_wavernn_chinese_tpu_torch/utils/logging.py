"""Run logging: stdout + timestamped logfile (reference infolog.py:13-47,
minus the Slack webhook — hook point kept) and rolling metric windows
(reference tacotron/utils/__init__.py:1-22).  A copy of the JAX package's
``utils/logging.py``, which imports no JAX."""

from __future__ import annotations

import atexit
import os
from datetime import datetime


class InfoLog:
    def __init__(self):
        self._file = None
        self._run_name = None
        self._hook = None  # optional callable(msg) for external sinks

    def init(self, log_path: str, run_name: str, hook=None) -> None:
        os.makedirs(os.path.dirname(log_path) or ".", exist_ok=True)
        self._file = open(log_path, "a", encoding="utf-8")
        self._run_name = run_name
        self._hook = hook
        self._file.write(
            "\n-----------------------------------------------------------------\n"
        )
        self._file.write(f"Starting new {run_name} training run\n")
        self._file.write(
            "-----------------------------------------------------------------\n"
        )
        atexit.register(self._close)

    def log(self, msg: str, end: str = "\n", external: bool = False) -> None:
        print(msg, end=end, flush=True)
        if self._file is not None:
            self._file.write(f"[{datetime.now().strftime('%Y-%m-%d %H:%M:%S.%f')[:-3]}]  {msg}{end}")
            self._file.flush()
        if external and self._hook is not None:
            self._hook(msg)

    def _close(self):
        if self._file is not None:
            self._file.close()
            self._file = None


_default = InfoLog()
init = _default.init
log = _default.log


class ValueWindow:
    """Rolling mean over the last N values."""

    def __init__(self, window_size: int = 100):
        self._window_size = window_size
        self._values: list[float] = []

    def append(self, x: float) -> None:
        self._values = (self._values + [float(x)])[-self._window_size:]

    @property
    def sum(self) -> float:
        return sum(self._values)

    @property
    def count(self) -> int:
        return len(self._values)

    @property
    def average(self) -> float:
        return self.sum / max(1, self.count)

    def reset(self) -> None:
        self._values = []
