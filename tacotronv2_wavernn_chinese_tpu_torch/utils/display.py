"""Console display helpers: progress bar, stream, ASCII tables.

The port's own copy of the JAX package's ``utils/display.py`` (same names
and output).  Counterpart of the reference's wavernn/utils/display.py:9-121.
"""

from __future__ import annotations

import sys
import time
from typing import Iterable, Sequence


def stream(message: str) -> None:
    """Carriage-return streaming line (reference display.py stream)."""
    sys.stdout.write(f"\r{message}")
    sys.stdout.flush()


def progbar(i: int, n: int, size: int = 16) -> str:
    """Textual progress bar like ``|████    |`` (reference display.py progbar)."""
    done = int(size * i / max(n, 1))
    return "|" + "█" * done + " " * (size - done) + "|"


def simple_table(item_tuples: Sequence[tuple]) -> None:
    """Boxed two-row ASCII table of (heading, value) pairs.

    Same console contract as the reference's wavernn/utils/display.py
    simple_table; widths are computed per column (no fixed-width padding
    constants), headings and values are centered.
    """
    headings = [str(h) for h, _ in item_tuples]
    cells = [str(c) for _, c in item_tuples]
    widths = [max(len(h), len(c)) for h, c in zip(headings, cells)]
    border = "+" + "+".join("-" * (w + 2) for w in widths) + "+"
    head_row = "|" + "|".join(f" {h.center(w)} " for h, w in zip(headings, widths)) + "|"
    cell_row = "|" + "|".join(f" {c.center(w)} " for c, w in zip(cells, widths)) + "|"
    print(border)
    print(head_row)
    print(border)
    print(cell_row)
    print(border)
    print(" ")


def time_since(started: float) -> str:
    """Elapsed m:ss / h:mm:ss string (reference display.py time_since)."""
    elapsed = time.time() - started
    m, s = divmod(int(elapsed), 60)
    h, m = divmod(m, 60)
    if h:
        return f"{h}h {m:02d}m {s:02d}s"
    return f"{m}m {s:02d}s"


def bar_stream(i: int, n: int, msg: str, size: int = 16) -> None:
    stream(f"{progbar(i, n, size)} {i}/{n} {msg}")
