"""One file per hand-written kernel of the program, found by name: its
names in the profiler's trace (``TRACE_NAMES``, without namespaces or
template arguments), the program's entry points
that launch it with the shape of each launch (``ENTRIES``: ``"module:function"``
-> a function of the entry's arguments giving the shape tuple, or None for a
launch that does not reach the kernel, such as one on a CPU tensor), and the
bytes and operations of one launch of that shape (``count``: -> (bytes,
operations, the peak of the units it computes on)). Each input byte counts
once and each output byte once, whatever the kernel reads again; products
count two operations a multiply-add. A new kernel's roofline needs only a
new file here and its reader under ``metrics/``."""

from __future__ import annotations

import importlib
from pathlib import Path

HERE = Path(__file__).resolve().parent


def names() -> list:
    """Every kernel that has a file here."""
    return sorted(p.stem for p in HERE.glob("*.py") if p.stem != "__init__")


def load(name: str):
    return importlib.import_module(f"benchmark.counts.kernels.{name}")
