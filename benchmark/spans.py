"""What the readers of the program's own spans share.

The program keeps its spans in memory (``mage_tpu_torch.utils.trace``): a
root span for each ``generate`` call (``mage.generate``) and each train step
(``mage.train_step``), with its stages under it, each with host stamps and
hand-written kernel launches; every train step's spans carry device times
(the step is a timed span), and other spans only while a profiler runs. A
reader runs in the process that drove the window, after it, and groups the
spans by the call or step they belong to. Both kinds of number come from
the window's unprofiled part, after the profiler has stopped, so neither
holds the profiler's own cost:

- host numbers from the last ``attempted - profiled_calls``
  ``mage.generate`` roots;
- device numbers from the last ``attempted - profiled_steps``
  ``mage.train_step`` roots, each with its device time; the median step.

A program that has no tracer module (an older one) gives nothing to read:
every reader returns None, and the metric is left out. A tracer that fails
to import raises.
"""

from __future__ import annotations

import importlib
import statistics
from typing import Optional

TRACER = "mage_tpu_torch.utils.trace"


def program_spans() -> Optional[list]:
    """The program's finished spans, oldest first, or None where the
    program has no tracer module."""
    try:
        trace = importlib.import_module(TRACER)
    except ModuleNotFoundError as exc:
        if exc.name != TRACER:
            raise
        return None
    return trace.records()


def trees(spans: list, root: str, count: int, device: bool = False) -> list:
    """The spans of the last ``count`` roots named ``root`` (only those with
    device times, if ``device``), one list per root, oldest first."""
    if count <= 0:
        return []
    roots = [s for s in spans if s["parent"] is None and s["name"] == root
             and (not device or s["device_ms"] is not None)][-count:]
    members: dict = {s["id"]: [] for s in roots}
    for s in spans:
        if s["root"] in members:
            members[s["root"]].append(s)
    return [members[s["id"]] for s in roots]


def call_trees(rec: dict) -> list:
    """The span trees of the window's unprofiled ``generate`` calls."""
    spans = program_spans() if rec["kind"] == "generate" else None
    if not spans:
        return []
    return trees(spans, "mage.generate", rec["attempted"] - rec.get("profiled_calls", 0))


def step_trees(rec: dict) -> list:
    """The span trees of the window's unprofiled train steps."""
    spans = program_spans() if rec["kind"] == "train" else None
    if not spans:
        return []
    return trees(spans, "mage.train_step", rec["attempted"] - rec.get("profiled_steps", 0),
                 device=True)


def host_ms_per_call(rec: dict, name: str):
    """Mean over the unprofiled calls of the host milliseconds their spans
    named ``name`` took."""
    calls = [[s["host_ms"] for s in tree if s["name"] == name] for tree in call_trees(rec)]
    if not any(calls):
        return None
    return statistics.fmean(sum(c) for c in calls)


def host_ms_per_span(rec: dict, name: str):
    """Mean host milliseconds of one span named ``name`` in the unprofiled
    calls."""
    found = [s["host_ms"] for tree in call_trees(rec) for s in tree if s["name"] == name]
    return statistics.fmean(found) if found else None


def launch_host_us(rec: dict):
    """Host microseconds per hand-written kernel launch, over every span of
    the unprofiled calls."""
    spans = [s for tree in call_trees(rec) for s in tree]
    launches = sum(n for s in spans for n in s["launches"].values())
    if not launches:
        return None
    return sum(s["launch_ns"] for s in spans) * 1e-3 / launches


def device_ms_per_step(rec: dict, name: str, less: Optional[str] = None):
    """Median over the unprofiled steps of the device milliseconds of their
    spans named ``name``, less those of their direct children named
    ``less`` (a span's own time without a stage it contains). The median,
    since a span's events also time the device waiting on a host that
    stalls inside it: a few such steps read 10x a phase's work."""
    per_step = []
    for tree in step_trees(rec):
        outer = [s for s in tree if s["name"] == name and s["device_ms"] is not None]
        if not outer:
            continue
        ids = {s["id"] for s in outer}
        inner = sum(s["device_ms"] for s in tree if s["name"] == less and s["parent"] in ids)
        per_step.append(sum(s["device_ms"] for s in outer) - inner)
    return statistics.median(per_step) if per_step else None
