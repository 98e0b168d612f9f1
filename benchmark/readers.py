"""What the metric readers under ``metrics/`` share. A reader takes the
run's records and returns a number, or None where it finds nothing to read."""

from __future__ import annotations

import statistics

from benchmark.counts import kernels
from benchmark.counts.peaks import least_seconds
from benchmark.harness import short_name


def span_mean_ms(rec: dict, name: str):
    """Mean milliseconds of a span over the window's calls."""
    spans = rec.get("spans_ms", {}).get(name)
    return statistics.fmean(spans) if spans else None


def profiled(rec: dict) -> int:
    """Calls or steps that ran under the profiler."""
    return rec["profiled_calls"] if rec["kind"] == "generate" else rec["profiled_steps"]


def roofline_pct(rec: dict, kernel: str):
    """The least time that the work of ``kernel`` in the profiled calls or
    steps needs, over the device time its kernels took there (matched by
    their unqualified names: vq.cu keeps its variants in namespaces), in
    percent. The work is reckoned from the cell's configuration and mix
    (``counts/kernels/<kernel>.py``'s pieces of one call or step, times the
    calls or steps profiled), so it reads the same whether Python launched
    each kernel or a CUDA graph replayed it."""
    trace = rec.get("trace")
    if not trace:
        return None
    spec = kernels.load(kernel)
    pieces = spec.pieces(rec["model"], rec["mix"], rec["itemsize"])
    device_s = sum(e - s for n, s, e in trace["device_events"]
                   if short_name(n).split("::")[-1] in spec.TRACE_NAMES)
    if not pieces or device_s <= 0:
        return None
    least = profiled(rec) * sum(least_seconds(*piece)[0] for piece in pieces)
    return 100.0 * least / device_s


def idle_pct(rec: dict, kind: str):
    """The share of the profiled window in which no device operation ran."""
    trace = rec.get("trace")
    if rec["kind"] != kind or not trace or trace["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - trace["busy_s"] / trace["window_s"])


def unprofiled_calls_s(rec: dict) -> list:
    """Host-clock seconds of the window's calls that ran outside the profiler."""
    return rec["calls_s"][rec.get("profiled_calls", 0):]
