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


def roofline_pct(rec: dict, kernel: str):
    """The least time the launches of ``kernel`` in the profiled calls could
    take, from their shapes (``counts/kernels/<kernel>.py``), over the device
    time its kernels took there (matched by their unqualified names: vq.cu
    keeps its variants in namespaces), in percent."""
    trace = rec.get("trace")
    shapes = [s for k, s in rec.get("launches", []) if k == kernel]
    if not trace or not shapes:
        return None
    spec = kernels.load(kernel)
    device_s = sum(e - s for n, s, e in trace["device_events"]
                   if short_name(n).split("::")[-1] in spec.TRACE_NAMES)
    if device_s <= 0:
        return None
    least = sum(least_seconds(*spec.count(*shape))[0] for shape in shapes)
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
