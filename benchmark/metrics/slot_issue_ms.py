"""Mean host milliseconds of one ``mage.slot`` span (one ``decode_slot`` of
the cached sampler, the anchor's included) over the window's unprofiled
calls."""

from benchmark.spans import host_ms_per_span


def read(rec):
    return host_ms_per_span(rec, "mage.slot")
