"""The ``cached`` kernel's share of its roofline over the profiled calls
(``readers.roofline_pct``, ``counts.kernels.cached``)."""

from benchmark.readers import roofline_pct


def read(rec):
    return roofline_pct(rec, "cached")
