"""The ``gn_stats`` kernel's share of its roofline over the profiled calls
(``readers.roofline_pct``, ``counts.kernels.gn_stats``)."""

from benchmark.readers import roofline_pct


def read(rec):
    return roofline_pct(rec, "gn_stats")
