"""The ``axial`` kernel's share of its roofline over the profiled calls
(``readers.roofline_pct``, ``counts.kernels.axial``)."""

from benchmark.readers import roofline_pct


def read(rec):
    return roofline_pct(rec, "axial")
