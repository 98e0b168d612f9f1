"""The ``vq_decode_tail`` kernel's share of its roofline over the profiled
calls (``readers.roofline_pct``, ``counts.kernels.vq_decode_tail``)."""

from benchmark.readers import roofline_pct


def read(rec):
    return roofline_pct(rec, "vq_decode_tail")
