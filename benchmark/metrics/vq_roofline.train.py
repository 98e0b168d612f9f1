"""The ``vq`` kernel's share of its roofline over the profiled train steps,
where the frozen f32 encode runs its SIMT variant (``readers.roofline_pct``,
``counts/kernels/vq.py``)."""

from benchmark.readers import roofline_pct


def read(rec):
    return roofline_pct(rec, "vq") if rec["kind"] == "train" else None
