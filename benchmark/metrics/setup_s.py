"""Seconds from the process's start to the first timed call: imports, the
kernels' build or load, the model's construction and weights, the inputs
and the warm-up calls."""


def read(rec):
    return rec["setup_s"]
