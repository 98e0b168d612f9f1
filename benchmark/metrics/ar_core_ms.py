"""Mean device milliseconds of the ``ar_core`` span (CUDA events around the
program's own call) over the window's calls."""

from benchmark.readers import span_mean_ms


def read(rec):
    return span_mean_ms(rec, "ar_core")
