"""Mean device milliseconds of the ``frozen_encode`` span (CUDA events
around the program's own ``encode_first_stage`` call inside each train
step) over the window's steps."""

from benchmark.readers import span_mean_ms


def read(rec):
    return span_mean_ms(rec, "frozen_encode")
