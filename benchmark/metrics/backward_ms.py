"""Device milliseconds of the program's ``mage.backward`` span per step,
the median over the window's unprofiled steps."""

from benchmark.spans import device_ms_per_step


def read(rec):
    return device_ms_per_step(rec, "mage.backward")
