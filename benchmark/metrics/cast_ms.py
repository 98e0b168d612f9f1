"""Device milliseconds of the program's ``mage.cast`` span (the bf16
copies of the f32 masters) per step, the median over the window's
unprofiled steps."""

from benchmark.spans import device_ms_per_step


def read(rec):
    return device_ms_per_step(rec, "mage.cast")
