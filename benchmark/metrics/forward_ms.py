"""Device milliseconds of the program's ``mage.forward`` span less its
``mage.encode`` child (the frozen encode, ``frozen_encode_ms``) per step,
the median over the window's unprofiled steps: the teacher-forced forward
and the loss."""

from benchmark.spans import device_ms_per_step


def read(rec):
    return device_ms_per_step(rec, "mage.forward", less="mage.encode")
