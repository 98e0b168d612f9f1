"""Host microseconds per hand-written kernel launch (an op's launcher from
entry to return: input checks, output allocation, the ctypes call), summed
over every span of the window's unprofiled calls."""

from benchmark.spans import launch_host_us


def read(rec):
    return launch_host_us(rec)
