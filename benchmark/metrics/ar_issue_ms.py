"""Host milliseconds of the program's ``mage.ar_core`` span per call, over
the window's unprofiled calls: the host's time to issue the AR core. Read
beside ``ar_core_ms``, its device time: where the two are close, the host
sets the AR core's pace."""

from benchmark.spans import host_ms_per_call


def read(rec):
    return host_ms_per_call(rec, "mage.ar_core")
