"""Host milliseconds of the program's ``mage.inputs`` span per call (the
uploads of caption, speed and prior noise, queued after the first-frame
encode), over the window's unprofiled calls. A copy from pageable host
memory that waits for the stream shows here as the encode's device time."""

from benchmark.spans import host_ms_per_call


def read(rec):
    return host_ms_per_call(rec, "mage.inputs")
