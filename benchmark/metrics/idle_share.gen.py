"""Share of the profiled generate calls' window in which no device
operation ran (the union of the kernels' intervals, not their sum)."""

from benchmark.readers import idle_pct


def read(rec):
    return idle_pct(rec, "generate")
