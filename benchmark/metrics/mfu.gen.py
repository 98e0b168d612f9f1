"""The FLOPs one generate needs (``counts.flops.generate``, the cached
sampler's work) over the mean wall time of the unprofiled calls, against the
bf16 dense peak."""

import statistics

from benchmark.counts import flops
from benchmark.counts.peaks import BF16_FLOP_PER_S
from benchmark.readers import unprofiled_calls_s


def read(rec):
    calls = unprofiled_calls_s(rec)
    if rec["kind"] != "generate" or not calls:
        return None
    work = flops.generate(rec["model"], rec["batch"], temporal="cached")
    return 100.0 * work / statistics.fmean(calls) / BF16_FLOP_PER_S
