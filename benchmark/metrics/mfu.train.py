"""The FLOPs one train step needs (``counts.flops.train_step``: the frozen
encode's forward, stage 2's forward and backward) over the mean wall time of
the unprofiled steps, against the bf16 dense peak."""

from benchmark.counts import flops
from benchmark.counts.peaks import BF16_FLOP_PER_S


def read(rec):
    if rec["kind"] != "train" or not rec["steady_steps"] or rec["steady_s"] <= 0:
        return None
    work = flops.train_step(rec["model"], rec["batch"])
    return 100.0 * work * rec["steady_steps"] / rec["steady_s"] / BF16_FLOP_PER_S
