"""95th percentile of the wall time of every generate call in the window,
each ended by a device synchronise."""

import numpy as np


def read(rec):
    if rec["kind"] != "generate" or not rec["calls_s"]:
        return None
    return float(np.percentile(np.array(rec["calls_s"]) * 1e3, 95))
