"""The readings each limit is set from, on the card:

    python -m benchmark.calibrate --workload <cell> --seeds 1 2 3 ... [--seconds 5] [--fault NAME]

For each seed one run of the cell through ``benchmark.run.run_cell``, the
window at the cell's own load for ``--seconds``, prints one JSON line: the
program's numbers and those of the control, the float32 reference with every
product's operands rounded to fp8 e4m3 (the precision below the
configuration's bf16; a training cell's frozen float32 encode in bf16), put
in the program's place at the same positions.
With ``--fault`` a fault of ``benchmark.faults`` is planted in the program
first, and the line gives the program's numbers under it. The benchmark's
own runs never run this."""

from __future__ import annotations

import argparse
import json
import sys
import time

from benchmark import faults, harness


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=5.0)
    ap.add_argument("--fault", choices=sorted(faults.FAULTS))
    args = ap.parse_args(argv)

    from benchmark.reference.model import fp8_round

    cell = {c["name"]: c for c in harness.manifest()["workloads"]}[args.workload]
    harness.require_cards(cell["chips"])
    for row in readings(cell, args.seeds, args.seconds, "cuda", fp8_round, args.fault):
        print(json.dumps(row), flush=True)
    return 0


def readings(cell: dict, seeds: list, seconds: float, device: str, control, fault=None,
             config_path=None, mix=None):
    """-> one row a seed: {"seed", "correct", "program": numbers, "control":
    numbers}."""
    from benchmark import run

    undo = faults.plant(fault, cell, config_path) if fault else (lambda: None)
    try:
        for seed in seeds:
            result, checks = run.run_cell(cell, seed, seconds, False, device, time.time(),
                                          config_path=config_path, mix=mix, control=control)
            numbers = result.get("program") or {k: c["value"] for k, c in checks.items()}
            row = {"seed": seed, "correct": result["correct"], "program": numbers}
            if result.get("control") is not None:
                row["control"] = result["control"]
            yield row
    finally:
        undo()


if __name__ == "__main__":
    sys.exit(main())
