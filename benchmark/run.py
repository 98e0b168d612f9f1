"""Run one cell of the benchmark and print its result as the last line.

    python -m benchmark.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. The cell is looked up in ``BENCHMARK.json``;
its configuration is ``benchmark/configs/<config>.json`` (YAML's superset,
so the program's own config loader reads it), its traffic mix
``benchmark/traffic/<traffic>.json``, whose ``driver`` names the driver
``benchmark/traffic/<driver>.py``, and its limits
``benchmark/workloads/<cell>.json``. Each metric is read by
``benchmark/metrics/<metric>.py`` from the run's records; a reader that finds
nothing to read returns None and the metric is left out. With ``--trace 1``
the per-layer metrics are reported, otherwise the end-to-end ones.

The run fails, printing no result, without the cards the cell asks for, and
when a JAX module is loaded once the window has closed.
"""

from __future__ import annotations

import argparse
import os
import sys
import time
from types import SimpleNamespace

STARTED = time.time()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from benchmark import harness

    started = min(STARTED, harness.process_start())
    cells = {c["name"]: c for c in harness.manifest()["workloads"]}
    if args.workload not in cells:
        print(f"benchmark: no cell {args.workload!r} in BENCHMARK.json", file=sys.stderr)
        return 2
    cell = cells[args.workload]
    harness.require_cards(cell["chips"])
    result = run_cell(cell, args.seed, args.seconds, bool(args.trace), "cuda", started)
    if result is None:
        return 1
    harness.emit(*result)
    return 0


def run_cell(cell: dict, seed: int, seconds: float, trace: bool, device: str,
             started: float, config_path=None, mix=None, control=None):
    """Drive the cell and read its metrics -> (result, checks), or None when
    a forbidden module was loaded. ``config_path`` and ``mix`` replace the
    cell's files (the CPU tests' small sizes). With ``control`` (an operand
    rounding of the reference) the result also gives, under ``control``,
    the numbers of the reference in that precision put in the program's
    place, and under ``program`` every number the program read, compared
    or not (``benchmark.calibrate``; the benchmark's own runs never pass it)."""
    from benchmark import harness

    config_path = config_path or harness.HERE / "configs" / f"{cell['config']}.json"
    mix = mix or harness.read_json(harness.HERE / "traffic" / f"{cell['traffic']}.json")
    ctx = SimpleNamespace(
        cell=cell["name"], config=harness.read_json(config_path),
        config_path=str(config_path), mix=mix, seed=seed, seconds=seconds, trace=trace,
        device=device, started=started, control=control)
    driver = harness.load_module(harness.HERE / "traffic" / f"{mix['driver']}.py")
    rec = driver.run(ctx)
    if rec["forbidden"]:
        print("benchmark: JAX modules loaded: " + ", ".join(rec["forbidden"]), file=sys.stderr)
        return None

    metrics = {}
    for m in harness.cell_metrics(cell["name"], trace):
        reader = harness.load_module(harness.HERE / "metrics" / f"{m['name']}.py")
        value = reader.read(rec)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    limits = harness.read_json(harness.HERE / "workloads" / f"{cell['name']}.json")["limits"]
    checks = {k: {"value": rec["checks"].get(k), "limit": v} for k, v in limits.items()}
    correct = (rec["failed"] == 0 and bool(rec["checks"])
               and all(c["value"] is not None and c["value"] <= c["limit"]
                       for c in checks.values()))
    result = {"correct": correct, "attempted": rec["attempted"], "failed": rec["failed"],
              "metrics": metrics,
              "device": (harness.device_block(cell["chips"], rec["process_peak_bytes"])
                         if device == "cuda" else {"platform": "cpu"})}
    if control is not None:  # every number of both sides, compared or not
        result["program"] = rec["checks"]
        result["control"] = rec.get("control_checks")
    if trace and "trace" in rec:
        tr = rec["trace"]
        result["device"].update(busy_s=tr["busy_s"], window_s=tr["window_s"])
        result["breakdown"] = {"device_ops": tr["device_ops"], "idle_gaps": tr["idle_gaps"]}
    return result, checks


if __name__ == "__main__":
    os.environ.setdefault("USE_FLAX", "0")
    sys.exit(main())
