"""What every traffic driver and metric reader shares: the manifest and the
files found by name, the seeded weights, the device's description, the
profiler's trace reduced to kernel times and idle gaps, the wrapper that
records spans around the program's own calls, and the check that no JAX
module was loaded.

Nothing here imports the program; a driver hands it the program's objects.
"""

from __future__ import annotations

import importlib.util
import json
import math
import os
import subprocess
import sys
import time
from pathlib import Path
from typing import Any, Optional

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
OUT = HERE / "out"
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "mage_tpu")


# ---- the manifest and the files it names --------------------------------------


def manifest() -> dict:
    with open(ROOT / "BENCHMARK.json") as fp:
        return json.load(fp)


def read_json(path: Path) -> dict:
    with open(path) as fp:
        return json.load(fp)


def load_module(path: Path):
    """Import the Python file at ``path`` under a name of its own."""
    spec = importlib.util.spec_from_file_location(
        "benchmark_file_" + path.stem.replace(".", "_").replace("-", "_"), path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def cell_metrics(cell: str, trace: bool) -> list:
    """The manifest's metrics that this cell reports: per-layer ones in a
    traced run, end-to-end ones otherwise."""
    group = manifest()["per_layer" if trace else "end_to_end"]
    return [m for m in group if "workloads" not in m or cell in m["workloads"]]


def process_start() -> float:
    """The wall-clock time at which this process started (Linux's
    /proc/self/stat, 10 ms resolution)."""
    with open("/proc/self/stat") as fp:
        start_ticks = int(fp.read().rsplit(")", 1)[1].split()[19])
    with open("/proc/uptime") as fp:
        uptime = float(fp.read().split()[0])
    return time.time() - (uptime - start_ticks / os.sysconf("SC_CLK_TCK"))


# ---- seeded weights ------------------------------------------------------------


def make_weights(shapes: dict, seed: int, dtype, device) -> dict:
    """Weights for every named tensor, drawn from ``seed`` on ``device`` in
    one call: 1-D weights (norm scales) 1 + N(0, 0.1), 1-D biases N(0, 0.02),
    codebooks N(0, 1) (a trained codebook sits where the encoder's outputs
    do), every other tensor N(0, 1 / fan_in) with fan_in its size over its
    first dimension. The same seed gives the same tensors."""
    import torch

    gen = torch.Generator(device=device).manual_seed(seed)
    total = sum(math.prod(s) for s in shapes.values())
    flat = torch.randn(total, generator=gen, device=device)
    out, at = {}, 0
    for name, shape in shapes.items():
        n = math.prod(shape)
        t = flat[at:at + n].view(shape)
        at += n
        if len(shape) == 1:
            t = 1.0 + 0.1 * t if name.endswith("weight") else 0.02 * t
        elif "codebook" not in name:
            t = t * (n // shape[0]) ** -0.5
        out[name] = t.to(dtype)
    return out


# ---- the device ----------------------------------------------------------------


def require_cards(chips: int) -> None:
    """Exit with code 2, printing no result, without ``chips`` CUDA cards."""
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        found = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"benchmark: needs {chips} CUDA card(s), found {found}", file=sys.stderr)
        sys.exit(2)


def power_limit_w() -> Optional[float]:
    """The first card's power limit by nvidia-smi, None if it cannot be read."""
    try:
        res = subprocess.run(["nvidia-smi", "--query-gpu=power.limit",
                              "--format=csv,noheader,nounits"],
                             capture_output=True, text=True, timeout=30)
        return float(res.stdout.split()[0])
    except (OSError, ValueError, IndexError, subprocess.TimeoutExpired):
        return None


def device_block(chips: int, peak_bytes: int) -> dict:
    import torch

    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": chips,
            "memory_peak_bytes": int(peak_bytes), "power_limit_w": power_limit_w()}


def quiet_host():
    """Before a window: the set-up's objects frozen out of the garbage
    collector's scans, and one CPU thread for the program's host-side ops,
    so that idle worker threads do not spin beside the thread that launches
    the work. -> what ``restore_host`` takes."""
    import gc

    import torch

    gc.collect()
    gc.freeze()
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    return threads


def restore_host(threads: int) -> None:
    import gc

    import torch

    torch.set_num_threads(threads)
    gc.unfreeze()


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted({name for name in sys.modules if name.split(".")[0] in FORBIDDEN})


# ---- spans ------------------------------------------------------------------------


class Spans:
    """CUDA-event spans around calls, by name: ``wrap(obj, attr, name)``
    replaces the bound method on the instance with one that records a pair
    of events (and, while a profiler runs, a labelled range) around it."""

    def __init__(self):
        self.events: dict = {}

    def wrap(self, obj: Any, attr: str, name: str) -> None:
        import torch

        inner = getattr(obj, attr)
        pairs = self.events.setdefault(name, [])

        def call(*args, **kwargs):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            with torch.profiler.record_function(name):
                start.record()
                out = inner(*args, **kwargs)
                end.record()
            pairs.append((start, end))
            return out

        setattr(obj, attr, call)

    def reset(self) -> None:
        for pairs in self.events.values():
            pairs.clear()

    def ms(self) -> dict:
        """Milliseconds of every recorded span, by name (synchronises)."""
        import torch

        torch.cuda.synchronize()
        return {k: [s.elapsed_time(e) for s, e in v] for k, v in self.events.items()}


# ---- the profiler's trace ---------------------------------------------------------

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation", "python_function")


def read_trace(path: Path, window: str = "window") -> dict:
    """A chrome trace of ``torch.profiler`` reduced to the events inside the
    range labelled ``window``: device events (name, start, end) and host
    events, in seconds, with the window's own start and end."""
    with open(path) as fp:
        events = json.load(fp)["traceEvents"]
    spans = [e for e in events if e.get("ph") == "X" and "dur" in e]
    win = [e for e in spans if e.get("name") == window and e.get("cat") in HOST_CATS]
    if not win:
        return {}
    w0, w1 = win[0]["ts"], win[0]["ts"] + win[0]["dur"]

    def inside(e):
        return e["ts"] < w1 and e["ts"] + e["dur"] > w0

    dev = [(e["name"], e["ts"] * 1e-6, (e["ts"] + e["dur"]) * 1e-6)
           for e in spans if e.get("cat") in DEVICE_CATS and inside(e)]
    host = [(e["name"], e["ts"] * 1e-6, (e["ts"] + e["dur"]) * 1e-6)
            for e in spans if e.get("cat") in HOST_CATS and inside(e) and e is not win[0]]
    return {"start": w0 * 1e-6, "end": w1 * 1e-6, "device": dev, "host": host}


def busy_intervals(device: list) -> list:
    """The union of the device events' intervals, sorted."""
    merged: list = []
    for _, s, e in sorted(device, key=lambda d: d[1]):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return merged


def short_name(name: str) -> str:
    """A kernel's name without its return type, anonymous namespaces and
    template and argument lists."""
    name = name.replace("(anonymous namespace)::", "")
    if name.startswith("void "):
        name = name[5:]
    return name.split("(")[0].split("<")[0][:96]


def _top(seconds: dict) -> list:
    return [[k, v] for k, v in sorted(seconds.items(), key=lambda kv: -kv[1])[:10]]


def summarize_trace(tr: dict) -> dict:
    """Busy and window seconds, device seconds by kernel name, and idle
    seconds by the innermost host range open at each gap's midpoint (the
    one that started last)."""
    import numpy as np

    busy = busy_intervals(tr["device"])
    by_kernel: dict = {}
    for name, s, e in tr["device"]:
        by_kernel[short_name(name)] = by_kernel.get(short_name(name), 0.0) + (e - s)
    edges = [tr["start"]] + [x for s, e in busy for x in (s, e)] + [tr["end"]]
    names = [h[0] for h in tr["host"]]
    hs = np.array([h[1] for h in tr["host"]] or [0.0])
    he = np.array([h[2] for h in tr["host"]] or [0.0])
    idle: dict = {}
    for gs, ge in zip(edges[::2], edges[1::2]):
        if ge <= gs:
            continue
        mid = 0.5 * (gs + ge)
        open_at = np.where((hs <= mid) & (he >= mid), hs, -np.inf)
        label = names[int(open_at.argmax())] if names and open_at.max() > -np.inf \
            else "(no host range)"
        idle[label] = idle.get(label, 0.0) + (ge - gs)
    return {"busy_s": sum(e - s for s, e in busy), "window_s": tr["end"] - tr["start"],
            "kernel_s_by_name": by_kernel, "device_ops": _top(by_kernel),
            "idle_gaps": _top(idle)}


class Profiled:
    """``torch.profiler`` (CPU and CUDA) over part of a window, inside a range
    labelled ``window``: ``start()`` and ``stop()`` around the calls to
    trace (``stop`` synchronises first), ``export(path)`` after the window,
    so that writing the trace costs the window nothing."""

    def __init__(self):
        from torch.profiler import ProfilerActivity, profile, record_function

        self.prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
        self.range = record_function("window")

    def start(self) -> None:
        self.prof.__enter__()
        self.range.__enter__()

    def stop(self) -> None:
        import torch

        torch.cuda.synchronize()
        self.range.__exit__(None, None, None)
        self.prof.__exit__(None, None, None)

    def export(self, path: Path) -> None:
        path.parent.mkdir(parents=True, exist_ok=True)
        self.prof.export_chrome_trace(str(path))


# ---- the result line -----------------------------------------------------------------


def emit(result: dict, checks: dict) -> None:
    """Print each compared number beside its limit as the last lines of
    standard error, and the result as the last line of standard output, its
    ``checks`` key last."""
    for name, c in checks.items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps({**result, "checks": checks}), flush=True)
