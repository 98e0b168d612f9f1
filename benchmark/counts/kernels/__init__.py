"""One file per hand-written kernel of the program, found by name: its
names in the profiler's trace (``TRACE_NAMES``, without namespaces or
template arguments), the bytes and operations of one launch of a shape
(``count``: -> (bytes, operations, the peak of the units it computes on)),
and the work that one call or step of a cell needs of it, reckoned from
the configuration's ``model.params``, the traffic mix and the bytes of an
element of the pipeline's tensors (``pieces``: -> a list of ``count``'s
results; empty where the mix's route does not run the kernel). Each input
byte counts once and each output byte once, whatever the kernel reads
again; products count two operations a multiply-add. ``count``'s first
argument is the one that grows with the batch (groups, rows, images), so
``count(0, ...)`` gives the bytes that a launch reads whatever its batch:
weights and affine rows. Nothing here reads the program, so a launch that a
CUDA graph replays counts the same as one that Python makes. A new
kernel's roofline needs only a new file here and its reader under
``metrics/``."""

from __future__ import annotations

import importlib
from pathlib import Path

HERE = Path(__file__).resolve().parent


def names() -> list:
    """Every kernel that has a file here."""
    return sorted(p.stem for p in HERE.glob("*.py") if p.stem != "__init__")


def load(name: str):
    return importlib.import_module(f"benchmark.counts.kernels.{name}")


def decoder(p: dict) -> tuple:
    """(L, r, C, layers, temporal layers) of the axial decoder: every third
    layer from the first attends along time, the others along H or W."""
    layers = int(p["generate_decoder_config"]["params"]["layers"])
    return (int(p["frames_length"]), int(p["image_resolution"]), int(p["vision_width"]),
            layers, len(range(0, layers, 3)))
