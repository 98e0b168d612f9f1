"""Profiling, analytic FLOPs, and numeric-debug hooks.

Port of ``mage_tpu/utils/profiling.py``. ``profile_trace`` records a
``torch.profiler`` trace (host ops and, on the card, CUDA kernels) and
writes it as Chrome/Perfetto JSON; ``enable_debug_checks`` turns on
autograd's anomaly detection (what the JAX package's ``jax_debug_nans``
replaced); the three FLOP helpers are the JAX package's, unchanged; and
``cost_analysis`` counts a call's FLOPs with PyTorch's ``FlopCounterMode``
where the JAX package asks XLA's cost model, and its hand-written kernel
launches with ``utils.trace``'s counters.
"""

from __future__ import annotations

import contextlib
import os
from typing import Iterator

import torch

from mage_tpu_torch.utils import trace

TRACE_FILE = "trace.json"


@contextlib.contextmanager
def profile_trace(log_dir: str) -> Iterator[torch.profiler.profile]:
    """Trace the enclosed work with ``torch.profiler`` (CPU ops, plus CUDA
    kernels when a card is present) and write it to
    ``log_dir/trace.json`` (open in Perfetto or ``chrome://tracing``). The
    program's spans (``utils.trace``: ``mage.generate`` and its stages,
    ``mage.train_step`` and its phases) appear in it as ranges of those
    names around the operators and kernels they issued. The profiler is
    yielded, so a caller can read ``key_averages()``."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(log_dir, TRACE_FILE))


def enable_debug_checks(enable: bool = True) -> None:
    """NaN/Inf detection in every backward pass (the reference keeps anomaly
    detection on during training, main_mage.py:136; here it is opt-in,
    because, like the JAX package's ``jax_debug_nans``, it costs real
    throughput)."""
    torch.autograd.set_detect_anomaly(enable)


def axial_block_flops(d_model: int, token_num: int, axis_len: int) -> int:
    """Reference AxialAttentionBlock.flops (mage_model.py:55-70)."""
    return (
        3 * token_num * d_model * d_model
        + token_num * axis_len * d_model * 2
        + 2 * token_num * d_model * d_model * 4
        + token_num * d_model * 2
    )


def cross_attn_flops(d_model: int, q_num: int = 16 * 16, k_num: int = 20) -> int:
    """Reference TransformerBlock.flops (mage_model.py:97-102)."""
    return (
        k_num * d_model * d_model * 2
        + q_num * d_model * d_model
        + q_num * k_num * d_model * 2
        + 2 * q_num * d_model * d_model * 4
        + q_num * d_model
    )


def mage_decoder_flops(
    d_model: int = 512,
    layers: int = 6,
    frames_length: int = 10,
    resolution: int = 16,
) -> int:
    """Full FlatAxialDecoder forward FLOPs (axial layers cycling T/H/W), as
    the reference counts them: one per multiply-add, and without the
    attention's out-projection (``cost_analysis`` counts two per
    multiply-add)."""
    token_num = resolution * resolution * frames_length
    total = 0
    for i in range(layers):
        axis_len = frames_length if i % 3 == 0 else resolution
        total += axial_block_flops(d_model, token_num, axis_len)
    return total


def cost_analysis(fn, *args, **kwargs) -> dict:
    """``{"flops": n}``: the FLOPs of ``fn(*args, **kwargs)`` as PyTorch's
    ``FlopCounterMode`` counts them (2 per multiply-add of the matmuls,
    convolutions and attention it knows; elementwise ops count 0), with the
    call run once. The counterpart of the JAX package's
    ``jit_cost_analysis``; XLA's bytes-accessed has no counterpart here,
    since PyTorch runs the ops eagerly and compiles no program to read it
    from.

    ``FlopCounterMode`` cannot see the hand-written kernels, which launch
    through ``ctypes``: when the call launched any, the dict also holds
    ``kernel_launches``, the launches by kernel, whose work ``flops`` leaves
    out. The call runs in its own span, ``mage.cost_analysis``, whose tree
    of spans counts them."""
    from torch.utils.flop_counter import FlopCounterMode

    with trace.span("mage.cost_analysis") as outer, FlopCounterMode(display=False) as counter:
        fn(*args, **kwargs)
    out = {"flops": int(counter.get_total_flops())}
    launched: dict = {}
    for s in trace.records():  # the outer span and the spans opened inside it
        if s["root"] == outer.root and s["id"] >= outer.id:
            for kernel, n in s["launches"].items():
                launched[kernel] = launched.get(kernel, 0) + n
    if launched:
        out["kernel_launches"] = launched
    return out
