"""Build the hand-written Hopper kernels under ``csrc/`` and bind them.

The ``.cu`` files have a plain C interface. At first use they are compiled
by ``nvcc`` for ``sm_90a`` (one process per source, all started together),
linked into one shared library under ``_build/`` whose name carries a hash
of the sources and flags, and loaded with ``ctypes``. A second process that
finds the library already built loads it without compiling.

Each C entry point launches on the stream it is given and returns
``cudaGetLastError()``; :class:`Kernel` raises if that is not 0. A wrapper
never synchronises and allocates its outputs itself with ``torch.empty``.
Each op's launcher (the Python function that checks the inputs, allocates
the outputs and calls its one entry point once) is decorated with
:func:`launcher`, the one place a launch is counted: by launcher name, with
its host time, in ``utils.trace``.

While a CUDA graph captures (``capturing_launches``), a launch reaches no
device: it is counted in the capture's record instead, and each replay of
the graph credits it (``credit``).
"""

from __future__ import annotations

import contextlib
import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Iterator, Sequence

import torch

from mage_tpu_torch.utils import trace

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC")

# dtype codes shared with csrc/common.cuh
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    found = shutil.which("nvcc") or shutil.which(os.path.join(cuda_home, "bin", "nvcc"))
    if found is None:
        raise RuntimeError(
            "nvcc not found (looked on PATH and in $CUDA_HOME/bin): the "
            "mage_tpu_torch kernels are built from csrc/ at first use"
        )
    return found


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(CSRC.iterdir()):
        if p.suffix in (".cu", ".cuh"):
            h.update(p.name.encode())
            h.update(p.read_bytes())
    return h.hexdigest()[:16]


def library_path() -> Path:
    return BUILD_DIR / f"libmage_kernels_{_digest()}.so"


def build(verbose: bool = False) -> Path:
    """Compile every source in parallel and link the shared library, unless
    a library built from the same sources exists. Returns its path."""
    out = library_path()
    if out.exists():
        return out
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        procs = []
        for src in _sources():
            obj = Path(tmp) / (src.stem + ".o")
            cmd = [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-c", str(src), "-o", str(obj)]
            if verbose:
                cmd[1:1] = ["-Xptxas", "-v"]
            procs.append((src, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
        failed = []
        for src, _, proc in procs:
            log, _ = proc.communicate()
            if verbose and log:
                print(f"[nvcc {src.name}]\n{log}", flush=True)
            if proc.returncode != 0:
                failed.append(f"{src.name}:\n{log}")
        if failed:
            raise RuntimeError("nvcc failed for " + "\n".join(failed))
        tmp_lib = Path(tmp) / out.name
        link = [nvcc, *NVCC_FLAGS, "-shared", "-o", str(tmp_lib),
                *(str(obj) for _, obj, _ in procs), "-lcudart"]
        res = subprocess.run(link, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                             text=True)
        if res.returncode != 0:
            raise RuntimeError(f"nvcc link failed:\n{res.stdout}")
        os.replace(tmp_lib, out)  # atomic: a concurrent builder sees all or nothing
    return out


@functools.cache
def library() -> ctypes.CDLL:
    return ctypes.CDLL(str(build()))


class Kernel:
    """One C entry point of the kernel library: a call launches it and
    raises on a CUDA error."""

    def __init__(self, symbol: str, argtypes: Sequence):
        self.symbol = symbol
        self.argtypes = list(argtypes)

    @functools.cached_property
    def _fn(self):
        fn = getattr(library(), self.symbol)
        fn.argtypes = self.argtypes
        fn.restype = ctypes.c_int
        return fn

    def __call__(self, *args) -> None:
        err = self._fn(*args)
        if err != 0:
            describe = library().mage_cuda_error_string
            describe.argtypes = [ctypes.c_int]
            describe.restype = ctypes.c_char_p
            raise RuntimeError(
                f"{self.symbol}: CUDA error {err}: {describe(err).decode()}")


_launching = threading.local()
_capture = threading.local()


@contextlib.contextmanager
def capturing_launches() -> Iterator[dict]:
    """Inside, on this thread, every launch goes into the yielded count by
    launcher name and into no other: wrap a CUDA graph's capture, whose
    launches run only when it replays."""
    outer = getattr(_capture, "record", None)
    _capture.record = captured = {}
    try:
        yield captured
    finally:
        _capture.record = outer


def credit(captured: dict) -> None:
    """Count a capture's launches as launched once, as one replay of its
    graph launches them, with no host time of their own."""
    for kernel, n in captured.items():
        trace.count_launch(kernel, 0, n)


def launcher(kernel: str):
    """Decorate an op's launcher: each call that returns counts one launch
    of ``kernel`` with its host nanoseconds from entry to return
    (``trace.count_launch``), or in the record of a CUDA graph's capture
    (``capturing_launches``). A launcher called by another (gn_conv's
    statistics pass) counts its launch with no time of its own: the
    caller's time holds it."""

    def wrap(fn):
        @functools.wraps(fn)
        def call(*args, **kwargs):
            nested = getattr(_launching, "on", False)
            start = trace.now_ns()
            _launching.on = True
            try:
                out = fn(*args, **kwargs)
            finally:
                _launching.on = nested
            captured = getattr(_capture, "record", None)
            if captured is None:
                trace.count_launch(kernel, 0 if nested else trace.now_ns() - start)
            else:
                captured[kernel] = captured.get(kernel, 0) + 1
            return out

        return call

    return wrap


def stream_ptr(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def dtype_code(t: torch.Tensor) -> int:
    try:
        return DTYPE_CODES[t.dtype]
    except KeyError:
        raise TypeError(
            f"kernel takes float32 or bfloat16, got {t.dtype}") from None


def check_cuda(name: str, *tensors: torch.Tensor) -> None:
    """Device, dtype and contiguity checks shared by every kernel wrapper."""
    first = tensors[0]
    for t in tensors:
        if not t.is_cuda:
            raise ValueError(f"{name}: the kernel takes CUDA tensors, got {t.device}")
        if t.device != first.device:
            raise ValueError(f"{name}: tensors on {first.device} and {t.device}")
        if t.dtype != first.dtype:
            raise TypeError(f"{name}: mixed dtypes {first.dtype} and {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: the kernel takes contiguous tensors")
    dtype_code(first)


class _PlainGradient(torch.autograd.Function):
    """Forward by a kernel, backward through its plain version recomputed
    on the saved inputs: the kernels' outputs carry no autograd graph of
    their own, and the TPU kernels they port have no backward kernel."""

    @staticmethod
    def forward(ctx, kernel_fn, plain_fn, *tensors):
        ctx.plain_fn = plain_fn
        ctx.save_for_backward(*tensors)
        return kernel_fn(*tensors)

    @staticmethod
    def backward(ctx, grad_out):
        inputs = [t.detach().requires_grad_(need)
                  for t, need in zip(ctx.saved_tensors, ctx.needs_input_grad[2:])]
        wanted = [t for t in inputs if t.requires_grad]
        with torch.enable_grad():
            grads = iter(torch.autograd.grad(ctx.plain_fn(*inputs), wanted, grad_out))
        return (None, None, *(next(grads) if t.requires_grad else None for t in inputs))


def launch_differentiable(kernel_fn, plain_fn, *tensors: torch.Tensor) -> torch.Tensor:
    """``kernel_fn(*tensors)``; when autograd records and an input needs a
    gradient, its gradient is that of ``plain_fn`` at the same inputs."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        return _PlainGradient.apply(kernel_fn, plain_fn, *tensors)
    return kernel_fn(*tensors)


def use_kernel(impl: str, x: torch.Tensor) -> bool:
    """``impl="auto"``: the kernel for a CUDA tensor, the plain version for a
    CPU tensor. ``impl="torch"``: the plain version on any device."""
    if impl == "torch":
        return False
    if impl != "auto":
        raise ValueError(f"impl must be 'auto' or 'torch', got {impl!r}")
    return x.is_cuda
