"""CUDA graphs of a module's call, one for each shape it meets, replayed.

``call(module, fn, inputs)`` runs ``fn(*inputs)`` for a module whose work
on the card ``fn`` issues (the cached greedy sampler of ``MAGECore``). The
first call of a key (the inputs' shapes and dtypes and the caller's
``route``) runs ``fn`` eagerly, which also warms up every kernel and
library handle it uses. The second captures ``fn`` into one CUDA graph on
a side stream (``torch.cuda.graph``), with its own memory pool, and every
later call replays it: the host issues one graph launch where the eager
loop issued every operation through Python.

- **Inputs.** Each call copies its inputs device to device into the
  graph's static buffers (a host tensor is uploaded first) before the
  replay. ``fn`` must make no host read of a device value, and no other
  host-device copy, inside the captured region.
- **Outputs.** Each call returns its own clone of the graph's static
  output, so an output that a caller keeps is never overwritten by the
  next replay.
- **Memory.** Everything ``fn`` allocates, its caches included, lives in
  the graph's private pool and is released there: outside a replay only
  the static inputs and output stay allocated (``memory_allocated``),
  while the pool stays reserved (``memory_reserved``) as long as the graph
  lives. The cuBLAS workspace that the capture stream takes is returned to
  that pool too.
- **Validity.** A graph reads every parameter and buffer of the module at
  the address it had when captured. In-place updates (``load_state_dict``,
  an optimizer step) keep the storage and the graph; a ``.to()`` or a
  replaced or added parameter, buffer or submodule drops every graph of
  the module (``_Storage``). The module's other attributes are taken as
  its constructor set them, but for the keys the caller passes
  (``route``).
- **Counts.** The launches made during a capture run only when the graph
  replays: ``_build.capturing_launches`` keeps them out of the launch
  record, and each replay credits them (``_build.credit``) to its totals
  and to the innermost open span.

At most ``MAX_GRAPHS`` graphs are kept for a module; the oldest goes first.
A module's graphs go when it does.
"""

from __future__ import annotations

import weakref
from typing import Callable, Optional, Sequence

import torch
from torch import nn

from mage_tpu_torch import _build

MAX_GRAPHS = 4  # graphs kept for one module, each with its memory pool

_STATES: "weakref.WeakKeyDictionary[nn.Module, _State]" = weakref.WeakKeyDictionary()


class _Storage:
    """What a module's graphs were captured against: every entry of its
    modules' submodule, parameter and buffer dicts, and every parameter's
    and buffer's address. ``holds()`` is false once an entry is added,
    removed or replaced, or a tensor's storage moved."""

    def __init__(self, module: nn.Module):
        self.sizes, self.entries, self.tensors = [], [], []
        mods = [module]
        for m in mods:  # grows as it goes
            for d in (m._modules, m._parameters, m._buffers):
                self.sizes.append((d, len(d)))
                self.entries.extend((d, k, v) for k, v in d.items())
            mods.extend(c for c in m._modules.values() if c is not None)
            self.tensors.extend(t for d in (m._parameters, m._buffers) for t in d.values()
                                if t is not None)
        self.ptrs = [t.data_ptr() for t in self.tensors]

    def holds(self) -> bool:
        for d, n in self.sizes:
            if len(d) != n:
                return False
        for d, k, v in self.entries:
            if d.get(k) is not v:
                return False
        return [t.data_ptr() for t in self.tensors] == self.ptrs


def key(inputs: Sequence[Optional[torch.Tensor]], route) -> tuple:
    """What a graph is kept under: each input's shape and dtype (None for
    an input not given) and the caller's ``route``."""
    return (tuple(None if t is None else (tuple(t.shape), t.dtype) for t in inputs), route)


class _State:
    """A module's storage, its graphs by key, and the keys met once."""

    def __init__(self, module: nn.Module):
        self.storage = _Storage(module)
        self.seen: set = set()
        self.graphs: dict = {}


class _Graph:
    """One captured call: static inputs, the graph, its static output and
    the launches it replays (``captured``, by launcher name)."""

    def __init__(self, fn: Callable, inputs: Sequence[Optional[torch.Tensor]]):
        device = inputs[0].device  # a host tensor among the others is uploaded on replay
        self.inputs = tuple(None if t is None else torch.empty(t.shape, dtype=t.dtype,
                                                               device=device)
                            for t in inputs)
        self.graph = torch.cuda.CUDAGraph()
        with _build.capturing_launches() as self.captured, torch.cuda.graph(self.graph):
            self.output = fn(*self.inputs)
        # the capture stream's cuBLAS workspace was allocated in the graph's
        # pool and stays mapped there; dropping the map's hold on it keeps it
        # out of the allocated bytes (the main stream's is made again on use)
        torch._C._cuda_clearCublasWorkspaces()

    def replay(self, inputs: Sequence[Optional[torch.Tensor]]) -> torch.Tensor:
        for buf, t in zip(self.inputs, inputs):
            if buf is not None:
                buf.copy_(t)
        self.graph.replay()
        _build.credit(self.captured)
        return self.output.clone()


def call(module: nn.Module, fn: Callable, inputs: Sequence[Optional[torch.Tensor]],
         route=None) -> torch.Tensor:
    """``fn(*inputs)`` on the card, where ``fn`` issues work of ``module``
    on tensors that live on ``inputs[0]``'s device: eagerly the first time
    a key is met, then from its CUDA graph (captured at the second call)."""
    state = _STATES.get(module)
    if state is None or not state.storage.holds():  # drops every graph it had
        state = _STATES[module] = _State(module)
    k = key(inputs, route)
    graph = state.graphs.get(k)
    if graph is None:
        if k not in state.seen:
            state.seen.add(k)
            return fn(*inputs)
        if len(state.graphs) >= MAX_GRAPHS:
            del state.graphs[next(iter(state.graphs))]
        graph = state.graphs[k] = _Graph(fn, inputs)
    return graph.replay(inputs)
