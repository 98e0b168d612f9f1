"""Tensor-parallel and FSDP placement of the stage-2 parameters.

Port of ``mage_tpu/parallel/partitioning.py``. The JAX package makes tensor
parallelism (Megatron column-parallel q/k/v and MLP-in kernels, row-parallel
output projections over a ``model`` axis) and FSDP (ZeRO-3: every parameter
of at least ``FSDP_MIN_SIZE`` elements also split over the ``data`` axis,
on its largest free divisible dimension) a placement decision, and GSPMD
inserts the gathers and reductions. The port takes the same decisions and
places each parameter as a ``torch.distributed.tensor`` ``DTensor`` master
with them; the train step gathers the parameters for its forward
(:func:`gather`: whole over the ``data`` axis, this rank's shard over the
``model`` axis, which ``tensor_parallel`` runs as column- and row-parallel
linears) and the backward returns each gradient in its master's
placement: averaged over the ``data`` axis (DDP's all-reduce where the
master is replicated, a reduce-scatter where FSDP split it) and local to
the shard over the ``model`` axis. Adam then updates the shards it holds,
so parameters and moments stay split.

Decisions are taken in the JAX package's layout, so they equal JAX's
element for element: each port tensor is viewed as the flax tensor it is
carried from (``compat.from_jax``; a (O, I) Linear weight as (I, O), a conv
weight with its channel axes last), and the packed (3D, D) attention
``in_proj_weight`` as three (D, heads, head_dim) blocks, so that the model
axis splits the heads of q, k and v each (a plain split of the packed rows
would give one rank all of q and half of k). Parameters of other modules
(the frozen first stage is not a parameter of the core) stay replicated.
"""

from __future__ import annotations

import math
from typing import Callable, Mapping, NamedTuple, Optional

import torch
from torch import nn

from mage_tpu_torch.models.layers import MultiHeadAttention
from mage_tpu_torch.parallel.mesh import axis_size

# column-parallel: shard the output features; row-parallel: the input ones
_COLUMN_KEYS = ("in_proj", "c_fc", "linear1")
_ROW_KEYS = ("out_proj", "c_proj", "linear2")

# FSDP shards only params with at least this many elements; smaller ones
# (biases, LN scales) replicate: the all-gather latency beats the bytes.
FSDP_MIN_SIZE = 2 ** 15


class Layout(NamedTuple):
    """How a port tensor maps to the flax tensor(s) it is carried from:
    ``to_view(t)`` gives the flax-layout view, ``from_view(v)`` the port
    tensor back, and ``packed`` is 1 where the view's leading axis stacks
    the three q/k/v blocks (each one flax tensor) and 0 otherwise."""

    to_view: Callable
    from_view: Callable
    packed: int = 0


def _identity() -> Layout:
    return Layout(lambda t: t, lambda v: v)


def _channels_last(ndim: int) -> Layout:
    """(O, I, *k) -> flax's (*k, I, O); a Linear's (O, I) -> (I, O)."""
    perm = tuple(range(2, ndim)) + (1, 0)
    inv = tuple(perm.index(i) for i in range(ndim))
    return Layout(lambda t: t.permute(perm), lambda v: v.permute(inv))


def _packed_in_proj(heads: int, d: int) -> Layout:
    """(3D, D) -> (3, D, heads, hd): block b is flax's (D, heads, hd) kernel."""
    hd = d // heads
    return Layout(lambda t: t.reshape(3, heads, hd, d).permute(0, 3, 1, 2),
                  lambda v: v.permute(0, 2, 3, 1).reshape(-1, v.shape[1]), packed=1)


def _packed_bias(heads: int, d: int) -> Layout:
    """(3D,) -> (3, heads, hd): flax's (heads, hd) q/k/v biases."""
    return Layout(lambda t: t.reshape(3, heads, d // heads),
                  lambda v: v.reshape(3 * d), packed=1)


def _out_proj(heads: int, d: int) -> Layout:
    """(D, heads * hd) -> flax's (heads, hd, D) out_proj kernel."""
    hd = d // heads
    return Layout(lambda t: t.T.reshape(heads, hd, d),
                  lambda v: v.reshape(-1, v.shape[-1]).T)


def layouts(module: nn.Module) -> dict:
    """Each parameter name of ``module`` -> its :class:`Layout`."""
    out = {}
    for mname, m in module.named_modules():
        prefix = f"{mname}." if mname else ""
        if isinstance(m, MultiHeadAttention):
            out[f"{prefix}in_proj_weight"] = _packed_in_proj(m.n_head, m.d_model)
            out[f"{prefix}in_proj_bias"] = _packed_bias(m.n_head, m.d_model)
            out[f"{prefix}out_proj.weight"] = _out_proj(m.n_head, m.d_model)
        for leaf, p in m.named_parameters(recurse=False):
            name = prefix + leaf
            if name in out:
                continue
            conv = isinstance(m, (nn.Linear, nn.Conv2d, nn.Conv3d, nn.ConvTranspose2d))
            out[name] = _channels_last(p.ndim) if conv and leaf == "weight" else _identity()
    return out


def param_spec(name: str, shape, model_axis: str = "model") -> tuple:
    """The tensor-parallel spec (an axis name or None per dimension) of one
    flax-layout tensor of ``shape``, keyed on the port parameter's name."""
    ndim = len(shape)
    spec = [None] * ndim
    if ndim < 2 or not name.endswith("weight"):
        return tuple(spec)  # biases, scales, embeddings: replicate
    if any(k in name for k in _COLUMN_KEYS):
        # the q/k/v blocks are (d, heads, head_dim): shard heads
        spec[1 if ndim == 3 else ndim - 1] = model_axis
    elif any(k in name for k in _ROW_KEYS):
        # out_proj is (heads, head_dim, d), the others (4d, d): axis 0
        spec[0] = model_axis
    return tuple(spec)


def fsdp_extend_spec(spec: tuple, shape, data_axis_size: int, data_axis: str = "data",
                     min_size: Optional[int] = None) -> tuple:
    """Extend a (possibly empty) TP spec with a data-axis shard on the
    largest still-free, divisible dimension of ``shape``. Returns ``spec``
    unchanged if the tensor is small or no dimension divides."""
    ndim = len(shape)
    min_size = FSDP_MIN_SIZE if min_size is None else min_size
    if ndim < 1 or math.prod(shape) < min_size or data_axis_size <= 1:
        return spec
    full = list(spec) + [None] * (ndim - len(spec))
    for dim in sorted(range(ndim), key=lambda d: -shape[d]):
        if full[dim] is None and shape[dim] % data_axis_size == 0:
            full[dim] = data_axis
            return tuple(full)
    return spec


def plan(module: nn.Module, sizes: Mapping[str, int], model_axis: str = "model",
         fsdp_axis: Optional[str] = None, fsdp_min_size: Optional[int] = None) -> dict:
    """Each parameter name -> (its :class:`Layout`, the spec of its
    flax-layout view) on a mesh of axis ``sizes``. Divisibility-guarded: a
    model-axis split that does not divide falls back to replication; with
    ``fsdp_axis`` set, large tensors also split one free dimension over it.
    A packed q/k/v view takes the decision of one block (JAX's tensor) on
    its block axes."""
    tp, fsdp_size = sizes.get(model_axis, 1), sizes.get(fsdp_axis, 1) if fsdp_axis else 1
    out = {}
    params = dict(module.named_parameters())
    for name, layout in layouts(module).items():
        shape = tuple(layout.to_view(params[name]).shape)
        block = shape[layout.packed:]
        spec = param_spec(name, block, model_axis)
        if tp <= 1 or any(s == model_axis and block[d] % tp for d, s in enumerate(spec)):
            spec = (None,) * len(block)
        if fsdp_axis is not None:
            spec = fsdp_extend_spec(spec, block, fsdp_size, fsdp_axis, fsdp_min_size)
        out[name] = (layout, (None,) * layout.packed + tuple(spec))
    return out


def _placements(mesh, spec: tuple) -> list:
    from torch.distributed.tensor import Replicate, Shard

    return [Shard(spec.index(axis)) if axis in spec else Replicate()
            for axis in mesh.mesh_dim_names]


def shard_params(module: nn.Module, mesh, model_axis: str = "model",
                 fsdp_axis: Optional[str] = None,
                 fsdp_min_size: Optional[int] = None) -> dict:
    """Each parameter of ``module`` -> ``(DTensor master, Layout)``: the
    flax-layout view of its current value, placed on ``mesh`` as
    :func:`plan` decides (replicated over every axis its spec does not
    name). The masters are leaf ``nn.Parameter``s for an optimizer."""
    from torch.distributed.tensor import distribute_tensor

    sizes = {n: axis_size(mesh, n) for n in mesh.mesh_dim_names}
    params = dict(module.named_parameters())
    out = {}
    for name, (layout, spec) in plan(module, sizes, model_axis, fsdp_axis,
                                     fsdp_min_size).items():
        view = layout.to_view(params[name].detach()).contiguous()
        out[name] = (nn.Parameter(distribute_tensor(view, mesh, _placements(mesh, spec))),
                     layout)
    return out


def gather(masters: Mapping, mesh, data_axis: str = "data", model_axis: str = "model",
           local_model: bool = False) -> dict:
    """The full parameters (port layout) from :func:`shard_params`' masters,
    differentiable: each gradient comes back averaged over ``data_axis`` and
    in its master's placement. With ``local_model`` a tensor split over
    ``model_axis`` stays split there: this rank's shard, for the
    tensor-parallel forward (``parallel.tensor_parallel``)."""
    from torch.distributed.tensor import Partial, Replicate

    out = {}
    for name, (m, layout) in masters.items():
        keep = [p if local_model and axis == model_axis else Replicate()
                for axis, p in zip(mesh.mesh_dim_names, m.placements)]
        grads = [Partial("avg") if axis == data_axis else p
                 for axis, p in zip(mesh.mesh_dim_names, keep)]
        out[name] = layout.from_view(m.redistribute(mesh, keep).to_local(
            grad_placements=grads))
    return out


def distribute_like(master, full: torch.Tensor, layout: Layout):
    """A full port-layout tensor placed as ``master`` is (for restoring a
    whole checkpoint onto the live placement)."""
    from torch.distributed.tensor import distribute_tensor

    view = layout.to_view(full.to(master.device_mesh.device_type)).contiguous()
    return distribute_tensor(view, master.device_mesh, master.placements)


def sharding_summary(masters: Mapping, model_axis: str = "model") -> dict:
    """Count masters by their placed sharding: ``model`` (split on the model
    axis), ``data`` (split on another axis only: FSDP), ``replicated``."""
    from torch.distributed.tensor import Shard

    counts = {"model": 0, "data": 0, "replicated": 0}
    for m, _ in masters.values():
        split = [axis for axis, p in zip(m.device_mesh.mesh_dim_names, m.placements)
                 if isinstance(p, Shard)]
        counts["model" if model_axis in split else "data" if split else "replicated"] += 1
    return counts
