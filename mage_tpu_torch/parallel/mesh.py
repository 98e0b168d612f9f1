"""Process groups, device meshes and batch sharding.

Port of ``mage_tpu/parallel/mesh.py``. JAX runs one program over a
``Mesh`` of devices and lets XLA insert the collectives; PyTorch runs one
process per device, so the port's mesh is a
``torch.distributed.device_mesh.DeviceMesh`` over the ranks of a process
group: a ``data`` axis over which the batch is split, and an optional
``model`` axis over which parameters are split (``parallel.partitioning``).
Every rank of one ``data`` coordinate holds the same slice of the batch.

``init_distributed`` starts the process group from what ``torchrun`` sets
(``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``,
``MASTER_PORT``), and only when a caller asks for it (the CLIs'
``--multihost``): nccl on the card, gloo on the CPU.
"""

from __future__ import annotations

import math
import os
from typing import Any, Mapping, Optional

import torch
import torch.distributed as dist


def init_distributed(device: str = "cuda", backend: Optional[str] = None) -> torch.device:
    """Join the process group ``torchrun`` describes in the environment and
    return this rank's device: ``cuda:LOCAL_RANK`` with nccl, or the CPU with
    gloo (``device="cpu"``). ``backend`` overrides the choice."""
    device = torch.device(device)
    if device.type == "cuda":
        from mage_tpu_torch.models.pipeline import resolve_device

        resolve_device(device)
        device = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
        torch.cuda.set_device(device)
    backend = backend or ("nccl" if device.type == "cuda" else "gloo")
    addr = os.environ.get("MASTER_ADDR", "localhost")
    port = os.environ["MASTER_PORT"]
    dist.init_process_group(backend, init_method=f"tcp://{addr}:{port}",
                            rank=int(os.environ["RANK"]),
                            world_size=int(os.environ["WORLD_SIZE"]))
    return device


def make_mesh(axes: Optional[Mapping[str, int]] = None, device_type: str = "cuda"):
    """A ``DeviceMesh`` over the process group's ranks. ``axes`` maps axis
    name -> size; one axis may be -1 (all remaining ranks). Default: a 1-D
    ``data`` mesh over every rank. The process group must be initialised."""
    from torch.distributed.device_mesh import init_device_mesh

    n = dist.get_world_size()
    axes = dict(axes or {"data": -1})
    known, infer_key = 1, None
    for k, v in axes.items():
        if v == -1:
            if infer_key is not None:
                raise ValueError("Only one mesh axis may be -1.")
            infer_key = k
        else:
            known *= v
    if infer_key is not None:
        if n % known:
            raise ValueError(f"{n} devices not divisible by {known}.")
        axes[infer_key] = n // known
    total = math.prod(axes.values())
    if total != n:
        raise ValueError(f"Mesh size {total} != device count {n}.")
    return init_device_mesh(device_type, tuple(axes.values()), mesh_dim_names=tuple(axes))


def axis_size(mesh, axis: str) -> int:
    """The mesh's size along ``axis`` (1 where it has no such axis, or no
    mesh is given)."""
    names = () if mesh is None else mesh.mesh_dim_names or ()
    return mesh.size(names.index(axis)) if axis in names else 1


def axis_index(mesh, axis: str) -> int:
    """This rank's coordinate along ``axis`` (0 where the mesh has none)."""
    names = () if mesh is None else mesh.mesh_dim_names or ()
    return mesh.get_local_rank(axis) if axis in names else 0


def is_main_rank(mesh) -> bool:
    """Rank 0 of the process group (or no mesh): the one that writes files."""
    return mesh is None or dist.get_rank() == 0


def local_batch_slice(global_batch_size: int, mesh, axis: str = "data") -> slice:
    """The slice of the global batch this rank's ``axis`` coordinate owns."""
    per = global_batch_size // axis_size(mesh, axis)
    idx = axis_index(mesh, axis)
    return slice(idx * per, (idx + 1) * per)


def shard_batch(batch: Any, mesh, axis: str = "data", device=None) -> Any:
    """This rank's slice of each leaf's leading (batch) dimension, as a
    tensor on ``device``; dicts, lists and tuples are walked. The port's
    counterpart of placing a global batch on a mesh sharded along ``axis``."""
    if isinstance(batch, Mapping):
        return {k: shard_batch(v, mesh, axis, device) for k, v in batch.items()}
    if isinstance(batch, (list, tuple)):
        return type(batch)(shard_batch(v, mesh, axis, device) for v in batch)
    x = torch.as_tensor(batch)
    return x[local_batch_slice(x.shape[0], mesh, axis)].to(device)


def gather_batch(x: torch.Tensor, mesh, axis: str = "data") -> torch.Tensor:
    """The inverse of :func:`shard_batch`: every ``axis`` slice, concatenated
    in coordinate order along the leading dimension (an all-gather)."""
    if axis_size(mesh, axis) == 1:
        return x
    group = mesh.get_group(axis)
    parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, x.contiguous(), group=group)
    return torch.cat(parts)


def data_mean(x: torch.Tensor, mesh, axis: str = "data") -> torch.Tensor:
    """The mean of ``x`` over the ranks of ``axis`` (the global-batch mean of
    equal-sized per-rank means), without gradient."""
    if axis_size(mesh, axis) == 1:
        return x
    out = x.detach().clone()
    dist.all_reduce(out, group=mesh.get_group(axis))
    return out / axis_size(mesh, axis)

