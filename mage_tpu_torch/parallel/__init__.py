"""Data, tensor and FSDP parallelism over a ``torch.distributed`` device
mesh (the port of ``mage_tpu/parallel``)."""

from mage_tpu_torch.parallel.mesh import (
    gather_batch,
    init_distributed,
    local_batch_slice,
    make_mesh,
    shard_batch,
)

__all__ = ["gather_batch", "init_distributed", "local_batch_slice", "make_mesh",
           "shard_batch"]
