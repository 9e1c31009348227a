"""Data, tensor and sequence parallelism over `torch.distributed`,
counterpart of `ldt_tpu/parallel/`: `mesh` (data-parallel placement),
`tp` (the process group, the data x model DeviceMesh, Megatron sharding),
`sp` (the sequence-parallel decode) and `comm` (the collectives and their
autograd functions)."""

from ldt_torch.parallel.mesh import (
    data_mesh,
    replicate,
    shard_batch,
    shard_leading_axis,
)
from ldt_torch.parallel.sp import set_sp_mesh, sp_shard

__all__ = ["data_mesh", "replicate", "shard_batch", "shard_leading_axis",
           "set_sp_mesh", "sp_shard"]
