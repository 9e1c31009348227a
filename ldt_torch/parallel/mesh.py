"""Data-parallel placement over a DeviceMesh, counterpart of
`ldt_tpu/parallel/mesh.py`.

The JAX package places a global array with a sharding and lets XLA run the
step on each device's share; here every rank holds the global batch (all
draw it alike), keeps its rows with `shard_batch`, and the trainers reduce
gradients and batch statistics over `data` themselves (`parallel.comm`).
"""

from __future__ import annotations

from typing import Any

import torch
import torch.distributed as dist

from ldt_torch.parallel import comm
from ldt_torch.parallel.tp import axis_rank, axis_size


def data_mesh(axis_name: str = "data"):
    """1-D DeviceMesh over every rank of the process group."""
    from torch.distributed.device_mesh import init_device_mesh

    from ldt_torch.parallel.tp import _mesh_device

    if not dist.is_initialized():
        raise RuntimeError("data_mesh needs a process group: call "
                           "initialize_distributed() first")
    return init_device_mesh(_mesh_device(), (dist.get_world_size(),),
                            mesh_dim_names=(axis_name,))


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(fn, v) for v in tree)
    return fn(tree)


def batch_rows(mesh, batch: int, axis_name: str = "data"):
    """(start, stop) of this rank's rows of a global batch of `batch`
    along `axis_name`; the whole batch where the axis does not divide it
    (the JAX package then replicates)."""
    d = axis_size(mesh, axis_name)
    if d == 1 or batch % d:
        return 0, batch
    step = batch // d
    r = axis_rank(mesh, axis_name)
    return r * step, (r + 1) * step


def shard_batch(mesh, batch: Any, axis_name: str = "data"):
    """This rank's rows of every array in `batch` (tensors and numpy arrays
    of a nested dict, list or tuple): its 1/d of the leading axis; an array
    whose leading dimension d does not divide stays whole, as the JAX
    package replicates it. The batch itself without a mesh or at d = 1."""
    if axis_size(mesh, axis_name) == 1:
        return batch

    def rows(x):
        if getattr(x, "ndim", 0) >= 1:
            start, stop = batch_rows(mesh, x.shape[0], axis_name)
            return x[start:stop]
        return x

    return _map(rows, batch)


def shard_leading_axis(mesh, x, axis_name: str = "data"):
    """This rank's 1/d of `x`'s leading axis; raises where d does not
    divide it (the JAX package's `device_put` raises too)."""
    d = axis_size(mesh, axis_name)
    if d == 1:
        return x
    if x.shape[0] % d:
        raise ValueError(f"leading axis {x.shape[0]} does not split over "
                         f"{d} ranks of {axis_name!r}")
    return shard_batch(mesh, x, axis_name)


def replicate(mesh, tree: Any):
    """Rank 0's values of every tensor in `tree` on every rank (a broadcast,
    in place); the tree without a mesh."""
    if mesh is None or mesh.size() == 1:
        return tree

    def put(x):
        if isinstance(x, torch.Tensor):
            comm.broadcast(x.data if isinstance(x, torch.nn.Parameter)
                           else x, 0, None)
        return x

    return _map(put, tree)


def device_put_host(mesh, tree: Any, device=None):
    """Host (numpy) leaves of `tree` as tensors on `device` (the default
    CUDA device when None and a card is present, else the CPU); tensors
    pass through. The placement is replicated: every rank holds the same
    values (tensor-parallel placement is `tp.shard_train_state`'s)."""
    import numpy as np

    if device is None:
        device = "cuda" if torch.cuda.is_available() else "cpu"

    def put(x):
        if isinstance(x, np.ndarray):
            return torch.as_tensor(x, device=device)
        return x

    return _map(put, tree)
