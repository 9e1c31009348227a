"""Sequence-parallel decode, counterpart of `ldt_tpu/parallel/sp.py`.

The Compressor's decode is up to 2048 independent queries cross-attending
to <= 32 latent tokens, so under a mesh with a `model` axis the decoded set
[B, N, D] is split over the model ranks along N: each rank runs the
decoder blocks (K2 on its N/m queries against the whole key set, the MLPs,
the output Dense) on its slice, and the set is all-gathered over `model`
where a consumer needs all of it (the posterior's keys in stage-1
training, the decoded clouds). The seed set is drawn whole and then
sliced, so the draws do not depend on m. The JAX package's constraint also
puts the batch on `data` (`sp_spec`); here the batch is already this
rank's rows (`mesh.shard_batch` in the trainers), so `sp_shard` splits the
point axis only. The decode's norms take no statistic over the point axis
(its batch norm reads running statistics), so nothing there is reduced.

Same registry discipline as `eval.metrics.set_eval_mesh`: the trainers
register their mesh at construction (`training.base.BaseTrainer`).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from ldt_torch.parallel import comm
from ldt_torch.parallel.tp import axis_group, axis_size

_SP_MESH = None


def set_sp_mesh(mesh) -> None:
    """Register (or clear, with None) the mesh decode activations shard
    over."""
    global _SP_MESH
    _SP_MESH = mesh


def sp_spec(shape, mesh) -> Optional[Tuple[Optional[str], ...]]:
    """The JAX package's spec of one [B, N, D] decoded-set activation:
    ("data" where d > 1 divides B, "model" where m > 1 divides N, None), or
    None when nothing splits."""
    spec = [None, None, None]
    d = axis_size(mesh, "data")
    if d > 1 and shape[0] % d == 0:
        spec[0] = "data"
    m = axis_size(mesh, "model")
    if m > 1 and shape[1] % m == 0:
        spec[1] = "model"
    if spec[0] is None and spec[1] is None:
        return None
    return tuple(spec)


def _model_split(x: torch.Tensor):
    mesh = _SP_MESH
    if mesh is None or x.dim() != 3:
        return None
    spec = sp_spec(x.shape, mesh)
    if spec is None or spec[1] != "model":
        return None
    return axis_group(mesh, "model")


def sp_shard(x: torch.Tensor) -> torch.Tensor:
    """This model rank's N/m points of a [B, N, D] decoded set under the
    registered mesh; `x` itself without one, for another rank, or where m
    does not divide N. A slice: its gradient needs no collective."""
    group = _model_split(x)
    if group is None:
        return x
    return comm.local_slice(x, group, 1)


def sp_gather(x: torch.Tensor, n: int) -> torch.Tensor:
    """The whole [B, n, D] set from the model ranks' slices (differentiable:
    `comm.gather`); `x` itself where `sp_shard` did not split a set of n
    points."""
    if x.dim() != 3 or x.shape[1] == n:
        return x
    group = _model_split(x.new_empty((x.shape[0], n, 1)))
    if group is None:
        return x
    return comm.gather(x, group, 1)
