"""The collectives of the port's parallelism, and the autograd functions
built on them.

`torch.distributed` with an explicit group for each call: the `data` or
`model` group of a `DeviceMesh` (`tp.make_mesh`), or the whole world
(None). A failed collective raises; nothing here falls back.

Gradient semantics (every rank runs the same program on its share): each
rank back-propagates its own loss, unscaled, and the gradient of a tensor
that several ranks hold alike is split among them, its parts summing to m
times the true gradient (m the `model` size: every model rank seeds the
same loss). So:
  * `reduce_sum` (forward all_reduce) has an all_reduce backward: the sum
    depends on every rank's input (Megatron's row-parallel output, the
    global BatchNorm statistics);
  * `gather` (forward all_gather) has backward all_reduce-then-slice;
  * slicing a replicated tensor, and a column-parallel GEMM on a
    replicated input, need no collective (autograd's own backward);
  * after the backward, `sync_grads` sums each parameter's gradient over
    the ranks that hold it (the world for a replicated parameter, `data`
    for a tensor-parallel shard) and divides by the world size.
The result is the single-process gradient of the global batch's mean loss.

Gloo reduces CUDA tensors too (all_reduce, all_gather and broadcast:
chip_smoke.py's phase 28 tries each on the card), which lets ranks that
share one card run over gloo; NCCL refuses two ranks on one device.
"""

from __future__ import annotations

import contextlib
from typing import Dict, Iterable, Sequence

import torch
import torch.distributed as dist

def world_size(group=None) -> int:
    if not dist.is_available() or not dist.is_initialized():
        return 1
    return dist.get_world_size(group)


def rank(group=None) -> int:
    if not dist.is_available() or not dist.is_initialized():
        return 0
    return dist.get_rank(group)


def all_reduce(t: torch.Tensor, group=None, op: str = "sum"
               ) -> torch.Tensor:
    """The sum (or with `op` "max" the maximum) of `t` over `group`, in
    place (returned)."""
    if world_size(group) == 1:
        return t
    red = dist.ReduceOp.MAX if op == "max" else dist.ReduceOp.SUM
    dist.all_reduce(t, op=red, group=group)
    return t


def all_gather(t: torch.Tensor, group=None, dim: int = 0) -> torch.Tensor:
    """The ranks' `t` of `group` concatenated along `dim`, in rank order."""
    size = world_size(group)
    if size == 1:
        return t
    t = t.contiguous()
    parts = [torch.empty_like(t) for _ in range(size)]
    dist.all_gather(parts, t, group=group)
    return torch.cat(parts, dim=dim)


def broadcast(t: torch.Tensor, src: int = 0, group=None) -> torch.Tensor:
    """`t` of the group rank `src` on every rank of `group`, in place."""
    if world_size(group) == 1:
        return t
    src = dist.get_global_rank(group, src) if group is not None else src
    dist.broadcast(t, src, group=group)
    return t


def local_slice(t: torch.Tensor, group, dim: int) -> torch.Tensor:
    """This rank's contiguous 1/size of `t` along `dim` (a view)."""
    size = world_size(group)
    if size == 1:
        return t
    n = t.shape[dim]
    if n % size:
        raise ValueError(f"dimension {dim} of {tuple(t.shape)} does not "
                         f"split over {size} ranks")
    step = n // size
    return t.narrow(dim, rank(group) * step, step)


class _ReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return all_reduce(x.clone(), group)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g.clone(), ctx.group), None


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return all_gather(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        g = all_reduce(g.contiguous().clone(), ctx.group)
        return local_slice(g, ctx.group, ctx.dim).contiguous(), None, None


def reduce_sum(x: torch.Tensor, group) -> torch.Tensor:
    """all_reduce(x) over `group`, differentiable (backward all_reduce)."""
    if world_size(group) == 1:
        return x
    return _ReduceSum.apply(x, group)


def gather(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    """all_gather(x) along `dim` over `group`, differentiable (backward:
    all_reduce, then this rank's slice)."""
    if world_size(group) == 1:
        return x
    return _Gather.apply(x, group, dim)


def sync_grads(named_params: Dict[str, torch.Tensor], sharded: Iterable[str],
               mesh) -> None:
    """After a backward on every rank: sum each gradient over the ranks
    that hold its parameter (the world; `data` for the names in `sharded`,
    tensor-parallel shards) and divide by the world size, in place, one
    flat all_reduce per group. A parameter without a gradient gets zeros
    (a rank whose share never reached it still joins the sum)."""
    if mesh is None:
        return
    sharded = set(sharded)
    size = mesh.size()
    groups = {False: None, True: _data_group(mesh)}
    for is_sharded, group in groups.items():
        params = [p for k, p in named_params.items()
                  if (k in sharded) == is_sharded]
        if not params:
            continue
        for p in params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        flat = torch.cat([p.grad.reshape(-1).float() for p in params])
        all_reduce(flat, group)
        flat.div_(size)
        offset = 0
        for p in params:
            n = p.grad.numel()
            p.grad.copy_(flat[offset:offset + n].view_as(p.grad))
            offset += n


def _data_group(mesh):
    if "data" in (mesh.mesh_dim_names or ()):
        return mesh.get_group("data")
    return None


def global_norm(grads: Sequence[torch.Tensor], sharded: Sequence[bool],
                model_group) -> torch.Tensor:
    """The norm of the whole gradient when the `sharded` leaves are this
    rank's tensor-parallel shards: their squares summed over `model_group`,
    each replicated leaf counted once."""
    norms = torch.stack(torch._foreach_norm(list(grads)))
    sq = torch.square(norms)
    mask = torch.tensor(list(sharded), device=sq.device)
    part = torch.stack([sq[~mask].sum(), sq[mask].sum()])
    all_reduce(part[1:], model_group)
    return torch.sqrt(part.sum())


# The group train-mode BatchNorms reduce their statistics over (None: the
# rank's own batch); set by `batch_stats_over` for a data-parallel step.
_STATS_GROUP = [None]


@contextlib.contextmanager
def batch_stats_over(group):
    """Train-mode BatchNorms inside take the statistics of the batch
    spread over `group` (each rank holding an equal share)."""
    prev = _STATS_GROUP[0]
    _STATS_GROUP[0] = group if world_size(group) > 1 else None
    try:
        yield
    finally:
        _STATS_GROUP[0] = prev


def stats_group():
    return _STATS_GROUP[0]
