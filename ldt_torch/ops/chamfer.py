"""Chamfer distance, counterpart of `ldt_tpu/ops/chamfer.py`: its XLA path
(`chamfer_distance`, `chamfer_loss`, `chamfer_metric`) in plain PyTorch, and
K5, the eval tiles' per-pair chamfer means, as a CUDA kernel.

For clouds x [B, N, 3] and y [B, M, 3]:
  dist1[b, n] = min_m |x[b, n] - y[b, m]|^2,   idx1[b, n] = argmin_m
  dist2[b, m] = min_n |x[b, n] - y[b, m]|^2,   idx2[b, m] = argmin_n
Distances are IEEE f32, taken one coordinate at a time (`ops.geometry`):
no matrix product, so no TF32 and no `torch.cdist` (which takes an
expanded-form product above 25 points). They agree with the JAX package's
expanded form |x|^2 + |y|^2 - 2 x.y to its rounding, and are clamped at 0
as it clamps them (a no-op in the direct form). The argmin is the first
index on ties, as `jnp.argmin`.

Gradient: the distances are recomputed at the argmin with autograd (the
same bits as the minimum: `sum_square_diff` takes the coordinates in
`square_distance`'s order), which gives 2 (x - y[idx1]) to x (and its
negative to y[idx1]), the gradient JAX takes through the min of its
expanded form. At an exact tie `jnp.min` splits the gradient between the
tied entries; here all of it goes to the first
(tests/test_torch_port_losses.py pins this).

K5 `pairwise_cd_means(x, y)` — mean_n dist1 + mean_m dist2 of each pair, the
only number the eval tiles take from a pair (`eval.metrics._pair_block`).
  * Replaces `ldt_tpu/ops/chamfer.py::_pairwise_cd_kernel`
    (`pairwise_cd_means_pallas`).
  * Bound on an H100: instruction issue, 8 N M per pair at 128 lanes per
    SM per clock: the least work within the card limit (`chip_smoke.K5_TOL`)
    takes each d_ij in the direct form with its adds fused (three
    differences, a square, two FMAs) and a row and a column minimum; its
    bytes are the two clouds. The kernels issue more (no FMA, so that the
    minima keep this module's bits): ~10.5 N M on the split schedule.
  * Design (`csrc/eval.cu`): two schedules, picked in the library by
    `csrc/rules.h`, which `_eval_kernels.cd_schedule` asks. "split" (N, M
    <= 2048, M % 4 == 0, y 16-byte aligned: the eval's path) spreads a
    pair's rows over a thread-block cluster of 2, 4 or 8 blocks, chosen from
    the pair count and the card's SM count, takes each d_ij once for both
    its row's and its column's minimum, merges the column minima across the
    cluster (a minimum is exact in any order) and sums both sets in a fixed
    order that depends on N and M alone, so a pair's bits do not depend on
    its tile. "block"
    (the rest; the first version) runs one block per pair, rows then
    columns. Each d_ij is the direct form with the products and sums
    rounded one at a time as here, so every minimum has the CPU's bits; a
    run repeats itself bit for bit. Its plain twin `pairwise_cd_means_plain`
    is the means of `chamfer_distance`. On a CPU tensor the wrapper takes the
    twin; on a CUDA tensor it launches the kernel or raises; it counts its
    launches in `pairwise_cd_means.launches`, those on the split schedule
    in `.split_launches` too.
"""

from __future__ import annotations

import ctypes

import torch

from ldt_torch.ops import _build, _eval_kernels
from ldt_torch.ops.geometry import (
    index_points,
    square_distance,
    sum_square_diff,
)


def chamfer_distance(x: torch.Tensor, y: torch.Tensor):
    """(dist1 [B, N], dist2 [B, M], idx1 [B, N], idx2 [B, M]) of x [B, N, 3]
    against y [B, M, 3], in f32; the indices are int64."""
    x, y = x.float(), y.float()
    with torch.no_grad():
        d = square_distance(x, y)                    # [B, N, M]
        idx1 = torch.argmin(d, dim=2)
        idx2 = torch.argmin(d, dim=1)
    d1 = torch.clamp(sum_square_diff(x, index_points(y, idx1)), min=0.0)
    d2 = torch.clamp(sum_square_diff(y, index_points(x, idx2)), min=0.0)
    return d1, d2, idx1, idx2


def chamfer_loss(pred: torch.Tensor, target: torch.Tensor,
                 kind: str = "l1") -> torch.Tensor:
    """`CD_loss`: 'l1' mean(sqrt(max(d1, 1e-12))) + the same of d2; else
    mean(d1) + mean(d2)."""
    d1, d2, _, _ = chamfer_distance(pred, target)
    if kind == "l1":
        return (torch.mean(torch.sqrt(torch.clamp(d1, min=1e-12)))
                + torch.mean(torch.sqrt(torch.clamp(d2, min=1e-12))))
    return torch.mean(d1) + torch.mean(d2)


def chamfer_metric(x: torch.Tensor, y: torch.Tensor):
    """(dist1, dist2) only."""
    d1, d2, _, _ = chamfer_distance(x, y)
    return d1, d2


def pairwise_cd_means_plain(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Plain twin of K5: [P] mean(dist1) + mean(dist2) of x [P, N, 3]
    against y [P, M, 3], from `chamfer_distance`."""
    with torch.no_grad():
        d1, d2, _, _ = chamfer_distance(x, y)
    return d1.mean(dim=1) + d2.mean(dim=1)


def pairwise_cd_means(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """K5: [P] float32 chamfer means (squared distances) of the pairs
    x [P, N, 3], y [P, M, 3]; forward only."""
    name = "pairwise_cd_means"
    x, y = _eval_kernels.pairs(name, x, y, _eval_kernels.cd_smem_bytes)
    if x.device.type == "cpu":
        _build.count_shape(_build.PLAIN_SHAPES, name, x)
        return pairwise_cd_means_plain(x, y)
    p, n, _ = x.shape
    out = torch.empty(p, dtype=torch.float32, device=x.device)
    cluster = ctypes.c_int(0)
    with torch.cuda.device(x.device):
        err = _eval_kernels.lib().ldt_pairwise_cd_means(
            x.data_ptr(), y.data_ptr(), out.data_ptr(), p, n, y.shape[1],
            _eval_kernels.stream(x), ctypes.byref(cluster))
    _eval_kernels.raise_on(err, name)
    pairwise_cd_means.launches += 1
    _build.count_shape(_build.SHAPES, name, x)
    pairwise_cd_means.split_launches += int(cluster.value > 0)
    return out


pairwise_cd_means.launches = 0
# the launches (counted in `launches` too) that took the split schedule, as
# the library reports what it launched
pairwise_cd_means.split_launches = 0
