"""Chamfer distance, counterpart of `ldt_tpu/ops/chamfer.py`'s XLA path
(`chamfer_distance`, `chamfer_loss`, `chamfer_metric`), plain PyTorch.

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
"""

from __future__ import annotations

import torch

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
