"""Point-cloud geometry of the Compressor's grouping, counterpart of
`ldt_tpu/ops/geometry.py` (plain PyTorch: the JAX package has no Pallas
kernel here).

Clouds are [B, N, C], channels last. Distances are taken in the direct form
sum_c (a_c - b_c)^2, one channel at a time, so that each element is the
same IEEE sum on every device: the JAX package's expanded form
|a|^2 + |b|^2 - 2 a.b runs a product whose rounding depends on the device,
and a distance that rounds differently can change a nearest neighbour. The
two forms agree to rounding (tests/test_torch_port_geometry.py); the
neighbour sets agree as sets.
"""

from __future__ import annotations

from typing import Tuple

import torch


def sum_square_diff(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """sum_c (a_c - b_c)^2 over the last axis (a and b broadcast against
    each other), one coordinate at a time."""
    out = None
    for c in range(a.shape[-1]):
        diff = a[..., c] - b[..., c]
        sq = diff * diff
        out = sq if out is None else out + sq
    return out


def square_distance(src: torch.Tensor, dst: torch.Tensor) -> torch.Tensor:
    """[B, N, C], [B, M, C] -> [B, N, M] squared euclidean distances."""
    return sum_square_diff(src[:, :, None, :], dst[:, None, :, :])


def index_points(points: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Batched gather: [B, N, C] at idx [B, S] or [B, S, K] ->
    [B, S, C] or [B, S, K, C]."""
    if idx.dim() not in (2, 3):
        raise ValueError(f"idx must be rank 2 or 3, got {tuple(idx.shape)}")
    b = points.shape[0]
    flat = idx.reshape(b, -1)
    out = torch.gather(points, 1,
                       flat[..., None].expand(-1, -1, points.shape[-1]))
    return out.reshape(*idx.shape, points.shape[-1])


def knn_point(nsample: int, xyz: torch.Tensor,
              new_xyz: torch.Tensor) -> torch.Tensor:
    """[B, S, nsample] indices of the nearest points of `xyz` [B, N, C] to
    each query of `new_xyz` [B, S, C], nearest first. Which of two equally
    distant points comes first may differ from `lax.top_k`'s order; the
    grouping that uses them is symmetric in the order."""
    dist = square_distance(new_xyz, xyz)
    return torch.topk(dist, nsample, dim=-1, largest=False, sorted=True)[1]


def furthest_point_sample(xyz: torch.Tensor, n_samples: int) -> torch.Tensor:
    """[B, n_samples] furthest-point-sampling indices, from index 0 (as the
    reference CUDA kernel): each step takes the point furthest from those
    taken, the first such index on ties (`torch.argmax`, as `jnp.argmax`)."""
    b, n, _ = xyz.shape
    idx = torch.zeros((b, n_samples), dtype=torch.long, device=xyz.device)
    min_d = torch.full((b, n), torch.finfo(xyz.dtype).max, dtype=xyz.dtype,
                       device=xyz.device)
    last = idx[:, 0]
    rows = torch.arange(b, device=xyz.device)
    for i in range(1, n_samples):
        d = square_distance(xyz, xyz[rows, last][:, None, :])[..., 0]
        min_d = torch.minimum(min_d, d)
        last = torch.argmax(min_d, dim=-1)
        idx[:, i] = last
    return idx


def cluster(xyz: torch.Tensor, n_groups: int, k: int
            ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """FPS centers + kNN groups: (new_xyz [B, S, 3], center_idx [B, S],
    group_idx [B, S, k])."""
    center_idx = furthest_point_sample(xyz.detach(), n_groups)
    new_xyz = index_points(xyz, center_idx)
    return new_xyz, center_idx, knn_point(k, xyz, new_xyz)
