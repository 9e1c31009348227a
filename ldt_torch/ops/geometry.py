"""Point-cloud geometry, counterpart of `ldt_tpu/ops/geometry.py` (plain
PyTorch: the JAX package has no Pallas kernel here): the Compressor's
grouping (FPS, kNN, `index_points`) and the PVCNN primitives the reference
API carries (`ball_query`, `grouping`, `gather`,
`nearest_neighbor_interpolate`, `avg_voxelize`, `trilinear_devoxelize`,
`normalize_point_clouds` on tensors).

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


def ball_query(radius: float, nsample: int, xyz: torch.Tensor,
               new_xyz: torch.Tensor) -> torch.Tensor:
    """[B, S, nsample] indices of the first `nsample` points of `xyz`
    [B, N, C] within `radius` of each query of `new_xyz` [B, S, C], in
    index order; an empty slot takes the query's first pick, and a ball
    with no point in it gives index 0 (the reference CUDA's zeroed output),
    not N - 1. A compaction (each in-ball point's rank by a cumulative sum,
    its index scattered into its rank's slot by a minimum), no sort."""
    in_ball = square_distance(new_xyz, xyz) <= radius * radius  # [B, S, N]
    n = xyz.shape[1]
    rank = torch.cumsum(in_ball.to(torch.int64), dim=-1) - 1
    dest = torch.where(in_ball & (rank < nsample), rank, nsample)
    index = torch.arange(n, device=xyz.device).expand_as(dest)
    slots = torch.full(dest.shape[:2] + (nsample + 1,), n, dtype=torch.long,
                       device=xyz.device)
    slots.scatter_reduce_(-1, dest, index, "amin")
    group_idx = slots[..., :nsample]
    first = group_idx[..., :1]
    first = torch.where(first < n, first, 0)
    return torch.where(group_idx < n, group_idx, first)


def grouping(features: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Features [B, N, C] at neighbour indices [B, S, K] -> [B, S, K, C]
    (PVCNN's `grouping`, channels last)."""
    return index_points(features, idx)


def gather(features: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Features [B, N, C] at center indices [B, S] -> [B, S, C]."""
    return index_points(features, idx)


def nearest_neighbor_interpolate(points_coords: torch.Tensor,
                                 centers_coords: torch.Tensor,
                                 centers_features: torch.Tensor
                                 ) -> torch.Tensor:
    """[B, N, C] features of the points [B, N, 3] interpolated from their 3
    nearest centers [B, M, 3] (features [B, M, C]) with the weights
    1 / max(d^2, 1e-10), normalized to sum 1."""
    d2 = square_distance(points_coords, centers_coords)
    near, idx = torch.topk(d2, 3, dim=-1, largest=False, sorted=True)
    w = 1.0 / torch.clamp(near, min=1e-10)
    w = w / torch.sum(w, dim=-1, keepdim=True)
    return torch.sum(index_points(centers_features, idx) * w[..., None],
                     dim=2)


def avg_voxelize(features: torch.Tensor, coords: torch.Tensor,
                 resolution: int) -> torch.Tensor:
    """The mean of the point features [B, N, C] in each voxel of an r^3 grid
    at the integer voxel coordinates `coords` [B, N, 3] in [0, r):
    [B, r, r, r, C], 0 in an empty voxel (a scatter-add divided by
    max(count, 1))."""
    r = resolution
    b, _, c = features.shape
    coords = coords.long()
    flat = (coords[..., 0] * r + coords[..., 1]) * r + coords[..., 2]
    num = features.new_zeros((b, r * r * r, c))
    num.scatter_add_(1, flat[..., None].expand(-1, -1, c), features)
    cnt = features.new_zeros((b, r * r * r))
    cnt.scatter_add_(1, flat, torch.ones_like(flat, dtype=features.dtype))
    avg = num / torch.clamp(cnt[..., None], min=1.0)
    return avg.reshape(b, r, r, r, c)


def trilinear_devoxelize(grid: torch.Tensor,
                         coords: torch.Tensor) -> torch.Tensor:
    """A voxel grid [B, R, R, R, C] sampled trilinearly at the float
    coordinates `coords` [B, N, 3] in [0, R - 1]: [B, N, C], the 8 corners
    clipped to [0, R - 1]."""
    b, r = grid.shape[0], grid.shape[1]
    flat_grid = grid.reshape(b, r * r * r, -1)
    c0 = torch.floor(coords).long()
    frac = coords - c0.to(coords.dtype)
    out = 0.0
    for dx in (0, 1):
        for dy in (0, 1):
            for dz in (0, 1):
                corner = torch.clamp(
                    c0 + torch.tensor([dx, dy, dz], device=coords.device),
                    0, r - 1)
                w = ((frac[..., 0] if dx else 1 - frac[..., 0])
                     * (frac[..., 1] if dy else 1 - frac[..., 1])
                     * (frac[..., 2] if dz else 1 - frac[..., 2]))
                flat = (corner[..., 0] * r + corner[..., 1]) * r \
                    + corner[..., 2]
                out = out + index_points(flat_grid, flat) * w[..., None]
    return out


def normalize_point_clouds(pc: torch.Tensor) -> torch.Tensor:
    """Each cloud of [B, N, 3] centred and scaled to unit max radius, on the
    tensor's device (`tools.utils.normalize_point_clouds` is the numpy
    one)."""
    pc = pc - torch.mean(pc, dim=1, keepdim=True)
    furthest = torch.amax(torch.sqrt(torch.sum(pc ** 2, dim=-1,
                                               keepdim=True)),
                          dim=1, keepdim=True)
    return pc / furthest
