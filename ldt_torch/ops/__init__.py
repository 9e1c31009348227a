"""Hand-written CUDA kernels of the port and their plain PyTorch twins, and
the geometry and transport primitives: the names `ldt_tpu/ops/__init__.py`
exports, each the counterpart of the JAX package's."""

from ldt_torch.ops.chamfer import (
    chamfer_distance,
    chamfer_loss,
    chamfer_metric,
)
from ldt_torch.ops.emd import (
    approx_match_cost,
    auction_emd,
    emd_approx,
    emd_loss,
)
from ldt_torch.ops.geometry import (
    avg_voxelize,
    ball_query,
    cluster,
    furthest_point_sample,
    gather,
    grouping,
    index_points,
    knn_point,
    nearest_neighbor_interpolate,
    normalize_point_clouds,
    square_distance,
    trilinear_devoxelize,
)
from ldt_torch.ops.masks import (
    MaskedBatchNorm,
    check,
    get_mask,
    get_pairwise_distance,
    masked_fill,
    sample_mask,
)

__all__ = [
    "MaskedBatchNorm",
    "avg_voxelize",
    "check",
    "get_mask",
    "get_pairwise_distance",
    "masked_fill",
    "sample_mask",
    "approx_match_cost",
    "auction_emd",
    "ball_query",
    "chamfer_distance",
    "chamfer_loss",
    "chamfer_metric",
    "cluster",
    "emd_approx",
    "emd_loss",
    "furthest_point_sample",
    "gather",
    "grouping",
    "index_points",
    "knn_point",
    "nearest_neighbor_interpolate",
    "normalize_point_clouds",
    "square_distance",
    "trilinear_devoxelize",
]
