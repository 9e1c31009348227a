"""Set masks and the masked batch norm, counterpart of
`ldt_tpu/ops/masks.py` (the reference's model/Compressor/ops.py; plain
PyTorch: no kernel).

Variable-cardinality sets: random presence masks (`sample_mask`), prefix
masks (`get_mask`), masked fills, the NaN/Inf `check`, pairwise distances
and a batch norm that leaves padded slots out of its statistics. A mask is
[B, N] bool, True where the slot is padding. The shipped configs decode
full sets (2048 of 2048); the API is the reference's.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
from torch import nn


def sample_mask(sample_sizes: Tuple[int, int], max_size: int,
                generator: Optional[torch.Generator] = None,
                permutations: Optional[Sequence] = None,
                device=None) -> torch.Tensor:
    """Random padding mask [B, max_size]: each row keeps `n_present` random
    slots (False) of `max_size`, `sample_sizes` = (B, n_present). A slot is
    kept where its entry of the row's permutation of range(max_size) is
    below n_present, as the JAX package's `permutation(k, max_size) < n`.
    The permutations come from `generator` (`torch.randperm`) or are pinned
    by `permutations` [B, max_size] (another framework's draws)."""
    b, n = sample_sizes
    if permutations is None:
        perms = torch.stack([torch.randperm(max_size, generator=generator,
                                            device=device)
                             for _ in range(b)])
    else:
        perms = torch.as_tensor(permutations, device=device)
        if tuple(perms.shape) != (b, max_size):
            raise ValueError(f"permutations {tuple(perms.shape)} for a mask "
                             f"of {(b, max_size)}")
    return ~(perms < n)


def get_mask(sizes: Tuple[int, int], max_size: int,
             device=None) -> torch.Tensor:
    """Prefix padding mask [B, max_size]: slots n.. are padding."""
    b, n = sizes
    return (torch.arange(max_size, device=device) >= n).expand(b, max_size)


def masked_fill(tensor_bnc: torch.Tensor,
                mask_bn: Optional[torch.Tensor] = None,
                value: float = 0.0) -> torch.Tensor:
    """`value` at the padded slots of [B, N, C]; the tensor as it is without
    a mask."""
    if mask_bn is None:
        return tensor_bnc
    return torch.where(mask_bn[..., None],
                       torch.tensor(value, dtype=tensor_bnc.dtype,
                                    device=tensor_bnc.device), tensor_bnc)


def check(x: torch.Tensor) -> None:
    """Assert that `x` holds no inf and no NaN (on the host)."""
    x = torch.as_tensor(x).detach()
    isinf = bool(torch.isinf(x).any())
    isnan = bool(torch.isnan(x).any())
    assert not (isinf or isnan), (
        f"Tensor of shape [{tuple(x.shape)}] is isinf:{isinf} or "
        f"isnan:{isnan}")


def get_pairwise_distance(x: torch.Tensor, p: int = 2) -> torch.Tensor:
    """[N, D] -> [N, N] pairwise p-norm distances (the difference form)."""
    diff = x[:, None, :] - x[None, :, :]
    if p == 2:
        return torch.sqrt(torch.clamp(torch.sum(diff * diff, -1), min=0.0))
    return torch.sum(torch.abs(diff) ** p, -1) ** (1.0 / p)


class MaskedBatchNorm(nn.Module):
    """Batch norm over [B, N, C] sets that leaves the padded slots
    (`mask_bn` True) out of its statistics, as the JAX module: momentum
    0.9, epsilon 1e-5, f32.

    `forward(x, mask, train=True)` normalizes with the batch's statistics
    over (B, N): without a mask the mean and the biased variance
    mean((x - mean)^2); with one, sums over the kept slots divided by
    max(count, 1). It leaves the updated running statistics
    0.9 * running + 0.1 * batch (detached) in `self.update` ({"mean",
    "var"}), as flax's mutable `batch_stats`; the buffers do not change.
    Otherwise it takes the running statistics. The padded slots of the
    output are 0. Parameters and buffers carry the flax names: `scale`,
    `bias`, `mean`, `var` (`ldt_torch.weights.masked_batch_norm_state_dict`
    converts).
    """

    def __init__(self, features: int, momentum: float = 0.9,
                 epsilon: float = 1e-5, use_scale: bool = True,
                 use_bias: bool = True, *, device=None):
        super().__init__()
        kw = dict(dtype=torch.float32, device=device)
        self.momentum = momentum
        self.epsilon = epsilon
        if use_scale:
            self.scale = nn.Parameter(torch.ones(features, **kw))
        if use_bias:
            self.bias = nn.Parameter(torch.zeros(features, **kw))
        self.register_buffer("mean", torch.zeros(features, **kw))
        self.register_buffer("var", torch.ones(features, **kw))
        self.update = None

    def forward(self, x: torch.Tensor, mask_bn: Optional[torch.Tensor] = None,
                train: bool = False) -> torch.Tensor:
        if train:
            if mask_bn is None:
                mean = x.mean(dim=(0, 1))
                var = torch.square(x - mean).mean(dim=(0, 1))
            else:
                keep = (~mask_bn)[..., None].to(x.dtype)
                count = torch.clamp(keep.sum(), min=1.0)
                mean = torch.sum(x * keep, dim=(0, 1)) / count
                var = torch.sum(keep * torch.square(x - mean),
                                dim=(0, 1)) / count
            m = self.momentum
            self.update = {"mean": (m * self.mean + (1 - m) * mean).detach(),
                           "var": (m * self.var + (1 - m) * var).detach()}
        else:
            mean, var = self.mean, self.var
        y = (x - mean) * torch.rsqrt(var + self.epsilon)
        if hasattr(self, "scale"):
            y = y * self.scale
        if hasattr(self, "bias"):
            y = y + self.bias
        return masked_fill(y, mask_bn)
