"""Training losses and completion scores, counterpart of
`ldt_tpu/eval/loss.py` (the same names), on `ldt_torch.ops.chamfer` and
`ldt_torch.ops.emd`."""

from __future__ import annotations

import torch

from ldt_torch.ops.chamfer import chamfer_distance, chamfer_loss
from ldt_torch.ops.emd import emd_loss


def CD_loss(pred: torch.Tensor, target: torch.Tensor,
            kind: str = "l1") -> torch.Tensor:
    """Chamfer training loss."""
    return chamfer_loss(pred, target, kind)


def EMD_loss(pred: torch.Tensor, target: torch.Tensor, eps: float = 0.005,
             iters: int = 50) -> torch.Tensor:
    """Auction-EMD training loss."""
    return emd_loss(pred, target, eps, iters)


def L2_ChamferEval_1000(array1: torch.Tensor,
                        array2: torch.Tensor) -> torch.Tensor:
    """Mean bidirectional squared chamfer x 1000."""
    d1, d2, _, _ = chamfer_distance(array1, array2)
    return (torch.mean(d1) + torch.mean(d2)) * 1000.0


def fscore(dist1: torch.Tensor, dist2: torch.Tensor,
           threshold: float = 0.001):
    """(F-score [B], precision_1 [B], precision_2 [B]) from per-point
    squared distances [B, N] and [B, M]."""
    precision_1 = torch.mean((dist1 < threshold).float(), dim=1)
    precision_2 = torch.mean((dist2 < threshold).float(), dim=1)
    denom = precision_1 + precision_2
    f = torch.where(denom > 0, 2 * precision_1 * precision_2
                    / torch.clamp(denom, min=1e-12), 0.0)
    return f, precision_1, precision_2


def F1Score(array1: torch.Tensor, array2: torch.Tensor,
            threshold: float = 0.001):
    """Completion F-score of two clouds: `fscore` of their chamfer
    distances."""
    d1, d2, _, _ = chamfer_distance(array1, array2)
    return fscore(d1, d2, threshold)


def kl_softmax_loss(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """KL(softmax(x) || softmax(y)) over axis 1, x detached."""
    px = torch.softmax(x.detach(), dim=1)
    log_py = torch.log_softmax(y, dim=1)
    return torch.mean(torch.sum(px * (torch.log(px) - log_py), dim=1))


def huber_loss(error: torch.Tensor, delta: float) -> torch.Tensor:
    """mean(0.5 min(|e|, delta)^2 + delta (|e| - min(|e|, delta)))."""
    abs_error = torch.abs(error)
    quadratic = torch.clamp(abs_error, max=delta)
    return torch.mean(0.5 * quadratic ** 2 + delta * (abs_error - quadratic))
