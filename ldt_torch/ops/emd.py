"""Auction EMD, the stage-1 training loss, counterpart of
`ldt_tpu/ops/emd.py::auction_emd` and `emd_loss` (plain PyTorch: the JAX
package runs it in XLA).

A fixed number of Jacobi auction rounds over the [N, N] squared distances of
each cloud pair, the JAX package's default dense schedule (`compact=False`):
each round, every unassigned row bids for its best column (value
-(d + price)) with the increment best - second + eps, the top two taken by
two max-reductions; each column goes to its highest bid, the lowest row
winning a tie (`torch.argmax`'s first index, as `jnp.argmax`), and its price
rises by that bid. After the rounds, rows that own no column fall back to
their nearest column. `neg_inf` is the most negative f32, not -inf, as in
the JAX code. The bids of a round are gathered per column with
`scatter_reduce` (an order-free max, then the lowest bidding row) instead
of JAX's [N, N] bid matrix: the same winners and prices.

Distances are IEEE f32 one coordinate at a time (`ops.geometry`): on clouds
whose distances are exact in f32 (a dyadic grid) the assignments equal the
JAX package's bit for bit, ties included. The gradient goes to the
prediction only, as the reference CUDA backward. The compact two-phase
schedule (`LDT_EMD_COMPACT`, the same results) is not ported.
"""

from __future__ import annotations

import torch

from ldt_torch.ops.geometry import (
    index_points,
    square_distance,
    sum_square_diff,
)


def _auction(d: torch.Tensor, eps: float, iters: int) -> torch.Tensor:
    """[B, N] column of each row from the distances d [B, N, N]."""
    b, n, _ = d.shape
    dev = d.device
    neg_inf = torch.finfo(d.dtype).min
    index = torch.arange(n, device=dev).expand(b, n)
    owner = torch.full((b, n), -1, dtype=torch.long, device=dev)
    price = torch.zeros((b, n), dtype=d.dtype, device=dev)
    neg_d = -d  # -(d + price) == -d - price in IEEE arithmetic: one pass
    for _ in range(iters):
        # rows that own a column (the unowned columns write to a dump slot)
        assigned = torch.zeros((b, n + 1), dtype=torch.bool, device=dev)
        assigned.scatter_(1, torch.where(owner >= 0, owner, n), True)
        value = neg_d - price[:, None, :]
        best_j = torch.argmax(value, dim=2)
        best_v = torch.gather(value, 2, best_j[..., None])
        second_v = value.scatter_(2, best_j[..., None], neg_inf).amax(dim=2)
        incr = best_v[..., 0] - second_v + eps
        bid = torch.where(assigned[:, :n], neg_inf, incr)
        col_max = torch.full((b, n), neg_inf, dtype=d.dtype, device=dev)
        col_max.scatter_reduce_(1, best_j, bid, "amax")
        won = bid == torch.gather(col_max, 1, best_j)
        col_winner = torch.full((b, n), n, dtype=torch.long, device=dev)
        col_winner.scatter_reduce_(1, best_j, torch.where(won, index, n),
                                   "amin")
        has_bid = col_max > neg_inf
        owner = torch.where(has_bid, col_winner, owner)
        price = torch.where(has_bid, price + col_max, price)
    assignment = torch.full((b, n), -1, dtype=torch.long, device=dev)
    assignment.scatter_reduce_(1, owner.clamp(min=0),
                               torch.where(owner >= 0, index, -1), "amax")
    nearest = torch.argmin(d, dim=2)
    return torch.where(assignment >= 0, assignment, nearest)


def auction_emd(x: torch.Tensor, y: torch.Tensor, eps: float = 0.005,
                iters: int = 50):
    """(dist [B, N] squared distances to the assigned target points,
    assignment [B, N] int64) of predictions x [B, N, 3] against targets
    y [B, N, 3]; the gradient flows to x only."""
    x = x.float()
    y = y.float().detach()
    with torch.no_grad():
        d = torch.clamp(square_distance(x, y), min=0.0)
        assignment = _auction(d, eps, iters)
    return sum_square_diff(x, index_points(y, assignment)), assignment


def emd_loss(pred: torch.Tensor, target: torch.Tensor, eps: float = 0.005,
             iters: int = 50) -> torch.Tensor:
    """`EMD_loss`: mean(sqrt(max(dist, 1e-12))) of the auction matching."""
    dist, _ = auction_emd(pred, target, eps, iters)
    return torch.mean(torch.sqrt(torch.clamp(dist, min=1e-12)))
