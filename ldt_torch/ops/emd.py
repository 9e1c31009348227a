"""Earth Mover's Distance, counterpart of `ldt_tpu/ops/emd.py`: the auction
EMD, the stage-1 training loss (`auction_emd`, `emd_loss`; plain PyTorch:
the JAX package runs it in XLA), and the approx-match EMD, the evaluation
metric (`approx_match_cost`, `emd_approx`), with K6/K7 as a CUDA kernel.

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

K6/K7 `approx_match_cost(x1, x2, otf=False)` — the annealed approx-match
transport cost sum(match * |x1 - x2|) of each pair, 9 levels
L = -4^7 ... -4^-1 (the reference's `match_cost`).
  * Replaces `ldt_tpu/ops/emd.py::_approx_match_cost_kernel` (K6, with
    `_emd_pair_step`: the squared distances d [P, N, M] computed first and
    streamed) and `_approx_match_cost_otf_kernel` (K7, `otf=True`: each d_ij
    built from the two clouds inside the kernel). The JAX package's
    `LDT_EMD_PALLAS_OTF` is the `otf` argument, off by default as there.
  * Bound on an H100: the 9 N M exponentials on the special-function units
    (16 per SM per clock), ~9 us a pair at 2048 points; then the f32 FMAs,
    and K6's one read of d (16.8 MB a pair).
  * Design (`csrc/eval.cu`): two schedules, picked in the library (mirrored
    by `_eval_kernels.emd_schedule(p, n, m, otf, sms)`). "cluster"
    (M <= 2048, the eval's path): a pair's rows over 16 warps in a
    thread-block cluster of `emd_cluster(p, sms)` blocks (2 at the eval's
    64-pair tile: 128 of an H100's 132 SMs); two sweeps a level, the second
    fused with the next level's first (A(0), eight fused sweeps, B(8): 10
    reads of d and 18 exponentials per element), each row's w held in its
    warp's registers; the column sums
    and the cost reduced in a fixed balanced tree over the 16 warps, the
    same for every cluster size, so a pair's cost does not depend on its
    tile. "block" (M > 2048): the first version, one block per pair, three
    passes a level. K6 takes d from `ops.geometry.square_distance`; K7
    computes it with the same roundings, so the two return the same bits
    in either schedule. Every sum runs in a fixed order (a run repeats
    itself bit for bit). On a CPU tensor the wrapper takes the plain
    twin `approx_match_cost_plain` (the batched `_approx_match_cost_single`:
    multi_l = max(1, M // N), multi_r = max(1, N // M),
    dist = sqrt(max(d, 1e-20))); on a CUDA tensor it launches the kernel or
    raises. `approx_match_cost.launches` counts both modes,
    `.otf_launches` the K7 ones, `.cluster_launches` those of the cluster
    schedule.
The twin takes the JAX form's matrix-vector products with `torch.matmul`:
on a card they are full f32 only under torch's default matmul precision
("highest", `torch.backends.cuda.matmul.allow_tf32` False), which
`chip_smoke.py` sets; TF32 would round d's weights to ~3 digits.
`approx_match_plain` is the matrix form (`_approx_match_single`): the match
itself.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from ldt_torch.ops import _eval_kernels
from ldt_torch.ops.attention import true_divide
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


# The annealing levels -4^j, j = 7 ... -1 (exact in f32).
LEVELS = tuple(-(4.0 ** j) for j in range(7, -2, -1))


def _approx_match_setup(x1: torch.Tensor, x2: torch.Tensor,
                        d: Optional[torch.Tensor]):
    """(d clamped at 0, remain_l, remain_r) of a batch of pairs, f32."""
    if d is None:
        d = square_distance(x1.float(), x2.float())
    d = torch.clamp(d.float(), min=0.0)
    p, n, m = d.shape
    remain_l = torch.full((p, n), float(max(1, m // n)), device=d.device)
    remain_r = torch.full((p, m), float(max(1, n // m)), device=d.device)
    return d, remain_l, remain_r


def _mv(a: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Batched a [P, N, M] @ v [P, M] -> [P, N]."""
    return torch.matmul(a, v[:, :, None])[:, :, 0]


def _vm(v: torch.Tensor, a: torch.Tensor) -> torch.Tensor:
    """Batched v [P, N] @ a [P, N, M] -> [P, M]."""
    return torch.matmul(v[:, None, :], a)[:, 0, :]


def _level(d, level, remain_l, remain_r):
    """One level's w [P, N, M], ratio_l [P, N], sumr and ratio_r [P, M]."""
    w = torch.exp(level * d)
    ratio_l = remain_l / (1e-9 + _mv(w, remain_r))
    sumr = _vm(ratio_l, w) * remain_r
    ratio_r = torch.clamp(remain_r / (sumr + 1e-9), max=1.0) * remain_r
    return w, ratio_l, sumr, ratio_r


@torch.no_grad()
def approx_match_cost_plain(x1: torch.Tensor, x2: torch.Tensor,
                            d: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain twin of K6/K7: [P] transport costs of x1 [P, N, 3] against
    x2 [P, M, 3], from their squared distances `d` [P, N, M] when given
    (else the direct-form `square_distance`)."""
    d, remain_l, remain_r = _approx_match_setup(x1, x2, d)
    dist = torch.sqrt(torch.clamp(d, min=1e-20))
    cost = torch.zeros(d.shape[0], device=d.device)
    for level in LEVELS:
        w, ratio_l, sumr, ratio_r = _level(d, level, remain_l, remain_r)
        cost = cost + (ratio_l[:, None, :]
                       @ _mv(w * dist, ratio_r)[:, :, None])[:, 0, 0]
        remain_l = torch.clamp(remain_l - ratio_l * _mv(w, ratio_r), min=0.0)
        remain_r = torch.clamp(remain_r - sumr, min=0.0)
    return cost


@torch.no_grad()
def approx_match_plain(x1: torch.Tensor, x2: torch.Tensor) -> torch.Tensor:
    """The matrix form: the soft match [P, N, M] of x1 [P, N, 3] against
    x2 [P, M, 3] (`ldt_tpu/ops/emd.py::_approx_match_single`, batched)."""
    d, remain_l, remain_r = _approx_match_setup(x1, x2, None)
    match = torch.zeros_like(d)
    for level in LEVELS:
        w, ratio_l, sumr, ratio_r = _level(d, level, remain_l, remain_r)
        delta = w * ratio_l[:, :, None] * ratio_r[:, None, :]
        match = match + delta
        remain_l = torch.clamp(remain_l - delta.sum(dim=2), min=0.0)
        remain_r = torch.clamp(remain_r - sumr, min=0.0)
    return match


def approx_match_cost(x1: torch.Tensor, x2: torch.Tensor,
                      otf: bool = False) -> torch.Tensor:
    """K6 (or K7 with `otf`): [P] float32 transport costs
    sum(match * |x1 - x2|) of x1 [P, N, 3] against x2 [P, M, 3] (divide by
    N for the reference's `emd_approx_cuda`); forward only."""
    name = "approx_match_cost"
    x1, x2 = _eval_kernels.pairs(
        name, x1, x2,
        lambda n, m: _eval_kernels.emd_smem_bytes(n, m, otf))
    if x1.device.type == "cpu":
        return approx_match_cost_plain(x1, x2)
    p, n, _ = x1.shape
    m = x2.shape[1]
    # K6 streams the distances of `square_distance` (clamped at 0, a no-op
    # in the direct form); K7 builds them itself
    d = None if otf else torch.clamp(square_distance(x1, x2), min=0.0)
    out = torch.empty(p, dtype=torch.float32, device=x1.device)
    cluster = ctypes.c_int(0)
    with torch.cuda.device(x1.device):
        err = _eval_kernels.lib().ldt_approx_match_cost(
            x1.data_ptr(), x2.data_ptr(), None if d is None else d.data_ptr(),
            out.data_ptr(), p, n, m, int(otf), _eval_kernels.stream(x1),
            ctypes.byref(cluster))
    _eval_kernels.raise_on(err, name)
    approx_match_cost.launches += 1
    if otf:
        approx_match_cost.otf_launches += 1
    if cluster.value:
        approx_match_cost.cluster_launches += 1
    return out


approx_match_cost.launches = 0
# the launches (counted in `launches` too) that took K7, the on-the-fly d,
# and those that took the cluster schedule (as the library reports it)
approx_match_cost.otf_launches = 0
approx_match_cost.cluster_launches = 0


def emd_approx(sample: torch.Tensor, ref: torch.Tensor) -> torch.Tensor:
    """`emd_approx_cuda`: [B] transport costs / N of equal-size clouds."""
    n = sample.shape[1]
    if n != ref.shape[1]:
        raise ValueError("EMD requires equal-size clouds")
    return true_divide(approx_match_cost(sample, ref), float(n))
