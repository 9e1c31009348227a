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
prediction only, as the reference CUDA backward.

The compact schedule (`auction_emd(..., compact=True)`; the JAX package
reads it from `LDT_EMD_COMPACT` and `LDT_EMD_ENTER`, the port takes
arguments): a pair runs dense rounds while more than `enter` of its rows
are unassigned, then rounds over its first `tile` unassigned rows (a
cumulative-sum compaction, no sort), and stops once its assignment is a
bijection, never past `iters` rounds. Each phase gives the dense round's
owners and prices exactly (assigned rows never bid; once at most `tile`
rows are unassigned the count cannot grow), so the assignment is the dense
one. Off by default, as in the JAX package.

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

from ldt_torch.ops import _build, _eval_kernels
from ldt_torch.ops.attention import true_divide
from ldt_torch.ops.geometry import (
    index_points,
    square_distance,
    sum_square_diff,
)


# The compact schedule's row block and the unassigned count below which it
# starts (`ldt_tpu/ops/emd.py::_COMPACT_TILE`, `_COMPACT_ENTER`).
COMPACT_TILE = 256
COMPACT_ENTER = 256


def _bid_round(neg_d_rows: torch.Tensor, row_ids: torch.Tensor,
               bidding: torch.Tensor, owner: torch.Tensor,
               price: torch.Tensor, eps: float):
    """One Jacobi round of the rows `row_ids` [b, R] (ascending global row
    ids), whose negated distances are `neg_d_rows` [b, R, N]: each row with
    `bidding` bids for its best column; each column goes to its highest bid,
    the lowest row winning a tie. Returns the new (owner, price)."""
    n = owner.shape[1]
    neg_inf = torch.finfo(neg_d_rows.dtype).min
    value = neg_d_rows - price[:, None, :]
    best_j = torch.argmax(value, dim=2)
    best_v = torch.gather(value, 2, best_j[..., None])
    second_v = value.scatter_(2, best_j[..., None], neg_inf).amax(dim=2)
    incr = best_v[..., 0] - second_v + eps
    bid = torch.where(bidding, incr, neg_inf)
    col_max = torch.full_like(price, neg_inf)
    col_max.scatter_reduce_(1, best_j, bid, "amax")
    won = bid == torch.gather(col_max, 1, best_j)
    col_winner = torch.full_like(owner, n)
    col_winner.scatter_reduce_(1, best_j, torch.where(won, row_ids, n),
                               "amin")
    has_bid = col_max > neg_inf
    return (torch.where(has_bid, col_winner, owner),
            torch.where(has_bid, price + col_max, price))


def _row_assigned(owner: torch.Tensor) -> torch.Tensor:
    """[b, N] whether each row owns a column."""
    b, n = owner.shape
    assigned = torch.zeros((b, n + 1), dtype=torch.bool, device=owner.device)
    assigned.scatter_(1, torch.where(owner >= 0, owner, n), True)
    return assigned[:, :n]


def _compact_rows(unassigned: torch.Tensor, tile: int):
    """(row ids [b, tile] of the first `tile` unassigned rows, ascending,
    padded with N - 1; which of them are real [b, tile]): a cumulative-sum
    compaction, no sort."""
    b, n = unassigned.shape
    rank = torch.cumsum(unassigned.to(torch.int64), dim=1) - 1
    dest = torch.where(unassigned & (rank < tile), rank, tile)
    slots = torch.full((b, tile + 1), n, dtype=torch.long,
                       device=unassigned.device)
    slots.scatter_reduce_(1, dest, torch.arange(n, device=dest.device)
                          .expand(b, n), "amin")
    idx = slots[:, :tile]
    return torch.clamp(idx, max=n - 1), idx < n


def _auction(d: torch.Tensor, eps: float, iters: int, compact: bool = False,
             tile: int = COMPACT_TILE,
             enter: int = COMPACT_ENTER) -> torch.Tensor:
    """[B, N] column of each row from the distances d [B, N, N]: `iters`
    dense rounds, or with `compact` the same rounds scheduled as the JAX
    package's `_auction_single(compact=True)` (see `auction_emd`)."""
    b, n, _ = d.shape
    dev = d.device
    index = torch.arange(n, device=dev).expand(b, n)
    owner = torch.full((b, n), -1, dtype=torch.long, device=dev)
    price = torch.zeros((b, n), dtype=d.dtype, device=dev)
    neg_d = -d  # -(d + price) == -d - price in IEEE arithmetic: one pass
    if not compact:
        for _ in range(iters):
            owner, price = _bid_round(neg_d, index, ~_row_assigned(owner),
                                      owner, price, eps)
    else:
        enter = min(enter, tile)
        rounds = torch.zeros(b, dtype=torch.long, device=dev)
        while True:
            unassigned = ~_row_assigned(owner)
            left = unassigned.sum(dim=1)
            active = (rounds < iters) & (left > 0)
            if not bool(active.any()):
                break
            # a pair stays dense while more than `enter` rows are
            # unassigned (the count never grows), then bids over its first
            # `tile` unassigned rows only
            for sel, dense in ((active & (left > enter), True),
                               (active & (left <= enter), False)):
                pairs = torch.nonzero(sel)[:, 0]
                if pairs.numel() == 0:
                    continue
                if dense:
                    rows, bidding = index[pairs], unassigned[pairs]
                    rows_d = neg_d[pairs]
                else:
                    rows, bidding = _compact_rows(unassigned[pairs], tile)
                    rows_d = torch.gather(
                        neg_d[pairs], 1, rows[..., None].expand(-1, -1, n))
                o, p = _bid_round(rows_d, rows, bidding, owner[pairs],
                                  price[pairs], eps)
                owner[pairs], price[pairs] = o, p
            rounds += active.long()
    assignment = torch.full((b, n), -1, dtype=torch.long, device=dev)
    assignment.scatter_reduce_(1, owner.clamp(min=0),
                               torch.where(owner >= 0, index, -1), "amax")
    nearest = torch.argmin(d, dim=2)
    return torch.where(assignment >= 0, assignment, nearest)


def auction_emd(x: torch.Tensor, y: torch.Tensor, eps: float = 0.005,
                iters: int = 50, compact: bool = False,
                enter: int = COMPACT_ENTER, tile: int = COMPACT_TILE):
    """(dist [B, N] squared distances to the assigned target points,
    assignment [B, N] int64) of predictions x [B, N, 3] against targets
    y [B, N, 3]; the gradient flows to x only. `compact` takes the
    two-phase schedule (the JAX package's `LDT_EMD_COMPACT=1`, with
    `enter` its `LDT_EMD_ENTER`, clamped to `tile`): the same assignment as
    the dense rounds."""
    x = x.float()
    y = y.float().detach()
    with torch.no_grad():
        d = torch.clamp(square_distance(x, y), min=0.0)
        assignment = _auction(d, eps, iters, compact, tile, enter)
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
        _build.count_shape(_build.PLAIN_SHAPES, name, x1)
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
    _build.count_shape(_build.SHAPES, name, x1)
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
