"""ctypes binding of `csrc/eval.cu` (K5 `ldt_pairwise_cd_means`, K6/K7
`ldt_approx_match_cost`), K5's schedule rule as the library decides it
(`cd_schedule`), the Python mirror of K6/K7's, the default route between
K6 and K7 (`emd_route`), and the checks the wrappers in `ops.chamfer` and
`ops.emd` share."""

from __future__ import annotations

import ctypes
import functools

import torch

from ldt_torch.ops import _build

# Most dynamic shared memory a block may use on sm_90 (bytes).
SMEM_LIMIT = 232448
# Warps per K5 and per K6/K7 block of the block schedule (kCdThreads / 32,
# kEmdWarps in csrc/eval.cu).
_CD_WARPS = 8
_EMD_WARPS = 16
# K6/K7's cluster schedule (csrc/eval.cu): row slots (warps) per pair
# (kEmdSlots) and the most float4 column groups a lane holds (kEmdMaxGroups:
# 128 columns each).
_EMD_SLOTS = 16
_EMD_MAX_GROUPS = 16


def cd_smem_bytes(n: int, m: int) -> int:
    """K5's shared memory: both clouds and one float per warp."""
    return 4 * (3 * n + 3 * m + _CD_WARPS)


def emd_smem_bytes(n: int, m: int, otf: bool) -> int:
    """K6's shared memory in the block schedule (the least of the two, so
    the one that decides what the kernel takes at all): the row state
    [2, n], the column state [3, m] and one float per warp; K7 holds both
    clouds beside them."""
    return 4 * (2 * n + 3 * m + _EMD_WARPS + (3 * n + 3 * m if otf else 0))


def emd_route(n: int, m: int) -> bool:
    """The `otf` that `ops.emd.approx_match_cost(otf=None)` takes on a card:
    True (K7, d built inside the kernel) where K7's shared memory fits, up
    to ~5,280 points a cloud; False (K6 behind the d build) past that, for
    the clouds that only K6 takes."""
    return emd_smem_bytes(n, m, True) <= SMEM_LIMIT


def emd_cluster(p: int, sms: int) -> int:
    """The cluster schedule's blocks per pair for a tile of p pairs on a card
    of `sms` SMs (132 on an H100 SXM): the largest of 8, 4, 2 with
    p * c <= sms, else 2. A block has 16 / c warps, so every pair has 16 row
    slots."""
    for c in (8, 4):
        if p * c <= sms:
            return c
    return 2


def emd_groups(m: int) -> int:
    """Float4 column groups a lane of the cluster schedule holds: 8 for
    M <= 1024, 16 for M <= 2048, 0 past 2048."""
    if m <= 1024:
        return 8
    return _EMD_MAX_GROUPS if m <= 128 * _EMD_MAX_GROUPS else 0


def emd_cluster_smem_bytes(n: int, m: int, otf: bool, c: int) -> int:
    """The cluster schedule's shared memory with cluster size c: the row
    state [2, n], the column state [2, MP] (MP = 128 groups), the 16 / c
    warps' partial rows and the block's two [MP + 4]; K7 holds both clouds
    beside them."""
    mp = 128 * emd_groups(m)
    n4 = -(-n // 4) * 4
    f = 2 * n4 + 2 * mp + (_EMD_SLOTS // c + 2) * (mp + 4)
    if otf:
        f += 3 * n4 + 3 * mp
    return 4 * f


def emd_schedule(p: int, n: int, m: int, otf: bool, sms: int):
    """(schedule, cluster size) of K6/K7 on a card of `sms` SMs
    (`emd_cluster_fits` in csrc/eval.cu, which decides and reports the
    cluster size it launched): ("cluster", c) where M <= 2048 and its shared
    memory fits, else ("block", 1), the first version's one block per pair.
    The tests and chip_smoke.py hold what the library reports to this."""
    c = emd_cluster(p, sms)
    if emd_groups(m) and emd_cluster_smem_bytes(n, m, otf, c) <= SMEM_LIMIT:
        return "cluster", c
    return "block", 1


@functools.lru_cache(maxsize=None)
def lib() -> ctypes.CDLL:
    out = _build.load("eval")
    p, i = ctypes.c_void_p, ctypes.c_int
    out.ldt_pairwise_cd_means.argtypes = [p, p, p, i, i, i, p,
                                          ctypes.POINTER(i)]
    out.ldt_pairwise_cd_means.restype = i
    out.ldt_cd_schedule.argtypes = [i] * 5
    out.ldt_cd_schedule.restype = i
    out.ldt_approx_match_cost.argtypes = [p, p, p, p, i, i, i, i, p,
                                          ctypes.POINTER(i)]
    out.ldt_approx_match_cost.restype = i
    out.ldt_eval_error_string.argtypes = [i]
    out.ldt_eval_error_string.restype = ctypes.c_char_p
    return out


def cd_schedule(p: int, n: int, m: int, sms: int,
                aligned: bool = True) -> int:
    """K5's schedule for p pairs of N x M points on a card of `sms` SMs, y
    16-byte aligned or not, asked of the library without a launch (its
    `cd_split` / `cd_cluster` in csrc/rules.h): the split schedule's cluster
    size, 0 for the block schedule. `pairwise_cd_means` reports the same
    for its launch."""
    return lib().ldt_cd_schedule(p, n, m, int(aligned), sms)


def raise_on(err: int, name: str) -> None:
    if err != 0:
        msg = lib().ldt_eval_error_string(err).decode()
        raise RuntimeError(f"{name}: kernel launch failed: CUDA error {err} "
                           f"({msg})")


def pairs(name: str, x: torch.Tensor, y: torch.Tensor, smem_bytes):
    """x [P, N, 3] and y [P, M, 3] as contiguous float32 (the kernels' and
    the JAX package's type); raises on shapes, devices or a shared-memory
    need (`smem_bytes(N, M)`) the kernel does not take."""
    if x.dim() != 3 or y.dim() != 3 or x.shape[2] != 3 or y.shape[2] != 3 \
            or x.shape[0] != y.shape[0]:
        raise ValueError(f"{name}: expected clouds [P, N, 3] and [P, M, 3], "
                         f"got {tuple(x.shape)} and {tuple(y.shape)}")
    if x.shape[1] == 0 or y.shape[1] == 0:
        raise ValueError(f"{name}: empty clouds")
    if x.device != y.device:
        raise ValueError(f"{name}: inputs differ in device")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {x.device}")
    smem = smem_bytes(x.shape[1], y.shape[1])
    if smem > SMEM_LIMIT:
        raise ValueError(f"{name}: N={x.shape[1]}, M={y.shape[1]} need {smem} "
                         f"B of shared memory, more than the {SMEM_LIMIT} B "
                         "a block may use")
    return x.float().contiguous(), y.float().contiguous()


def stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream
