"""ctypes binding of `csrc/eval.cu` (K5 `ldt_pairwise_cd_means`, K6/K7
`ldt_approx_match_cost`) and the checks the wrappers in `ops.chamfer` and
`ops.emd` share."""

from __future__ import annotations

import ctypes
import functools

import torch

from ldt_torch.ops import _build

# Most dynamic shared memory a block may use on sm_90 (bytes).
SMEM_LIMIT = 232448
# Warps per K5 and per K6/K7 block (kCdThreads / 32, kEmdWarps in
# csrc/eval.cu).
_CD_WARPS = 8
_EMD_WARPS = 16


def cd_smem_bytes(n: int, m: int) -> int:
    """K5's shared memory: both clouds and one float per warp."""
    return 4 * (3 * n + 3 * m + _CD_WARPS)


def emd_smem_bytes(n: int, m: int, otf: bool) -> int:
    """K6's shared memory: the row state [2, n], the column state [3, m] and
    one float per warp; K7 holds both clouds beside them."""
    return 4 * (2 * n + 3 * m + _EMD_WARPS + (3 * n + 3 * m if otf else 0))


@functools.lru_cache(maxsize=None)
def lib() -> ctypes.CDLL:
    out = _build.load("eval")
    p, i = ctypes.c_void_p, ctypes.c_int
    out.ldt_pairwise_cd_means.argtypes = [p, p, p, i, i, i, p]
    out.ldt_pairwise_cd_means.restype = i
    out.ldt_approx_match_cost.argtypes = [p, p, p, p, i, i, i, i, p]
    out.ldt_approx_match_cost.restype = i
    out.ldt_eval_error_string.argtypes = [i]
    out.ldt_eval_error_string.restype = ctypes.c_char_p
    return out


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
