"""Attention cores: hand-written CUDA kernels K1, K2, K3, K4 and K8, and
their plain twins.

K1 `packed_self_attention(qkv, num_heads)` — the attention core of every
DiT block (24 launches per denoise step).
  * Replaces `ldt_tpu/ops/pallas_attention.py::_fwd_kernel_packed_phased_multi`
    (default schedule), `_fwd_kernel_packed_phased` and `_fwd_kernel_packed`:
    all three compute per head softmax(q_h k_h^T dh^-1/2) v_h from the packed
    [B, N, 3D] qkv GEMM output.
  * Bound on an H100: device-memory bytes. At the flagship shape (B=64,
    N=32, D=1024, 16 heads, bf16) it reads 12.6 MB and writes 4.2 MB for
    0.27 GFLOP, far below the card's operations-per-byte balance.
  * Design: three schedules, picked in the library (mirrored by
    `packed_schedule(n, dh, dtype)`). All read q_h, k_h, v_h straight out
    of the packed rows (no split copies) and write [N, dh] once.
    "mma" (bf16, N a multiple of 16 up to 64, dh 16/32/64/128, the generation
    path): a block holds 4 heads of one element in shared memory (16-byte
    `cp.async` copies); a warp owns 16 query rows of a head, takes the
    scores with `mma.sync` m16n8k16 bf16 products (f32 accumulation), runs
    the softmax on the accumulator fragments in registers, rounds the
    weights to bf16 straight into the A fragments of the AV product, and
    writes the output with 16-byte stores.
    "tiled" (f32, dh a multiple of 4, 16-byte aligned rows, two heads'
    shared memory within a block's: training's path; TF32 would fail its
    limits): the "fma" kernel fed one FMA per two scalar shared-memory loads,
    so the shared-memory pipe, not the device's 33.6 MB (0.0100 ms), set its
    time. Here a thread owns a 4 x 4 register tile of scores, then of
    outputs, read as float4 slices (8 FMAs a shared load); 2 heads a block,
    q and k by `cp.async`, v copied over q during the softmax (44 KB a
    block at the train step's shape, all 512 blocks resident at once).
    Each score and output is the same f32 FMA chain, in the same order, as
    the "fma" kernel's, and the softmax the same warp loop: the same bits.
    "fma" (every other input): one block per (batch element, head) keeps q,
    k, v and the [N, N] scores in shared memory as f32 and runs each score
    and output element as an FMA chain.
    The library reports which schedule it launched; the calls on the first
    two are counted in `.mma_launches` and `.tiled_launches` too. "mma"
    orders its f32 sums differently from the others; each repeats its bits.

K3 `packed_self_attention_bwd(qkv, g, num_heads)` — the backward of K1: the
packed [B, N, 3D] gradient of the qkv from the output's gradient g [B, N, D]
(24 launches per stage-2 train step). `PackedSelfAttention` is the
autograd.Function whose forward is K1 and whose backward is K3; it saves
only qkv, as the JAX VJP does.
  * Replaces `ldt_tpu/ops/pallas_attention.py::_bwd_kernel_packed_phased`
    (and `_bwd_kernel_packed`, the same function): recompute the f32 weights
    w, then dv = round(w)^T g, dw = g v^T, ds = w (dw - rowsum(dw w)),
    dq = round(ds) k dh^-1/2, dk = round(ds)^T q dh^-1/2, round() to the
    input dtype, products in f32.
  * Bound on an H100: device-memory bytes. At the train step's shape (B=64,
    N=32, D=1024, 16 heads, f32) it reads 33.6 MB and writes 25.2 MB for
    0.67 GFLOP.
  * Design: one block per (batch element, head) with q_h, k_h, v_h, g_h and
    the [N, N] weights and their gradient in shared memory; every gradient
    element is written once. Where dh % 4 == 0, qkv, g and the output are
    16-byte aligned and the layout fits (`self_bwd_tiled`, decided in the
    library, which reports it and answers the query; `.tiled_launches`
    counts those calls): the register-tiled kernel, training's path. q, k,
    v and g by `cp.async`, 256 threads a block and four blocks a SM at the
    train step's shape, K4's register-tiled products (a thread owns 4 x 4
    tiles of the scores or dw, of dk and dv, of dq, read as float4 slices:
    8 FMAs a shared-memory load where the first kernel fed each FMA from
    scalar loads), 16-byte stores. Every FMA chain keeps the first
    kernel's order and the softmax rows are the same code, so the two give
    the same bits; the first kernel (256 threads, each element an FMA chain
    over scalar loads) takes the rest.

K2 `cross_attention(q, k, v, num_heads)` — the set-VAE's cross-attention:
the decoder's 2048 points over 32 latents (6 launches per generation), and
in the encode the 32 tokens over themselves (13) and over the 2048-point
decoded set (5).
  * Replaces `ldt_tpu/ops/pallas_attention.py::_fwd_kernel` and the grouped
    schedule `_fwd_kernel_grouped` (the same function for N == M).
  * Bound on an H100: device-memory bytes. At the decode shape (B=64,
    N=2048, M=32, D=128, 4 heads, bf16) q in and the output out are 33.5 MB
    each, k and v 1 MB together (0.020 ms), and the 1.07 G f32 FMAs take
    about as long (0.032 ms at 67 TFLOP/s). At the posterior shape (N=32,
    M=2048, f32) k and v are 134 MB.
  * Design: two schedules (`cross_schedule`), f32 on the CUDA cores.
    Whole-set, where dh <= 64 and a head's k_h and v_h fit in shared memory
    (M=32): grid (128-row tile, head, batch), one thread per query row
    with its q row, 32 scores and its output row in registers; k and v in
    shared memory are read by all lanes at one address (a broadcast), so
    one 16-byte shared load feeds 4 FMAs of 32 rows.
    Long-key (M=2048): the keys split into chunks of up to 128 (grid:
    chunk x 32-row tile, head, batch), three CUDA launches: each chunk's
    row max and exp-sum; the merge of those in chunk order, the chunk's
    rounded weights and its f32 partial AV product; the partials' sum in
    chunk order. k and v are read once per 32 query rows. The weights are
    rounded before AV as the TPU kernel does, which an online-softmax
    rescale would not. The schedules round the row sum differently (a few
    f32 ulps); each repeats itself bit for bit. The launches of one call
    count as one in `.launches`.

K4 `cross_attention_bwd(q, k, v, g, num_heads)` — the backward of K2: dq
[B, N, D], dk and dv [B, M, D] from the output's gradient g [B, N, D] (24
launches per stage-1 train step: 13 at N = M = 32, 5 at N=32, M=2048, 6 at
N=2048, M=32). `CrossAttention` is the autograd.Function whose forward is K2
and whose backward is K4; it saves (q, k, v), as the JAX VJP does.
  * Replaces `ldt_tpu/ops/pallas_attention.py::_bwd_kernel`, K3's formulas
    on a query set against a key set.
  * Bound on an H100: f32 FMAs at the long shapes (B=16, dh=32: 0.67 G FMAs,
    0.020 ms, against 51-68 MB).
  * Design: where a head's k and v fit in shared memory, the long-query
    schedule: grid (query tile, head, batch), k and v whole, dq of the
    tile's rows complete in the block; dk and dv, sums over every query, are
    written by the block when there is one tile, else as f32 partial sums
    per tile that a second CUDA launch adds in tile order (no atomics, so a
    run repeats itself bit for bit). Longer key sets take the long-key
    schedule: grid (64-key chunk, head, batch), each block with the N query
    rows; a first launch writes each chunk's row max, exp-sum and
    dw-weighted exp-sum, a second merges them in chunk order into the
    softmax statistics and D = rowsum(dw * w), writes the chunk's complete
    dk and dv and its dq partial sums, and a third adds those in chunk
    order. The launches of one call count as one in `.launches`.
    In both, where dh % 4 == 0, q, k, v and g are 16-byte aligned and the
    layout fits (`cross_bwd_tiled`, decided in the library, which reports
    it and answers the query; `.tiled_launches` counts those calls), the
    products are register-tiled: a thread owns 4 x 4 tiles (rows x keys of
    the scores and dw, keys x channels of dk and dv, rows x channels of dq)
    read as float4 slices of shared rows, 8 FMAs a shared load where the
    first kernels fed each FMA from scalar loads. Every FMA chain keeps the
    first kernels' order and the softmax rows are the same code, so the two
    give the same bits; the first kernels take the rest.

K1-K4 accumulate in f32, run the softmax in f32 and round the weights to the
input dtype before the AV product, as the Pallas kernels do. They take f32
and bf16 tensors that are contiguous and lie on one device; on the CPU the
plain twins also take f64, and compute in it (gradient checks).

K8 `packed_self_attention_int8(qkv, num_heads, elems=4)` — K1 with int8
operands, the attention core of the int8 serving step when its int8
attention is on (24 launches per denoise step).
  * Replaces `ldt_tpu/ops/pallas_attention.py::
    _fwd_kernel_packed_phased_multi_int8`. Per group of `elems` consecutive
    batch elements, q, k and v each get one scale max|x| / 127 + 1e-20 over
    the group's rows and all heads; q8(a, s) = clip(round(a / s), -127, 127)
    (half to even); scores int32(q8 k8^T) * ((sq sk) dh^-1/2) in f32; an f32
    row softmax; weight codes clip(round(w * 127), 0, 127); output
    int32(w8 v8) * (sv / 127) in the input dtype.
  * Bound on an H100: device-memory bytes, as K1 (the same 16.8 MB at the
    flagship shape; its dots are int8).
  * Design: two schedules, picked in the library, whose report the wrapper
    counts (no Python mirror); each is two CUDA launches, which together
    count as ONE launch of K8 in `.launches`. Int8 tensor cores (N a
    multiple of 16 up to 64, dh a multiple of 32, 16-byte aligned rows: the
    generation path; `.mma_launches` counts them): a scale pass over
    (group, q|k|v, 8-row slice) blocks writes partial maxima with 16-byte
    loads; the main kernel merges them, quantizes 4 heads of an element
    into int8 codes in shared memory (v transposed, the AV product's
    column-major operand), and a warp per 16 query rows takes the scores
    and the AV product as `mma.sync` m16n8k32 s8 products, the f32 softmax
    between them in the other schedule's warp loop. The rest: one block per
    (group, q|k|v) reduces the scales, then one block per (element, head)
    runs K1's CUDA-core schedule with int32 dots. The dots are exact, so the
    two give the same bits.
  The plain twin takes its integer dots in f64, which is exact here
  (|sum| <= 127^2 * dh) on both devices.

Dispatch: a wrapper computes with its plain version only when its input
lies on the CPU; for a CUDA tensor it launches the kernel or raises. Each
wrapper counts its kernel launches in `<wrapper>.launches`, and by shape in
`_build.SHAPES[<wrapper name>]`; its plain twin's calls by shape go to
`_build.PLAIN_SHAPES` (the same in `chamfer` and `emd`). K1 and K2
differentiate only through
`PackedSelfAttention` and `CrossAttention`, and K8 has no backward: their
wrappers raise when grad mode is on and an input requires grad, rather than
return an output with no `grad_fn`.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from ldt_torch.ops import _build

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
# Most dynamic shared memory a block may use on sm_90 (bytes).
SMEM_LIMIT = 232448
# K2's schedules (csrc/attention.cu): the whole-set schedule's threads per
# block (kWholeThreads), widest head (kWholeMaxDh) and keys per register
# chunk (kWholeChunk); the long-key schedule's threads (kLkThreads) and rows
# (kLkRows) per block and its most and fewest keys per chunk (kLkKeys,
# kLkMinKeys).
_WHOLE_THREADS = 128
_WHOLE_MAX_DH = 64
_WHOLE_CHUNK = 32
_LK_THREADS = 256
_LK_ROWS = 32
_LK_KEYS = 128
_LK_MIN_KEYS = 32
# K1's tensor-core schedule (csrc/attention.cu): heads per block (kMmaHeads),
# the most tokens (kMmaMaxN), the padding of its shared-memory rows in bf16
# (kMmaPad), and the head widths it takes.
_MMA_HEADS = 4
_MMA_MAX_N = 64
_MMA_PAD = 8
_MMA_DH = (16, 32, 64, 128)
# K1's register-tiled f32 schedule (csrc/attention.cu): heads per block
# (kTileHeads).
_TILE_HEADS = 2
# Keys per chunk of K4's long-key schedule (kBwdKeys in csrc/attention.cu),
# and the most query rows per block of its long-query schedule.
_BWD_KEYS = 64
_BWD_ROWS = 128


def self_smem_bytes(n: int, dh: int) -> int:
    """K1's and K8's shared memory: q, k (stride dh+1), v and the [n, n]
    scores, 4 bytes each (f32, or K8's int32 codes)."""
    return 4 * (n * dh + n * (dh + 1) + n * dh + n * n)


def self_mma_smem_bytes(n: int, dh: int) -> int:
    """K1's tensor-core shared memory: q, k and v of 4 heads, [n, dh + 8]
    bf16 each."""
    return 2 * 3 * _MMA_HEADS * n * (dh + _MMA_PAD)


def self_tiled_smem_bytes(n: int, dh: int) -> int:
    """K1's register-tiled shared memory: per head q (then v) and k [n4,
    lk_ld(dh)] and the scores [n4, n4 + 8], n4 = n rounded up to 4, f32,
    for `_TILE_HEADS` heads."""
    n4 = -(-n // 4) * 4
    return 4 * _TILE_HEADS * (2 * n4 * lk_ld(dh) + n4 * (n4 + 8))


def packed_schedule(n: int, dh: int, dtype: torch.dtype,
                    aligned: bool = True) -> str:
    """K1's schedule for n tokens of head width dh (`self_mma` and
    `self_tiled` in csrc/attention.cu, which decide): "mma" (the tensor
    cores) where dtype is bf16, n a multiple of 16 in [16, 64], dh 16, 32,
    64 or 128, and the qkv and output 16-byte `aligned`; "tiled" (the CUDA
    cores, register-tiled) where dtype is f32, dh a multiple of 4, the rows
    `aligned` and two heads' shared memory within a block's; "fma" (the
    first CUDA-core kernel) for everything else. The wrapper counts what the
    library reports it launched; this rule is what the tests and
    chip_smoke.py expect it to report."""
    if (dtype == torch.bfloat16 and aligned and n % 16 == 0
            and 16 <= n <= _MMA_MAX_N and dh in _MMA_DH
            and self_mma_smem_bytes(n, dh) <= SMEM_LIMIT):
        return "mma"
    if (dtype == torch.float32 and aligned and dh % 4 == 0
            and self_tiled_smem_bytes(n, dh) <= SMEM_LIMIT):
        return "tiled"
    return "fma"


def whole_width(dh: int) -> int:
    """The register width (16, 32, 48 or 64) in which K2's whole-set
    schedule keeps a head of width dh, zero-padded; 0 past 64."""
    return 0 if dh > _WHOLE_MAX_DH else -(-dh // 16) * 16


def cross_whole_smem_bytes(m: int, dh: int) -> int:
    """K2's whole-set shared memory: k and v [m, whole_width(dh)], f32."""
    return 4 * 2 * m * whole_width(dh)


def lk_ld(dh: int) -> int:
    """Row stride (floats) of the long-key schedule's q, k and v in shared
    memory: dh padded to a multiple of 8, plus 4."""
    return -(-dh // 8) * 8 + 4


def cross_lk_smem_bytes(dh: int, keys: int) -> int:
    """K2's long-key shared memory (its second launch, the larger): q rows,
    the chunk's k (then its weights, [keys, rows + 4]) and v, and two
    scalars per row, f32."""
    ld = lk_ld(dh)
    return 4 * (_LK_ROWS * ld + keys * max(ld, _LK_ROWS + 4) + keys * ld
                + 2 * _LK_ROWS)


def cross_lk_keys(dh: int) -> int:
    """Keys per chunk of K2's long-key schedule: the most, from 128 down to
    32, whose shared memory fits; 0 if none does."""
    keys = _LK_KEYS
    while keys >= _LK_MIN_KEYS:
        if cross_lk_smem_bytes(dh, keys) <= SMEM_LIMIT:
            return keys
        keys //= 2
    return 0


def cross_schedule(n: int, m: int, dh: int) -> Optional[str]:
    """K2's schedule for n queries over m keys of width dh: "whole" where
    dh <= 64 and a head's k and v fit in shared memory, else "long_key",
    or None where neither fits (n does not decide it)."""
    if whole_width(dh) and cross_whole_smem_bytes(m, dh) <= SMEM_LIMIT:
        return "whole"
    return "long_key" if cross_lk_keys(dh) else None


def cross_lk_workspace(b: int, n: int, m: int, d: int, num_heads: int) -> int:
    """f32 values of the long-key schedule's scratch: per element and chunk,
    each row's max and exp-sum per head, and the partial output [n, d]."""
    chunks = -(-m // cross_lk_keys(d // num_heads))
    return b * chunks * (2 * num_heads * n + n * d)


def cross_bwd_lq_smem_bytes(m: int, dh: int, rows: int) -> int:
    """K4's long-query schedule with `rows` query rows per block: k and v
    (stride dh+1), the rows' q and g, and their weights and ds, f32."""
    return 4 * (2 * m * (dh + 1) + 2 * rows * dh + 2 * rows * m)


def cross_bwd_lk_smem_bytes(n: int, dh: int) -> int:
    """K4's long-key schedule: q and g [n, dh], a chunk of k and v (stride
    dh+1), the rows' weights and ds over the chunk, and three scalars per
    row, f32."""
    return 4 * (2 * n * dh + 2 * _BWD_KEYS * (dh + 1) + 2 * n * _BWD_KEYS
                + 3 * n)


def cross_bwd_schedule(n: int, m: int, dh: int) -> Optional[int]:
    """K4's schedule for n queries over m keys of width dh: the long-query
    schedule's rows per block (the most, up to 128 and n, whose shared memory
    fits), 0 for the long-key schedule, None where neither fits."""
    rows = _BWD_ROWS
    while rows:
        r = min(rows, max(n, 1))
        if cross_bwd_lq_smem_bytes(m, dh, r) <= SMEM_LIMIT:
            return r
        rows //= 2
    return 0 if cross_bwd_lk_smem_bytes(n, dh) <= SMEM_LIMIT else None


def cross_bwd_tiled(n: int, m: int, dh: int, aligned: bool = True) -> bool:
    """Whether K4 at n queries over m keys of width dh, with q, k, v and g
    16-byte aligned or not, takes its register-tiled kernels in the
    schedule `cross_bwd_schedule` picks, asked of the library without a
    launch (`cross_bwd_tiled` in csrc/rules.h: dh % 4 == 0, aligned, and
    the tiled layout's shared memory within a block's). The wrapper
    reports the same for its launch."""
    rows = cross_bwd_schedule(n, m, dh)
    return rows is not None and bool(
        _lib().ldt_cross_bwd_tiled(n, m, dh, rows, int(aligned)))


def self_bwd_tiled(n: int, dh: int, aligned: bool = True) -> bool:
    """Whether K3 at n tokens of head width dh, with qkv, g and the output
    16-byte aligned or not, takes its register-tiled kernel, asked of the
    library without a launch (`self_bwd_tiled` in csrc/rules.h: dh % 4 ==
    0, aligned, and the tiled layout's shared memory within a block's). The
    wrapper reports the same for its launch."""
    return bool(_lib().ldt_self_bwd_tiled(n, dh, int(aligned)))


def _softmax_rows(s: torch.Tensor) -> torch.Tensor:
    s = s - s.amax(dim=-1, keepdim=True)
    e = torch.exp(s)
    return e / e.sum(dim=-1, keepdim=True)


def _acc(dtype: torch.dtype) -> torch.dtype:
    """The twins' arithmetic type: f32, or f64 for f64 inputs."""
    return torch.promote_types(dtype, torch.float32)


def _heads(t: torch.Tensor, num_heads: int) -> torch.Tensor:
    """[B, N, D] -> [B, H, N, dh] in f32 (f64 for f64 inputs)."""
    b, n, d = t.shape
    return t.reshape(b, n, num_heads, d // num_heads).transpose(1, 2).to(
        _acc(t.dtype))


def _merge(t: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """[B, H, N, dh] -> [B, N, H * dh] in `dtype`."""
    b, h, n, dh = t.shape
    return t.to(dtype).transpose(1, 2).reshape(b, n, h * dh)


def attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    num_heads: int) -> torch.Tensor:
    """Plain PyTorch twin of both kernels: per head
    softmax(q_h k_h^T dh^-1/2) v_h with f32 products and softmax, weights
    rounded to the input dtype before AV, output in the input dtype
    (`ldt_tpu/ops/pallas_attention.py::reference_attention_core`)."""
    dh = q.shape[-1] // num_heads
    qh, kh, vh = (_heads(t, num_heads) for t in (q, k, v))
    s = torch.matmul(qh, kh.transpose(-1, -2)) * (dh ** -0.5)
    w = _softmax_rows(s).to(q.dtype).to(qh.dtype)
    return _merge(torch.matmul(w, vh), q.dtype)


def packed_self_attention_plain(qkv: torch.Tensor,
                                num_heads: int) -> torch.Tensor:
    """Plain twin of K1 on the packed [B, N, 3D] qkv."""
    d = qkv.shape[-1] // 3
    return attention_plain(qkv[..., :d], qkv[..., d:2 * d], qkv[..., 2 * d:],
                           num_heads)


def cross_attention_bwd_plain(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor, g: torch.Tensor,
                              num_heads: int):
    """Plain twin of K4 (and of K3 on the packed qkv): (dq, dk, dv) of
    `attention_plain`'s output from its gradient g, written out step by step
    as `ldt_tpu/ops/pallas_attention.py::_bwd_kernel` computes it (not by
    autograd through the forward): per head the f32 scores and softmax w,
    dv = round(w)^T g, dw = g v^T, ds = w (dw - rowsum(dw w)),
    dq = round(ds) k dh^-1/2, dk = round(ds)^T q dh^-1/2, round() to the
    input dtype, each gradient in its input's dtype."""
    scale = (q.shape[-1] // num_heads) ** -0.5
    dt = q.dtype
    qh, kh, vh, gh = (_heads(t, num_heads) for t in (q, k, v, g))
    w = _softmax_rows(torch.matmul(qh, kh.transpose(-1, -2)) * scale)
    dv = torch.matmul(w.to(dt).to(w.dtype).transpose(-1, -2), gh)
    dw = torch.matmul(gh, vh.transpose(-1, -2))
    ds = (w * (dw - (dw * w).sum(dim=-1, keepdim=True))).to(dt).to(w.dtype)
    dq = torch.matmul(ds, kh) * scale
    dk = torch.matmul(ds.transpose(-1, -2), qh) * scale
    return _merge(dq, dt), _merge(dk, k.dtype), _merge(dv, v.dtype)


def packed_self_attention_bwd_plain(qkv: torch.Tensor, g: torch.Tensor,
                                    num_heads: int) -> torch.Tensor:
    """Plain twin of K3: the packed [B, N, 3D] gradient of K1's qkv from the
    output's gradient g [B, N, D]
    (`ldt_tpu/ops/pallas_attention.py::_bwd_kernel_packed_phased`, the same
    arithmetic as `_bwd_kernel`)."""
    d = qkv.shape[-1] // 3
    return torch.cat(cross_attention_bwd_plain(
        qkv[..., :d], qkv[..., d:2 * d], qkv[..., 2 * d:], g, num_heads),
        dim=-1)


def true_divide(a: torch.Tensor, b: float) -> torch.Tensor:
    """a / b correctly rounded on every device. PyTorch's CUDA division by a
    Python number multiplies by its f32 reciprocal, which is off by an ulp
    for some a (e.g. b = 127); a 0-d tensor on a's device divides."""
    return a / a.new_tensor(b)


def _int8_codes(a: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """q8(a, s) = clip(round(a / s), -127, 127), as f64 (exact integers)."""
    return torch.clamp(torch.round(a / s), -127.0, 127.0).double()


def packed_self_attention_int8_plain(qkv: torch.Tensor, num_heads: int,
                                     elems: int = 4) -> torch.Tensor:
    """Plain twin of K8 on the packed [B, N, 3D] qkv (B a multiple of
    `elems`), its integer dots in f64."""
    b, n, d3 = qkv.shape
    d = d3 // 3
    dh = d // num_heads
    _check_elems("packed_self_attention_int8_plain", b, elems)
    # [groups, q|k|v, elems, heads, n, dh]
    x = qkv.float().reshape(b // elems, elems, n, 3, num_heads, dh)
    x = x.permute(0, 3, 1, 4, 2, 5)
    s = true_divide(x.abs().amax(dim=(2, 3, 4, 5), keepdim=True), 127.0) \
        + 1e-20
    sq, sk, sv = s[:, 0], s[:, 1], s[:, 2]
    q8, k8, v8 = (_int8_codes(x[:, i], s[:, i]) for i in range(3))
    scores = torch.matmul(q8, k8.transpose(-1, -2)).float() * (
        (sq * sk) * (dh ** -0.5))
    w8 = torch.clamp(torch.round(_softmax_rows(scores) * 127.0), 0.0, 127.0)
    out = torch.matmul(w8.double(), v8).float() * true_divide(sv, 127.0)
    # [groups, elems, heads, n, dh] -> [B, N, D]
    return out.permute(0, 1, 3, 2, 4).reshape(b, n, d).to(qkv.dtype)


def _check_elems(name: str, b: int, elems: int) -> None:
    if elems <= 0 or b % elems != 0:
        raise ValueError(f"{name}: batch {b} is not a multiple of "
                         f"elems={elems}")


def _check(name: str, tensors) -> None:
    first = tensors[0]
    for t in tensors:
        if t.dim() != 3:
            raise ValueError(f"{name}: expected [B, N, C] tensors, got "
                             f"{tuple(t.shape)}")
        if t.dtype not in _DTYPE_CODES and not (
                t.dtype == torch.float64 and t.device.type == "cpu"):
            raise TypeError(f"{name}: dtype {t.dtype} not supported "
                            "(float32 or bfloat16; float64 on the CPU)")
        if t.dtype != first.dtype or t.device != first.device:
            raise ValueError(f"{name}: inputs differ in dtype or device")
        if not t.is_contiguous():
            raise ValueError(f"{name}: inputs must be contiguous")
    if first.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {first.device}")


def _check_heads(name: str, d: int, num_heads: int) -> None:
    if num_heads <= 0 or d % num_heads != 0:
        raise ValueError(f"{name}: width {d} is not divisible by "
                         f"num_heads={num_heads}")


def _check_no_grad(name: str, tensors) -> None:
    """Refuse to drop a gradient silently: K1 and K2 differentiate only
    through `PackedSelfAttention` and `CrossAttention`, K8 not at all."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{name}: the kernel's output would carry no gradient (K1 "
            "differentiates through PackedSelfAttention, K2 through "
            "CrossAttention, K8 has no backward); call it under "
            "torch.no_grad() or through the autograd.Function")


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = _build.load("attention")
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.ldt_packed_self_attention.argtypes = [p, p, i, i, i, i, f, i, p,
                                              ctypes.POINTER(i)]
    lib.ldt_packed_self_attention.restype = i
    lib.ldt_cross_attention.argtypes = [p, p, p, p, p, i, i, i, i, i, f, i,
                                        p]
    lib.ldt_cross_attention.restype = i
    lib.ldt_packed_self_attention_bwd.argtypes = [p, p, p, i, i, i, i, f, i,
                                                  p, ctypes.POINTER(i)]
    lib.ldt_packed_self_attention_bwd.restype = i
    lib.ldt_self_bwd_tiled.argtypes = [i] * 3
    lib.ldt_self_bwd_tiled.restype = i
    lib.ldt_self_bwd_smem_bytes.argtypes = [i] * 3
    lib.ldt_self_bwd_smem_bytes.restype = ctypes.c_size_t
    lib.ldt_packed_self_attention_int8.argtypes = [p, p, p, i, i, i, i, i, f,
                                                   i, p, ctypes.POINTER(i)]
    lib.ldt_packed_self_attention_int8.restype = i
    lib.ldt_cross_attention_bwd.argtypes = [p, p, p, p, p, p, p, p, i, i, i,
                                            i, i, i, f, i, p,
                                            ctypes.POINTER(i)]
    lib.ldt_cross_attention_bwd.restype = i
    lib.ldt_cross_bwd_tiled.argtypes = [i] * 5
    lib.ldt_cross_bwd_tiled.restype = i
    lib.ldt_error_string.argtypes = [i]
    lib.ldt_error_string.restype = ctypes.c_char_p
    return lib


def _raise_on(err: int, name: str) -> None:
    if err != 0:
        msg = _lib().ldt_error_string(err).decode()
        raise RuntimeError(f"{name}: kernel launch failed: CUDA error "
                           f"{err} ({msg})")


def packed_self_attention(qkv: torch.Tensor, num_heads: int) -> torch.Tensor:
    """K1: self-attention on the packed [B, N, 3D] qkv -> [B, N, D]."""
    name = "packed_self_attention"
    dh = _check_packed(name, qkv, num_heads)
    _check_no_grad(name, (qkv,))
    if qkv.device.type == "cpu":
        _build.count_shape(_build.PLAIN_SHAPES, name, qkv,
                           num_heads)
        return packed_self_attention_plain(qkv, num_heads)
    b, n, d3 = qkv.shape
    d = d3 // 3
    out = torch.empty((b, n, d), dtype=qkv.dtype, device=qkv.device)
    schedule = ctypes.c_int(0)
    with torch.cuda.device(qkv.device):
        stream = torch.cuda.current_stream(qkv.device).cuda_stream
        err = _lib().ldt_packed_self_attention(
            qkv.data_ptr(), out.data_ptr(), b, n, d, num_heads, dh ** -0.5,
            _DTYPE_CODES[qkv.dtype], stream, ctypes.byref(schedule))
    _raise_on(err, name)
    packed_self_attention.launches += 1
    _build.count_shape(_build.SHAPES, name, qkv, num_heads)
    packed_self_attention.mma_launches += int(schedule.value == 1)
    packed_self_attention.tiled_launches += int(schedule.value == 2)
    return out


packed_self_attention.launches = 0
# the launches (counted in `launches` too) that took the tensor cores and
# the register-tiled f32 schedule, as the library reports what it launched
packed_self_attention.mma_launches = 0
packed_self_attention.tiled_launches = 0


def _check_packed(name: str, qkv: torch.Tensor, num_heads: int) -> int:
    """Checks of K1 and K8 on the packed qkv; returns dh."""
    _check(name, (qkv,))
    n, d3 = qkv.shape[1:]
    if d3 % 3 != 0:
        raise ValueError(f"{name}: last dim {d3} is not 3 * D")
    _check_heads(name, d3 // 3, num_heads)
    dh = d3 // 3 // num_heads
    if self_smem_bytes(n, dh) > SMEM_LIMIT:
        raise ValueError(f"{name}: N={n}, dh={dh} need "
                         f"{self_smem_bytes(n, dh)} B of shared memory, "
                         f"more than the {SMEM_LIMIT} B a block may use")
    return dh


def packed_self_attention_int8(qkv: torch.Tensor, num_heads: int,
                               elems: int = 4) -> torch.Tensor:
    """K8: int8 self-attention on the packed [B, N, 3D] qkv -> [B, N, D],
    scales per group of `elems` batch elements (B must be a multiple).
    One call is one count in `.launches` (two CUDA launches); the calls
    that took the int8 tensor cores, as the library reports, are counted in
    `.mma_launches` too."""
    name = "packed_self_attention_int8"
    dh = _check_packed(name, qkv, num_heads)
    b, n, d3 = qkv.shape
    _check_elems(name, b, elems)
    _check_no_grad(name, (qkv,))
    if qkv.device.type == "cpu":
        return packed_self_attention_int8_plain(qkv, num_heads, elems)
    d = d3 // 3
    out = torch.empty((b, n, d), dtype=qkv.dtype, device=qkv.device)
    # the group scales, then room for the tensor-core schedule's partial
    # maxima (the C entry's contract)
    scales = torch.empty(int8_scratch(b, n, elems), dtype=torch.float32,
                         device=qkv.device)
    schedule = ctypes.c_int(0)
    with torch.cuda.device(qkv.device):
        stream = torch.cuda.current_stream(qkv.device).cuda_stream
        err = _lib().ldt_packed_self_attention_int8(
            qkv.data_ptr(), scales.data_ptr(), out.data_ptr(), b, n, d,
            num_heads, elems, dh ** -0.5, _DTYPE_CODES[qkv.dtype], stream,
            ctypes.byref(schedule))
    _raise_on(err, name)
    packed_self_attention_int8.launches += 1
    packed_self_attention_int8.mma_launches += schedule.value
    return out


packed_self_attention_int8.launches = 0
packed_self_attention_int8.mma_launches = 0


def int8_scratch(b: int, n: int, elems: int) -> int:
    """f32 values of K8's scratch: the [b / elems, 3] group scales, then
    up to one partial maximum per row of a group and part."""
    return b // elems * 3 * (1 + elems * n)


def _check_cross(name: str, q: torch.Tensor, k: torch.Tensor,
                 v: torch.Tensor, num_heads: int):
    """Checks of K2 and K4 on q [B, N, D] against k, v [B, M, D]; returns
    (B, N, M, D, dh)."""
    _check(name, (q, k, v))
    b, n, d = q.shape
    m = k.shape[1]
    if k.shape != v.shape or k.shape[0] != b or k.shape[2] != d or m == 0:
        raise ValueError(f"{name}: shapes q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)} do not match")
    _check_heads(name, d, num_heads)
    return b, n, m, d, d // num_heads


def cross_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    num_heads: int) -> torch.Tensor:
    """K2: attention of q [B, N, D] over k, v [B, M, D] -> [B, N, D]. One
    call is one count in `.launches` (three CUDA launches on the long-key
    schedule, whose calls `.tiled_launches` counts too)."""
    name = "cross_attention"
    b, n, m, d, dh = _check_cross(name, q, k, v, num_heads)
    schedule = cross_schedule(n, m, dh)
    if schedule is None:
        raise ValueError(f"{name}: dh={dh} needs "
                         f"{cross_lk_smem_bytes(dh, _LK_MIN_KEYS)} B of "
                         f"shared memory for a chunk of {_LK_MIN_KEYS} keys, "
                         f"more than the {SMEM_LIMIT} B a block may use")
    _check_no_grad(name, (q, k, v))
    if q.device.type == "cpu":
        _build.count_shape(_build.PLAIN_SHAPES, name, q, num_heads)
        return attention_plain(q, k, v, num_heads)
    out = torch.empty_like(q)
    work = (torch.empty(cross_lk_workspace(b, n, m, d, num_heads),
                        dtype=torch.float32, device=q.device)
            if schedule == "long_key" else None)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = _lib().ldt_cross_attention(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            None if work is None else work.data_ptr(), b, n, m, d,
            num_heads, dh ** -0.5, _DTYPE_CODES[q.dtype], stream)
    _raise_on(err, name)
    cross_attention.launches += 1
    _build.count_shape(_build.SHAPES, name, q, num_heads)
    if schedule == "long_key":
        cross_attention.tiled_launches += 1
    return out


cross_attention.launches = 0
# the calls (counted in `launches` too) that took the long-key schedule
cross_attention.tiled_launches = 0


def packed_self_attention_bwd(qkv: torch.Tensor, g: torch.Tensor,
                              num_heads: int) -> torch.Tensor:
    """K3: the packed [B, N, 3D] gradient of K1's qkv from the output's
    gradient g [B, N, D]. The calls that took the register-tiled kernel, as
    the library reports, are counted in `.tiled_launches` too."""
    name = "packed_self_attention_bwd"
    dh = _check_packed(name, qkv, num_heads)
    _check(name, (qkv, g))
    b, n, d3 = qkv.shape
    d = d3 // 3
    if tuple(g.shape) != (b, n, d):
        raise ValueError(f"{name}: g {tuple(g.shape)} is not the output "
                         f"shape {(b, n, d)}")
    if qkv.device.type == "cpu":
        _build.count_shape(_build.PLAIN_SHAPES, name, qkv,
                           num_heads)
        return packed_self_attention_bwd_plain(qkv, g, num_heads)
    smem = _lib().ldt_self_bwd_smem_bytes(n, dh, 0)
    if smem > SMEM_LIMIT:
        raise ValueError(f"{name}: N={n}, dh={dh} need {smem} B of shared "
                         f"memory, more than the {SMEM_LIMIT} B a block may "
                         "use")
    dqkv = torch.empty_like(qkv)
    schedule = ctypes.c_int(0)
    with torch.cuda.device(qkv.device):
        stream = torch.cuda.current_stream(qkv.device).cuda_stream
        err = _lib().ldt_packed_self_attention_bwd(
            qkv.data_ptr(), g.data_ptr(), dqkv.data_ptr(), b, n, d,
            num_heads, dh ** -0.5, _DTYPE_CODES[qkv.dtype], stream,
            ctypes.byref(schedule))
    _raise_on(err, name)
    packed_self_attention_bwd.launches += 1
    _build.count_shape(_build.SHAPES, name, qkv, num_heads)
    packed_self_attention_bwd.tiled_launches += schedule.value
    return dqkv


packed_self_attention_bwd.launches = 0
# the launches (counted in `launches` too) that took the register-tiled
# kernel, as the library reports what it launched
packed_self_attention_bwd.tiled_launches = 0


class PackedSelfAttention(torch.autograd.Function):
    """K1 forward, K3 backward (on CPU tensors: their plain twins). Saves
    only qkv and recomputes the weights in the backward, as the JAX VJP
    (`ldt_tpu/ops/pallas_attention.py::fused_attention_packed`) does. The
    kernels are looked up in this module at each call."""

    @staticmethod
    def forward(ctx, qkv: torch.Tensor, num_heads: int) -> torch.Tensor:
        ctx.save_for_backward(qkv)
        ctx.num_heads = num_heads
        return packed_self_attention(qkv, num_heads)

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        (qkv,) = ctx.saved_tensors
        return (packed_self_attention_bwd(qkv, g.contiguous(),
                                          ctx.num_heads), None)


def cross_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        g: torch.Tensor, num_heads: int):
    """K4: (dq [B, N, D], dk [B, M, D], dv [B, M, D]) of K2's output from
    its gradient g [B, N, D]. One call is one count in `.launches` (two
    CUDA launches where the long-query schedule takes more than one query
    tile, three for the long-key schedule); `.long_key_launches` and
    `.long_query_launches` count the calls that took the long-key schedule
    and the multi-tile long-query one, `.tiled_launches` those that took
    the register-tiled kernels (as the library reports it)."""
    name = "cross_attention_bwd"
    b, n, m, d, dh = _check_cross(name, q, k, v, num_heads)
    _check(name, (q, g))
    if g.shape != q.shape:
        raise ValueError(f"{name}: g {tuple(g.shape)} is not the output "
                         f"shape {tuple(q.shape)}")
    rows = cross_bwd_schedule(n, m, dh)
    if rows is None:
        raise ValueError(f"{name}: N={n}, M={m}, dh={dh} fit neither "
                         f"schedule's shared memory (long-key: "
                         f"{cross_bwd_lk_smem_bytes(n, dh)} B of "
                         f"{SMEM_LIMIT})")
    if q.device.type == "cpu":
        _build.count_shape(_build.PLAIN_SHAPES, name, q, num_heads)
        return cross_attention_bwd_plain(q, k, v, g, num_heads)
    dq = torch.empty_like(q)
    dk = torch.zeros_like(k) if n == 0 else torch.empty_like(k)
    dv = torch.zeros_like(v) if n == 0 else torch.empty_like(v)
    # f32 scratch: the long-query tiles' dk and dv partials, or the long-key
    # chunks' row statistics and dq partials
    tiles = -(-n // rows) if rows else -(-m // _BWD_KEYS)
    size = (2 * b * tiles * m * d if rows
            else b * tiles * (3 * num_heads * n + n * d))
    part = (torch.empty(size, dtype=torch.float32, device=q.device)
            if tiles > 1 or not rows else None)
    schedule = ctypes.c_int(0)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = _lib().ldt_cross_attention_bwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), g.data_ptr(),
            dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            None if part is None else part.data_ptr(), b, n, m, d,
            num_heads, rows, dh ** -0.5, _DTYPE_CODES[q.dtype], stream,
            ctypes.byref(schedule))
    _raise_on(err, name)
    cross_attention_bwd.launches += 1
    _build.count_shape(_build.SHAPES, name, q, num_heads)
    cross_attention_bwd.tiled_launches += schedule.value
    if rows == 0:
        cross_attention_bwd.long_key_launches += 1
    elif tiles > 1:
        cross_attention_bwd.long_query_launches += 1
    return dq, dk, dv


cross_attention_bwd.launches = 0
# the launches (counted in `launches` too) that took the long-key schedule,
# those that took the long-query schedule with more than one tile, and those
# on the register-tiled kernels (either schedule)
cross_attention_bwd.long_key_launches = 0
cross_attention_bwd.long_query_launches = 0
cross_attention_bwd.tiled_launches = 0


class CrossAttention(torch.autograd.Function):
    """K2 forward, K4 backward (on CPU tensors: their plain twins). Saves
    (q, k, v) and recomputes the weights in the backward, as the JAX VJP
    (`ldt_tpu/ops/pallas_attention.py::fused_attention`) does. The kernels
    are looked up in this module at each call."""

    @staticmethod
    def forward(ctx, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                num_heads: int) -> torch.Tensor:
        ctx.save_for_backward(q, k, v)
        ctx.num_heads = num_heads
        return cross_attention(q, k, v, num_heads)

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        q, k, v = ctx.saved_tensors
        return (*cross_attention_bwd(q, k, v, g.contiguous(), ctx.num_heads),
                None)
