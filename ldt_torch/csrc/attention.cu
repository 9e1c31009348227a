// Attention cores of the latent DiT and of the set-VAE, for sm_90a.
//
// K1 ldt_packed_self_attention: per head softmax(q_h k_h^T * dh^-1/2) v_h
//    read straight from the packed [B, N, 3D] qkv GEMM output (q, k, v at
//    column offsets 0, D, 2D), written to [B, N, D] with heads concatenated.
//    Replaces ldt_tpu/ops/pallas_attention.py::_fwd_kernel_packed_phased_multi
//    (and its one-element and per-head schedules, which compute the same).
//    Bound on an H100: bytes. At the generation shape (B=64, N=32, 16 heads
//    of dh=64, bf16) it reads 12.6 MB and writes 4.2 MB, 0.0050 ms at 3.35
//    TB/s; its 0.27 GFLOP are far below the tensor cores' rate. Three
//    schedules, chosen by one rule (self_mma and self_tiled below; the entry
//    point reports the schedule it launched; ldt_torch/ops/attention.py::
//    packed_schedule mirrors the rule for the tests and chip_smoke.py's
//    expected counts):
//    - Tensor cores (packed_self_attention_mma_kernel) where the input is
//      bf16, N is a multiple of 16 in [16, 64], dh is 16, 32, 64 or 128, and
//      qkv and out are 16-byte aligned: the generation path. A block holds 4
//      heads of one element; q, k and v come into shared memory with 16-byte
//      cp.async copies (rows padded by 16 bytes, so ldmatrix's 8 rows hit 8
//      bank groups). A warp owns 16 query rows of one head: the scores are
//      mma.sync m16n8k16 bf16 products with f32 accumulation (A from
//      ldmatrix on q, B from ldmatrix on k, whose [keys, dh] rows are the
//      column-major operand); the softmax runs on the accumulator fragments
//      in registers (row max and sum over the 4 lanes of a quad, expf and an
//      IEEE division, as the TPU kernel); the weights, rounded to bf16, are
//      packed straight into the A fragments of the AV product (two adjacent
//      m16n8 accumulator tiles are one m16k16 A tile), v comes in with
//      ldmatrix.trans, and the bf16 output goes out through the warp's q rows
//      in shared memory with 16-byte stores. The products of bf16 operands
//      are exact; only the order of the f32 sums differs from the other
//      schedules.
//    - Register-tiled CUDA cores (packed_self_attention_tiled_kernel) where
//      the input is f32 (training's path: TF32 would fail its limits), dh is
//      a multiple of 4, qkv and out are 16-byte aligned and the shared
//      memory of kTileHeads heads fits a block. At the train step's shape
//      (B=64, f32) it reads 25.2 MB and writes 8.4 MB, 0.0100 ms at 3.35
//      TB/s; its FMAs take 0.004 ms at 67 TFLOP/s, but fed one FMA per two
//      scalar shared loads (the kernel below) the shared-memory pipe sets
//      the time (~0.05 ms). So a thread owns a 4 x 4 tile of scores, then
//      of outputs, in registers and reads float4 slices of q, k (of weights,
//      v), 8 FMAs a shared load; 2 heads a block, 256 threads, q and k by
//      cp.async, v copied over q once the scores are taken (in flight during
//      the softmax): 44 KB a block, the 512 blocks resident at once. Every
//      score and output is the same fmaf chain in the same order as the
//      kernel below, and the softmax the same warp loop: the same bits.
//    - CUDA cores (packed_self_attention_kernel<T>) for every other input:
//      one block per (element, head), q, k, v and the scores in shared
//      memory as f32, each score and output element an f32 FMA chain over
//      shared loads.
// K3 ldt_packed_self_attention_bwd: the backward of K1. From the packed qkv
//    and the output's gradient g [B, N, D] it recomputes the f32 weights w and
//    writes dq, dk, dv into one packed [B, N, 3D] gradient:
//      dv = round(w)^T g,  dw = g v^T,  ds = w * (dw - rowsum(dw * w)),
//      dq = round(ds) k * dh^-1/2,  dk = round(ds)^T q * dh^-1/2,
//    with round() to the input dtype, products in f32.
//    Replaces ldt_tpu/ops/pallas_attention.py::_bwd_kernel_packed_phased (and
//    _bwd_kernel_packed, the same function). Bound on an H100: bytes. At the
//    train step's shape (B=64, N=32, D=1024, 16 heads of dh=64, f32) it reads
//    33.6 MB and writes 25.2 MB, 0.0175 ms at 3.35 TB/s; its 0.34 G FMAs take
//    0.010 ms at 67 TFLOP/s. Fed from scalar shared loads (two a FMA of the
//    scores, dw, dk and dv), the shared-memory pipe sets a kernel's time, so
//    two schedules, chosen by self_bwd_tiled (rules.h; the entry reports the
//    one it launched, and the library exports the rule as
//    ldt_self_bwd_tiled):
//    - Register-tiled CUDA cores (packed_self_attention_bwd_tiled_kernel<T>)
//      where dh % 4 == 0, qkv, g and dqkv are 16-byte aligned and the tiled
//      layout fits: training's path. A block of 256 threads per (element,
//      head), four blocks a SM (44 KB of shared memory each at the train
//      step's shape); q, k, v and g staged into rows of stride lk_ld(dh), f32
//      by cp.async; K4's register-tiled products (4 x 4 tiles of the scores
//      and dw, of dk and dv, of dq, read as float4 slices: 8 FMAs a shared
//      load); dqkv written 16 bytes a store (f32). Every FMA chain runs in
//      the scalar kernel's order and the softmax rows are the same code: the
//      same bits.
//    - CUDA cores (packed_self_attention_bwd_kernel<T>) for the rest: a block
//      of 256 threads per (element, head), each element an FMA chain over
//      scalar shared loads.
// K2 ldt_cross_attention: the same function as K1 for q [B, N, D] against
//    k, v [B, M, D], any M. Replaces ldt_tpu/ops/pallas_attention.py::
//    _fwd_kernel (and the grouped schedule _fwd_kernel_grouped, which
//    computes the same). Two schedules, both on the CUDA cores in f32:
//    - Whole-set (dh <= 64 and a head's k and v fit in shared memory: the
//      decode's N=2048, M=32 and the encoder's N=M=32). Grid (128-row tile,
//      head, element); one thread owns one query row, its q row, a chunk of
//      32 scores and its output row in registers, and runs the row's softmax
//      alone. k and v sit in shared memory as f32 rows that every lane of a
//      warp reads at the same address, so one ld.shared.v4 broadcast feeds
//      4 FMAs of all 32 lanes. At the decode shape the bytes bound it (68 MB
//      in bf16, 0.020 ms on an H100) about as much as its 1.07 G f32 FMAs
//      (0.032 ms at 67 TFLOP/s). Past 32 keys the thread recomputes each
//      32-key chunk's scores, so its registers stay fixed for any M.
//    - Long-key (the rest: the posterior's N=32, M=2048). Split the keys,
//      not the rows, so that k and v are read once per row tile, not once
//      per block of rows: launch A, grid (128-key chunk x 32-row tile, head,
//      element), writes each row's chunk max m_c and sum_c exp(s - m_c);
//      launch B merges them in chunk order (m = max m_c, l = sum_c l_c
//      exp(m_c - m)), recomputes its chunk's scores, rounds the weights and
//      writes the f32 partial AV product of the chunk; launch C adds the
//      partials in chunk order. Scores and AV are register-tiled (4 rows x 4
//      keys, 4 rows x 4 channels a thread), so a shared load feeds 8 FMAs.
//      At the posterior shape (f32, B=64) it moves k twice, v once and the
//      partials twice, ~0.22 GB, so the bytes bound it (~0.065 ms).
//    No tensor cores: training runs K2 in f32, whose limits TF32 fails; a
//    bf16 mma.sync path for generation is later work. The two schedules no
//    longer give each other's bits (the merged row sum differs from a direct
//    one by a few f32 ulps); each repeats itself bit for bit, every sum in a
//    fixed order without atomics.
// K4 ldt_cross_attention_bwd: the backward of K2. From q [B, N, D], k, v
//    [B, M, D] and the output's gradient g [B, N, D] it recomputes the f32
//    weights and writes dq [B, N, D], dk and dv [B, M, D] with K3's formulas.
//    Replaces ldt_tpu/ops/pallas_attention.py::_bwd_kernel. Two schedules:
//    where a head's k and v fit in shared memory (M=32) each block keeps them
//    whole and takes a tile of query rows; dq is local to the block, and the
//    tiles' dk and dv partial sums (f32) go to a workspace that a second
//    launch sums in tile order (no atomics: a run repeats itself bit for
//    bit). Longer key sets (M=2048, with N=32) split the keys into chunks,
//    one block per (chunk, head, element) holding all N query rows: a first
//    launch writes each chunk's row max, exp-sum and dw-weighted exp-sum; a
//    second merges them in chunk order into the rows' softmax statistics and
//    D = rowsum(dw * w), writes the chunk's complete dk and dv and its dq
//    partial sums, which a third launch adds in chunk order. No block holds
//    a row's [M] weights.
//    Bound on an H100 at the stage-1 step's long shapes (B=16, 4 heads of
//    dh=32, f32): its 0.67 G FMAs, 0.020 ms at 67 TFLOP/s, above its 51-68
//    MB. The scalar products feed each FMA from scalar shared loads (two per
//    FMA of the scores and of dk/dv, one of dq), so the shared-memory pipe
//    set their time (~0.16 ms of loads at the long-query shape). Both
//    schedules therefore take register-tiled products where dh % 4 == 0,
//    q, k, v and g are 16-byte aligned and the tiled layout's shared memory
//    fits (cross_bwd_tiled in rules.h; the entry reports it, and the
//    library exports it as ldt_cross_bwd_tiled): q, g, k, v staged into
//    rows of stride lk_ld(dh) (f32 by cp.async, all in flight at once; the
//    long-key kernel merges the chunk statistics meanwhile), a thread owning
//    4 x 4 tiles of the scores and dw (rows x keys), of dk and dv (keys x
//    channels) and of dq (rows x channels), read as float4 slices, 8 FMAs a
//    shared load. The long-query kernel runs 512 threads, two blocks a SM
//    (its 128-row tile holds 79 KB of shared memory at the stage-1 shape),
//    so 16 warps share the softmax rows and a block's latency-bound phases
//    overlap the other's. The FMA chains run in the scalar kernels' order
//    (scores and dw over the channels, dk and dv over the rows, dq over the
//    keys, each ascending) and the softmax rows are the same code, so the
//    tiled kernels give the scalar kernels' bits; the scalar kernels stay
//    for the rest.
// K8 ldt_packed_self_attention_int8: K1 with int8 operands. q, k and v are
//    quantized to int8 with one symmetric scale each per group of `elems`
//    consecutive batch elements (max|x| / 127 + 1e-20 over the group's rows
//    and all heads), the scores and the AV product are int32 dots, and the
//    f32 softmax weights are quantized at the static scale 127 before AV.
//    Replaces ldt_tpu/ops/pallas_attention.py::
//    _fwd_kernel_packed_phased_multi_int8. Bound on an H100: bytes, as K1
//    (16.8 MB in bf16 at the generation shape, 0.0050 ms; its 0.27 G int8
//    operations take 0.0001 ms on the int8 tensor cores). Two schedules,
//    chosen by self_int8_mma (the entry point reports which it launched; no
//    Python mirror):
//    - Int8 tensor cores where N is a multiple of 16 in [16, 64], dh a
//      multiple of 32 and qkv and out 16-byte aligned (the generation path).
//      The scale pass reads each group over 3 x ceil(elems N / kScaleRows)
//      blocks (768 at B=64) with 16-byte loads and writes partial maxima,
//      which each block of the main kernel merges (a max is exact in any
//      order). The main kernel holds 4 heads a block and quantizes 16-byte
//      loads in registers into int8 codes in shared memory: q and k as rows,
//      v transposed (the AV product's column-major B operand; ldmatrix.trans
//      takes b16 only). A warp owns 16 query rows: mma.sync m16n8k32 s8
//      products (A and B by ldmatrix over int8 rows) give the int32 scores,
//      the f32 softmax runs the CUDA-core kernel's warp loop on them, its
//      weight codes go to int8 rows, and the AV product runs the same way
//      over v transposed (keys padded to 32 with zero codes). The dots are
//      exact (|dot| <= 127^2 dh), so the output and the scales have the
//      other schedule's bits.
//    - CUDA cores (int8_group_scales_kernel, one block per (group, q|k|v);
//      packed_self_attention_int8_kernel, one block per (element, head), K1's
//      layout with int32 copies of the codes) for every other input.
//
// Numerics of K1-K4 follow the TPU kernels: products accumulate in f32, the
// softmax runs in f32 (max-shifted, exp, divide by the row sum), and the
// weights are rounded to the input dtype before the AV product (K3, K4:
// before dv, and ds, taken from the unrounded weights, before dq and dk). K8
// rounds half to even (rintf, as jnp.round) and divides exactly: the build
// has no --use_fast_math, which would make `/` approximate.
//
// K1, K3 and K8 are memory-bound at the shapes the model gives them (N=32,
// dh=64, 16 heads), so each block reads its heads' operands from device
// memory once, keeps them and the scores in shared memory, and writes each
// output element once (K8 reads the packed qkv twice: once for the group
// scales). K4 at its long
// shapes (f32, dh=32) does five N x M x dh products for as many bytes, so
// f32 FMAs and bytes bound it about equally; it reads each operand once per
// block as well. The arithmetic runs on the CUDA cores in f32 (K1 in f32,
// K2-K4), on the bf16 tensor cores (K1 in bf16) and on the int8 tensor
// cores (K8 where its rule takes the shape; else int32 CUDA-core dots).
//
// C interface for ctypes: each entry point returns cudaGetLastError() after
// the launch (0 on success). dtype: 0 = float32, 1 = bfloat16.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

#include "rules.h"

namespace {

constexpr int kDtypeF32 = 0;
constexpr int kDtypeBF16 = 1;
// Above this a kernel needs cudaFuncAttributeMaxDynamicSharedMemorySize.
constexpr size_t kDefaultSmem = 48 * 1024;

constexpr int kSelfThreads = 256;
// K1's tensor-core schedule: heads per block, the most tokens it takes (a
// warp per 16 query rows, scores of up to 64 keys in registers), and the
// padding of its shared-memory rows (bf16). ldt_torch/ops/attention.py
// mirrors all three.
constexpr int kMmaHeads = 4;
constexpr int kMmaMaxN = 64;
constexpr int kMmaPad = 8;
// K1's register-tiled f32 schedule: heads and threads per block
// (ldt_torch/ops/attention.py mirrors kTileHeads).
constexpr int kTileHeads = 2;
constexpr int kTileThreads = 256;
// K8's scale reduction: threads per (group, q|k|v) block; rows per block of
// the int8 tensor-core schedule's scale pass.
constexpr int kScaleThreads = 512;
constexpr int kScaleRows = 8;
// K2's whole-set schedule: threads (query rows) per block, the widest head
// it takes in registers, and keys per register chunk of scores.
// K2's long-key schedule: threads per block, query rows per block (4 per
// warp), and the most keys per chunk (fewer, down to kLkMinKeys, where a
// wide head would not fit). ldt_torch/ops/attention.py mirrors all six.
constexpr int kWholeThreads = 128;
constexpr int kWholeMaxDh = 64;
constexpr int kWholeChunk = 32;
constexpr int kLkThreads = 256;
constexpr int kLkRows = 32;
constexpr int kLkKeys = 128;
constexpr int kLkMinKeys = 32;
// K4: threads per block (its keys per long-key tile, kBwdKeys, are in
// rules.h).
constexpr int kBwdThreads = 256;
// Threads of K4's register-tiled long-query kernel: 16 warps share its
// softmax rows, and two blocks fit a SM (their registers are bounded to
// that, and the shared memory at the stage-1 shape leaves room).
constexpr int kBwdLqThreads = 512;
// K3's register-tiled kernel: threads per block (one head), and the blocks
// a SM holds (their registers are bounded to that, 64 a thread; 44 KB of
// shared memory each at the train step's shape). Of 128 (5 blocks), 192
// (5), 256 (4) and 384 (3) threads, 256 took the least time there.
constexpr int kSelfBwdTileThreads = 256;
constexpr int kSelfBwdTileBlocks = 4;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);  // round to nearest even
}

// x rounded to T's precision, as a float (the weights before AV).
template <typename T>
__device__ __forceinline__ float round_to(float x) {
  return to_f32(from_f32<T>(x));
}

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// One f32 score row of n in shared memory, one warp: s[c] = exp(s[c] -
// max) in place, lane l taking c = l, l + 32, ...; returns the row sum (the
// same in every lane). Every schedule of K1 and K8 runs its softmax through
// this, so their weights have the same bits.
__device__ __forceinline__ float softmax_exp_row(float* s, int n, int lane) {
  float mx = -INFINITY;
  for (int c = lane; c < n; c += 32) mx = fmaxf(mx, s[c]);
  mx = warp_max(mx);
  float sum = 0.f;
  for (int c = lane; c < n; c += 32) {
    const float e = expf(s[c] - mx);
    s[c] = e;
    sum += e;
  }
  return warp_sum(sum);
}

// K8's weight code of a softmax numerator e over the row sum:
// clip(round(w * 127), 0, 127), as an exact small float.
__device__ __forceinline__ float weight_code(float e, float sum) {
  return fminf(fmaxf(rintf((e / sum) * 127.0f), 0.f), 127.f);
}

// Shared memory of K1: q [n, dh], k [n, dh+1] (odd stride: lanes reading
// different keys hit different banks), v [n, dh], scores [n, n]; all f32.
size_t self_smem_bytes(int n, int dh) {
  return sizeof(float) *
         ((size_t)n * dh + (size_t)n * (dh + 1) + (size_t)n * dh +
          (size_t)n * n);
}

// Shared memory of K1's tensor-core schedule: q, k and v of kMmaHeads heads,
// [n, dh + kMmaPad] bf16 each.
size_t self_mma_smem_bytes(int n, int dh) {
  return sizeof(__nv_bfloat16) * 3 * kMmaHeads * (size_t)n * (dh + kMmaPad);
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

// K1's schedule rule: the tensor cores take bf16 with n a multiple of 16 in
// [16, kMmaMaxN], dh of 16, 32, 64 or 128, and 16-byte aligned qkv and out;
// the CUDA-core kernel takes the rest.
bool self_mma(int n, int dh, int dtype, const void* qkv, const void* out) {
  return dtype == kDtypeBF16 && n % 16 == 0 && n >= 16 && n <= kMmaMaxN &&
         (dh == 16 || dh == 32 || dh == 64 || dh == 128) && aligned16(qkv) &&
         aligned16(out) && self_mma_smem_bytes(n, dh) <= kMaxSmem;
}

// K2's whole-set schedule keeps a head of width dh in registers of width
// 16, 32, 48 or 64 (zero-padded); 0 where dh is wider.
int whole_width(int dh) {
  return dh > kWholeMaxDh ? 0 : (dh + 15) / 16 * 16;
}

// Shared memory of K2's whole-set schedule: k and v [m, width], f32.
size_t cross_whole_smem_bytes(int m, int dh) {
  return sizeof(float) * 2 * (size_t)m * whole_width(dh);
}

// Row stride of the long-key schedule's weights, stored [key][row].
constexpr int kLkLdw = kLkRows + 4;

// Shared memory of the long-key schedule's launch B (launch A uses less):
// q [kLkRows, ld], the chunk's k [keys, ld] (then its weights [keys,
// kLkLdw]), v [keys, ld], and the rows' merged max and sum; f32.
size_t cross_lk_smem_bytes(int dh, int keys) {
  const size_t ld = lk_ld(dh);
  return sizeof(float) *
         ((size_t)kLkRows * ld + (size_t)keys * (ld > kLkLdw ? ld : kLkLdw) +
          (size_t)keys * ld + 2 * kLkRows);
}

// Keys per chunk of the long-key schedule: the most, from kLkKeys down to
// kLkMinKeys, whose shared memory fits; 0 if none does.
int cross_lk_keys(int dh) {
  for (int keys = kLkKeys; keys >= kLkMinKeys; keys >>= 1)
    if (cross_lk_smem_bytes(dh, keys) <= kMaxSmem) return keys;
  return 0;
}

// Shared memory of K4's long-query schedule with `rows` query rows per block:
// k and v [m, dh+1], the rows' q and g [rows, dh], and their weights and ds
// [rows, m]; all f32.
size_t cross_bwd_lq_smem_bytes(int m, int dh, int rows) {
  return sizeof(float) * (2 * (size_t)m * (dh + 1) + 2 * (size_t)rows * dh +
                          2 * (size_t)rows * m);
}

// Shared memory of K4's long-key schedule (either launch): q and g [n, dh],
// the chunk's k and v [kBwdKeys, dh+1], the rows' scores (weights) and dw
// (ds) over the chunk [n, kBwdKeys], and per row its max, sum and D; f32.
size_t cross_bwd_lk_smem_bytes(int n, int dh) {
  return sizeof(float) * (2 * (size_t)n * dh + 2 * (size_t)kBwdKeys * (dh + 1) +
                          2 * (size_t)n * kBwdKeys + 3 * (size_t)n);
}

// Shared memory of K1's register-tiled schedule: per head q (then v) and k
// [n4, lk_ld(dh)] and the scores [n4, n4 + 8], n4 = n rounded up to 4; f32.
size_t self_tiled_smem_bytes(int n, int dh) {
  const size_t n4 = (n + 3) / 4 * 4;
  return sizeof(float) * kTileHeads * (2 * n4 * lk_ld(dh) + n4 * (n4 + 8));
}

// K1's register-tiled rule: f32, dh a multiple of 4, 16-byte aligned qkv
// and out, and the shared memory of kTileHeads heads within a block's.
bool self_tiled(int n, int dh, int dtype, const void* qkv, const void* out) {
  return dtype == kDtypeF32 && dh % 4 == 0 && aligned16(qkv) &&
         aligned16(out) && self_tiled_smem_bytes(n, dh) <= kMaxSmem;
}

// Shared memory of K8's int8 tensor-core schedule: the group's 3 scales
// (16 bytes), then per head the f32 scores [n, n + 8], the q and k codes
// [n, dh + 16], the v codes transposed [dh, np + 16] and the weight codes
// [n, np + 16], np = n rounded up to 32 (the keys of an m16n8k32 step; the
// padding holds zero codes).
size_t self_int8_mma_smem_bytes(int n, int dh) {
  const size_t np = (n + 31) / 32 * 32;
  return 16 + kMmaHeads * (sizeof(float) * n * (n + 8) +
                           2 * (size_t)n * (dh + 16) +
                           ((size_t)dh + n) * (np + 16));
}

// K8's rule: the int8 tensor cores take n a multiple of 16 in [16,
// kMmaMaxN], dh a multiple of 32, 16-byte aligned qkv and out; the
// CUDA-core kernels take the rest.
bool self_int8_mma(int n, int dh, int elems, const void* qkv,
                   const void* out) {
  return n % 16 == 0 && n >= 16 && n <= kMmaMaxN && dh % 32 == 0 &&
         aligned16(qkv) && aligned16(out) &&
         self_int8_mma_smem_bytes(n, dh) <= kMaxSmem &&
         ((long long)elems * n + kScaleRows - 1) / kScaleRows <= 65535;
}

// One block per (batch element, head).
template <typename T>
__global__ void __launch_bounds__(kSelfThreads)
packed_self_attention_kernel(const T* __restrict__ qkv, T* __restrict__ out,
                             int n, int d, int dh, float scale) {
  extern __shared__ float smem[];
  const int b = blockIdx.x;
  const int h = blockIdx.y;
  const int ldk = dh + 1;
  float* qs = smem;
  float* ks = qs + (size_t)n * dh;
  float* vs = ks + (size_t)n * ldk;
  float* ss = vs + (size_t)n * dh;

  const size_t row = 3 * (size_t)d;
  const T* base = qkv + (size_t)b * n * row + (size_t)h * dh;
  for (int i = threadIdx.x; i < n * dh; i += blockDim.x) {
    const int r = i / dh;
    const int c = i - r * dh;
    const T* p = base + r * row + c;
    qs[i] = to_f32(p[0]);
    ks[r * ldk + c] = to_f32(p[d]);
    vs[i] = to_f32(p[2 * (size_t)d]);
  }
  __syncthreads();

  // scores: thread i owns (query r, key c)
  for (int i = threadIdx.x; i < n * n; i += blockDim.x) {
    const int r = i / n;
    const int c = i - r * n;
    const float* q = qs + (size_t)r * dh;
    const float* k = ks + (size_t)c * ldk;
    float acc = 0.f;
    for (int j = 0; j < dh; ++j) acc = fmaf(q[j], k[j], acc);
    ss[i] = acc * scale;
  }
  __syncthreads();

  // row softmax, one warp per row
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int nwarps = blockDim.x >> 5;
  for (int r = warp; r < n; r += nwarps) {
    float* s = ss + (size_t)r * n;
    const float sum = softmax_exp_row(s, n, lane);
    for (int c = lane; c < n; c += 32) s[c] = round_to<T>(s[c] / sum);
  }
  __syncthreads();

  // AV: thread i owns output (query r, channel c)
  T* obase = out + (size_t)b * n * d + (size_t)h * dh;
  for (int i = threadIdx.x; i < n * dh; i += blockDim.x) {
    const int r = i / dh;
    const int c = i - r * dh;
    const float* w = ss + (size_t)r * n;
    float acc = 0.f;
    for (int m = 0; m < n; ++m) acc = fmaf(w[m], vs[(size_t)m * dh + c], acc);
    obase[(size_t)r * d + c] = from_f32<T>(acc);
  }
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes from global memory into shared memory, asynchronously.
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::
                   : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Four 8x8 b16 matrices from shared memory; lane l gives the address of row
// l % 8 of matrix l / 8, and receives row l / 4, columns 2 (l % 4) and
// 2 (l % 4) + 1 of each (of its transpose with `trans`).
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

// d += a b: a 16x16 bf16 (row-major fragment), b 16x8 bf16 (column-major),
// d 16x8 f32.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d += a b: a 16x32 s8 (row-major fragment), b 32x8 s8 (column-major), d
// 16x8 s32. The fragments hold 4 bytes where m16n8k16 holds 2 b16 values,
// so the same ldmatrix addressing loads them from int8 rows.
__device__ __forceinline__ void mma_s8(int (&d)[4], const uint32_t (&a)[4],
                                       uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// (lo, hi) rounded to bf16 (nearest even), lo in the low half.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

// K1 on the tensor cores (the header's first schedule). Grid (element,
// group of kMmaHeads heads); n / 16 warps per head. In a warp, lane l is
// (g, t) = (l / 4, l % 4): its accumulator fragment of an m16n8 tile holds
// rows g and g + 8, columns 2t and 2t + 1.
template <int DH>
__global__ void __launch_bounds__(kMmaHeads* kMmaMaxN / 16 * 32)
packed_self_attention_mma_kernel(const __nv_bfloat16* __restrict__ qkv,
                                 __nv_bfloat16* __restrict__ out, int n,
                                 int h, float scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* smem = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  constexpr int LD = DH + kMmaPad;  // row stride in shared memory
  constexpr int CH = DH / 8;        // 16-byte chunks per row
  constexpr int KT = DH / 16;       // k-steps of the scores
  constexpr int NT = kMmaMaxN / 8;  // most key tiles of 8
  constexpr int OT = DH / 8;        // output tiles of 8 channels
  const int d = h * DH;
  const int b = blockIdx.x;
  const int h0 = blockIdx.y * kMmaHeads;
  const int heads = min(kMmaHeads, h - h0);
  const size_t row = 3 * (size_t)d;
  const int per_head = 3 * n * LD;  // [q|k|v][n][LD] per head

  // q, k, v of the block's heads: consecutive threads take consecutive 16
  // bytes of a token's row (the heads of one of q, k, v are adjacent)
  const __nv_bfloat16* base = qkv + (size_t)b * n * row + (size_t)h0 * DH;
  const int chunks = heads * 3 * n * CH;
  for (int i = threadIdx.x; i < chunks; i += blockDim.x) {
    const int c = i % CH;
    int t = i / CH;
    const int hh = t % heads;
    t /= heads;
    const int which = t % 3;
    const int r = t / 3;
    cp_async16(smem + hh * per_head + (which * n + r) * LD + c * 8,
               base + r * row + (size_t)which * d + hh * DH + c * 8);
  }
  cp_async_wait_all();
  __syncthreads();

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int wph = n >> 4;  // warps per head
  const int hh = warp / wph;
  if (hh >= heads) return;
  const int r0 = (warp - hh * wph) * 16;
  const int nt = n >> 3;
  __nv_bfloat16* qs = smem + hh * per_head;
  const __nv_bfloat16* ks = qs + n * LD;
  const __nv_bfloat16* vs = ks + n * LD;

  // scores of the warp's 16 rows against all keys, f32
  uint32_t qa[KT][4];
#pragma unroll
  for (int kk = 0; kk < KT; ++kk)
    ldmatrix_x4(qa[kk], qs + (r0 + (lane & 15)) * LD + kk * 16 +
                            (lane >> 4) * 8);
  float s[NT][4];
#pragma unroll
  for (int j = 0; j < NT; j += 2) {
    if (j < nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = s[j + 1][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < KT; ++kk) {
        // keys 8j..8j+15, channels 16kk..16kk+15: two B fragments
        uint32_t kb[4];
        ldmatrix_x4(kb, ks + (j * 8 + (lane & 7) + ((lane >> 4) << 3)) * LD +
                            kk * 16 + ((lane >> 3) & 1) * 8);
        mma_bf16(s[j], qa[kk], kb[0], kb[1]);
        mma_bf16(s[j + 1], qa[kk], kb[2], kb[3]);
      }
    }
  }

  // softmax of rows g (elements 0, 1) and g + 8 (elements 2, 3)
  float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    if (j < nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] *= scale;
      mx0 = fmaxf(mx0, fmaxf(s[j][0], s[j][1]));
      mx1 = fmaxf(mx1, fmaxf(s[j][2], s[j][3]));
    }
  }
#pragma unroll
  for (int o = 1; o <= 2; o <<= 1) {
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, o));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, o));
  }
  float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    if (j < nt) {
      s[j][0] = expf(s[j][0] - mx0);
      s[j][1] = expf(s[j][1] - mx0);
      s[j][2] = expf(s[j][2] - mx1);
      s[j][3] = expf(s[j][3] - mx1);
      sum0 += s[j][0] + s[j][1];
      sum1 += s[j][2] + s[j][3];
    }
  }
#pragma unroll
  for (int o = 1; o <= 2; o <<= 1) {
    sum0 += __shfl_xor_sync(0xffffffffu, sum0, o);
    sum1 += __shfl_xor_sync(0xffffffffu, sum1, o);
  }

  // AV: the rounded weights of key tiles 2kk and 2kk + 1 are the A fragment
  // of keys 16kk..16kk+15
  float acc[OT][4];
#pragma unroll
  for (int jn = 0; jn < OT; ++jn)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[jn][e] = 0.f;
#pragma unroll
  for (int kk = 0; kk < NT / 2; ++kk) {
    if (2 * kk < nt) {
      uint32_t wa[4];
      wa[0] = pack_bf16(s[2 * kk][0] / sum0, s[2 * kk][1] / sum0);
      wa[1] = pack_bf16(s[2 * kk][2] / sum1, s[2 * kk][3] / sum1);
      wa[2] = pack_bf16(s[2 * kk + 1][0] / sum0, s[2 * kk + 1][1] / sum0);
      wa[3] = pack_bf16(s[2 * kk + 1][2] / sum1, s[2 * kk + 1][3] / sum1);
#pragma unroll
      for (int jn = 0; jn < OT; jn += 2) {
        // keys 16kk..16kk+15, channels 8jn..8jn+15: two B fragments
        uint32_t vb[4];
        ldmatrix_x4_trans(vb, vs + (kk * 16 + (lane & 15)) * LD + jn * 8 +
                                  (lane >> 4) * 8);
        mma_bf16(acc[jn], wa, vb[0], vb[1]);
        mma_bf16(acc[jn + 1], wa, vb[2], vb[3]);
      }
    }
  }

  // out: through the warp's own q rows (read only by this warp, above)
  __syncwarp();
  __nv_bfloat16* os = qs + r0 * LD;
  const int g = lane >> 2;
  const int t2 = (lane & 3) * 2;
#pragma unroll
  for (int jn = 0; jn < OT; ++jn) {
    *reinterpret_cast<uint32_t*>(os + g * LD + jn * 8 + t2) =
        pack_bf16(acc[jn][0], acc[jn][1]);
    *reinterpret_cast<uint32_t*>(os + (g + 8) * LD + jn * 8 + t2) =
        pack_bf16(acc[jn][2], acc[jn][3]);
  }
  __syncwarp();
  __nv_bfloat16* ob = out + ((size_t)b * n + r0) * d + (size_t)(h0 + hh) * DH;
  for (int i = lane; i < 16 * CH; i += 32) {
    const int r = i / CH;
    const int c = i - r * CH;
    *reinterpret_cast<uint4*>(ob + (size_t)r * d + c * 8) =
        *reinterpret_cast<const uint4*>(os + r * LD + c * 8);
  }
}

// Component e (0-3, known at compile time once unrolled) of v.
__device__ __forceinline__ float lane4(const float4& v, int e) {
  return e == 0 ? v.x : e == 1 ? v.y : e == 2 ? v.z : v.w;
}

// K1 on the CUDA cores in f32, register-tiled (the header's second
// schedule). Grid (element, group of kTileHeads heads), kTileThreads
// threads. With n4 = n rounded up to 4 and rn = n4 / 4, a thread's 4 x 4
// tile of scores holds query rows rt + rn i and keys kt + rn j (i, j < 4),
// so the 8 lanes of a quarter warp read one q row (a broadcast) and 8
// consecutive k rows (lk_ld: 8 bank groups) as float4; a 4 x 4 output tile
// holds rows rt + rn i and channels 4 ct .. 4 ct + 3. v comes into q's rows
// once the scores are taken, its copy in flight during the softmax. Each
// score is the chain fmaf(q[j], k[j], acc) over j ascending times scale,
// and each output fmaf(w[m], v[m][c], acc) over m ascending, as in
// packed_self_attention_kernel: the same bits.
__global__ void __launch_bounds__(kTileThreads)
packed_self_attention_tiled_kernel(const float* __restrict__ qkv,
                                   float* __restrict__ out, int n, int h,
                                   int dh, float scale) {
  extern __shared__ __align__(16) float smem_f[];
  const int ld = lk_ld(dh);
  const int rn = (n + 3) / 4;
  const int n4 = 4 * rn;
  const int lds = n4 + 8;  // score row stride
  const int d = h * dh;
  const int b = blockIdx.x;
  const int h0 = blockIdx.y * kTileHeads;
  const int heads = min(kTileHeads, h - h0);
  const int per_head = 2 * n4 * ld + n4 * lds;  // q (then v) | k | scores
  const size_t row = 3 * (size_t)d;

  // q and k (which 0, 1), or v into q's rows (which 2), of the block's
  // heads by 16-byte copies, consecutive threads on consecutive bytes of a
  // token's row; q and k rows [n, n4) zero
  const int ch = dh / 4;
  const float* base = qkv + (size_t)b * n * row + (size_t)h0 * dh;
  auto copy = [&](int which, int rows) {
    const int parts = which == 2 ? 1 : 2;
    const int chunks = heads * parts * rows * ch;
    for (int i = threadIdx.x; i < chunks; i += blockDim.x) {
      const int c = i % ch;
      int t = i / ch;
      const int hh = t % heads;
      t /= heads;
      const int w = which == 2 ? 2 : t % 2;
      const int r = which == 2 ? t : t / 2;
      float* dst = smem_f + hh * per_head + ((w & 1) * n4 + r) * ld + c * 4;
      if (r < n)
        cp_async16(dst, base + r * row + (size_t)w * d + hh * dh + c * 4);
      else
        *reinterpret_cast<float4*>(dst) = make_float4(0.f, 0.f, 0.f, 0.f);
    }
  };
  copy(0, n4);
  cp_async_wait_all();
  __syncthreads();

  // scores, a 4 x 4 register tile a step
  const int tiles = rn * rn;
  for (int t = threadIdx.x; t < heads * tiles; t += blockDim.x) {
    const int hh = t / tiles;
    const int rt = (t - hh * tiles) / rn;
    const int kt = t - hh * tiles - rt * rn;
    const float* qs = smem_f + hh * per_head + rt * ld;
    const float* ks = smem_f + hh * per_head + (n4 + kt) * ld;
    float acc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
    for (int c = 0; c < dh; c += 4) {
      float4 qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        qv[i] = *reinterpret_cast<const float4*>(qs + i * rn * ld + c);
        kv[i] = *reinterpret_cast<const float4*>(ks + i * rn * ld + c);
      }
#pragma unroll
      for (int e = 0; e < 4; ++e)
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j)
            acc[i][j] = fmaf(lane4(qv[i], e), lane4(kv[j], e), acc[i][j]);
    }
    float* ss = smem_f + hh * per_head + 2 * n4 * ld;
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int r = rt + rn * i;
        const int k = kt + rn * j;
        if (r < n && k < n) ss[r * lds + k] = acc[i][j] * scale;
      }
  }
  __syncthreads();
  copy(2, n);  // v over q, in flight during the softmax
  cp_async_commit();

  // row softmax, one warp per row
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int nwarps = blockDim.x >> 5;
  for (int t = warp; t < heads * n; t += nwarps) {
    const int hh = t / n;
    float* s = smem_f + hh * per_head + 2 * n4 * ld + (t - hh * n) * lds;
    const float sum = softmax_exp_row(s, n, lane);
    for (int c = lane; c < n; c += 32) s[c] = s[c] / sum;
  }
  cp_async_wait_all();
  __syncthreads();

  // AV, a 4 x 4 register tile a step: float4 reads of 4 weights of a row
  // (a broadcast across the quarter warp) and of 4 channels of a v row
  const int cn = dh / 4;
  const int otiles = rn * cn;
  for (int t = threadIdx.x; t < heads * otiles; t += blockDim.x) {
    const int hh = t / otiles;
    const int rt = (t - hh * otiles) / cn;
    const int ct = t - hh * otiles - rt * cn;
    const float* vs = smem_f + hh * per_head + 4 * ct;
    const float* ws = smem_f + hh * per_head + 2 * n4 * ld + rt * lds;
    float acc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
    int m = 0;
    for (; m + 4 <= n; m += 4) {
      float4 wv[4], vv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        wv[i] = *reinterpret_cast<const float4*>(ws + i * rn * lds + m);
        vv[i] = *reinterpret_cast<const float4*>(vs + (m + i) * ld);
      }
#pragma unroll
      for (int e = 0; e < 4; ++e)
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j)
            acc[i][j] = fmaf(lane4(wv[i], e), lane4(vv[e], j), acc[i][j]);
    }
    for (; m < n; ++m) {
      const float4 vv = *reinterpret_cast<const float4*>(vs + m * ld);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float w = ws[i * rn * lds + m];
#pragma unroll
        for (int j = 0; j < 4; ++j)
          acc[i][j] = fmaf(w, lane4(vv, j), acc[i][j]);
      }
    }
    float* ob = out + (size_t)b * n * d + (size_t)(h0 + hh) * dh + 4 * ct;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = rt + rn * i;
      if (r < n)
        *reinterpret_cast<float4*>(ob + (size_t)r * d) =
            make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
    }
  }
}

// Elements of T in 16 bytes: one vector load or store.
template <typename T>
constexpr int kVec = 16 / (int)sizeof(T);

// 16 bytes of T at p (16-byte aligned) as f32, into dst[0, kVec<T>).
__device__ __forceinline__ void load16(const float* p, float* dst) {
  const float4 x = *reinterpret_cast<const float4*>(p);
  dst[0] = x.x;
  dst[1] = x.y;
  dst[2] = x.z;
  dst[3] = x.w;
}
__device__ __forceinline__ void load16(const __nv_bfloat16* p, float* dst) {
  const uint4 x = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&x);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    dst[2 * i] = f.x;
    dst[2 * i + 1] = f.y;
  }
}

// src[0, kVec<T>) rounded to T, stored as 16 bytes at p (16-byte aligned).
__device__ __forceinline__ void store16(float* p, const float* src) {
  *reinterpret_cast<float4*>(p) = make_float4(src[0], src[1], src[2], src[3]);
}
__device__ __forceinline__ void store16(__nv_bfloat16* p, const float* src) {
  uint4 x;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&x);
#pragma unroll
  for (int i = 0; i < 4; ++i)
    h[i] = __floats2bfloat162_rn(src[2 * i], src[2 * i + 1]);  // nearest even
  *reinterpret_cast<uint4*>(p) = x;
}

// K2's staging: rows [0, rows) of a slice of width dh and row stride
// `stride` (elements of T) into dst [rows, ld] as f32, zero in columns
// [dh, width) and in rows [valid, rows). width is a multiple of 8 and ld of
// 4; with `vec` every row starts 16-byte aligned and dh is a multiple of
// kVec<T>, and each thread moves 16 bytes at a time.
template <typename T>
__device__ __forceinline__ void stage_rows(float* dst, int ld,
                                           const T* __restrict__ src,
                                           size_t stride, int rows, int valid,
                                           int dh, int width, bool vec) {
  if (vec) {
    constexpr int V = kVec<T>;
    const int groups = width / V;
    for (int i = threadIdx.x; i < rows * groups; i += blockDim.x) {
      const int r = i / groups;
      const int c = (i - r * groups) * V;
      float x[V];
      if (r < valid && c < dh) {
        load16(src + r * stride + c, x);
      } else {
#pragma unroll
        for (int e = 0; e < V; ++e) x[e] = 0.f;
      }
#pragma unroll
      for (int e = 0; e < V; e += 4)
        *reinterpret_cast<float4*>(dst + (size_t)r * ld + c + e) =
            make_float4(x[e], x[e + 1], x[e + 2], x[e + 3]);
    }
  } else {
    for (int i = threadIdx.x; i < rows * width; i += blockDim.x) {
      const int r = i / width;
      const int c = i - r * width;
      dst[(size_t)r * ld + c] =
          r < valid && c < dh ? to_f32(src[r * stride + c]) : 0.f;
    }
  }
}

// One row of width dh at p into x[0, W) as f32, zero past dh.
template <typename T, int W>
__device__ __forceinline__ void load_row(const T* __restrict__ p, int dh,
                                         bool vec, float (&x)[W]) {
  if (vec) {
    constexpr int V = kVec<T>;
#pragma unroll
    for (int c = 0; c < W; c += V) {
      if (c < dh) {
        load16(p + c, x + c);
      } else {
#pragma unroll
        for (int e = 0; e < V; ++e) x[c + e] = 0.f;
      }
    }
  } else {
#pragma unroll
    for (int c = 0; c < W; ++c) x[c] = c < dh ? to_f32(p[c]) : 0.f;
  }
}

// x[0, dh) rounded to T into the row at p.
template <typename T, int W>
__device__ __forceinline__ void store_row(T* __restrict__ p, int dh, bool vec,
                                          const float (&x)[W]) {
  if (vec) {
    constexpr int V = kVec<T>;
#pragma unroll
    for (int c = 0; c < W; c += V)
      if (c < dh) store16(p + c, x + c);
  } else {
#pragma unroll
    for (int c = 0; c < W; ++c)
      if (c < dh) p[c] = from_f32<T>(x[c]);
  }
}

// K2's whole-set schedule. Grid (128-row tile, head, element); thread i of
// the block owns query row 128 * tile + i. The head's k and v stay in shared
// memory as [m, W] f32 rows (W = whole_width(dh), zero-padded), read by all
// lanes of a warp at one address (a broadcast). The thread keeps its q row,
// the scores of 32 keys and its output row in registers: pass 1 finds the
// row max, pass 2 the sum of exp(s - max), pass 3 forms the weights (divided
// by the sum, rounded to T) and the AV product, every sum in key order.
// With more than 32 keys each pass recomputes a chunk's scores.
template <typename T, int W>
__global__ void __launch_bounds__(kWholeThreads)
cross_attention_whole_kernel(const T* __restrict__ q, const T* __restrict__ k,
                             const T* __restrict__ v, T* __restrict__ out,
                             int n, int m, int d, int dh, float scale,
                             int vec) {
  extern __shared__ float smem[];
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  float* ks = smem;                    // [m, W]
  float* vs = ks + (size_t)m * W;      // [m, W]
  const size_t kv0 = (size_t)b * m * d + (size_t)h * dh;
  stage_rows(ks, W, k + kv0, d, m, m, dh, W, vec);
  stage_rows(vs, W, v + kv0, d, m, m, dh, W, vec);
  const int r = blockIdx.x * kWholeThreads + threadIdx.x;
  const size_t o0 = ((size_t)b * n + r) * d + (size_t)h * dh;
  float qr[W];
  if (r < n) load_row<T, W>(q + o0, dh, vec, qr);
  __syncthreads();
  if (r >= n) return;

  float s[kWholeChunk];
  // s[i]: the score of key j0 + i, -inf past m
  auto scores = [&](int j0) {
#pragma unroll
    for (int i = 0; i < kWholeChunk; ++i) {
      float acc = -INFINITY;
      if (j0 + i < m) {
        const float4* kr =
            reinterpret_cast<const float4*>(ks + (size_t)(j0 + i) * W);
        acc = 0.f;
#pragma unroll
        for (int c = 0; c < W / 4; ++c) {
          const float4 kk = kr[c];
          acc = fmaf(qr[4 * c], kk.x, acc);
          acc = fmaf(qr[4 * c + 1], kk.y, acc);
          acc = fmaf(qr[4 * c + 2], kk.z, acc);
          acc = fmaf(qr[4 * c + 3], kk.w, acc);
        }
        acc *= scale;
      }
      s[i] = acc;
    }
  };
  const bool one_chunk = m <= kWholeChunk;
  float mx = -INFINITY;
  for (int j0 = 0; j0 < m; j0 += kWholeChunk) {
    scores(j0);
#pragma unroll
    for (int i = 0; i < kWholeChunk; ++i) mx = fmaxf(mx, s[i]);
  }
  float sum = 0.f;
  for (int j0 = 0; j0 < m; j0 += kWholeChunk) {
    if (!one_chunk) scores(j0);
#pragma unroll
    for (int i = 0; i < kWholeChunk; ++i) {
      s[i] = expf(s[i] - mx);  // 0 past m
      sum += s[i];
    }
  }
  float o[W];
#pragma unroll
  for (int c = 0; c < W; ++c) o[c] = 0.f;
  for (int j0 = 0; j0 < m; j0 += kWholeChunk) {
    if (!one_chunk) {
      scores(j0);
#pragma unroll
      for (int i = 0; i < kWholeChunk; ++i) s[i] = expf(s[i] - mx);
    }
#pragma unroll
    for (int i = 0; i < kWholeChunk; ++i) {
      if (j0 + i < m) {
        const float w = round_to<T>(s[i] / sum);
        const float4* vr =
            reinterpret_cast<const float4*>(vs + (size_t)(j0 + i) * W);
#pragma unroll
        for (int c = 0; c < W / 4; ++c) {
          const float4 vv = vr[c];
          o[4 * c] = fmaf(w, vv.x, o[4 * c]);
          o[4 * c + 1] = fmaf(w, vv.y, o[4 * c + 1]);
          o[4 * c + 2] = fmaf(w, vv.z, o[4 * c + 2]);
          o[4 * c + 3] = fmaf(w, vv.w, o[4 * c + 3]);
        }
      }
    }
  }
  store_row<T, W>(out + o0, dh, vec, o);
}

// The long-key schedule's scores: warp w's query rows [4w, 4w + 4) of qs
// against keys lane + 32 i (i < KPL) of ks, each a dot over `width` columns
// in column order, times scale. Launches A and B run this same code, so B
// recomputes A's bits.
template <int KPL>
__device__ __forceinline__ void lk_scores(const float* qs, const float* ks,
                                          int ld, int width, float scale,
                                          float (&s)[4][KPL]) {
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const float* q0 = qs + (size_t)(4 * warp) * ld;
  const float* k0 = ks + (size_t)lane * ld;
  float acc[4][KPL];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int i = 0; i < KPL; ++i) acc[a][i] = 0.f;
  for (int c = 0; c < width; c += 4) {
    float4 qv[4], kv[KPL];
#pragma unroll
    for (int a = 0; a < 4; ++a)
      qv[a] = *reinterpret_cast<const float4*>(q0 + (size_t)a * ld + c);
#pragma unroll
    for (int i = 0; i < KPL; ++i)
      kv[i] = *reinterpret_cast<const float4*>(k0 + (size_t)(32 * i) * ld + c);
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int i = 0; i < KPL; ++i) {
        acc[a][i] = fmaf(qv[a].x, kv[i].x, acc[a][i]);
        acc[a][i] = fmaf(qv[a].y, kv[i].y, acc[a][i]);
        acc[a][i] = fmaf(qv[a].z, kv[i].z, acc[a][i]);
        acc[a][i] = fmaf(qv[a].w, kv[i].w, acc[a][i]);
      }
  }
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int i = 0; i < KPL; ++i) s[a][i] = acc[a][i] * scale;
}

// Launches A and B of the long-key schedule share this grid: x = row tile *
// chunks + chunk (kLkRows rows, 32 * KPL keys), y = head, z = element.
struct LkBlock {
  int chunk, r0, t0, nr, tm, h, b;
  __device__ LkBlock(int n, int m, int chunks, int keys) {
    chunk = blockIdx.x % chunks;
    r0 = (blockIdx.x / chunks) * kLkRows;
    t0 = chunk * keys;
    nr = min(kLkRows, n - r0);
    tm = min(keys, m - t0);
    h = blockIdx.y;
    b = blockIdx.z;
  }
};

// K2's long-key launch A: per query row, the chunk's score max m_c and
// sum_c exp(s - m_c) into stats [element][head][chunk][n][2].
template <typename T, int KPL>
__global__ void __launch_bounds__(kLkThreads)
cross_attention_lk_stats_kernel(const T* __restrict__ q,
                                const T* __restrict__ k,
                                float* __restrict__ stats, int n, int m,
                                int d, int dh, int chunks, float scale,
                                int vec) {
  extern __shared__ float smem[];
  constexpr int kKeys = 32 * KPL;
  const LkBlock blk(n, m, chunks, kKeys);
  const int ld = lk_ld(dh);
  float* qs = smem;                          // [kLkRows, ld]
  float* ks = qs + (size_t)kLkRows * ld;     // [kKeys, ld]
  const size_t head = (size_t)blk.h * dh;
  stage_rows(qs, ld, q + ((size_t)blk.b * n + blk.r0) * d + head, d, kLkRows,
             blk.nr, dh, ld - 4, vec);
  stage_rows(ks, ld, k + ((size_t)blk.b * m + blk.t0) * d + head, d, kKeys,
             blk.tm, dh, ld - 4, vec);
  __syncthreads();
  float s[4][KPL];
  lk_scores<KPL>(qs, ks, ld, ld - 4, scale, s);

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  float* st = stats + (((size_t)blk.b * gridDim.y + blk.h) * chunks +
                       blk.chunk) * n * 2;
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    float mx = -INFINITY;
#pragma unroll
    for (int i = 0; i < KPL; ++i)
      if (lane + 32 * i < blk.tm) mx = fmaxf(mx, s[a][i]);
    mx = warp_max(mx);
    float sum = 0.f;
#pragma unroll
    for (int i = 0; i < KPL; ++i)
      if (lane + 32 * i < blk.tm) sum += expf(s[a][i] - mx);
    sum = warp_sum(sum);
    const int r = 4 * warp + a;
    if (lane == 0 && r < blk.nr) {
      st[(size_t)(blk.r0 + r) * 2] = mx;
      st[(size_t)(blk.r0 + r) * 2 + 1] = sum;
    }
  }
}

// The AV sums of a 4-row x 4-channel output tile (rows 4 rq.., channels
// 4 cq..) over keys [j0, j1): weights ws [key][kLkLdw], values vs [key][ld].
__device__ __forceinline__ void lk_av_tile(const float* ws, const float* vs,
                                           int ld, int rq, int cq, int j0,
                                           int j1, float (&acc)[4][4]) {
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[a][e] = 0.f;
  for (int j = j0; j < j1; ++j) {
    const float4 w =
        *reinterpret_cast<const float4*>(ws + (size_t)j * kLkLdw + 4 * rq);
    const float4 x =
        *reinterpret_cast<const float4*>(vs + (size_t)j * ld + 4 * cq);
    const float wa[4] = {w.x, w.y, w.z, w.w};
    const float xa[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[a][e] = fmaf(wa[a], xa[e], acc[a][e]);
  }
}

// K2's long-key launch B: merges the chunks' row statistics in chunk order,
// recomputes the chunk's scores, forms the weights exp(s - m) / l rounded to
// T and writes the chunk's f32 partial AV sums to part [element][chunk][n]
// [d]. Each output tile's keys are split among `splits` threads whose sums
// are added in split order.
template <typename T, int KPL>
__global__ void __launch_bounds__(kLkThreads)
cross_attention_lk_av_kernel(const T* __restrict__ q, const T* __restrict__ k,
                             const T* __restrict__ v,
                             const float* __restrict__ stats,
                             float* __restrict__ part, int n, int m, int d,
                             int dh, int chunks, float scale, int vec) {
  extern __shared__ float smem[];
  constexpr int kKeys = 32 * KPL;
  const LkBlock blk(n, m, chunks, kKeys);
  const int ld = lk_ld(dh);
  const int ldw = ld > kLkLdw ? ld : kLkLdw;
  float* qs = smem;                          // [kLkRows, ld]
  float* ks = qs + (size_t)kLkRows * ld;     // [kKeys, ld], then weights
  float* vs = ks + (size_t)kKeys * ldw;      // [kKeys, ld]
  float* rmax = vs + (size_t)kKeys * ld;     // [kLkRows]
  float* rsum = rmax + kLkRows;              // [kLkRows]

  if ((int)threadIdx.x < blk.nr) {
    const float* st = stats + ((size_t)blk.b * gridDim.y + blk.h) * chunks *
                                  n * 2 + (size_t)(blk.r0 + threadIdx.x) * 2;
    const size_t step = (size_t)n * 2;
    float mx = -INFINITY;
    for (int c = 0; c < chunks; ++c) mx = fmaxf(mx, st[c * step]);
    float sum = 0.f;
    for (int c = 0; c < chunks; ++c)
      sum += st[c * step + 1] * expf(st[c * step] - mx);
    rmax[threadIdx.x] = mx;
    rsum[threadIdx.x] = sum;
  }
  const size_t head = (size_t)blk.h * dh;
  const size_t kv0 = ((size_t)blk.b * m + blk.t0) * d + head;
  stage_rows(qs, ld, q + ((size_t)blk.b * n + blk.r0) * d + head, d, kLkRows,
             blk.nr, dh, ld - 4, vec);
  stage_rows(ks, ld, k + kv0, d, kKeys, blk.tm, dh, ld - 4, vec);
  stage_rows(vs, ld, v + kv0, d, kKeys, blk.tm, dh, ld - 4, vec);
  __syncthreads();
  float s[4][KPL];
  lk_scores<KPL>(qs, ks, ld, ld - 4, scale, s);
  __syncthreads();  // every warp is done with k: the weights take its place

  float* ws = ks;  // [kKeys, kLkLdw], stored key by key
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int r = 4 * warp + a;
    const float mx = r < blk.nr ? rmax[r] : 0.f;
    const float sum = r < blk.nr ? rsum[r] : 1.f;
#pragma unroll
    for (int i = 0; i < KPL; ++i) {
      const int j = lane + 32 * i;
      ws[(size_t)j * kLkLdw + r] =
          r < blk.nr && j < blk.tm ? round_to<T>(expf(s[a][i] - mx) / sum)
                                   : 0.f;
    }
  }
  __syncthreads();

  const int quads = (dh + 3) / 4;
  const int tiles = kLkRows / 4 * quads;
  float* dp = part + ((size_t)blk.b * chunks + blk.chunk) * n * d +
              (size_t)blk.r0 * d + head;
  float acc[4][4];
  if (tiles * 2 > kLkThreads) {  // one thread per tile, all the keys
    for (int t = threadIdx.x; t < tiles; t += blockDim.x) {
      const int rq = t / quads;
      const int cq = t - rq * quads;
      lk_av_tile(ws, vs, ld, rq, cq, 0, blk.tm, acc);
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (4 * rq + a < blk.nr && 4 * cq + e < dh)
            dp[(size_t)(4 * rq + a) * d + 4 * cq + e] = acc[a][e];
    }
    return;
  }
  const int splits = kLkThreads / tiles;
  const int split = threadIdx.x / tiles;
  const int t = threadIdx.x - split * tiles;
  const int rq = t / quads;
  const int cq = t - rq * quads;
  if (split < splits)
    lk_av_tile(ws, vs, ld, rq, cq, split * blk.tm / splits,
               (split + 1) * blk.tm / splits, acc);
  __syncthreads();  // the weights and values are consumed
  float* red = ks;  // [splits][kLkRows][4 * quads], over ws and vs
  const int ldr = 4 * quads;
  if (split < splits)
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        red[((size_t)split * kLkRows + 4 * rq + a) * ldr + 4 * cq + e] =
            acc[a][e];
  __syncthreads();
  for (int i = threadIdx.x; i < blk.nr * dh; i += blockDim.x) {
    const int r = i / dh;
    const int c = i - r * dh;
    float sum = 0.f;
    for (int sp = 0; sp < splits; ++sp)
      sum += red[((size_t)sp * kLkRows + r) * ldr + c];
    dp[(size_t)r * d + c] = sum;
  }
}

// K2's long-key launch C: out = the sum of the chunks' partials ([element]
// [chunk][nd] f32) in chunk order, in T.
template <typename T>
__global__ void __launch_bounds__(kLkThreads)
cross_attention_lk_reduce_kernel(const float* __restrict__ part,
                                 T* __restrict__ out, int b, int chunks,
                                 size_t nd) {
  const size_t total = (size_t)b * nd;
  for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x; i < total;
       i += (size_t)gridDim.x * blockDim.x) {
    const size_t bi = i / nd;
    const float* p = part + bi * chunks * nd + (i - bi * nd);
    float s = 0.f;
    for (int c = 0; c < chunks; ++c) s += p[(size_t)c * nd];
    out[i] = from_f32<T>(s);
  }
}

// One warp turns a row of scores s and dw (length m, in shared memory) into
// the f32 softmax weights w, kept unrounded in s, and
// ds = w * (dw - rowsum(dw * w)) rounded to T, in dw's place (K3, K4).
template <typename T>
__device__ __forceinline__ void softmax_ds_row(float* s, float* dr, int m,
                                               int lane) {
  float mx = -INFINITY;
  for (int c = lane; c < m; c += 32) mx = fmaxf(mx, s[c]);
  mx = warp_max(mx);
  float sum = 0.f;
  for (int c = lane; c < m; c += 32) {
    const float e = expf(s[c] - mx);
    s[c] = e;
    sum += e;
  }
  sum = warp_sum(sum);
  float dot = 0.f;
  for (int c = lane; c < m; c += 32) {
    const float w = s[c] / sum;
    s[c] = w;
    dot += dr[c] * w;
  }
  dot = warp_sum(dot);
  for (int c = lane; c < m; c += 32) dr[c] = round_to<T>(s[c] * (dr[c] - dot));
}

// K3: one block per (batch element, head). q, k, v and g of the head and the
// [n, n] weights and their gradient stay in shared memory; dq, dk and dv are
// written once each into the packed gradient.
template <typename T>
__global__ void __launch_bounds__(kSelfThreads)
packed_self_attention_bwd_kernel(const T* __restrict__ qkv,
                                 const T* __restrict__ g,
                                 T* __restrict__ dqkv, int n, int d, int dh,
                                 float scale) {
  extern __shared__ float smem[];
  const int b = blockIdx.x;
  const int h = blockIdx.y;
  const int ld = dh + 1;
  float* qs = smem;                     // [n, dh]
  float* ks = qs + (size_t)n * dh;      // [n, dh+1]
  float* vs = ks + (size_t)n * ld;      // [n, dh+1]
  float* gs = vs + (size_t)n * ld;      // [n, dh]
  float* ws = gs + (size_t)n * dh;      // [n, n] weights, f32
  float* ds = ws + (size_t)n * n;       // [n, n] dw, then round(ds)

  const size_t row = 3 * (size_t)d;
  const T* base = qkv + (size_t)b * n * row + (size_t)h * dh;
  const T* gbase = g + (size_t)b * n * d + (size_t)h * dh;
  for (int i = threadIdx.x; i < n * dh; i += blockDim.x) {
    const int r = i / dh;
    const int c = i - r * dh;
    const T* p = base + r * row + c;
    qs[i] = to_f32(p[0]);
    ks[r * ld + c] = to_f32(p[d]);
    vs[r * ld + c] = to_f32(p[2 * (size_t)d]);
    gs[i] = to_f32(gbase[(size_t)r * d + c]);
  }
  __syncthreads();

  // scores (as K1) and dw = g v^T: thread i owns (query r, key c)
  for (int i = threadIdx.x; i < n * n; i += blockDim.x) {
    const int r = i / n;
    const int c = i - r * n;
    const float* q = qs + (size_t)r * dh;
    const float* kk = ks + (size_t)c * ld;
    const float* gg = gs + (size_t)r * dh;
    const float* vv = vs + (size_t)c * ld;
    float acc = 0.f, dw = 0.f;
    for (int j = 0; j < dh; ++j) {
      acc = fmaf(q[j], kk[j], acc);
      dw = fmaf(gg[j], vv[j], dw);
    }
    ws[i] = acc * scale;
    ds[i] = dw;
  }
  __syncthreads();

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int nwarps = blockDim.x >> 5;
  for (int r = warp; r < n; r += nwarps)
    softmax_ds_row<T>(ws + (size_t)r * n, ds + (size_t)r * n, n, lane);
  __syncthreads();

  // thread i owns row c (a key for dk and dv, a query for dq), channel j
  T* obase = dqkv + (size_t)b * n * row + (size_t)h * dh;
  for (int i = threadIdx.x; i < n * dh; i += blockDim.x) {
    const int c = i / dh;
    const int j = i - c * dh;
    float dv = 0.f, dk = 0.f, dq = 0.f;
    for (int r = 0; r < n; ++r) {
      dv = fmaf(round_to<T>(ws[(size_t)r * n + c]), gs[(size_t)r * dh + j],
                dv);
      dk = fmaf(ds[(size_t)r * n + c], qs[(size_t)r * dh + j], dk);
      dq = fmaf(ds[(size_t)c * n + r], ks[(size_t)r * ld + j], dq);
    }
    T* o = obase + (size_t)c * row + j;
    o[0] = from_f32<T>(dq * scale);
    o[d] = from_f32<T>(dk * scale);
    o[2 * (size_t)d] = from_f32<T>(dv);
  }
}

// K4's shared-memory stages. Loads rows [r0, r0 + nr) of q and g of head h
// of element b ([nr, dh] each) and keys [t0, t0 + tm) of k and v ([tm, dh+1]
// each, the odd stride keeping lanes that read different keys on different
// banks).
template <typename T>
__device__ __forceinline__ void load_rows_and_keys(
    const T* __restrict__ q, const T* __restrict__ g, const T* __restrict__ k,
    const T* __restrict__ v, float* qs, float* gs, float* ks, float* vs,
    int b, int h, int n, int m, int d, int dh, int r0, int nr, int t0,
    int tm) {
  const int ld = dh + 1;
  const size_t q0 = ((size_t)b * n + r0) * d + (size_t)h * dh;
  for (int i = threadIdx.x; i < nr * dh; i += blockDim.x) {
    const int r = i / dh;
    const int c = i - r * dh;
    qs[i] = to_f32(q[q0 + (size_t)r * d + c]);
    gs[i] = to_f32(g[q0 + (size_t)r * d + c]);
  }
  const size_t kv0 = ((size_t)b * m + t0) * d + (size_t)h * dh;
  for (int i = threadIdx.x; i < tm * dh; i += blockDim.x) {
    const int r = i / dh;
    const int c = i - r * dh;
    ks[r * ld + c] = to_f32(k[kv0 + (size_t)r * d + c]);
    vs[r * ld + c] = to_f32(v[kv0 + (size_t)r * d + c]);
  }
}

// The scores s = q k^T * scale and dw = g v^T of nr rows against tm keys,
// into ws and ds (row stride ldw): thread i owns (row r, key j).
__device__ __forceinline__ void scores_and_dw(const float* qs, const float* gs,
                                              const float* ks, const float* vs,
                                              float* ws, float* ds, int nr,
                                              int tm, int ldw, int dh,
                                              float scale) {
  const int ld = dh + 1;
  for (int i = threadIdx.x; i < nr * tm; i += blockDim.x) {
    const int r = i / tm;
    const int j = i - r * tm;
    const float* qr = qs + (size_t)r * dh;
    const float* gr = gs + (size_t)r * dh;
    const float* kj = ks + (size_t)j * ld;
    const float* vj = vs + (size_t)j * ld;
    float acc = 0.f, dw = 0.f;
    for (int c = 0; c < dh; ++c) {
      acc = fmaf(qr[c], kj[c], acc);
      dw = fmaf(gr[c], vj[c], dw);
    }
    ws[(size_t)r * ldw + j] = acc * scale;
    ds[(size_t)r * ldw + j] = dw;
  }
}

// dk and dv of tm keys over nr rows (weights ws, unrounded, and round(ds),
// row stride ldw): thread i owns (key j, channel c); `out(j, c, sum, is_dv)`
// takes the sums.
template <typename T, typename Out>
__device__ __forceinline__ void dk_dv_sums(const float* ws, const float* ds,
                                           const float* qs, const float* gs,
                                           int nr, int tm, int ldw, int dh,
                                           Out out) {
  for (int i = threadIdx.x; i < tm * dh; i += blockDim.x) {
    const int j = i / dh;
    const int c = i - j * dh;
    float sk = 0.f, sv = 0.f;
    for (int r = 0; r < nr; ++r) {
      sv = fmaf(round_to<T>(ws[(size_t)r * ldw + j]), gs[(size_t)r * dh + c],
                sv);
      sk = fmaf(ds[(size_t)r * ldw + j], qs[(size_t)r * dh + c], sk);
    }
    out(j, c, sk, false);
    out(j, c, sv, true);
  }
}

// dq sums of nr rows over tm keys (round(ds), row stride ldw): thread i owns
// (row r, channel c); `out(r, c, sum)` takes them.
template <typename Out>
__device__ __forceinline__ void dq_sums(const float* ds, const float* ks,
                                        int nr, int tm, int ldw, int dh,
                                        Out out) {
  const int ld = dh + 1;
  for (int i = threadIdx.x; i < nr * dh; i += blockDim.x) {
    const int r = i / dh;
    const int c = i - r * dh;
    const float* dr = ds + (size_t)r * ldw;
    float acc = 0.f;
    for (int j = 0; j < tm; ++j) acc = fmaf(dr[j], ks[(size_t)j * ld + c], acc);
    out(r, c, acc);
  }
}

// stage_rows for f32 rows that start 16-byte aligned with dh % 4 == 0: the
// copies go out as cp.async, all in flight at once; the caller waits
// (cp_async_wait_all) before its barrier.
__device__ __forceinline__ void stage_rows_async(float* dst, int ld,
                                                 const float* __restrict__ src,
                                                 size_t stride, int rows,
                                                 int valid, int dh,
                                                 int width) {
  const int groups = width / 4;
  for (int i = threadIdx.x; i < rows * groups; i += blockDim.x) {
    const int r = i / groups;
    const int c = (i - r * groups) * 4;
    float* p = dst + (size_t)r * ld + c;
    if (r < valid && c < dh)
      cp_async16(p, src + r * stride + c);
    else
      *reinterpret_cast<float4*>(p) = make_float4(0.f, 0.f, 0.f, 0.f);
  }
}

// K4's register-tiled stages (the tiled schedule; dh % 4 == 0, rows 16-byte
// aligned). Rows [r0, r0 + nr) of q and g into [nr4, lk_ld(dh)] and keys
// [t0, t0 + tm) of k and v into [tm4, lk_ld(dh)], f32, zero in the padding
// up to nr4 and tm4 (multiples of 4) and past dh. f32 rows go by cp.async
// (the caller waits), bf16 ones through stage_rows.
template <typename T>
__device__ __forceinline__ void stage_rows_and_keys(
    const T* __restrict__ q, const T* __restrict__ g, const T* __restrict__ k,
    const T* __restrict__ v, float* qs, float* gs, float* ks, float* vs,
    int b, int h, int n, int m, int d, int dh, int r0, int nr, int nr4,
    int t0, int tm, int tm4) {
  const int ld = lk_ld(dh);
  const int width = (dh + 7) / 8 * 8;
  const size_t q0 = ((size_t)b * n + r0) * d + (size_t)h * dh;
  const size_t kv0 = ((size_t)b * m + t0) * d + (size_t)h * dh;
  if constexpr (sizeof(T) == sizeof(float)) {
    stage_rows_async(qs, ld, q + q0, d, nr4, nr, dh, width);
    stage_rows_async(gs, ld, g + q0, d, nr4, nr, dh, width);
    stage_rows_async(ks, ld, k + kv0, d, tm4, tm, dh, width);
    stage_rows_async(vs, ld, v + kv0, d, tm4, tm, dh, width);
  } else {
    const bool vec = dh % kVec<T> == 0;
    stage_rows(qs, ld, q + q0, d, nr4, nr, dh, width, vec);
    stage_rows(gs, ld, g + q0, d, nr4, nr, dh, width, vec);
    stage_rows(ks, ld, k + kv0, d, tm4, tm, dh, width, vec);
    stage_rows(vs, ld, v + kv0, d, tm4, tm, dh, width, vec);
  }
}

// scores_and_dw by 4 x 4 register tiles: with rn = nr4 / 4 and kn = tm4 / 4,
// a thread's tile holds rows rt + rn i and keys kt + kn j (i, j < 4), of the
// scores (q, k) or, in the second half of the work, of dw (g, v). Per 4
// channels it reads 4 float4 of each operand for 64 FMAs; the 8 lanes of a
// quarter warp read one row (a broadcast) and 8 consecutive keys (lk_ld: 8
// bank groups). Each element is scores_and_dw's fmaf chain over the
// channels, ascending: the same bits.
__device__ __forceinline__ void scores_and_dw_tiled(
    const float* qs, const float* gs, const float* ks, const float* vs,
    float* ws, float* ds, int nr, int tm, int ldw, int dh, float scale) {
  const int ld = lk_ld(dh);
  const int rn = (nr + 3) / 4;
  const int kn = (tm + 3) / 4;
  const int tiles = rn * kn;
  for (int t = threadIdx.x; t < 2 * tiles; t += blockDim.x) {
    const bool dw = t >= tiles;
    const int u = dw ? t - tiles : t;
    const int rt = u / kn;
    const int kt = u - rt * kn;
    const float* a = (dw ? gs : qs) + (size_t)rt * ld;
    const float* bk = (dw ? vs : ks) + (size_t)kt * ld;
    float acc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
    for (int c = 0; c < dh; c += 4) {
      float4 av[4], bv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        av[i] = *reinterpret_cast<const float4*>(a + (size_t)(i * rn) * ld + c);
        bv[i] = *reinterpret_cast<const float4*>(bk + (size_t)(i * kn) * ld +
                                                 c);
      }
#pragma unroll
      for (int e = 0; e < 4; ++e)
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j)
            acc[i][j] = fmaf(lane4(av[i], e), lane4(bv[j], e), acc[i][j]);
    }
    float* o = dw ? ds : ws;
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int r = rt + rn * i;
        const int key = kt + kn * j;
        if (r < nr && key < tm)
          o[(size_t)r * ldw + key] = dw ? acc[i][j] : acc[i][j] * scale;
      }
  }
}

// dk_dv_sums by 4 x 4 register tiles: a thread's tile holds keys 4 jt ..
// 4 jt + 3 and channels 4 ct .. 4 ct + 3 of dk's sums (round(ds), q) or, in
// the second half of the work, of dv's (round(w), g). Per row it reads one
// float4 of each operand for 16 FMAs. Each element is dk_dv_sums' fmaf chain
// over the rows, ascending: the same bits. ldw >= tm4; keys past tm are
// computed from the padding and dropped.
template <typename T, typename Out>
__device__ __forceinline__ void dk_dv_tiled(const float* ws, const float* ds,
                                            const float* qs, const float* gs,
                                            int nr, int tm, int ldw, int dh,
                                            Out out) {
  const int ld = lk_ld(dh);
  const int kn = (tm + 3) / 4;
  const int cn = dh / 4;
  const int tiles = kn * cn;
  for (int t = threadIdx.x; t < 2 * tiles; t += blockDim.x) {
    const bool dv = t >= tiles;
    const int u = dv ? t - tiles : t;
    const int jt = u / cn;
    const int ct = u - jt * cn;
    const float* w = (dv ? ws : ds) + 4 * jt;
    const float* x = (dv ? gs : qs) + 4 * ct;
    float acc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
    for (int r = 0; r < nr; ++r) {
      float4 wv = *reinterpret_cast<const float4*>(w + (size_t)r * ldw);
      if (dv)  // the weights rounded to T before the AV product's backward
        wv = make_float4(round_to<T>(wv.x), round_to<T>(wv.y),
                         round_to<T>(wv.z), round_to<T>(wv.w));
      const float4 xv = *reinterpret_cast<const float4*>(x + (size_t)r * ld);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          acc[i][j] = fmaf(lane4(wv, i), lane4(xv, j), acc[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
      if (4 * jt + i < tm)
#pragma unroll
        for (int j = 0; j < 4; ++j) out(4 * jt + i, 4 * ct + j, acc[i][j], dv);
  }
}

// dq_sums by 4 x 4 register tiles: a thread's tile holds rows rt + rn i and
// channels 4 ct .. 4 ct + 3. Per 4 keys it reads 4 float4 of round(ds) (a
// broadcast across the quarter warp) and 4 of k for 64 FMAs. Each element is
// dq_sums' fmaf chain over the keys, ascending: the same bits.
template <typename Out>
__device__ __forceinline__ void dq_tiled(const float* ds, const float* ks,
                                         int nr, int tm, int ldw, int dh,
                                         Out out) {
  const int ld = lk_ld(dh);
  const int rn = (nr + 3) / 4;
  const int cn = dh / 4;
  for (int t = threadIdx.x; t < rn * cn; t += blockDim.x) {
    const int rt = t / cn;
    const int ct = t - rt * cn;
    const float* dr = ds + (size_t)rt * ldw;
    const float* kc = ks + 4 * ct;
    float acc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
    int j0 = 0;
    for (; j0 + 4 <= tm; j0 += 4) {
      float4 wv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        wv[i] = *reinterpret_cast<const float4*>(dr + (size_t)(i * rn) * ldw +
                                                 j0);
        kv[i] = *reinterpret_cast<const float4*>(kc + (size_t)(j0 + i) * ld);
      }
#pragma unroll
      for (int e = 0; e < 4; ++e)
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j)
            acc[i][j] = fmaf(lane4(wv[i], e), lane4(kv[e], j), acc[i][j]);
    }
    for (; j0 < tm; ++j0) {
      const float4 kv = *reinterpret_cast<const float4*>(kc + (size_t)j0 * ld);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float w = dr[(size_t)(i * rn) * ldw + j0];
#pragma unroll
        for (int j = 0; j < 4; ++j)
          acc[i][j] = fmaf(w, lane4(kv, j), acc[i][j]);
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = rt + rn * i;
      if (r < nr)
#pragma unroll
        for (int j = 0; j < 4; ++j) out(r, 4 * ct + j, acc[i][j]);
    }
  }
}

// One schedule's shared-memory rows: the row counts and strides of K4's
// staged operands. The scalar kernels (kTiled false) keep q and g at stride
// dh, k and v at dh + 1 and the weights at the key count; the tiled ones pad
// the counts to multiples of 4 and the strides to lk_ld(dh) (q, g, k, v)
// and the padded key count (the weights), for float4 reads.
template <bool kTiled>
struct BwdLayout {
  int ldq, ldk;
  __device__ BwdLayout(int dh)
      : ldq(kTiled ? lk_ld(dh) : dh), ldk(kTiled ? lk_ld(dh) : dh + 1) {}
  __device__ static int count(int x) { return kTiled ? (x + 3) / 4 * 4 : x; }
};

// The staged operands and the three products in either schedule. The
// tiled stages may leave copies in flight: wait (cp_async_wait_all) before
// the barrier that follows.
template <typename T, bool kTiled>
__device__ __forceinline__ void bwd_stage(
    const T* __restrict__ q, const T* __restrict__ g, const T* __restrict__ k,
    const T* __restrict__ v, float* qs, float* gs, float* ks, float* vs,
    int b, int h, int n, int m, int d, int dh, int r0, int nr, int t0,
    int tm) {
  if (kTiled)
    stage_rows_and_keys(q, g, k, v, qs, gs, ks, vs, b, h, n, m, d, dh, r0, nr,
                        BwdLayout<true>::count(nr), t0, tm,
                        BwdLayout<true>::count(tm));
  else
    load_rows_and_keys(q, g, k, v, qs, gs, ks, vs, b, h, n, m, d, dh, r0, nr,
                       t0, tm);
}

template <bool kTiled>
__device__ __forceinline__ void bwd_scores(const float* qs, const float* gs,
                                           const float* ks, const float* vs,
                                           float* ws, float* ds, int nr,
                                           int tm, int ldw, int dh,
                                           float scale) {
  if (kTiled)
    scores_and_dw_tiled(qs, gs, ks, vs, ws, ds, nr, tm, ldw, dh, scale);
  else
    scores_and_dw(qs, gs, ks, vs, ws, ds, nr, tm, ldw, dh, scale);
}

template <typename T, bool kTiled, typename Out>
__device__ __forceinline__ void bwd_dk_dv(const float* ws, const float* ds,
                                          const float* qs, const float* gs,
                                          int nr, int tm, int ldw, int dh,
                                          Out out) {
  if (kTiled)
    dk_dv_tiled<T>(ws, ds, qs, gs, nr, tm, ldw, dh, out);
  else
    dk_dv_sums<T>(ws, ds, qs, gs, nr, tm, ldw, dh, out);
}

template <bool kTiled, typename Out>
__device__ __forceinline__ void bwd_dq(const float* ds, const float* ks,
                                       int nr, int tm, int ldw, int dh,
                                       Out out) {
  if (kTiled)
    dq_tiled(ds, ks, nr, tm, ldw, dh, out);
  else
    dq_sums(ds, ks, nr, tm, ldw, dh, out);
}

// 4 consecutive values x into T at p (f32: 16 bytes, 16-byte aligned;
// bf16: 8 bytes, 8-byte aligned).
__device__ __forceinline__ void store4(float* p, const float (&x)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(x[0], x[1], x[2], x[3]);
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, const float (&x)[4]) {
  uint2 u;
  u.x = pack_bf16(x[0], x[1]);  // nearest even, as from_f32
  u.y = pack_bf16(x[2], x[3]);
  *reinterpret_cast<uint2*>(p) = u;
}

// K3 on the CUDA cores, register-tiled (the header's tiled schedule). Grid
// (element, head), kSelfBwdTileThreads threads; kSelfBwdTileBlocks blocks
// share a SM. q, k, v and g of the head come into rows of stride lk_ld(dh)
// (f32 by cp.async, all in flight at once), rows padded to n4 with zeros.
// The products are K4's register-tiled ones on the head's n x n problem: a
// thread owns 4 x 4 tiles of the scores or dw (rows rt + rn i, keys kt + rn
// j), then of dk and dv (keys x channels) and of dq (rows x channels), read
// as float4 slices, 8 FMAs a shared load; the softmax rows are
// softmax_ds_row. Each element is packed_self_attention_bwd_kernel's fmaf
// chain in its order (scores and dw over the channels, dk and dv over the
// query rows, dq over the keys, each ascending): the same bits. The
// products hand a row's channels 4 ct .. 4 ct + 3 over in ascending order,
// so the fourth goes out with the other three in one store.
template <typename T>
__global__ void __launch_bounds__(kSelfBwdTileThreads, kSelfBwdTileBlocks)
packed_self_attention_bwd_tiled_kernel(const T* __restrict__ qkv,
                                       const T* __restrict__ g,
                                       T* __restrict__ dqkv, int n, int d,
                                       int dh, float scale) {
  extern __shared__ __align__(16) float smem[];
  const int b = blockIdx.x;
  const int h = blockIdx.y;
  const int ld = lk_ld(dh);
  const int width = (dh + 7) / 8 * 8;
  const int n4 = (n + 3) / 4 * 4;
  const int lds = n4 + 8;
  float* qs = smem;                   // [n4, ld]
  float* ks = qs + (size_t)n4 * ld;   // [n4, ld]
  float* vs = ks + (size_t)n4 * ld;   // [n4, ld]
  float* gs = vs + (size_t)n4 * ld;   // [n4, ld]
  float* ws = gs + (size_t)n4 * ld;   // [n4, lds] weights, f32
  float* ds = ws + (size_t)n4 * lds;  // [n4, lds] dw, then round(ds)

  const size_t row = 3 * (size_t)d;
  const T* base = qkv + (size_t)b * n * row + (size_t)h * dh;
  const T* gbase = g + (size_t)b * n * d + (size_t)h * dh;
  if constexpr (sizeof(T) == sizeof(float)) {
    stage_rows_async(qs, ld, base, row, n4, n, dh, width);
    stage_rows_async(ks, ld, base + d, row, n4, n, dh, width);
    stage_rows_async(vs, ld, base + 2 * (size_t)d, row, n4, n, dh, width);
    stage_rows_async(gs, ld, gbase, d, n4, n, dh, width);
  } else {
    const bool vec = dh % kVec<T> == 0;
    stage_rows(qs, ld, base, row, n4, n, dh, width, vec);
    stage_rows(ks, ld, base + d, row, n4, n, dh, width, vec);
    stage_rows(vs, ld, base + 2 * (size_t)d, row, n4, n, dh, width, vec);
    stage_rows(gs, ld, gbase, d, n4, n, dh, width, vec);
  }
  cp_async_wait_all();
  __syncthreads();
  scores_and_dw_tiled(qs, gs, ks, vs, ws, ds, n, n, lds, dh, scale);
  __syncthreads();
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int nwarps = blockDim.x >> 5;
  for (int r = warp; r < n; r += nwarps)
    softmax_ds_row<T>(ws + (size_t)r * lds, ds + (size_t)r * lds, n, lane);
  __syncthreads();

  T* obase = dqkv + (size_t)b * n * row + (size_t)h * dh;
  float four[4];
  dq_tiled(ds, ks, n, n, lds, dh, [&](int r, int c, float s) {
    four[c & 3] = s * scale;
    if ((c & 3) == 3) store4(obase + (size_t)r * row + c - 3, four);
  });
  dk_dv_tiled<T>(ws, ds, qs, gs, n, n, lds, dh,
                 [&](int j, int c, float s, bool is_dv) {
    four[c & 3] = is_dv ? s : s * scale;
    if ((c & 3) == 3)
      store4(obase + (size_t)j * row + (is_dv ? 2 : 1) * (size_t)d + c - 3,
             four);
  });
}

// K4's long-query schedule. Grid (query tile, head, batch), `rows` query rows
// per tile. The head's k and v stay whole in shared memory; dq of the tile's
// rows is complete here. dk and dv sum over every query row: with one tile
// they are written here, else this tile's f32 partial sums go to `part`
// ([2][batch][tile][m][d]: dk's, then dv's) for the reduction launch.
// kTiled: the register-tiled products (the header's tiled schedule).
template <typename T, bool kTiled>
__global__ void __launch_bounds__(kTiled ? kBwdLqThreads : kBwdThreads,
                                  kTiled ? 2 : 1)
cross_attention_bwd_lq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                              const T* __restrict__ v, const T* __restrict__ g,
                              T* __restrict__ dq, T* __restrict__ dk,
                              T* __restrict__ dv, float* __restrict__ part,
                              int n, int m, int d, int dh, int rows,
                              float scale) {
  extern __shared__ __align__(16) float smem[];
  const int tile = blockIdx.x;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int r0 = tile * rows;
  const int nr = min(rows, n - r0);
  const BwdLayout<kTiled> lay(dh);
  const int mk = BwdLayout<kTiled>::count(m);     // keys staged, weight stride
  const int rk = BwdLayout<kTiled>::count(rows);  // rows staged
  float* ks = smem;                          // [mk, ldk]
  float* vs = ks + (size_t)mk * lay.ldk;     // [mk, ldk]
  float* qs = vs + (size_t)mk * lay.ldk;     // [rk, ldq]
  float* gs = qs + (size_t)rk * lay.ldq;     // [rk, ldq]
  float* ws = gs + (size_t)rk * lay.ldq;     // [rk, mk] weights, f32
  float* ds = ws + (size_t)rk * mk;          // [rk, mk] dw, then round(ds)

  bwd_stage<T, kTiled>(q, g, k, v, qs, gs, ks, vs, b, h, n, m, d, dh, r0, nr,
                       0, m);
  cp_async_wait_all();
  __syncthreads();
  bwd_scores<kTiled>(qs, gs, ks, vs, ws, ds, nr, m, mk, dh, scale);
  __syncthreads();
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int nwarps = blockDim.x >> 5;
  for (int r = warp; r < nr; r += nwarps)
    softmax_ds_row<T>(ws + (size_t)r * mk, ds + (size_t)r * mk, m, lane);
  __syncthreads();

  const size_t q0 = ((size_t)b * n + r0) * d + (size_t)h * dh;
  bwd_dq<kTiled>(ds, ks, nr, m, mk, dh, [&](int r, int c, float s) {
    dq[q0 + (size_t)r * d + c] = from_f32<T>(s * scale);
  });
  const size_t kv0 = (size_t)b * m * d + (size_t)h * dh;
  const size_t tiles = gridDim.x;
  bwd_dk_dv<T, kTiled>(ws, ds, qs, gs, nr, m, mk, dh,
                       [&](int j, int c, float s, bool is_dv) {
    if (tiles == 1) {
      if (is_dv)
        dv[kv0 + (size_t)j * d + c] = from_f32<T>(s);
      else
        dk[kv0 + (size_t)j * d + c] = from_f32<T>(s * scale);
    } else {
      const size_t p = (((size_t)b * tiles + tile) * m + j) * d +
                       (size_t)h * dh + c;
      part[(is_dv ? (size_t)gridDim.z * tiles * m * d : 0) + p] = s;
    }
  });
}

// K4's reduction launch: each thread sums one element's `tiles` partials
// ([batch][tile][md] f32) in tile order into out0 (times scale0) and, when
// out1 is given, the partials that follow them ([batch][tile][md] again)
// into out1.
template <typename T>
__global__ void __launch_bounds__(kBwdThreads)
cross_attention_bwd_reduce_kernel(const float* __restrict__ part,
                                  T* __restrict__ out0, float scale0,
                                  T* __restrict__ out1, int b, int tiles,
                                  int md) {
  const size_t total = (size_t)b * md;
  for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x; i < total;
       i += (size_t)gridDim.x * blockDim.x) {
    const size_t bi = i / md;
    const size_t e = i - bi * md;
    const float* p0 = part + bi * tiles * md + e;
    float s0 = 0.f;
    for (int t = 0; t < tiles; ++t) s0 += p0[(size_t)t * md];
    out0[i] = from_f32<T>(s0 * scale0);
    if (out1 != nullptr) {
      const float* p1 = p0 + total * tiles;
      float s1 = 0.f;
      for (int t = 0; t < tiles; ++t) s1 += p1[(size_t)t * md];
      out1[i] = from_f32<T>(s1);
    }
  }
}

// K4's long-key schedule, first launch. Grid (key chunk, head, batch): the
// head's n query rows against the chunk's kBwdKeys keys. Per row, the
// chunk's score max mx_c, exp-sum sum_c = sum exp(s - mx_c) and
// dot_c = sum dw exp(s - mx_c) go to stats ([batch][head][chunk][n][3]).
template <typename T, bool kTiled>
__global__ void __launch_bounds__(kBwdThreads)
cross_attention_bwd_stats_kernel(const T* __restrict__ q,
                                 const T* __restrict__ k,
                                 const T* __restrict__ v,
                                 const T* __restrict__ g,
                                 float* __restrict__ stats, int n, int m,
                                 int d, int dh, float scale) {
  extern __shared__ __align__(16) float smem[];
  const int chunk = blockIdx.x;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int t0 = chunk * kBwdKeys;
  const int tm = min(kBwdKeys, m - t0);
  const BwdLayout<kTiled> lay(dh);
  const int nk = BwdLayout<kTiled>::count(n);
  float* qs = smem;                               // [nk, ldq]
  float* gs = qs + (size_t)nk * lay.ldq;          // [nk, ldq]
  float* ks = gs + (size_t)nk * lay.ldq;          // [kBwdKeys, ldk]
  float* vs = ks + (size_t)kBwdKeys * lay.ldk;    // [kBwdKeys, ldk]
  float* ws = vs + (size_t)kBwdKeys * lay.ldk;    // [nk, kBwdKeys] scores
  float* ds = ws + (size_t)nk * kBwdKeys;         // [nk, kBwdKeys] dw

  bwd_stage<T, kTiled>(q, g, k, v, qs, gs, ks, vs, b, h, n, m, d, dh, 0, n,
                       t0, tm);
  cp_async_wait_all();
  __syncthreads();
  bwd_scores<kTiled>(qs, gs, ks, vs, ws, ds, n, tm, kBwdKeys, dh, scale);
  __syncthreads();
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int nwarps = blockDim.x >> 5;
  float* out =
      stats + (((size_t)b * gridDim.y + h) * gridDim.x + chunk) * n * 3;
  for (int r = warp; r < n; r += nwarps) {
    const float* s = ws + (size_t)r * kBwdKeys;
    const float* dr = ds + (size_t)r * kBwdKeys;
    float mx = -INFINITY;
    for (int j = lane; j < tm; j += 32) mx = fmaxf(mx, s[j]);
    mx = warp_max(mx);
    float sum = 0.f, dot = 0.f;
    for (int j = lane; j < tm; j += 32) {
      const float e = expf(s[j] - mx);
      sum += e;
      dot += dr[j] * e;
    }
    sum = warp_sum(sum);
    dot = warp_sum(dot);
    if (lane == 0) {
      out[(size_t)r * 3] = mx;
      out[(size_t)r * 3 + 1] = sum;
      out[(size_t)r * 3 + 2] = dot;
    }
  }
}

// K4's long-key schedule, second launch. Grid (key chunk, head, batch). Each
// block merges the chunks' row statistics in chunk order (the row max, the
// exp-sum and D = rowsum(dw * w)), then recomputes its chunk's scores and
// dw, writes the chunk's dk and dv (complete: every query row is here) and
// its f32 dq partial sums ([batch][chunk][n][d]) for the reduction launch.
template <typename T, bool kTiled>
__global__ void __launch_bounds__(kBwdThreads)
cross_attention_bwd_lk_kernel(const T* __restrict__ q, const T* __restrict__ k,
                              const T* __restrict__ v, const T* __restrict__ g,
                              const float* __restrict__ stats,
                              float* __restrict__ dq_part, T* __restrict__ dk,
                              T* __restrict__ dv, int n, int m, int d, int dh,
                              float scale) {
  extern __shared__ __align__(16) float smem[];
  const int chunk = blockIdx.x;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int chunks = gridDim.x;
  const int t0 = chunk * kBwdKeys;
  const int tm = min(kBwdKeys, m - t0);
  const BwdLayout<kTiled> lay(dh);
  const int nk = BwdLayout<kTiled>::count(n);
  float* qs = smem;                               // [nk, ldq]
  float* gs = qs + (size_t)nk * lay.ldq;          // [nk, ldq]
  float* ks = gs + (size_t)nk * lay.ldq;          // [kBwdKeys, ldk]
  float* vs = ks + (size_t)kBwdKeys * lay.ldk;    // [kBwdKeys, ldk]
  float* ws = vs + (size_t)kBwdKeys * lay.ldk;    // [nk, kBwdKeys] weights
  float* ds = ws + (size_t)nk * kBwdKeys;         // [nk, kBwdKeys] dw, then ds
  float* rmax = ds + (size_t)nk * kBwdKeys;       // [n]
  float* rsum = rmax + n;                         // [n]
  float* rdot = rsum + n;                         // [n] D

  // the chunk's operands (in flight while the statistics merge)
  bwd_stage<T, kTiled>(q, g, k, v, qs, gs, ks, vs, b, h, n, m, d, dh, 0, n,
                       t0, tm);
  const float* st = stats + ((size_t)b * gridDim.y + h) * chunks * n * 3;
  for (int r = threadIdx.x; r < n; r += blockDim.x) {
    // unrolled, so that the statistics' loads are in flight together; the
    // sums still run in chunk order
    float mx = -INFINITY;
#pragma unroll 8
    for (int c = 0; c < chunks; ++c)
      mx = fmaxf(mx, st[((size_t)c * n + r) * 3]);
    float sum = 0.f, dot = 0.f;
#pragma unroll 8
    for (int c = 0; c < chunks; ++c) {
      const float* sc = st + ((size_t)c * n + r) * 3;
      const float f = expf(sc[0] - mx);
      sum += sc[1] * f;
      dot += sc[2] * f;
    }
    rmax[r] = mx;
    rsum[r] = sum;
    rdot[r] = dot / sum;
  }
  cp_async_wait_all();
  __syncthreads();
  bwd_scores<kTiled>(qs, gs, ks, vs, ws, ds, n, tm, kBwdKeys, dh, scale);
  __syncthreads();
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int nwarps = blockDim.x >> 5;
  for (int r = warp; r < n; r += nwarps) {
    float* s = ws + (size_t)r * kBwdKeys;
    float* dr = ds + (size_t)r * kBwdKeys;
    const float mx = rmax[r], sum = rsum[r], dot = rdot[r];
    for (int j = lane; j < tm; j += 32) {
      const float w = expf(s[j] - mx) / sum;
      s[j] = w;
      dr[j] = round_to<T>(w * (dr[j] - dot));
    }
  }
  __syncthreads();

  const size_t kv0 = ((size_t)b * m + t0) * d + (size_t)h * dh;
  bwd_dk_dv<T, kTiled>(ws, ds, qs, gs, n, tm, kBwdKeys, dh,
                       [&](int j, int c, float s, bool is_dv) {
    if (is_dv)
      dv[kv0 + (size_t)j * d + c] = from_f32<T>(s);
    else
      dk[kv0 + (size_t)j * d + c] = from_f32<T>(s * scale);
  });
  float* dp = dq_part + ((size_t)b * chunks + chunk) * n * d + (size_t)h * dh;
  bwd_dq<kTiled>(ds, ks, n, tm, kBwdKeys, dh,
                 [&](int r, int c, float s) { dp[(size_t)r * d + c] = s; });
}

// q8(x, s) = clip(round_half_even(x / s), -127, 127).
__device__ __forceinline__ int quantize_int8(float x, float s) {
  return (int)fminf(fmaxf(rintf(x / s), -127.f), 127.f);
}

// K8 on the CUDA cores, first launch: grid (group, part), part 0/1/2 =
// q/k/v. Writes scales[group * 3 + part] = max|x| / 127 + 1e-20 over the
// `rows` rows of the group and the part's d columns.
template <typename T>
__global__ void __launch_bounds__(kScaleThreads)
int8_group_scales_kernel(const T* __restrict__ qkv, float* __restrict__ scales,
                         int rows, int d) {
  __shared__ float part_max[kScaleThreads / 32];
  const size_t row = 3 * (size_t)d;
  const T* base = qkv + (size_t)blockIdx.x * rows * row +
                  (size_t)blockIdx.y * d;
  float mx = 0.f;
  for (int r = 0; r < rows; ++r)
    for (int c = threadIdx.x; c < d; c += blockDim.x)
      mx = fmaxf(mx, fabsf(to_f32(base[(size_t)r * row + c])));
  mx = warp_max(mx);
  const int warp = threadIdx.x >> 5;
  if ((threadIdx.x & 31) == 0) part_max[warp] = mx;
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int w = 1; w < (int)(blockDim.x >> 5); ++w)
      mx = fmaxf(mx, part_max[w]);
    scales[(size_t)blockIdx.x * 3 + blockIdx.y] = mx / 127.0f + 1e-20f;
  }
}

// K8 on the CUDA cores, second launch: one block per (batch element,
// head), K1's layout with int32 copies of the int8 codes: q [n, dh], k [n,
// dh+1], v [n, dh], and the [n, n] scores (later the weight codes) as f32.
template <typename T>
__global__ void __launch_bounds__(kSelfThreads)
packed_self_attention_int8_kernel(const T* __restrict__ qkv,
                                  const float* __restrict__ scales,
                                  T* __restrict__ out, int n, int d, int dh,
                                  int elems, float scale) {
  extern __shared__ float smem[];
  const int b = blockIdx.x;
  const int h = blockIdx.y;
  const int ldk = dh + 1;
  int* qs = reinterpret_cast<int*>(smem);
  int* ks = qs + (size_t)n * dh;
  int* vs = ks + (size_t)n * ldk;
  float* ss = reinterpret_cast<float*>(vs + (size_t)n * dh);
  const float* sc = scales + (size_t)(b / elems) * 3;
  const float sq = sc[0], sk = sc[1], sv = sc[2];

  const size_t row = 3 * (size_t)d;
  const T* base = qkv + (size_t)b * n * row + (size_t)h * dh;
  for (int i = threadIdx.x; i < n * dh; i += blockDim.x) {
    const int r = i / dh;
    const int c = i - r * dh;
    const T* p = base + r * row + c;
    qs[i] = quantize_int8(to_f32(p[0]), sq);
    ks[r * ldk + c] = quantize_int8(to_f32(p[d]), sk);
    vs[i] = quantize_int8(to_f32(p[2 * (size_t)d]), sv);
  }
  __syncthreads();

  // scores: int32 dot * ((sq * sk) * dh^-1/2), as the TPU kernel orders it
  const float qk_scale = (sq * sk) * scale;
  for (int i = threadIdx.x; i < n * n; i += blockDim.x) {
    const int r = i / n;
    const int c = i - r * n;
    const int* q = qs + (size_t)r * dh;
    const int* k = ks + (size_t)c * ldk;
    int acc = 0;
    for (int j = 0; j < dh; ++j) acc += q[j] * k[j];
    ss[i] = (float)acc * qk_scale;
  }
  __syncthreads();

  // f32 row softmax, one warp per row, then the weight codes
  // clip(round(w * 127), 0, 127) kept as exact small floats
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int nwarps = blockDim.x >> 5;
  for (int r = warp; r < n; r += nwarps) {
    float* s = ss + (size_t)r * n;
    const float sum = softmax_exp_row(s, n, lane);
    for (int c = lane; c < n; c += 32) s[c] = weight_code(s[c], sum);
  }
  __syncthreads();

  // AV: int32 dot of weight codes and v codes, times sv / 127
  const float out_scale = sv / 127.0f;
  T* obase = out + (size_t)b * n * d + (size_t)h * dh;
  for (int i = threadIdx.x; i < n * dh; i += blockDim.x) {
    const int r = i / dh;
    const int c = i - r * dh;
    const float* w = ss + (size_t)r * n;
    int acc = 0;
    for (int m = 0; m < n; ++m) acc += (int)w[m] * vs[(size_t)m * dh + c];
    obase[(size_t)r * d + c] = from_f32<T>((float)acc * out_scale);
  }
}

// K8's int8 tensor-core schedule, first launch: grid (group, part, slice of
// kScaleRows rows), part 0/1/2 = q/k/v. Writes the slice's max|x| over the
// part's d columns to part_max[(group * 3 + part) * slices + slice], from
// 16-byte loads. A max is exact in any order, so the merged scales have the
// bits of int8_group_scales_kernel's.
template <typename T>
__global__ void __launch_bounds__(kSelfThreads)
packed_self_attention_int8_scales_kernel(const T* __restrict__ qkv,
                                         float* __restrict__ part_max,
                                         int rows, int d, int slices) {
  __shared__ float warp_max_of[kSelfThreads / 32];
  constexpr int V = kVec<T>;
  const int r0 = blockIdx.z * kScaleRows;
  const int nr = min(kScaleRows, rows - r0);
  const int vecs = d / V;
  const size_t row = 3 * (size_t)d;
  const T* base = qkv + ((size_t)blockIdx.x * rows + r0) * row +
                  (size_t)blockIdx.y * d;
  float mx = 0.f;
  for (int i = threadIdx.x; i < nr * vecs; i += blockDim.x) {
    const int r = i / vecs;
    float x[V];
    load16(base + r * row + (size_t)(i - r * vecs) * V, x);
#pragma unroll
    for (int e = 0; e < V; ++e) mx = fmaxf(mx, fabsf(x[e]));
  }
  mx = warp_max(mx);
  if ((threadIdx.x & 31) == 0) warp_max_of[threadIdx.x >> 5] = mx;
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int w = 1; w < (int)(blockDim.x >> 5); ++w)
      mx = fmaxf(mx, warp_max_of[w]);
    part_max[((size_t)blockIdx.x * 3 + blockIdx.y) * slices + blockIdx.z] =
        mx;
  }
}

// The int8 codes of V values, packed little-endian into V bytes at p.
template <int V>
__device__ __forceinline__ void store_codes(int8_t* p, const float* x,
                                            float s);
template <>
__device__ __forceinline__ void store_codes<4>(int8_t* p, const float* x,
                                               float s) {
  uint32_t w = 0;
#pragma unroll
  for (int e = 0; e < 4; ++e)
    w |= (uint32_t)(uint8_t)(int8_t)quantize_int8(x[e], s) << (8 * e);
  *reinterpret_cast<uint32_t*>(p) = w;
}
template <>
__device__ __forceinline__ void store_codes<8>(int8_t* p, const float* x,
                                               float s) {
  store_codes<4>(p, x, s);
  store_codes<4>(p + 4, x + 4, s);
}

// (a, b) rounded to T, stored at p (aligned to two T).
__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// K8 on the int8 tensor cores (the header's first K8 schedule), second
// launch. Grid (element, group of kMmaHeads heads); n / 16 warps per head,
// each owning 16 query rows. Per head in shared memory: the f32 scores
// [n, n + 8], the q and k codes as int8 rows [n, dh + 16], the v codes
// transposed [dh, np + 16] (the AV product's column-major B operand:
// ldmatrix.trans takes b16 only) and the weight codes [n, np + 16]; every
// row stride is an odd number of 16 bytes, so ldmatrix's 8 rows hit 8 bank
// groups. Keys [n, np) hold zero codes in the weights and in v.
template <typename T>
__global__ void __launch_bounds__(kMmaHeads* kMmaMaxN / 16 * 32)
packed_self_attention_int8_mma_kernel(const T* __restrict__ qkv,
                                      const float* __restrict__ part_max,
                                      float* __restrict__ scales,
                                      T* __restrict__ out, int n, int h,
                                      int dh, int elems, int slices,
                                      float scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* group_scale = reinterpret_cast<float*>(smem_raw);  // sq, sk, sv
  unsigned char* heads_smem = smem_raw + 16;
  constexpr int V = kVec<T>;
  constexpr int NT = kMmaMaxN / 8;  // most key tiles of 8
  const int d = h * dh;
  const int b = blockIdx.x;
  const int h0 = blockIdx.y * kMmaHeads;
  const int heads = min(kMmaHeads, h - h0);
  const int np = (n + 31) / 32 * 32;
  const int ls = n + 8;    // score row stride (floats)
  const int lq = dh + 16;  // q and k code row stride (bytes)
  const int lv = np + 16;  // v^T and weight code row stride (bytes)
  const int per_head = 4 * n * ls + 2 * n * lq + (dh + n) * lv;
  const int group = b / elems;

  // the group's scales from its slices' maxima, as int8_group_scales_kernel
  // forms them; the group's first element writes them out
  if (threadIdx.x < 3) {
    const float* p = part_max + ((size_t)group * 3 + threadIdx.x) * slices;
    float mx = 0.f;
    for (int s = 0; s < slices; ++s) mx = fmaxf(mx, p[s]);
    const float s = mx / 127.0f + 1e-20f;
    group_scale[threadIdx.x] = s;
    if (b % elems == 0 && blockIdx.y == 0)
      scales[(size_t)group * 3 + threadIdx.x] = s;
  }
  // zero codes of the padding keys: v^T columns and weight columns [n, np)
  const int pad = np - n;
  for (int i = threadIdx.x; i < heads * (dh + n) * pad; i += blockDim.x) {
    const int c = i % pad;
    const int t = i / pad;
    const int hh = t / (dh + n);
    const int r = t - hh * (dh + n);
    heads_smem[hh * per_head + 4 * n * ls + 2 * n * lq + r * lv + n + c] = 0;
  }
  __syncthreads();

  // 16-byte loads of the block's q, k, v, quantized in registers: q and k
  // codes stored as rows, v codes transposed
  const size_t row = 3 * (size_t)d;
  const T* base = qkv + (size_t)b * n * row + (size_t)h0 * dh;
  const int ch = dh / V;  // 16-byte chunks per head row
  for (int i = threadIdx.x; i < heads * 3 * n * ch; i += blockDim.x) {
    const int c = i % ch;
    int t = i / ch;
    const int hh = t % heads;
    t /= heads;
    const int which = t % 3;
    const int r = t / 3;
    float x[V];
    load16(base + r * row + (size_t)which * d + hh * dh + c * V, x);
    const float s = group_scale[which];
    int8_t* hs =
        reinterpret_cast<int8_t*>(heads_smem + hh * per_head + 4 * n * ls);
    if (which < 2) {
      store_codes<V>(hs + (which * n + r) * lq + c * V, x, s);
    } else {
      int8_t* vt = hs + 2 * n * lq + (c * V) * lv + r;
#pragma unroll
      for (int e = 0; e < V; ++e) vt[e * lv] = (int8_t)quantize_int8(x[e], s);
    }
  }
  __syncthreads();

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int wph = n >> 4;  // warps per head
  const int hh = warp / wph;
  if (hh >= heads) return;
  const int r0 = (warp - hh * wph) * 16;
  const int nt = n >> 3;
  const int g = lane >> 2;
  const int t2 = (lane & 3) * 2;
  float* ss = reinterpret_cast<float*>(heads_smem + hh * per_head);
  int8_t* qs = reinterpret_cast<int8_t*>(ss + n * ls);
  const int8_t* ks = qs + n * lq;
  const int8_t* vt = ks + n * lq;
  int8_t* ws = qs + 2 * n * lq + dh * lv;

  // scores: int32 dots of the warp's 16 q rows with every key, k-steps of
  // 32 channels (A from q rows, B from k rows, both by ldmatrix), times
  // ((sq sk) dh^-1/2) into the f32 score rows
  int s[NT][4];
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[j][e] = 0;
  for (int kk = 0; kk < dh; kk += 32) {
    uint32_t qa[4];
    ldmatrix_x4(qa, qs + (r0 + (lane & 15)) * lq + kk + (lane >> 4) * 16);
#pragma unroll
    for (int j = 0; j < NT; j += 2) {
      if (j < nt) {
        // keys 8j..8j+15, channels kk..kk+31: two B fragments
        uint32_t kb[4];
        ldmatrix_x4(kb, ks + (j * 8 + (lane & 7) + ((lane >> 4) << 3)) * lq +
                            kk + ((lane >> 3) & 1) * 16);
        mma_s8(s[j], qa, kb[0], kb[1]);
        mma_s8(s[j + 1], qa, kb[2], kb[3]);
      }
    }
  }
  const float qk_scale = (group_scale[0] * group_scale[1]) * scale;
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    if (j < nt) {
      *reinterpret_cast<float2*>(ss + (r0 + g) * ls + j * 8 + t2) =
          make_float2((float)s[j][0] * qk_scale, (float)s[j][1] * qk_scale);
      *reinterpret_cast<float2*>(ss + (r0 + g + 8) * ls + j * 8 + t2) =
          make_float2((float)s[j][2] * qk_scale, (float)s[j][3] * qk_scale);
    }
  }
  __syncwarp();

  // f32 row softmax of the warp's rows, then the weight codes as int8 rows
  for (int rr = r0; rr < r0 + 16; ++rr) {
    float* sr = ss + rr * ls;
    const float sum = softmax_exp_row(sr, n, lane);
    for (int c = lane; c < n; c += 32)
      ws[rr * lv + c] = (int8_t)weight_code(sr[c], sum);
  }
  __syncwarp();

  // AV: int32 dots of the weight codes (A) with v^T rows (B), 32 channels
  // at a time, times sv / 127
  const float out_scale = group_scale[2] / 127.0f;
  T* ob = out + ((size_t)b * n + r0) * d + (size_t)(h0 + hh) * dh;
  for (int c0 = 0; c0 < dh; c0 += 32) {
    int acc[4][4];
#pragma unroll
    for (int jn = 0; jn < 4; ++jn)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[jn][e] = 0;
    for (int kk = 0; kk < np; kk += 32) {
      uint32_t wa[4];
      ldmatrix_x4(wa, ws + (r0 + (lane & 15)) * lv + kk + (lane >> 4) * 16);
#pragma unroll
      for (int jn = 0; jn < 4; jn += 2) {
        // channels c0+8jn..c0+8jn+15, keys kk..kk+31: two B fragments
        uint32_t vb[4];
        ldmatrix_x4(vb, vt + (c0 + jn * 8 + (lane & 7) + ((lane >> 4) << 3)) *
                                 lv +
                            kk + ((lane >> 3) & 1) * 16);
        mma_s8(acc[jn], wa, vb[0], vb[1]);
        mma_s8(acc[jn + 1], wa, vb[2], vb[3]);
      }
    }
#pragma unroll
    for (int jn = 0; jn < 4; ++jn) {
      const int c = c0 + jn * 8 + t2;
      store2(ob + (size_t)g * d + c, (float)acc[jn][0] * out_scale,
             (float)acc[jn][1] * out_scale);
      store2(ob + (size_t)(g + 8) * d + c, (float)acc[jn][2] * out_scale,
             (float)acc[jn][3] * out_scale);
    }
  }
}

// Lets `kernel` take `smem` bytes of dynamic shared memory.
template <typename K>
cudaError_t allow_smem(K kernel, size_t smem) {
  if (smem <= kDefaultSmem) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)smem);
}

// *schedule: 1 where the int8 tensor-core schedule was launched, else 0.
template <typename T>
cudaError_t launch_self_int8(const void* qkv, void* scales, void* out, int b,
                             int n, int d, int h, int elems, float scale,
                             cudaStream_t stream, int* schedule) {
  const int dh = d / h;
  float* sc = static_cast<float*>(scales);
  *schedule = self_int8_mma(n, dh, elems, qkv, out);
  if (*schedule) {
    const int rows = elems * n;
    const int slices = (rows + kScaleRows - 1) / kScaleRows;
    float* part = sc + (size_t)(b / elems) * 3;  // the slices' maxima
    const size_t smem = self_int8_mma_smem_bytes(n, dh);
    cudaError_t e =
        allow_smem(packed_self_attention_int8_mma_kernel<T>, smem);
    if (e != cudaSuccess) return e;
    packed_self_attention_int8_scales_kernel<T>
        <<<dim3(b / elems, 3, slices), kSelfThreads, 0, stream>>>(
            static_cast<const T*>(qkv), part, rows, d, slices);
    e = cudaGetLastError();
    if (e != cudaSuccess) return e;
    packed_self_attention_int8_mma_kernel<T>
        <<<dim3(b, (h + kMmaHeads - 1) / kMmaHeads),
           kMmaHeads * (n / 16) * 32, smem, stream>>>(
            static_cast<const T*>(qkv), part, sc, static_cast<T*>(out), n,
            h, dh, elems, slices, scale);
    return cudaGetLastError();
  }
  cudaError_t e = allow_smem(packed_self_attention_int8_kernel<T>,
                             self_smem_bytes(n, dh));
  if (e != cudaSuccess) return e;
  int8_group_scales_kernel<T><<<dim3(b / elems, 3), kScaleThreads, 0,
                                stream>>>(static_cast<const T*>(qkv), sc,
                                          elems * n, d);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  packed_self_attention_int8_kernel<T>
      <<<dim3(b, h), kSelfThreads, self_smem_bytes(n, dh), stream>>>(
          static_cast<const T*>(qkv), sc, static_cast<T*>(out), n, d, dh,
          elems, scale);
  return cudaGetLastError();
}

template <int DH>
cudaError_t launch_self_mma(const void* qkv, void* out, int b, int n, int h,
                            float scale, cudaStream_t stream) {
  const size_t smem = self_mma_smem_bytes(n, DH);
  if (smem > kDefaultSmem) {
    cudaError_t e = cudaFuncSetAttribute(
        packed_self_attention_mma_kernel<DH>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  const dim3 grid(b, (h + kMmaHeads - 1) / kMmaHeads);
  packed_self_attention_mma_kernel<DH>
      <<<grid, kMmaHeads * (n / 16) * 32, smem, stream>>>(
          static_cast<const __nv_bfloat16*>(qkv),
          static_cast<__nv_bfloat16*>(out), n, h, scale);
  return cudaGetLastError();
}

cudaError_t launch_self_tiled(const void* qkv, void* out, int b, int n,
                              int h, int dh, float scale,
                              cudaStream_t stream) {
  const size_t smem = self_tiled_smem_bytes(n, dh);
  const cudaError_t e = allow_smem(packed_self_attention_tiled_kernel, smem);
  if (e != cudaSuccess) return e;
  packed_self_attention_tiled_kernel
      <<<dim3(b, (h + kTileHeads - 1) / kTileHeads), kTileThreads, smem,
         stream>>>(static_cast<const float*>(qkv), static_cast<float*>(out),
                   n, h, dh, scale);
  return cudaGetLastError();
}

// *schedule: 1 where the tensor-core schedule was launched, 2 the
// register-tiled f32 one, 0 the CUDA-core kernel.
template <typename T>
cudaError_t launch_self(const void* qkv, void* out, int b, int n, int d,
                        int h, float scale, cudaStream_t stream,
                        int* schedule) {
  const int dh = d / h;
  const int dtype = sizeof(T) == 2 ? kDtypeBF16 : kDtypeF32;
  if (self_mma(n, dh, dtype, qkv, out)) {
    *schedule = 1;
    switch (dh) {
      case 16: return launch_self_mma<16>(qkv, out, b, n, h, scale, stream);
      case 32: return launch_self_mma<32>(qkv, out, b, n, h, scale, stream);
      case 64: return launch_self_mma<64>(qkv, out, b, n, h, scale, stream);
      default: return launch_self_mma<128>(qkv, out, b, n, h, scale, stream);
    }
  }
  if (self_tiled(n, dh, dtype, qkv, out)) {
    *schedule = 2;
    return launch_self_tiled(qkv, out, b, n, h, dh, scale, stream);
  }
  *schedule = 0;
  const size_t smem = self_smem_bytes(n, dh);
  const cudaError_t e = allow_smem(packed_self_attention_kernel<T>, smem);
  if (e != cudaSuccess) return e;
  packed_self_attention_kernel<T><<<dim3(b, h), kSelfThreads, smem, stream>>>(
      static_cast<const T*>(qkv), static_cast<T*>(out), n, d, dh, scale);
  return cudaGetLastError();
}

// K3 in the schedule its rule picks (*schedule: 1 for the register-tiled
// kernel, 0 the scalar one).
template <typename T>
cudaError_t launch_self_bwd(const void* qkv, const void* g, void* dqkv, int b,
                            int n, int d, int h, float scale,
                            cudaStream_t stream, int* schedule) {
  const int dh = d / h;
  const T* qt = static_cast<const T*>(qkv);
  const T* gt = static_cast<const T*>(g);
  T* dt = static_cast<T*>(dqkv);
  if (self_bwd_tiled(n, dh, aligned16(qkv) && aligned16(g) &&
                                aligned16(dqkv))) {
    *schedule = 1;
    const size_t smem = self_bwd_tiled_smem_bytes(n, dh);
    const auto kernel = packed_self_attention_bwd_tiled_kernel<T>;
    cudaError_t e = allow_smem(kernel, smem);
    if (e == cudaSuccess)  // all of the SM's shared memory, so that
      e = cudaFuncSetAttribute(  // kSelfBwdTileBlocks blocks fit
          kernel, cudaFuncAttributePreferredSharedMemoryCarveout, 100);
    if (e != cudaSuccess) return e;
    kernel<<<dim3(b, h), kSelfBwdTileThreads, smem, stream>>>(qt, gt, dt, n,
                                                              d, dh, scale);
    return cudaGetLastError();
  }
  const size_t smem = self_bwd_smem_bytes(n, dh);
  const cudaError_t e = allow_smem(packed_self_attention_bwd_kernel<T>, smem);
  if (e != cudaSuccess) return e;
  packed_self_attention_bwd_kernel<T>
      <<<dim3(b, h), kSelfThreads, smem, stream>>>(qt, gt, dt, n, d, dh,
                                                   scale);
  return cudaGetLastError();
}

// Whether K2 takes the whole-set schedule for m keys of width dh.
bool cross_whole(int m, int dh) {
  return whole_width(dh) > 0 && cross_whole_smem_bytes(m, dh) <= kMaxSmem;
}

template <typename T, int W>
cudaError_t launch_cross_whole(const T* q, const T* k, const T* v, T* out,
                               int b, int n, int m, int d, int h, float scale,
                               int vec, cudaStream_t stream) {
  const size_t smem = cross_whole_smem_bytes(m, d / h);
  cudaError_t e = allow_smem(cross_attention_whole_kernel<T, W>, smem);
  if (e != cudaSuccess) return e;
  const dim3 grid((n + kWholeThreads - 1) / kWholeThreads, h, b);
  cross_attention_whole_kernel<T, W><<<grid, kWholeThreads, smem, stream>>>(
      q, k, v, out, n, m, d, d / h, scale, vec);
  return cudaGetLastError();
}

template <typename T, int KPL>
cudaError_t launch_cross_lk(const T* q, const T* k, const T* v, T* out,
                            float* work, int b, int n, int m, int d, int h,
                            float scale, int vec, cudaStream_t stream) {
  const int dh = d / h;
  constexpr int keys = 32 * KPL;
  const int chunks = (m + keys - 1) / keys;
  const int tiles = (n + kLkRows - 1) / kLkRows;
  const size_t smem_a = sizeof(float) * (size_t)(kLkRows + keys) * lk_ld(dh);
  const size_t smem_b = cross_lk_smem_bytes(dh, keys);
  cudaError_t e = allow_smem(cross_attention_lk_stats_kernel<T, KPL>, smem_a);
  if (e == cudaSuccess)
    e = allow_smem(cross_attention_lk_av_kernel<T, KPL>, smem_b);
  if (e != cudaSuccess) return e;
  float* stats = work;                                  // [b][h][chunk][n][2]
  float* part = work + (size_t)b * h * chunks * n * 2;  // [b][chunk][n][d]
  const dim3 grid((unsigned)chunks * tiles, h, b);
  cross_attention_lk_stats_kernel<T, KPL>
      <<<grid, kLkThreads, smem_a, stream>>>(q, k, stats, n, m, d, dh,
                                             chunks, scale, vec);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  cross_attention_lk_av_kernel<T, KPL><<<grid, kLkThreads, smem_b, stream>>>(
      q, k, v, stats, part, n, m, d, dh, chunks, scale, vec);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  const size_t blocks = ((size_t)b * n * d + kLkThreads - 1) / kLkThreads;
  cross_attention_lk_reduce_kernel<T>
      <<<(unsigned)(blocks < 65535 ? blocks : 65535), kLkThreads, 0,
         stream>>>(part, out, b, chunks, (size_t)n * d);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_cross(const void* q, const void* k, const void* v,
                         void* out, void* work, int b, int n, int m, int d,
                         int h, float scale, cudaStream_t stream) {
  const int dh = d / h;
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  T* ot = static_cast<T*>(out);
  // 16-byte loads and stores where every row of a head starts aligned
  const uintptr_t any = reinterpret_cast<uintptr_t>(q) |
                        reinterpret_cast<uintptr_t>(k) |
                        reinterpret_cast<uintptr_t>(v) |
                        reinterpret_cast<uintptr_t>(out);
  const int vec = any % 16 == 0 && d % kVec<T> == 0 && dh % kVec<T> == 0;
  if (cross_whole(m, dh)) {
    switch (whole_width(dh)) {
      case 16:
        return launch_cross_whole<T, 16>(qt, kt, vt, ot, b, n, m, d, h, scale,
                                         vec, stream);
      case 32:
        return launch_cross_whole<T, 32>(qt, kt, vt, ot, b, n, m, d, h, scale,
                                         vec, stream);
      case 48:
        return launch_cross_whole<T, 48>(qt, kt, vt, ot, b, n, m, d, h, scale,
                                         vec, stream);
      default:
        return launch_cross_whole<T, 64>(qt, kt, vt, ot, b, n, m, d, h, scale,
                                         vec, stream);
    }
  }
  float* wt = static_cast<float*>(work);
  switch (cross_lk_keys(dh)) {
    case 128:
      return launch_cross_lk<T, 4>(qt, kt, vt, ot, wt, b, n, m, d, h, scale,
                                   vec, stream);
    case 64:
      return launch_cross_lk<T, 2>(qt, kt, vt, ot, wt, b, n, m, d, h, scale,
                                   vec, stream);
    default:
      return launch_cross_lk<T, 1>(qt, kt, vt, ot, wt, b, n, m, d, h, scale,
                                   vec, stream);
  }
}

template <typename Kernel>
cudaError_t allow_bwd_smem(Kernel kernel, size_t smem) {
  if (smem <= kDefaultSmem) return cudaSuccess;
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

template <typename T, bool kTiled>
cudaError_t launch_cross_bwd(const T* q, const T* k, const T* v, const T* g,
                             T* dq, T* dk, T* dv, float* part, int b, int n,
                             int m, int d, int h, int rows, float scale,
                             cudaStream_t stream) {
  const int dh = d / h;
  if (rows == 0) {
    const int chunks = (m + kBwdKeys - 1) / kBwdKeys;
    const size_t smem = kTiled ? cross_bwd_lk_tiled_smem_bytes(n, dh)
                               : cross_bwd_lk_smem_bytes(n, dh);
    cudaError_t e =
        allow_bwd_smem(cross_attention_bwd_stats_kernel<T, kTiled>, smem);
    if (e == cudaSuccess)
      e = allow_bwd_smem(cross_attention_bwd_lk_kernel<T, kTiled>, smem);
    if (e != cudaSuccess) return e;
    float* stats = part;
    float* dq_part = stats + (size_t)b * h * chunks * n * 3;
    const dim3 grid(chunks, h, b);
    cross_attention_bwd_stats_kernel<T, kTiled>
        <<<grid, kBwdThreads, smem, stream>>>(q, k, v, g, stats, n, m, d, dh,
                                               scale);
    e = cudaGetLastError();
    if (e != cudaSuccess) return e;
    cross_attention_bwd_lk_kernel<T, kTiled>
        <<<grid, kBwdThreads, smem, stream>>>(q, k, v, g, stats, dq_part, dk,
                                               dv, n, m, d, dh, scale);
    e = cudaGetLastError();
    if (e != cudaSuccess) return e;
    const size_t blocks = ((size_t)b * n * d + kBwdThreads - 1) / kBwdThreads;
    cross_attention_bwd_reduce_kernel<T>
        <<<(unsigned)(blocks < 65535 ? blocks : 65535), kBwdThreads, 0,
           stream>>>(dq_part, dq, scale, static_cast<T*>(nullptr), b, chunks,
                     n * d);
    return cudaGetLastError();
  }
  const int tiles = (n + rows - 1) / rows;
  const size_t smem = kTiled ? cross_bwd_lq_tiled_smem_bytes(m, dh, rows)
                             : cross_bwd_lq_smem_bytes(m, dh, rows);
  cudaError_t e =
      allow_bwd_smem(cross_attention_bwd_lq_kernel<T, kTiled>, smem);
  if (e == cudaSuccess && kTiled)  // all of the SM's shared memory, so
    e = cudaFuncSetAttribute(       // that two blocks fit
        cross_attention_bwd_lq_kernel<T, kTiled>,
        cudaFuncAttributePreferredSharedMemoryCarveout, 100);
  if (e != cudaSuccess) return e;
  cross_attention_bwd_lq_kernel<T, kTiled>
      <<<dim3(tiles, h, b), kTiled ? kBwdLqThreads : kBwdThreads, smem,
         stream>>>(
          q, k, v, g, dq, dk, dv, part, n, m, d, dh, rows, scale);
  e = cudaGetLastError();
  if (e != cudaSuccess || tiles == 1) return e;
  const size_t total = (size_t)b * m * d;
  const size_t blocks = (total + kBwdThreads - 1) / kBwdThreads;
  cross_attention_bwd_reduce_kernel<T>
      <<<(unsigned)(blocks < 65535 ? blocks : 65535), kBwdThreads, 0,
         stream>>>(part, dk, scale, dv, b, tiles, m * d);
  return cudaGetLastError();
}

// K4 in the schedule its rule picks (*schedule: 1 for the tiled one).
template <typename T>
cudaError_t launch_cross_bwd_any(const void* q, const void* k, const void* v,
                                 const void* g, void* dq, void* dk, void* dv,
                                 void* part, int b, int n, int m, int d,
                                 int h, int rows, float scale,
                                 cudaStream_t stream, int* schedule) {
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  const T* gt = static_cast<const T*>(g);
  T* dqt = static_cast<T*>(dq);
  T* dkt = static_cast<T*>(dk);
  T* dvt = static_cast<T*>(dv);
  float* pt = static_cast<float*>(part);
  if (cross_bwd_tiled(n, m, d / h, rows, aligned16(q) && aligned16(k) &&
                                           aligned16(v) && aligned16(g))) {
    *schedule = 1;
    return launch_cross_bwd<T, true>(qt, kt, vt, gt, dqt, dkt, dvt, pt, b, n,
                                     m, d, h, rows, scale, stream);
  }
  return launch_cross_bwd<T, false>(qt, kt, vt, gt, dqt, dkt, dvt, pt, b, n,
                                    m, d, h, rows, scale, stream);
}

bool bad_shape(int b, int n, int d, int h) {
  return b < 0 || n < 0 || h <= 0 || d <= 0 || d % h != 0 || h > 65535;
}

}  // namespace

extern "C" {

// *schedule: 1 where the launch took the tensor cores, 2 the register-tiled
// f32 schedule, 0 the CUDA-core kernel or no launch.
int ldt_packed_self_attention(const void* qkv, void* out, int b, int n, int d,
                              int h, float scale, int dtype, void* stream,
                              int* schedule) {
  *schedule = 0;
  if (bad_shape(b, n, d, h) || self_smem_bytes(n, d / h) > kMaxSmem)
    return (int)cudaErrorInvalidValue;
  if (b == 0 || n == 0) return (int)cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kDtypeF32)
    return (int)launch_self<float>(qkv, out, b, n, d, h, scale, s, schedule);
  if (dtype == kDtypeBF16)
    return (int)launch_self<__nv_bfloat16>(qkv, out, b, n, d, h, scale, s,
                                           schedule);
  return (int)cudaErrorInvalidValue;
}

// scales: f32 scratch of b / elems * 3 * (1 + elems * n) values. Both
// schedules write the group scales [b / elems, 3] at its start; the int8
// tensor-core schedule keeps its slices' partial maxima after them.
// *schedule: 1 where the launch took the int8 tensor cores, 0 the
// CUDA-core kernels or no launch.
int ldt_packed_self_attention_int8(const void* qkv, void* scales, void* out,
                                   int b, int n, int d, int h, int elems,
                                   float scale, int dtype, void* stream,
                                   int* schedule) {
  *schedule = 0;
  if (bad_shape(b, n, d, h) || elems <= 0 || b % elems != 0 ||
      self_smem_bytes(n, d / h) > kMaxSmem)
    return (int)cudaErrorInvalidValue;
  if (b == 0 || n == 0) return (int)cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kDtypeF32)
    return (int)launch_self_int8<float>(qkv, scales, out, b, n, d, h, elems,
                                        scale, s, schedule);
  if (dtype == kDtypeBF16)
    return (int)launch_self_int8<__nv_bfloat16>(qkv, scales, out, b, n, d, h,
                                                elems, scale, s, schedule);
  return (int)cudaErrorInvalidValue;
}

// dqkv: the packed [b, n, 3d] gradient; every element is written.
// *schedule: 1 where the launch took the register-tiled kernel
// (self_bwd_tiled), 0 the scalar kernel or no launch.
int ldt_packed_self_attention_bwd(const void* qkv, const void* g, void* dqkv,
                                  int b, int n, int d, int h, float scale,
                                  int dtype, void* stream, int* schedule) {
  *schedule = 0;
  if (bad_shape(b, n, d, h) || self_bwd_smem_bytes(n, d / h) > kMaxSmem)
    return (int)cudaErrorInvalidValue;
  if (b == 0 || n == 0) return (int)cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kDtypeF32)
    return (int)launch_self_bwd<float>(qkv, g, dqkv, b, n, d, h, scale, s,
                                       schedule);
  if (dtype == kDtypeBF16)
    return (int)launch_self_bwd<__nv_bfloat16>(qkv, g, dqkv, b, n, d, h,
                                               scale, s, schedule);
  return (int)cudaErrorInvalidValue;
}

// K2. work: f32 scratch for the long-key schedule (unused by the whole-set
// one) of b * chunks * (2 * h * n + n * d) values, chunks = ceil(m /
// cross_lk_keys(d / h)). Every element of out is written.
int ldt_cross_attention(const void* q, const void* k, const void* v,
                        void* out, void* work, int b, int n, int m, int d,
                        int h, float scale, int dtype, void* stream) {
  if (bad_shape(b, n, d, h) || m <= 0 || b > 65535)
    return (int)cudaErrorInvalidValue;
  const int dh = d / h;
  if (!cross_whole(m, dh)) {
    const int keys = cross_lk_keys(dh);
    if (keys == 0 || (long long)((m + keys - 1) / keys) *
                             ((n + kLkRows - 1) / kLkRows) > 2147483647LL)
      return (int)cudaErrorInvalidValue;
  }
  if (b == 0 || n == 0) return (int)cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kDtypeF32)
    return (int)launch_cross<float>(q, k, v, out, work, b, n, m, d, h, scale,
                                    s);
  if (dtype == kDtypeBF16)
    return (int)launch_cross<__nv_bfloat16>(q, k, v, out, work, b, n, m, d, h,
                                            scale, s);
  return (int)cudaErrorInvalidValue;
}

// K4. rows > 0 takes the long-query schedule with that many query rows per
// block (k and v of a head whole in shared memory); rows == 0 the long-key
// schedule (all n query rows of a head in each block, one block per chunk of
// kBwdKeys keys). part: f32 scratch of 2 * b * ceil(n / rows) * m * d values
// when the long-query schedule takes more than one tile (unused with one);
// of b * ceil(m / kBwdKeys) * (3 * h * n + n * d) values for the long-key
// schedule. Every element of dq, dk, dv is written. *schedule: 1 where the
// launch took the register-tiled kernels (cross_bwd_tiled), 0 the scalar
// kernels or no launch.
int ldt_cross_attention_bwd(const void* q, const void* k, const void* v,
                            const void* g, void* dq, void* dk, void* dv,
                            void* part, int b, int n, int m, int d, int h,
                            int rows, float scale, int dtype, void* stream,
                            int* schedule) {
  *schedule = 0;
  if (bad_shape(b, n, d, h) || m <= 0 || rows < 0 || b > 65535)
    return (int)cudaErrorInvalidValue;
  const int dh = d / h;
  if (rows > 0 ? cross_bwd_lq_smem_bytes(m, dh, rows) > kMaxSmem
               : cross_bwd_lk_smem_bytes(n, dh) > kMaxSmem)
    return (int)cudaErrorInvalidValue;
  if (b == 0 || n == 0) return (int)cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kDtypeF32)
    return (int)launch_cross_bwd_any<float>(q, k, v, g, dq, dk, dv, part, b,
                                            n, m, d, h, rows, scale, s,
                                            schedule);
  if (dtype == kDtypeBF16)
    return (int)launch_cross_bwd_any<__nv_bfloat16>(q, k, v, g, dq, dk, dv,
                                                    part, b, n, m, d, h, rows,
                                                    scale, s, schedule);
  return (int)cudaErrorInvalidValue;
}

const char* ldt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
