// Attention cores of the latent DiT and of the set-VAE, for sm_90a.
//
// K1 ldt_packed_self_attention: per head softmax(q_h k_h^T * dh^-1/2) v_h
//    read straight from the packed [B, N, 3D] qkv GEMM output (q, k, v at
//    column offsets 0, D, 2D), written to [B, N, D] with heads concatenated.
//    Replaces ldt_tpu/ops/pallas_attention.py::_fwd_kernel_packed_phased_multi
//    (and its one-element and per-head schedules, which compute the same).
// K3 ldt_packed_self_attention_bwd: the backward of K1. From the packed qkv
//    and the output's gradient g [B, N, D] it recomputes the f32 weights w and
//    writes dq, dk, dv into one packed [B, N, 3D] gradient:
//      dv = round(w)^T g,  dw = g v^T,  ds = w * (dw - rowsum(dw * w)),
//      dq = round(ds) k * dh^-1/2,  dk = round(ds)^T q * dh^-1/2,
//    with round() to the input dtype, products in f32.
//    Replaces ldt_tpu/ops/pallas_attention.py::_bwd_kernel_packed_phased (and
//    _bwd_kernel_packed, the same function).
// K2 ldt_cross_attention: the same function as K1 for q [B, N, D] against
//    k, v [B, M, D], any M. Replaces ldt_tpu/ops/pallas_attention.py::
//    _fwd_kernel (and the grouped schedule _fwd_kernel_grouped, which
//    computes the same). Two schedules: where a head's k and v fit in shared
//    memory (the decode's M=32) each block keeps them whole; longer key sets
//    (the posterior's M=2048) stream through shared memory in tiles, twice:
//    once for the scores of the block's query rows, which stay in shared
//    memory for the f32 softmax, once for the AV product. Both give the same
//    bits: every sum runs in the same order.
// K8 ldt_packed_self_attention_int8: K1 with int8 operands. q, k and v are
//    quantized to int8 with one symmetric scale each per group of `elems`
//    consecutive batch elements (max|x| / 127 + 1e-20 over the group's rows
//    and all heads), the scores and the AV product are int32 dots, and the
//    f32 softmax weights are quantized at the static scale 127 before AV.
//    Replaces ldt_tpu/ops/pallas_attention.py::
//    _fwd_kernel_packed_phased_multi_int8. Two launches: one block per
//    (group, q|k|v) reduces the scales, then one block per (element, head)
//    as in K1 (a group is 4 x 32 x 3072 values, more than a block holds).
//
// Numerics of K1, K2 and K3 follow the TPU kernels: products accumulate in
// f32, the softmax runs in f32 (max-shifted, exp, divide by the row sum), and
// the weights are rounded to the input dtype before the AV product (K3: before
// dv, and ds before dq and dk). K8 rounds half to even (rintf, as jnp.round)
// and divides exactly: the build has no --use_fast_math, which would make `/`
// approximate.
//
// All four are memory-bound at the shapes the model gives them (K1, K3 and
// K8: N=32, dh=64, 16 heads; K2: N=2048, M=32 and N=32, M=2048, dh=32, 4
// heads), so each block reads its head's operands from device memory once
// (the tiled K2: once per block of query rows), keeps them and the scores in
// shared memory, and writes each output element once (K8 reads the packed
// qkv twice: once for the group scales). The arithmetic runs on the CUDA
// cores, in f32 (K1, K2, K3) or int32 (K8's dots); tensor cores (wgmma) and
// TMA are later work.
//
// C interface for ctypes: each entry point returns cudaGetLastError() after
// the launch (0 on success). dtype: 0 = float32, 1 = bfloat16.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

namespace {

constexpr int kDtypeF32 = 0;
constexpr int kDtypeBF16 = 1;
// Most dynamic shared memory an sm_90 block may use.
constexpr size_t kMaxSmem = 232448;
// Above this a kernel needs cudaFuncAttributeMaxDynamicSharedMemorySize.
constexpr size_t kDefaultSmem = 48 * 1024;

constexpr int kSelfThreads = 256;
// K8's scale reduction: threads per (group, q|k|v) block.
constexpr int kScaleThreads = 512;
// K2: warps per block and query rows per warp. ldt_torch/ops/attention.py
// mirrors kCrossWarps in its shared-memory bound.
constexpr int kCrossWarps = 4;
constexpr int kCrossRowsPerWarp = 16;
// K2's tiled schedule: threads per block, keys per tile, and at most this
// many query rows per block (fewer where their scores would not fit).
// ldt_torch/ops/attention.py mirrors kTiledKeys in its shared-memory bound.
constexpr int kTiledThreads = 256;
constexpr int kTiledKeys = 256;
constexpr int kTiledRows = 8;

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

// Shared memory of K1: q [n, dh], k [n, dh+1] (odd stride: lanes reading
// different keys hit different banks), v [n, dh], scores [n, n]; all f32.
size_t self_smem_bytes(int n, int dh) {
  return sizeof(float) *
         ((size_t)n * dh + (size_t)n * (dh + 1) + (size_t)n * dh +
          (size_t)n * n);
}

// Shared memory of K2: k [m, dh+1], v [m, dh], and per warp one query row
// [dh] and its weights [m]; all f32.
size_t cross_smem_bytes(int m, int dh) {
  return sizeof(float) * ((size_t)m * (dh + 1) + (size_t)m * dh +
                          (size_t)kCrossWarps * dh + (size_t)kCrossWarps * m);
}

// Shared memory of K2's tiled schedule with `rows` query rows per block: one
// tile [kTiledKeys, dh+1] (k tiles in the first pass, v tiles in the
// second), the rows' q [rows, dh] and AV sums [rows, dh], and their weights
// [rows, m]; all f32.
size_t cross_tiled_smem_bytes(int m, int dh, int rows) {
  return sizeof(float) * ((size_t)kTiledKeys * (dh + 1) +
                          2 * (size_t)rows * dh + (size_t)rows * m);
}

// Query rows per block of the tiled K2: the most, up to kTiledRows, whose
// scores fit; 0 if not even one row fits.
int cross_tiled_rows(int m, int dh) {
  for (int rows = kTiledRows; rows > 0; rows >>= 1)
    if (cross_tiled_smem_bytes(m, dh, rows) <= kMaxSmem) return rows;
  return 0;
}

// Shared memory of K3: q [n, dh], k and v [n, dh+1], g [n, dh], and the
// [n, n] weights and their gradient; all f32.
size_t self_bwd_smem_bytes(int n, int dh) {
  return sizeof(float) * (2 * (size_t)n * dh + 2 * (size_t)n * (dh + 1) +
                          2 * (size_t)n * n);
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
    float mx = -INFINITY;
    for (int c = lane; c < n; c += 32) mx = fmaxf(mx, s[c]);
    mx = warp_max(mx);
    float sum = 0.f;
    for (int c = lane; c < n; c += 32) {
      const float e = expf(s[c] - mx);
      s[c] = e;
      sum += e;
    }
    sum = warp_sum(sum);
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

// Grid (batch, head, query tile); each warp owns whole query rows.
template <typename T>
__global__ void __launch_bounds__(kCrossWarps * 32)
cross_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ out, int n,
                       int m, int d, int dh, float scale) {
  extern __shared__ float smem[];
  const int b = blockIdx.x;
  const int h = blockIdx.y;
  const int ldk = dh + 1;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  float* ks = smem;
  float* vs = ks + (size_t)m * ldk;
  float* qw = vs + (size_t)m * dh + (size_t)warp * dh;
  float* ww = vs + (size_t)m * dh + (size_t)kCrossWarps * dh +
              (size_t)warp * m;

  const size_t kv0 = (size_t)b * m * d + (size_t)h * dh;
  for (int i = threadIdx.x; i < m * dh; i += blockDim.x) {
    const int r = i / dh;
    const int c = i - r * dh;
    ks[r * ldk + c] = to_f32(k[kv0 + (size_t)r * d + c]);
    vs[i] = to_f32(v[kv0 + (size_t)r * d + c]);
  }
  __syncthreads();

  const int rows = kCrossWarps * kCrossRowsPerWarp;
  const int row_end = min(n, (int)(blockIdx.z + 1) * rows);
  for (int r = blockIdx.z * rows + warp; r < row_end; r += kCrossWarps) {
    const size_t o = ((size_t)b * n + r) * d + (size_t)h * dh;
    for (int c = lane; c < dh; c += 32) qw[c] = to_f32(q[o + c]);
    __syncwarp();
    float mx = -INFINITY;
    for (int c = lane; c < m; c += 32) {
      const float* kr = ks + (size_t)c * ldk;
      float acc = 0.f;
      for (int j = 0; j < dh; ++j) acc = fmaf(qw[j], kr[j], acc);
      acc *= scale;
      ww[c] = acc;
      mx = fmaxf(mx, acc);
    }
    mx = warp_max(mx);
    float sum = 0.f;
    for (int c = lane; c < m; c += 32) {
      const float e = expf(ww[c] - mx);
      ww[c] = e;
      sum += e;
    }
    sum = warp_sum(sum);
    for (int c = lane; c < m; c += 32) ww[c] = round_to<T>(ww[c] / sum);
    __syncwarp();
    for (int c = lane; c < dh; c += 32) {
      float acc = 0.f;
      for (int j = 0; j < m; ++j) acc = fmaf(ww[j], vs[(size_t)j * dh + c], acc);
      out[o + c] = from_f32<T>(acc);
    }
    __syncwarp();
  }
}

// K2's tiled schedule for key sets too long for shared memory. Grid (query
// row block, head, batch); `rows` query rows per block. Pass 1 streams the
// head's keys in tiles and keeps the rows' scores; one warp per row takes
// the softmax as the whole-set kernel does (same lanes, same sums) and
// rounds the weights to T; pass 2 streams the values and accumulates each
// output in key order, so both schedules give the same bits.
template <typename T>
__global__ void __launch_bounds__(kTiledThreads)
cross_attention_tiled_kernel(const T* __restrict__ q, const T* __restrict__ k,
                             const T* __restrict__ v, T* __restrict__ out,
                             int n, int m, int d, int dh, int rows,
                             float scale) {
  extern __shared__ float smem[];
  const int b = blockIdx.z;
  const int h = blockIdx.y;
  const int r0 = blockIdx.x * rows;
  const int nr = min(rows, n - r0);
  const int ldk = dh + 1;
  float* ks = smem;                                // [kTiledKeys, dh+1]
  float* vs = smem;                                // [kTiledKeys, dh], pass 2
  float* qs = ks + (size_t)kTiledKeys * ldk;       // [rows, dh]
  float* os = qs + (size_t)rows * dh;              // [rows, dh]
  float* ws = os + (size_t)rows * dh;              // [rows, m]

  const size_t kv0 = (size_t)b * m * d + (size_t)h * dh;
  const size_t q0 = ((size_t)b * n + r0) * d + (size_t)h * dh;
  for (int i = threadIdx.x; i < nr * dh; i += blockDim.x) {
    const int r = i / dh;
    const int c = i - r * dh;
    qs[i] = to_f32(q[q0 + (size_t)r * d + c]);
    os[i] = 0.f;
  }

  // pass 1: scores; thread i owns (row r, key j) of the tile
  for (int t0 = 0; t0 < m; t0 += kTiledKeys) {
    const int tm = min(kTiledKeys, m - t0);
    __syncthreads();  // the previous tile is consumed; q is loaded
    for (int i = threadIdx.x; i < tm * dh; i += blockDim.x) {
      const int r = i / dh;
      const int c = i - r * dh;
      ks[r * ldk + c] = to_f32(k[kv0 + (size_t)(t0 + r) * d + c]);
    }
    __syncthreads();
    for (int i = threadIdx.x; i < nr * tm; i += blockDim.x) {
      const int r = i / tm;
      const int j = i - r * tm;
      const float* qr = qs + (size_t)r * dh;
      const float* kr = ks + (size_t)j * ldk;
      float acc = 0.f;
      for (int c = 0; c < dh; ++c) acc = fmaf(qr[c], kr[c], acc);
      ws[(size_t)r * m + t0 + j] = acc * scale;
    }
  }
  __syncthreads();  // the scores are complete; the k tile is consumed

  // row softmax, one warp per row, as cross_attention_kernel
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int nwarps = blockDim.x >> 5;
  for (int r = warp; r < nr; r += nwarps) {
    float* s = ws + (size_t)r * m;
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
    for (int c = lane; c < m; c += 32) s[c] = round_to<T>(s[c] / sum);
  }

  // pass 2: AV; thread i owns output (row r, channel c) across the tiles
  for (int t0 = 0; t0 < m; t0 += kTiledKeys) {
    const int tm = min(kTiledKeys, m - t0);
    __syncthreads();  // the weights are final; the tile buffer is free
    for (int i = threadIdx.x; i < tm * dh; i += blockDim.x) {
      const int r = i / dh;
      const int c = i - r * dh;
      vs[i] = to_f32(v[kv0 + (size_t)(t0 + r) * d + c]);
    }
    __syncthreads();
    for (int i = threadIdx.x; i < nr * dh; i += blockDim.x) {
      const int r = i / dh;
      const int c = i - r * dh;
      const float* w = ws + (size_t)r * m + t0;
      float acc = os[i];
      for (int j = 0; j < tm; ++j) acc = fmaf(w[j], vs[(size_t)j * dh + c], acc);
      os[i] = acc;
    }
  }
  // each thread writes the sums it accumulated itself
  for (int i = threadIdx.x; i < nr * dh; i += blockDim.x) {
    const int r = i / dh;
    const int c = i - r * dh;
    out[q0 + (size_t)r * d + c] = from_f32<T>(os[i]);
  }
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

  // per row, one warp: the f32 softmax w (kept unrounded), then
  // ds = w * (dw - rowsum(dw * w)) rounded to T
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int nwarps = blockDim.x >> 5;
  for (int r = warp; r < n; r += nwarps) {
    float* s = ws + (size_t)r * n;
    float* dr = ds + (size_t)r * n;
    float mx = -INFINITY;
    for (int c = lane; c < n; c += 32) mx = fmaxf(mx, s[c]);
    mx = warp_max(mx);
    float sum = 0.f;
    for (int c = lane; c < n; c += 32) {
      const float e = expf(s[c] - mx);
      s[c] = e;
      sum += e;
    }
    sum = warp_sum(sum);
    float dot = 0.f;
    for (int c = lane; c < n; c += 32) {
      const float w = s[c] / sum;
      s[c] = w;
      dot += dr[c] * w;
    }
    dot = warp_sum(dot);
    for (int c = lane; c < n; c += 32)
      dr[c] = round_to<T>(s[c] * (dr[c] - dot));
  }
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

// q8(x, s) = clip(round_half_even(x / s), -127, 127).
__device__ __forceinline__ int quantize_int8(float x, float s) {
  return (int)fminf(fmaxf(rintf(x / s), -127.f), 127.f);
}

// K8, first launch: grid (group, part), part 0/1/2 = q/k/v. Writes
// scales[group * 3 + part] = max|x| / 127 + 1e-20 over the `rows` rows of
// the group and the part's d columns.
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

// K8, second launch: one block per (batch element, head), K1's layout with
// int32 copies of the int8 codes: q [n, dh], k [n, dh+1], v [n, dh], and the
// [n, n] scores (later the weight codes) as f32.
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
    float mx = -INFINITY;
    for (int c = lane; c < n; c += 32) mx = fmaxf(mx, s[c]);
    mx = warp_max(mx);
    float sum = 0.f;
    for (int c = lane; c < n; c += 32) {
      const float e = expf(s[c] - mx);
      s[c] = e;
      sum += e;
    }
    sum = warp_sum(sum);
    for (int c = lane; c < n; c += 32)
      s[c] = fminf(fmaxf(rintf((s[c] / sum) * 127.0f), 0.f), 127.f);
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

template <typename T>
cudaError_t launch_self_int8(const void* qkv, void* scales, void* out, int b,
                             int n, int d, int h, int elems, float scale,
                             cudaStream_t stream) {
  const int dh = d / h;
  const size_t smem = self_smem_bytes(n, dh);
  if (smem > kDefaultSmem) {
    cudaError_t e = cudaFuncSetAttribute(
        packed_self_attention_int8_kernel<T>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  int8_group_scales_kernel<T><<<dim3(b / elems, 3), kScaleThreads, 0,
                                stream>>>(static_cast<const T*>(qkv),
                                          static_cast<float*>(scales),
                                          elems * n, d);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  packed_self_attention_int8_kernel<T>
      <<<dim3(b, h), kSelfThreads, smem, stream>>>(
          static_cast<const T*>(qkv), static_cast<const float*>(scales),
          static_cast<T*>(out), n, d, dh, elems, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_self(const void* qkv, void* out, int b, int n, int d,
                        int h, float scale, cudaStream_t stream) {
  const int dh = d / h;
  const size_t smem = self_smem_bytes(n, dh);
  if (smem > kDefaultSmem) {
    cudaError_t e = cudaFuncSetAttribute(
        packed_self_attention_kernel<T>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  packed_self_attention_kernel<T><<<dim3(b, h), kSelfThreads, smem, stream>>>(
      static_cast<const T*>(qkv), static_cast<T*>(out), n, d, dh, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_self_bwd(const void* qkv, const void* g, void* dqkv, int b,
                            int n, int d, int h, float scale,
                            cudaStream_t stream) {
  const int dh = d / h;
  const size_t smem = self_bwd_smem_bytes(n, dh);
  if (smem > kDefaultSmem) {
    cudaError_t e = cudaFuncSetAttribute(
        packed_self_attention_bwd_kernel<T>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  packed_self_attention_bwd_kernel<T>
      <<<dim3(b, h), kSelfThreads, smem, stream>>>(
          static_cast<const T*>(qkv), static_cast<const T*>(g),
          static_cast<T*>(dqkv), n, d, dh, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_cross_tiled(const void* q, const void* k, const void* v,
                               void* out, int b, int n, int m, int d, int h,
                               float scale, cudaStream_t stream) {
  const int dh = d / h;
  const int rows = cross_tiled_rows(m, dh);
  const size_t smem = cross_tiled_smem_bytes(m, dh, rows);
  if (smem > kDefaultSmem) {
    cudaError_t e = cudaFuncSetAttribute(
        cross_attention_tiled_kernel<T>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  const dim3 grid((n + rows - 1) / rows, h, b);
  cross_attention_tiled_kernel<T><<<grid, kTiledThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), n, m, d, dh, rows,
      scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_cross(const void* q, const void* k, const void* v,
                         void* out, int b, int n, int m, int d, int h,
                         float scale, cudaStream_t stream) {
  const int dh = d / h;
  if (cross_smem_bytes(m, dh) > kMaxSmem)
    return launch_cross_tiled<T>(q, k, v, out, b, n, m, d, h, scale, stream);
  const size_t smem = cross_smem_bytes(m, dh);
  if (smem > kDefaultSmem) {
    cudaError_t e = cudaFuncSetAttribute(
        cross_attention_kernel<T>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  const int rows = kCrossWarps * kCrossRowsPerWarp;
  const dim3 grid(b, h, (n + rows - 1) / rows);
  cross_attention_kernel<T><<<grid, kCrossWarps * 32, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), n, m, d, dh, scale);
  return cudaGetLastError();
}

bool bad_shape(int b, int n, int d, int h) {
  return b < 0 || n < 0 || h <= 0 || d <= 0 || d % h != 0 || h > 65535;
}

}  // namespace

extern "C" {

int ldt_packed_self_attention(const void* qkv, void* out, int b, int n, int d,
                              int h, float scale, int dtype, void* stream) {
  if (bad_shape(b, n, d, h) || self_smem_bytes(n, d / h) > kMaxSmem)
    return (int)cudaErrorInvalidValue;
  if (b == 0 || n == 0) return (int)cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kDtypeF32)
    return (int)launch_self<float>(qkv, out, b, n, d, h, scale, s);
  if (dtype == kDtypeBF16)
    return (int)launch_self<__nv_bfloat16>(qkv, out, b, n, d, h, scale, s);
  return (int)cudaErrorInvalidValue;
}

// scales: f32 scratch of b / elems * 3 values (the group scales).
int ldt_packed_self_attention_int8(const void* qkv, void* scales, void* out,
                                   int b, int n, int d, int h, int elems,
                                   float scale, int dtype, void* stream) {
  if (bad_shape(b, n, d, h) || elems <= 0 || b % elems != 0 ||
      self_smem_bytes(n, d / h) > kMaxSmem)
    return (int)cudaErrorInvalidValue;
  if (b == 0 || n == 0) return (int)cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kDtypeF32)
    return (int)launch_self_int8<float>(qkv, scales, out, b, n, d, h, elems,
                                        scale, s);
  if (dtype == kDtypeBF16)
    return (int)launch_self_int8<__nv_bfloat16>(qkv, scales, out, b, n, d, h,
                                                elems, scale, s);
  return (int)cudaErrorInvalidValue;
}

// dqkv: the packed [b, n, 3d] gradient; every element is written.
int ldt_packed_self_attention_bwd(const void* qkv, const void* g, void* dqkv,
                                  int b, int n, int d, int h, float scale,
                                  int dtype, void* stream) {
  if (bad_shape(b, n, d, h) || self_bwd_smem_bytes(n, d / h) > kMaxSmem)
    return (int)cudaErrorInvalidValue;
  if (b == 0 || n == 0) return (int)cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kDtypeF32)
    return (int)launch_self_bwd<float>(qkv, g, dqkv, b, n, d, h, scale, s);
  if (dtype == kDtypeBF16)
    return (int)launch_self_bwd<__nv_bfloat16>(qkv, g, dqkv, b, n, d, h,
                                               scale, s);
  return (int)cudaErrorInvalidValue;
}

int ldt_cross_attention(const void* q, const void* k, const void* v,
                        void* out, int b, int n, int m, int d, int h,
                        float scale, int dtype, void* stream) {
  if (bad_shape(b, n, d, h) || m <= 0) return (int)cudaErrorInvalidValue;
  const bool whole = cross_smem_bytes(m, d / h) <= kMaxSmem;
  if (whole ? (n + kCrossWarps * kCrossRowsPerWarp - 1) /
                      (kCrossWarps * kCrossRowsPerWarp) > 65535
            : cross_tiled_rows(m, d / h) == 0 || b > 65535)
    return (int)cudaErrorInvalidValue;
  if (b == 0 || n == 0) return (int)cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kDtypeF32)
    return (int)launch_cross<float>(q, k, v, out, b, n, m, d, h, scale, s);
  if (dtype == kDtypeBF16)
    return (int)launch_cross<__nv_bfloat16>(q, k, v, out, b, n, m, d, h,
                                            scale, s);
  return (int)cudaErrorInvalidValue;
}

const char* ldt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
