// Attention cores of the latent DiT and of the set-VAE decoder, for sm_90a.
//
// K1 ldt_packed_self_attention: per head softmax(q_h k_h^T * dh^-1/2) v_h
//    read straight from the packed [B, N, 3D] qkv GEMM output (q, k, v at
//    column offsets 0, D, 2D), written to [B, N, D] with heads concatenated.
//    Replaces ldt_tpu/ops/pallas_attention.py::_fwd_kernel_packed_phased_multi
//    (and its one-element and per-head schedules, which compute the same).
// K2 ldt_cross_attention: the same function for q [B, N, D] against
//    k, v [B, M, D], any M up to the shared-memory bound.
//    Replaces ldt_tpu/ops/pallas_attention.py::_fwd_kernel (and the grouped
//    schedule _fwd_kernel_grouped, which computes the same).
//
// Numerics follow the TPU kernels: products accumulate in f32, the softmax
// runs in f32 (max-shifted, exp, divide by the row sum), and the weights are
// rounded to the input dtype before the AV product.
//
// Both are memory-bound at the shapes the sampler gives them (K1: N=32,
// dh=64, 16 heads; K2: N=2048, M=32, dh=32, 4 heads), so each block reads its
// head's operands from device memory once, keeps them and the scores in
// shared memory, and writes each output element once. The arithmetic runs on
// the CUDA cores in f32; tensor cores (wgmma) and TMA are later work.
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
// K2: warps per block and query rows per warp. ldt_torch/ops/attention.py
// mirrors kCrossWarps in its shared-memory bound.
constexpr int kCrossWarps = 4;
constexpr int kCrossRowsPerWarp = 16;

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
cudaError_t launch_cross(const void* q, const void* k, const void* v,
                         void* out, int b, int n, int m, int d, int h,
                         float scale, cudaStream_t stream) {
  const int dh = d / h;
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

int ldt_cross_attention(const void* q, const void* k, const void* v,
                        void* out, int b, int n, int m, int d, int h,
                        float scale, int dtype, void* stream) {
  if (bad_shape(b, n, d, h) || m <= 0 ||
      cross_smem_bytes(m, d / h) > kMaxSmem ||
      (n + kCrossWarps * kCrossRowsPerWarp - 1) /
              (kCrossWarps * kCrossRowsPerWarp) > 65535)
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
