// Evaluation kernels of the point-cloud metrics, for sm_90a.
//
// K5 ldt_pairwise_cd_means: for each pair p of clouds x [P, N, 3] and
//    y [P, M, 3], mean_i min_j d_ij + mean_j min_i d_ij with the squared
//    distances d_ij = |x_i - y_j|^2. Replaces ldt_tpu/ops/chamfer.py::
//    _pairwise_cd_kernel. One block per pair: both clouds in shared memory
//    (coordinate-major, 48 KB at 2048 points each); a first pass gives each
//    thread four rows of x (in registers) and runs them over every point of
//    y for their minima, a second pass the same with the roles swapped for
//    the column minima. A minimum is exact, so both are deterministic; the
//    minima are summed per thread in row order and then over the block in a
//    fixed tree (no atomics: a run repeats itself bit for bit).
// K6/K7 ldt_approx_match_cost: the annealed approx-match transport cost
//    sum_ij match_ij * sqrt(d_ij) of each pair over the 9 levels
//    L = -4^7 ... -4^-1 (ldt_tpu/ops/emd.py::_approx_match_cost_single's
//    arithmetic):
//      w        = exp(L * d)
//      ratio_l  = remain_l / (1e-9 + w @ remain_r)
//      sumr     = (ratio_l @ w) * remain_r
//      ratio_r  = min(remain_r / (sumr + 1e-9), 1) * remain_r
//      cost    += ratio_l @ ((w * sqrt(max(d, 1e-20))) @ ratio_r)
//      remain_l = max(0, remain_l - ratio_l * (w @ ratio_r))
//      remain_r = max(0, remain_r - sumr)
//    from remain_l = max(1, M / N), remain_r = max(1, N / M). K6 (otf = 0)
//    reads a precomputed d [P, N, M] from device memory; it replaces
//    ldt_tpu/ops/emd.py::_approx_match_cost_kernel (with _emd_pair_step).
//    K7 (otf = 1) builds each d_ij from the two clouds held in shared memory;
//    it replaces _approx_match_cost_otf_kernel. Both are one template: only
//    the source of d differs, so on the same d they return the same bits.
//    One block per pair loops over the levels, and within a level over three
//    passes: rows (warps own rows: the row sums and ratio_l), columns
//    (threads own four columns: sumr, then ratio_r), rows again (the cost
//    and remain_l). The per-pair state (remain_l, ratio_l: [N]; remain_r,
//    sumr, ratio_r: [M]) stays in shared memory, 40 KB at 2048 points; w is
//    recomputed at each use, never stored. Every sum runs in a fixed order
//    and no atomics are used, so a run repeats itself bit for bit.
//
// Distances: d_ij is taken in the direct form sum_c (x_ic - y_jc)^2, one
// coordinate at a time with __fsub_rn / __fmul_rn / __fadd_rn, the order of
// ldt_torch/ops/geometry.py::square_distance. The intrinsics keep nvcc from
// contracting the products and sums into FMAs, so d has the same bits as on
// the CPU and as the d that K6 reads: K6 and K7 agree bit for bit, and K5's
// minima equal the CPU's. The exponentials use expf, not __expf (the build
// has no --use_fast_math): the fast intrinsic's error grows with |x|, and
// here x reaches -4^7 d.
//
// Bounds on an H100 at the eval tile (64 pairs of 2048-point clouds): K5 is
// bound by f32 operations (~10 N M per pair; its bytes are the clouds); K6
// and K7 by the 9 N M exponentials on the special-function units (16 per SM
// per clock), above the f32 FMAs and K6's one read of d (16.8 MB per pair).
// This first version recomputes each w three times per level on the CUDA
// cores and SFUs; caching a row tile's w and using more blocks per pair are
// later work.
//
// C interface for ctypes: each entry point returns cudaGetLastError() after
// the launch (0 on success); x, y, d and out are contiguous float32.

#include <cuda_runtime.h>
#include <float.h>
#include <math.h>
#include <stddef.h>

namespace {

// Most dynamic shared memory an sm_90 block may use, and what it may use
// without opting in.
constexpr int kMaxSmem = 232448;
constexpr int kDefaultSmem = 49152;
constexpr int kCdThreads = 256;
constexpr int kCdRows = 4;        // rows of a K5 thread per pass
constexpr int kEmdThreads = 512;
constexpr int kEmdWarps = kEmdThreads / 32;
constexpr int kEmdCols = 4;       // columns of a K6/K7 thread per pass
constexpr int kLevels = 9;

__device__ __forceinline__ float sq_dist(float ax, float ay, float az,
                                         float bx, float by, float bz) {
  const float dx = __fsub_rn(ax, bx);
  const float dy = __fsub_rn(ay, by);
  const float dz = __fsub_rn(az, bz);
  return __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                   __fmul_rn(dz, dz));
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Sum of v over the block (fixed order), valid in thread 0. `red` holds one
// float per warp.
__device__ float block_sum(float v, float* red) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  v = warp_sum(v);
  __syncthreads();
  if (lane == 0) red[warp] = v;
  __syncthreads();
  float t = 0.f;
  if (threadIdx.x == 0)
    for (int w = 0; w < (int)(blockDim.x >> 5); ++w) t += red[w];
  return t;
}

// Coordinate-major copy of a [k, 3] cloud into shared memory ([3][k]).
__device__ void load_cloud(const float* __restrict__ src, float* dst, int k) {
  for (int e = threadIdx.x; e < 3 * k; e += blockDim.x)
    dst[(e % 3) * k + e / 3] = src[e];
}

// This thread's sum of min_j d(a_i, b_j) over its rows i of a ([3][na]),
// against every point of b ([3][nb]); rows in increasing order.
__device__ float row_min_sum(const float* a, int na, const float* b, int nb) {
  float sum = 0.f;
  for (int base = 0; base < na; base += kCdThreads * kCdRows) {
    float ax[kCdRows], ay[kCdRows], az[kCdRows], best[kCdRows];
#pragma unroll
    for (int r = 0; r < kCdRows; ++r) {
      const int i = min(base + r * kCdThreads + (int)threadIdx.x, na - 1);
      ax[r] = a[i];
      ay[r] = a[na + i];
      az[r] = a[2 * na + i];
      best[r] = FLT_MAX;
    }
    for (int j = 0; j < nb; ++j) {
      const float bx = b[j], by = b[nb + j], bz = b[2 * nb + j];
#pragma unroll
      for (int r = 0; r < kCdRows; ++r)
        best[r] = fminf(best[r], sq_dist(ax[r], ay[r], az[r], bx, by, bz));
    }
#pragma unroll
    for (int r = 0; r < kCdRows; ++r)
      if (base + r * kCdThreads + (int)threadIdx.x < na) sum += best[r];
  }
  return sum;
}

__global__ void __launch_bounds__(kCdThreads)
pairwise_cd_means_kernel(const float* __restrict__ x,
                         const float* __restrict__ y,
                         float* __restrict__ out, int n, int m) {
  extern __shared__ float smem[];
  float* xs = smem;         // [3][n]
  float* ys = xs + 3 * n;   // [3][m]
  float* red = ys + 3 * m;  // [warps]
  const size_t p = blockIdx.x;
  load_cloud(x + p * n * 3, xs, n);
  load_cloud(y + p * m * 3, ys, m);
  __syncthreads();
  const float rows = block_sum(row_min_sum(xs, n, ys, m), red);
  // d(y_j, x_i) has the bits of d(x_i, y_j): a - b is exactly -(b - a)
  const float cols = block_sum(row_min_sum(ys, m, xs, n), red);
  if (threadIdx.x == 0) out[p] = rows / (float)n + cols / (float)m;
}

__device__ __forceinline__ float level_of(int lv) {
  // -4^(7 - lv): -16384, -4096, ..., -0.25 (exact powers of two)
  return -ldexpf(1.f, 14 - 2 * lv);
}

template <bool kOtf>
__global__ void __launch_bounds__(kEmdThreads)
approx_match_cost_kernel(const float* __restrict__ x,
                         const float* __restrict__ y,
                         const float* __restrict__ d,
                         float* __restrict__ out, int n, int m) {
  extern __shared__ float smem[];
  float* remain_l = smem;           // [n]
  float* ratio_l = remain_l + n;    // [n]
  float* remain_r = ratio_l + n;    // [m]
  float* sumr = remain_r + m;       // [m]
  float* ratio_r = sumr + m;        // [m]
  float* red = ratio_r + m;         // [kEmdWarps]
  float* xs = red + kEmdWarps;      // K7: [3][n]
  float* ys = xs + 3 * n;           // K7: [3][m]
  const size_t p = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const float* dp = kOtf ? nullptr : d + p * n * m;
  if (kOtf) {
    load_cloud(x + p * n * 3, xs, n);
    load_cloud(y + p * m * 3, ys, m);
  }
  const float multi_l = (float)max(1, m / n);
  const float multi_r = (float)max(1, n / m);
  for (int i = tid; i < n; i += kEmdThreads) remain_l[i] = multi_l;
  for (int j = tid; j < m; j += kEmdThreads) remain_r[j] = multi_r;
  __syncthreads();

  // d_ij; (xi0, xi1, xi2) is x_i in K7 (unused in K6)
  auto dist2 = [&](int i, int j, float xi0, float xi1, float xi2) -> float {
    if (kOtf)
      return fmaxf(sq_dist(xi0, xi1, xi2, ys[j], ys[m + j], ys[2 * m + j]),
                   0.f);
    return dp[(size_t)i * m + j];
  };

  float cost = 0.f;  // thread 0's running total
  for (int lv = 0; lv < kLevels; ++lv) {
    const float level = level_of(lv);

    // rows: ratio_l_i = remain_l_i / (1e-9 + sum_j w_ij remain_r_j)
    for (int i = warp; i < n; i += kEmdWarps) {
      const float xi0 = kOtf ? xs[i] : 0.f;
      const float xi1 = kOtf ? xs[n + i] : 0.f;
      const float xi2 = kOtf ? xs[2 * n + i] : 0.f;
      float s = 0.f;
      for (int j = lane; j < m; j += 32)
        s += expf(level * dist2(i, j, xi0, xi1, xi2)) * remain_r[j];
      s = warp_sum(s);
      if (lane == 0) ratio_l[i] = remain_l[i] / (1e-9f + s);
    }
    __syncthreads();

    // columns: sumr_j = (sum_i ratio_l_i w_ij) remain_r_j, then ratio_r_j
    for (int j0 = tid; j0 < m; j0 += kEmdThreads * kEmdCols) {
      float acc[kEmdCols], y0[kEmdCols], y1[kEmdCols], y2[kEmdCols];
      int jc[kEmdCols];
#pragma unroll
      for (int c = 0; c < kEmdCols; ++c) {
        jc[c] = min(j0 + c * kEmdThreads, m - 1);
        acc[c] = 0.f;
        y0[c] = kOtf ? ys[jc[c]] : 0.f;
        y1[c] = kOtf ? ys[m + jc[c]] : 0.f;
        y2[c] = kOtf ? ys[2 * m + jc[c]] : 0.f;
      }
      for (int i = 0; i < n; ++i) {
        const float rl = ratio_l[i];
        const float xi0 = kOtf ? xs[i] : 0.f;
        const float xi1 = kOtf ? xs[n + i] : 0.f;
        const float xi2 = kOtf ? xs[2 * n + i] : 0.f;
#pragma unroll
        for (int c = 0; c < kEmdCols; ++c) {
          const float dd =
              kOtf ? fmaxf(sq_dist(xi0, xi1, xi2, y0[c], y1[c], y2[c]), 0.f)
                   : dp[(size_t)i * m + jc[c]];
          acc[c] += rl * expf(level * dd);
        }
      }
#pragma unroll
      for (int c = 0; c < kEmdCols; ++c) {
        const int j = j0 + c * kEmdThreads;
        if (j < m) {
          const float rr = remain_r[j];
          const float s = acc[c] * rr;
          sumr[j] = s;
          ratio_r[j] = fminf(rr / (s + 1e-9f), 1.f) * rr;
        }
      }
    }
    __syncthreads();

    // rows: the level's cost and remain_l
    float level_cost = 0.f;  // this warp's rows, in order (lane 0)
    for (int i = warp; i < n; i += kEmdWarps) {
      const float xi0 = kOtf ? xs[i] : 0.f;
      const float xi1 = kOtf ? xs[n + i] : 0.f;
      const float xi2 = kOtf ? xs[2 * n + i] : 0.f;
      float wr = 0.f, c = 0.f;
      for (int j = lane; j < m; j += 32) {
        const float dd = dist2(i, j, xi0, xi1, xi2);
        const float w = expf(level * dd);
        const float rr = ratio_r[j];
        c += (w * sqrtf(fmaxf(dd, 1e-20f))) * rr;
        wr += w * rr;
      }
      wr = warp_sum(wr);
      c = warp_sum(c);
      if (lane == 0) {
        const float rl = ratio_l[i];
        level_cost += rl * c;
        remain_l[i] = fmaxf(0.f, remain_l[i] - rl * wr);
      }
    }
    if (lane == 0) red[warp] = level_cost;
    for (int j = tid; j < m; j += kEmdThreads)
      remain_r[j] = fmaxf(0.f, remain_r[j] - sumr[j]);
    __syncthreads();
    if (tid == 0) {
      float t = 0.f;
      for (int w = 0; w < kEmdWarps; ++w) t += red[w];
      cost += t;
    }
    // `red` is next written after the next level's first two barriers
  }
  if (tid == 0) out[p] = cost;
}

size_t cd_smem_bytes(int n, int m) {
  return sizeof(float) * (3 * (size_t)n + 3 * (size_t)m + kCdThreads / 32);
}

size_t emd_smem_bytes(int n, int m, bool otf) {
  size_t f = 2 * (size_t)n + 3 * (size_t)m + kEmdWarps;
  if (otf) f += 3 * (size_t)n + 3 * (size_t)m;
  return sizeof(float) * f;
}

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t smem) {
  if (smem <= (size_t)kDefaultSmem) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)smem);
}

bool bad_pairs(int p, int n, int m) { return p < 0 || n <= 0 || m <= 0; }

}  // namespace

extern "C" {

// K5. out: [p] float32.
int ldt_pairwise_cd_means(const void* x, const void* y, void* out, int p,
                          int n, int m, void* stream) {
  const size_t smem = cd_smem_bytes(n, m);
  if (bad_pairs(p, n, m) || smem > (size_t)kMaxSmem)
    return (int)cudaErrorInvalidValue;
  if (p == 0) return (int)cudaSuccess;
  cudaError_t e = allow_smem(pairwise_cd_means_kernel, smem);
  if (e != cudaSuccess) return (int)e;
  pairwise_cd_means_kernel<<<p, kCdThreads, smem,
                             static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(y),
      static_cast<float*>(out), n, m);
  return (int)cudaGetLastError();
}

// K6 (otf = 0: d is the [p, n, m] squared distances; x, y unused) and K7
// (otf = 1: x [p, n, 3], y [p, m, 3]; d unused). out: [p] float32.
int ldt_approx_match_cost(const void* x, const void* y, const void* d,
                          void* out, int p, int n, int m, int otf,
                          void* stream) {
  const size_t smem = emd_smem_bytes(n, m, otf != 0);
  if (bad_pairs(p, n, m) || smem > (size_t)kMaxSmem)
    return (int)cudaErrorInvalidValue;
  if (p == 0) return (int)cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* xf = static_cast<const float*>(x);
  const float* yf = static_cast<const float*>(y);
  const float* df = static_cast<const float*>(d);
  float* of = static_cast<float*>(out);
  cudaError_t e;
  if (otf) {
    e = allow_smem(approx_match_cost_kernel<true>, smem);
    if (e != cudaSuccess) return (int)e;
    approx_match_cost_kernel<true><<<p, kEmdThreads, smem, s>>>(xf, yf, df,
                                                                of, n, m);
  } else {
    e = allow_smem(approx_match_cost_kernel<false>, smem);
    if (e != cudaSuccess) return (int)e;
    approx_match_cost_kernel<false><<<p, kEmdThreads, smem, s>>>(xf, yf, df,
                                                                 of, n, m);
  }
  return (int)cudaGetLastError();
}

const char* ldt_eval_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
