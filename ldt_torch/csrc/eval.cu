// Evaluation kernels of the point-cloud metrics, for sm_90a.
//
// K5 ldt_pairwise_cd_means: for each pair p of clouds x [P, N, 3] and
//    y [P, M, 3], mean_i min_j d_ij + mean_j min_i d_ij with the squared
//    distances d_ij = |x_i - y_j|^2. Replaces ldt_tpu/ops/chamfer.py::
//    _pairwise_cd_kernel. Bound on an H100: instruction issue. The least
//    work the function needs within chip_smoke.py's K5_TOL is 8
//    instructions an element: d_ij in the direct form with its two adds
//    fused (three differences, a square, two FMAs; within 2 ulps of the
//    rounded form) and two minima (its row's and its column's), so 8 N M
//    per pair at 128 lanes per SM per clock: 0.065 ms for the eval tile (64
//    pairs of 2048 points) at 1980 MHz. The two minima go to the ALU pipe
//    (64 lanes per SM per clock, 4 / 128 of a clock per element), which
//    issue outruns; the clouds are 3 MB. The kernels below issue more (no
//    FMA, so that every minimum keeps the CPU's bits): about 10.5 an
//    element on the split schedule, 18 on the block one.
//    Two schedules, chosen by one rule (cd_split in rules.h; the entry point
//    reports the cluster size it launched, and the library exports the
//    rule as ldt_cd_schedule):
//    - Split (pairwise_cd_split_kernel), where N, M <= 2048, M % 4 == 0 and
//      y is 16-byte aligned: the eval's path. A pair's rows are split over a
//      thread-block cluster of c blocks (cd_cluster in rules.h: of 2, 4, 8
//      the one whose busiest SM holds the fewest rows, read against the
//      card's SM count at each call; c = 2 for a 64-pair tile: 128 blocks
//      on 132 SMs).
//      y sits in the block's shared memory (coordinate-major); a thread
//      holds 4 rows of x in registers and runs them over every column,
//      taking each d_ij once: its rows' minima in registers, and the
//      minimum over its 4 rows of each column, which one redux.sync on the
//      float's bits (d >= 0, so the bits order as the values) turns into the
//      warp's, stored in the warp's own row of column minima; about 10.5
//      instructions an element in all. The block merges its warps' rows;
//      after a cluster barrier the first block reads the cluster's row and
//      column minima through distributed shared memory, merges the columns'
//      (a minimum is exact in any order) and sums each set in a fixed order
//      that depends on N and M alone: 256 slots of every 256th value in
//      index order, then a balanced tree. So a pair's bits do not depend on
//      c or on its tile, and a run repeats them.
//    - Block (pairwise_cd_means_kernel, the first version) for the rest: one
//      block per pair with both clouds in shared memory; row minima, then
//      column minima with the roles swapped, each d_ij computed twice (18
//      instructions an element on P SMs); the minima summed per thread in
//      row order and then over the block in a fixed tree.
//    Both take every minimum with the CPU's bits; they sum them in other
//    orders.
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
//    it replaces _approx_match_cost_otf_kernel. Each schedule below is one
//    template in which only the source of d differs, so on the same d K6 and
//    K7 return the same bits.
//    Bound on an H100 at the eval tile (64 pairs of 2048-point clouds): the
//    9 N M exponentials of the function on the special-function units (16
//    per SM per clock: 0.58 ms at 1980 MHz), above K6's one read of d (16.8
//    MB a pair, 0.32 ms at 3.35 TB/s) and the f32 FMAs.
//    Two schedules, chosen by one rule (emd_cluster_fits below, which the
//    entry point reports as the cluster size it launched;
//    ldt_torch/ops/_eval_kernels.py::emd_schedule mirrors it for the tests
//    and chip_smoke.py's expected counts):
//    - Cluster (approx_match_cluster_kernel), where M <= 2048 and its shared
//      memory fits: the eval's path. A pair's rows are split over
//      kEmdSlots = 16 warps, spread over a thread-block cluster of c blocks
//      of 16 / c warps: c = 8, 4 or 2, the largest with P c <= the card's
//      SMs (read at each call; 132 on an H100 SXM), else 2, so a 64-pair
//      tile runs on 128 of 132 SMs. Two sweeps a level, the
//      second fused with the next level's first: sweep A(L) takes each row's
//      w = exp(L d) once, keeps it in the warp's registers (lane l holds
//      columns 128 t + 4 l .. + 3), takes the row sum and ratio_l from it and
//      adds ratio_l w to the warp's column partial sums (registers); after
//      the column sums are reduced, sumr, ratio_r and the next remain_r are
//      known, so sweep B(L) (the row's cost and remain_l) and A(L + 1),
//      which needs exactly that remain_l, run as one sweep: A(0), eight fused
//      sweeps, B(8), 10 reads of d and 18 exponentials per element, where
//      the first version did 27 and 27. The column partial sums and the
//      level's cost are reduced in a fixed balanced tree over the 16 warps:
//      within a block over its warps in warp order, then over the blocks in
//      rank order through distributed shared memory (cluster.map_shared_rank,
//      double-buffered, one cluster.sync a reduction). The tree is the same
//      for every c, so a pair's cost does not depend on the tile it lands in,
//      and no atomics are used, so a run repeats its bits. Every block keeps
//      the whole column state (remain_r, ratio_r: [M]) and updates it from
//      the same sums; the row state lives with the warp that owns the row.
//    - Block (approx_match_cost_kernel), for M > 2048: one block of 512
//      threads per pair, three passes a level (rows: the row sums and
//      ratio_l; columns: sumr, then ratio_r; rows: the cost and remain_l),
//      each w recomputed where it is used, the row and column state in
//      shared memory; every sum in a fixed order.
//    The two order their sums differently, so they do not give each other's
//    bits.
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
// C interface for ctypes: each entry point returns cudaGetLastError() after
// the launch (0 on success); x, y, d and out are contiguous float32.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <float.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

#include "rules.h"

namespace {

// The dynamic shared memory an sm_90 block may use without opting in (the
// most it may use, kMaxSmem, is in rules.h).
constexpr int kDefaultSmem = 49152;
constexpr int kCdThreads = 256;
constexpr int kCdRows = 4;        // rows of a K5 thread per pass
// K5's split schedule: the most threads a block and the slots of its
// fixed-order sums (its threads hold kCdRows rows each; its rule, cluster
// sizes and point limit are in rules.h). tests/test_torch_port_cd_split.py
// reads them.
constexpr int kCdSplitThreads = 256;
constexpr int kCdSumSlots = 256;
constexpr int kEmdThreads = 512;
constexpr int kEmdWarps = kEmdThreads / 32;
constexpr int kEmdCols = 4;       // columns of a K6/K7 thread per pass
constexpr int kLevels = 9;
// K6/K7's cluster schedule: row slots (warps) per pair, whatever the
// cluster; the most float4 column groups a lane holds (128 columns each:
// M <= 2048). ldt_torch/ops/_eval_kernels.py mirrors both.
constexpr int kEmdSlots = 16;
constexpr int kEmdMaxGroups = 16;

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

// The split schedule's sum of v[0, k) (k <= kCdSplitMaxPoints) into
// slots[s]: slot s adds v[s], v[s + kCdSumSlots], ... in index order; `at(i)`
// reads v[i]. The caller then reduces the slots with slot_tree.
template <typename At>
__device__ __forceinline__ void slot_sums(float* slots, int k, At at) {
  for (int s = threadIdx.x; s < kCdSumSlots; s += blockDim.x) {
    float t = 0.f;
    for (int i = s; i < k; i += kCdSumSlots) t += at(i);
    slots[s] = t;
  }
}

// The balanced tree over `count` arrays of kCdSumSlots slots at once
// (slots[a * kCdSumSlots + s]): slot s + w into slot s for w = 128, 64, ...,
// 1; the totals end in slots[a * kCdSumSlots]. Starts with a barrier.
__device__ __forceinline__ void slot_tree(float* slots, int count) {
  for (int w = kCdSumSlots / 2; w > 0; w >>= 1) {
    __syncthreads();
    for (int e = threadIdx.x; e < count * w; e += blockDim.x) {
      const int a = e / w;
      const int s = e - a * w;
      slots[a * kCdSumSlots + s] += slots[a * kCdSumSlots + s + w];
    }
  }
  __syncthreads();
}

// K5's split schedule (the header's first). Grid: c blocks per pair in a
// cluster of c; the block of rank r takes rows [r rb, (r + 1) rb) of x, rb =
// ceil(n / c) <= 1024 (n <= 2048, c >= 2), kCdRows a thread (thread t's
// rows r0 + i blockDim + t; past the block's last row it repeats that
// row, which moves no minimum and is not summed). Each warp writes its
// column minima to its own row of shared memory (no atomics: the warps of a
// block would contend for one word a column); the block then merges them.
// m % 4 == 0, y 16-byte aligned.
__global__ void __launch_bounds__(kCdSplitThreads)
pairwise_cd_split_kernel(const float* __restrict__ x,
                         const float* __restrict__ y,
                         float* __restrict__ out, int n, int m) {
  namespace cg = cooperative_groups;
  cg::cluster_group cluster = cg::this_cluster();
  extern __shared__ __align__(16) float smem[];
  const int c = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const size_t p = blockIdx.x / c;
  const int rb = (n + c - 1) / c;
  const int r0 = min(n, rank * rb);
  const int r1 = min(n, r0 + rb);
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nwarps = blockDim.x >> 5;
  float* ys = smem;                                         // [3][m]
  // the warps' column minima [nwarps][m] (bits); then the block's in row 0
  unsigned* colmin = reinterpret_cast<unsigned*>(ys + 3 * m);
  float* rowmin = reinterpret_cast<float*>(colmin + nwarps * m);  // [rb]
  float* slots = rowmin + rb;                               // [2][slots]

  // y, coordinate-major, by 16-byte loads
  const float4* y4 = reinterpret_cast<const float4*>(y + p * m * 3);
  for (int e = tid; e < 3 * m / 4; e += blockDim.x) {
    const float4 v = __ldg(y4 + e);
    const float f[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int i = 4 * e + k;
      ys[(i % 3) * m + i / 3] = f[k];
    }
  }
  __syncthreads();

  if (r0 < r1) {  // rb <= blockDim * kCdRows (the rule): one pass
    const float* xp = x + p * n * 3;
    float ax[kCdRows], ay[kCdRows], az[kCdRows], best[kCdRows];
#pragma unroll
    for (int r = 0; r < kCdRows; ++r) {
      const int i = min(r0 + r * (int)blockDim.x + tid, r1 - 1);
      ax[r] = __ldg(xp + 3 * i);
      ay[r] = __ldg(xp + 3 * i + 1);
      az[r] = __ldg(xp + 3 * i + 2);
      best[r] = FLT_MAX;
    }
    unsigned* mine = colmin + warp * m;
#pragma unroll 4
    for (int j = 0; j < m; j += 4) {
      const float4 bx = *reinterpret_cast<const float4*>(ys + j);
      const float4 by = *reinterpret_cast<const float4*>(ys + m + j);
      const float4 bz = *reinterpret_cast<const float4*>(ys + 2 * m + j);
      const float cx[4] = {bx.x, bx.y, bx.z, bx.w};
      const float cy[4] = {by.x, by.y, by.z, by.w};
      const float cz[4] = {bz.x, bz.y, bz.z, bz.w};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float col = 0.f;
#pragma unroll
        for (int r = 0; r < kCdRows; ++r) {
          const float dd = sq_dist(ax[r], ay[r], az[r], cx[e], cy[e], cz[e]);
          best[r] = fminf(best[r], dd);
          col = r == 0 ? dd : fminf(col, dd);
        }
        // d >= 0: the unsigned order of the bits is the order of the values
        const unsigned w = __reduce_min_sync(0xffffffffu, __float_as_uint(col));
        if (lane == 0) mine[j + e] = w;
      }
    }
#pragma unroll
    for (int r = 0; r < kCdRows; ++r) {
      const int i = r0 + r * (int)blockDim.x + tid;
      if (i < r1) rowmin[i - r0] = best[r];
    }
    __syncthreads();
    for (int j = tid; j < m; j += blockDim.x) {  // the block's column minima
      unsigned v = colmin[j];
      for (int w = 1; w < nwarps; ++w) v = min(v, colmin[w * m + j]);
      colmin[j] = v;
    }
  } else {  // a block without rows (n < c): no column minimum
    for (int j = tid; j < m; j += blockDim.x)
      colmin[j] = __float_as_uint(FLT_MAX);
  }
  cluster.sync();  // every block's row and column minima are in place

  if (rank == 0) {
    slot_sums(slots, n, [&](int i) {
      return cluster.map_shared_rank(rowmin, i / rb)[i % rb];
    });
    slot_sums(slots + kCdSumSlots, m, [&](int j) {
      unsigned v = colmin[j];
      for (int q = 1; q < c; ++q)
        v = min(v, cluster.map_shared_rank(colmin, q)[j]);
      return __uint_as_float(v);
    });
    slot_tree(slots, 2);
    if (tid == 0)
      out[p] = slots[0] / (float)n + slots[kCdSumSlots] / (float)m;
  }
  cluster.sync();  // no block leaves while the first reads its minima
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

// ((v0 + v1) + (v2 + v3)) + ((v4 + v5) + (v6 + v7)): a balanced tree of 8
// leaves. With the leaves past k zero it is the balanced tree of the first
// k (k a power of two): x + 0 is x.
__device__ __forceinline__ float tree8(const float (&v)[8]) {
  return ((v[0] + v[1]) + (v[2] + v[3])) + ((v[4] + v[5]) + (v[6] + v[7]));
}

// The distances of row i to the lane's columns 128 t + 4 lane + e (G groups
// of 4) into dd; 0 past m (the column state is 0 there, so a padded column
// adds +0 to every sum). K7: x_i = (xi0, xi1, xi2), ys [3][128 G] zero-padded;
// K6: drow = d + i m, 16-byte loads where `vec`.
template <bool kOtf, int G>
__device__ __forceinline__ void row_distances(float (&dd)[4 * G],
                                              const float* __restrict__ drow,
                                              const float* ys, float xi0,
                                              float xi1, float xi2, int m,
                                              bool vec, int lane) {
  constexpr int MP = 128 * G;
#pragma unroll
  for (int t = 0; t < G; ++t) {
    const int j = 128 * t + 4 * lane;
    if (kOtf) {
      const float4 a = *reinterpret_cast<const float4*>(ys + j);
      const float4 b = *reinterpret_cast<const float4*>(ys + MP + j);
      const float4 c = *reinterpret_cast<const float4*>(ys + 2 * MP + j);
      dd[4 * t] = fmaxf(sq_dist(xi0, xi1, xi2, a.x, b.x, c.x), 0.f);
      dd[4 * t + 1] = fmaxf(sq_dist(xi0, xi1, xi2, a.y, b.y, c.y), 0.f);
      dd[4 * t + 2] = fmaxf(sq_dist(xi0, xi1, xi2, a.z, b.z, c.z), 0.f);
      dd[4 * t + 3] = fmaxf(sq_dist(xi0, xi1, xi2, a.w, b.w, c.w), 0.f);
    } else if (vec) {
      float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
      if (j < m) a = __ldg(reinterpret_cast<const float4*>(drow + j));
      dd[4 * t] = a.x;
      dd[4 * t + 1] = a.y;
      dd[4 * t + 2] = a.z;
      dd[4 * t + 3] = a.w;
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e)
        dd[4 * t + e] = j + e < m ? __ldg(drow + j + e) : 0.f;
    }
  }
}

// One sweep of a warp over its rows i = slot, slot + kEmdSlots, ...: with kB
// sweep B of level lb (the row's cost into lc, remain_l), with kA sweep A of
// level la (ratio_l, and the row's ratio_l w added to acc). acc and lc are
// the warp's partial sums, the same in every lane.
template <bool kOtf, int G, bool kB, bool kA>
__device__ __forceinline__ void emd_sweep(
    float (&acc)[4 * G], float& lc, const float* __restrict__ dp,
    const float* xs, const float* ys, float* remain_l, float* ratio_l,
    const float* remain_r, const float* ratio_r, int n, int m, bool vec,
    int slot, int lane, float lb, float la) {
#pragma unroll
  for (int k = 0; k < 4 * G; ++k) acc[k] = 0.f;
  lc = 0.f;
  for (int i = slot; i < n; i += kEmdSlots) {
    const float rem0 = remain_l[i];
    const float rl = kB ? ratio_l[i] : 0.f;
    float dd[4 * G];
    row_distances<kOtf, G>(dd, kOtf ? nullptr : dp + (size_t)i * m, ys,
                           kOtf ? xs[i] : 0.f, kOtf ? xs[n + i] : 0.f,
                           kOtf ? xs[2 * n + i] : 0.f, m, vec, lane);
    float c = 0.f, wr = 0.f, sa = 0.f;
#pragma unroll
    for (int t = 0; t < G; ++t) {
      const int j = 128 * t + 4 * lane;
      float rr[4], rm[4];
      if (kB) {
        const float4 v = *reinterpret_cast<const float4*>(ratio_r + j);
        rr[0] = v.x; rr[1] = v.y; rr[2] = v.z; rr[3] = v.w;
      }
      if (kA) {
        const float4 v = *reinterpret_cast<const float4*>(remain_r + j);
        rm[0] = v.x; rm[1] = v.y; rm[2] = v.z; rm[3] = v.w;
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float dv = dd[4 * t + e];
        if (kB) {
          const float w = expf(lb * dv);
          c += (w * sqrtf(fmaxf(dv, 1e-20f))) * rr[e];
          wr += w * rr[e];
        }
        if (kA) {
          const float w = expf(la * dv);
          sa += w * rm[e];
          dd[4 * t + e] = w;
        }
      }
    }
    float rem = rem0;
    if (kB) {
      c = warp_sum(c);
      wr = warp_sum(wr);
      lc += rl * c;
      rem = fmaxf(0.f, rem0 - rl * wr);
    }
    float rl_next = 0.f;
    if (kA) {
      sa = warp_sum(sa);
      rl_next = rem / (1e-9f + sa);
#pragma unroll
      for (int k = 0; k < 4 * G; ++k) acc[k] += rl_next * dd[k];
    }
    if (lane == 0) {  // every lane read the row's state before the shuffles
      remain_l[i] = rem;
      ratio_l[i] = rl_next;
    }
  }
}

// K6/K7's cluster schedule (the header's first). Grid: c blocks per pair in
// a cluster of c; kEmdSlots / c warps a block; warp w of rank r is row slot
// r (kEmdSlots / c) + w. Columns padded to MP = 128 G.
template <bool kOtf, int G>
__global__ void __launch_bounds__(kEmdSlots / 2 * 32)
approx_match_cluster_kernel(const float* __restrict__ x,
                            const float* __restrict__ y,
                            const float* __restrict__ d,
                            float* __restrict__ out, int n, int m) {
  namespace cg = cooperative_groups;
  cg::cluster_group cluster = cg::this_cluster();
  constexpr int MP = 128 * G;
  constexpr int LS = MP + 4;  // a partial row: MP column sums, the cost
  extern __shared__ __align__(16) float smem[];
  const int c = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int nwarps = kEmdSlots / c;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int slot = rank * nwarps + warp;
  const size_t p = blockIdx.x / c;
  const int n4 = (n + 3) / 4 * 4;
  float* remain_l = smem;            // [n]
  float* ratio_l = remain_l + n4;    // [n]
  float* remain_r = ratio_l + n4;    // [MP]
  float* ratio_r = remain_r + MP;    // [MP]
  float* stage = ratio_r + MP;       // [nwarps][LS]
  float* bpart = stage + nwarps * LS;  // [2][LS], read by the cluster
  float* xs = bpart + 2 * LS;        // K7: [3][n4]
  float* ys = xs + 3 * n4;           // K7: [3][MP]
  const float* dp = kOtf ? nullptr : d + p * n * m;
  const bool vec = !kOtf && m % 4 == 0 &&
                   reinterpret_cast<uintptr_t>(d) % 16 == 0;

  const float multi_l = (float)max(1, m / n);
  const float multi_r = (float)max(1, n / m);
  for (int i = tid; i < n; i += blockDim.x) remain_l[i] = multi_l;
  for (int j = tid; j < MP; j += blockDim.x) {
    remain_r[j] = j < m ? multi_r : 0.f;
    ratio_r[j] = 0.f;
  }
  if (kOtf) {
    for (int e = tid; e < 3 * n; e += blockDim.x)
      xs[(e % 3) * n + e / 3] = x[p * n * 3 + e];
    for (int e = tid; e < 3 * MP; e += blockDim.x) {
      const int j = e / 3;
      ys[(e % 3) * MP + j] = j < m ? y[p * m * 3 + e] : 0.f;
    }
  }
  __syncthreads();

  float acc[4 * G];
  float lc;
  float cost = 0.f;  // kept by the thread that reduces entry MP
  for (int r = 0; r <= kLevels; ++r) {
    // r = 0: A(0); 0 < r < kLevels: B(r - 1) fused with A(r); r = kLevels:
    // B(kLevels - 1)
    const float lb = r > 0 ? level_of(r - 1) : 0.f;
    const float la = r < kLevels ? level_of(r) : 0.f;
    if (r == 0)
      emd_sweep<kOtf, G, false, true>(acc, lc, dp, xs, ys, remain_l, ratio_l,
                                      remain_r, ratio_r, n, m, vec, slot,
                                      lane, lb, la);
    else if (r < kLevels)
      emd_sweep<kOtf, G, true, true>(acc, lc, dp, xs, ys, remain_l, ratio_l,
                                     remain_r, ratio_r, n, m, vec, slot,
                                     lane, lb, la);
    else
      emd_sweep<kOtf, G, true, false>(acc, lc, dp, xs, ys, remain_l, ratio_l,
                                      remain_r, ratio_r, n, m, vec, slot,
                                      lane, lb, la);
    float* row = stage + warp * LS;
#pragma unroll
    for (int t = 0; t < G; ++t)
      *reinterpret_cast<float4*>(row + 128 * t + 4 * lane) =
          make_float4(acc[4 * t], acc[4 * t + 1], acc[4 * t + 2],
                      acc[4 * t + 3]);
    if (lane == 0) row[MP] = lc;
    __syncthreads();
    // the block's warps, in warp order
    float* mine = bpart + (r & 1) * LS;
    for (int j = tid; j <= MP; j += blockDim.x) {
      float v[8];
#pragma unroll
      for (int w = 0; w < 8; ++w) v[w] = w < nwarps ? stage[w * LS + j] : 0.f;
      mine[j] = tree8(v);
    }
    cluster.sync();
    // the cluster's blocks, in rank order; then the column state
    for (int j = tid; j <= MP; j += blockDim.x) {
      float v[8];
#pragma unroll
      for (int q = 0; q < 8; ++q)
        v[q] = q < c ? cluster.map_shared_rank(mine, q)[j] : 0.f;
      const float total = tree8(v);
      if (j == MP) {
        cost += total;
      } else if (r < kLevels) {  // sumr, ratio_r and remain_r of level r
        const float rr = remain_r[j];
        const float sumr = total * rr;
        ratio_r[j] = fminf(rr / (sumr + 1e-9f), 1.f) * rr;
        remain_r[j] = fmaxf(0.f, rr - sumr);
      }
    }
    __syncthreads();
  }
  if (rank == 0 && tid == MP % (int)blockDim.x) out[p] = cost;
  cluster.sync();  // no block leaves while another reads its partials
}

size_t cd_smem_bytes(int n, int m) {
  return sizeof(float) * (3 * (size_t)n + 3 * (size_t)m + kCdThreads / 32);
}

// Threads of a split block with rb rows: kCdRows rows each, in whole warps,
// at most kCdSplitThreads.
int cd_split_threads(int rb) {
  const int warps = (rb + 32 * kCdRows - 1) / (32 * kCdRows);
  return 32 * max(1, min(kCdSplitThreads / 32, warps));
}

// Shared memory of a split block: y [3][m], its warps' column minima
// [warps][m], its row minima [ceil(n / c)] and two sets of sum slots.
size_t cd_split_smem_bytes(int n, int m, int c) {
  const int rb = (n + c - 1) / c;
  return sizeof(float) * ((3 + cd_split_threads(rb) / 32) * (size_t)m + rb +
                          2 * kCdSumSlots);
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

size_t emd_smem_bytes(int n, int m, bool otf) {
  size_t f = 2 * (size_t)n + 3 * (size_t)m + kEmdWarps;
  if (otf) f += 3 * (size_t)n + 3 * (size_t)m;
  return sizeof(float) * f;
}

// The cluster schedule's cluster size for p pairs on a card of sms SMs: the
// largest of 8, 4, 2 with p c <= sms, else 2.
int emd_cluster(int p, int sms) {
  for (int c = 8; c > 2; c >>= 1)
    if ((long long)p * c <= sms) return c;
  return 2;
}

// Float4 column groups a lane of the cluster schedule holds: 8 (M <= 1024)
// or 16 (M <= 2048); 0 past 2048.
int emd_groups(int m) {
  return m <= 1024 ? 8 : m <= 128 * kEmdMaxGroups ? kEmdMaxGroups : 0;
}

// Shared memory of the cluster schedule with cluster size c: the row state
// [2, n], the column state [2, MP], the warps' partial rows and the block's
// two [MP + 4]; K7 holds both clouds beside them.
size_t emd_cluster_smem_bytes(int n, int m, bool otf, int c) {
  const size_t mp = 128 * (size_t)emd_groups(m);
  const size_t n4 = (n + 3) / 4 * 4;
  size_t f = 2 * n4 + 2 * mp + (kEmdSlots / c + 2) * (mp + 4);
  if (otf) f += 3 * n4 + 3 * mp;
  return sizeof(float) * f;
}

// The schedule rule: the cluster schedule where M <= 2048 and its shared
// memory fits, else the block schedule.
bool emd_cluster_fits(int p, int n, int m, bool otf, int sms) {
  return emd_groups(m) > 0 &&
         emd_cluster_smem_bytes(n, m, otf, emd_cluster(p, sms)) <= kMaxSmem;
}

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t smem) {
  if (smem <= (size_t)kDefaultSmem) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)smem);
}

template <bool kOtf, int G>
cudaError_t launch_emd_cluster(const float* x, const float* y, const float* d,
                               float* out, int p, int n, int m, int c,
                               cudaStream_t stream) {
  const size_t smem = emd_cluster_smem_bytes(n, m, kOtf, c);
  cudaError_t e = allow_smem(approx_match_cluster_kernel<kOtf, G>, smem);
  if (e != cudaSuccess) return e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)p * c);
  cfg.blockDim = dim3(32 * (kEmdSlots / c));
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = c;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, approx_match_cluster_kernel<kOtf, G>, x, y, d,
                         out, n, m);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

// *cluster: the cluster size launched, 0 for the block schedule.
template <bool kOtf>
cudaError_t launch_emd(const float* x, const float* y, const float* d,
                       float* out, int p, int n, int m, int sms,
                       cudaStream_t stream, int* cluster) {
  if (emd_cluster_fits(p, n, m, kOtf, sms)) {
    *cluster = emd_cluster(p, sms);
    return emd_groups(m) == 8
               ? launch_emd_cluster<kOtf, 8>(x, y, d, out, p, n, m, *cluster,
                                             stream)
               : launch_emd_cluster<kOtf, kEmdMaxGroups>(x, y, d, out, p, n,
                                                         m, *cluster, stream);
  }
  const size_t smem = emd_smem_bytes(n, m, kOtf);
  cudaError_t e = allow_smem(approx_match_cost_kernel<kOtf>, smem);
  if (e != cudaSuccess) return e;
  approx_match_cost_kernel<kOtf><<<p, kEmdThreads, smem, stream>>>(x, y, d,
                                                                   out, n, m);
  return cudaGetLastError();
}

cudaError_t launch_cd_split(const float* x, const float* y, float* out, int p,
                            int n, int m, int c, cudaStream_t stream) {
  const size_t smem = cd_split_smem_bytes(n, m, c);
  cudaError_t e = allow_smem(pairwise_cd_split_kernel, smem);
  if (e != cudaSuccess) return e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)p * c);
  cfg.blockDim = dim3(cd_split_threads((n + c - 1) / c));
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = c;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, pairwise_cd_split_kernel, x, y, out, n, m);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

bool bad_pairs(int p, int n, int m) { return p < 0 || n <= 0 || m <= 0; }

}  // namespace

extern "C" {

// K5. out: [p] float32. *cluster: the cluster size of the split schedule
// where it was launched, 0 where the block schedule was or nothing was.
int ldt_pairwise_cd_means(const void* x, const void* y, void* out, int p,
                          int n, int m, void* stream, int* cluster) {
  *cluster = 0;
  const bool split = cd_split(n, m, aligned16(y));
  if (bad_pairs(p, n, m) || (!split && cd_smem_bytes(n, m) > kMaxSmem))
    return (int)cudaErrorInvalidValue;
  if (p == 0) return (int)cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* xf = static_cast<const float*>(x);
  const float* yf = static_cast<const float*>(y);
  float* of = static_cast<float*>(out);
  if (split) {
    int dev = 0, sms = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e == cudaSuccess)
      e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return (int)e;
    *cluster = cd_cluster(p, sms);
    return (int)launch_cd_split(xf, yf, of, p, n, m, *cluster, s);
  }
  const size_t smem = cd_smem_bytes(n, m);
  cudaError_t e = allow_smem(pairwise_cd_means_kernel, smem);
  if (e != cudaSuccess) return (int)e;
  pairwise_cd_means_kernel<<<p, kCdThreads, smem, s>>>(xf, yf, of, n, m);
  return (int)cudaGetLastError();
}

// K6 (otf = 0: d is the [p, n, m] squared distances; x, y unused) and K7
// (otf = 1: x [p, n, 3], y [p, m, 3]; d unused). out: [p] float32.
// *cluster: the cluster size of the cluster schedule where it was launched,
// 0 where the block schedule was or nothing was.
int ldt_approx_match_cost(const void* x, const void* y, const void* d,
                          void* out, int p, int n, int m, int otf,
                          void* stream, int* cluster) {
  *cluster = 0;
  const size_t smem = emd_smem_bytes(n, m, otf != 0);
  if (bad_pairs(p, n, m) || smem > (size_t)kMaxSmem)
    return (int)cudaErrorInvalidValue;
  if (p == 0) return (int)cudaSuccess;
  int dev = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return (int)e;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* xf = static_cast<const float*>(x);
  const float* yf = static_cast<const float*>(y);
  const float* df = static_cast<const float*>(d);
  float* of = static_cast<float*>(out);
  return (int)(otf ? launch_emd<true>(xf, yf, df, of, p, n, m, sms, s, cluster)
                   : launch_emd<false>(xf, yf, df, of, p, n, m, sms, s,
                                       cluster));
}

const char* ldt_eval_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
