// Schedule rules of K3's and K4's register-tiled kernels and of K5's split
// schedule, and K3's shared memory, in host C++ alone. attention.cu and
// eval.cu include this and launch what it decides; their libraries also
// export the rules as ldt_self_bwd_tiled, ldt_cross_bwd_tiled and
// ldt_cd_schedule, for callers that ask without a launch (the K3 wrapper's
// shape check, chip_smoke.py's expected counts).
// tests/test_torch_port_csrc_syntax.py builds this header with a host
// compiler, so the CPU tests ask the same code; no Python copy of these
// rules exists.
#ifndef LDT_TORCH_CSRC_RULES_H_
#define LDT_TORCH_CSRC_RULES_H_

#include <stddef.h>

#ifdef __CUDACC__
#define LDT_HOST_DEVICE __host__ __device__
#else
#define LDT_HOST_DEVICE
#endif

// Most dynamic shared memory an sm_90 block may use.
constexpr size_t kMaxSmem = 232448;

// K4: keys per tile of its long-key schedule (ldt_torch/ops/attention.py
// mirrors it in its shared-memory bound and picks the long-query schedule's
// rows per block).
constexpr int kBwdKeys = 64;

// Row stride (floats) of K2's long-key schedule's q, k and v in shared
// memory, and of K3's and K4's register-tiled rows: dh padded with zeros to a
// multiple of 8, plus 4, so that the 8 lanes of a quarter warp reading 8
// rows as float4 hit 8 bank groups.
LDT_HOST_DEVICE inline int lk_ld(int dh) { return (dh + 7) / 8 * 8 + 4; }

// Shared memory of K3's scalar kernel: q [n, dh], k and v [n, dh+1], g [n,
// dh], and the [n, n] weights and their gradient; f32.
inline size_t self_bwd_smem_bytes(int n, int dh) {
  return sizeof(float) * (2 * (size_t)n * dh + 2 * (size_t)n * (dh + 1) +
                          2 * (size_t)n * n);
}

// Shared memory of K3's register-tiled kernel: q, k, v and g [n4,
// lk_ld(dh)], the weights and ds [n4, n4 + 8] (n4: n rounded up to 4; the
// 8 keep a warp's stores of 4 rows' scores on 32 banks); f32.
inline size_t self_bwd_tiled_smem_bytes(int n, int dh) {
  const size_t n4 = (n + 3) / 4 * 4;
  return sizeof(float) * (4 * n4 * lk_ld(dh) + 2 * n4 * (n4 + 8));
}

// K3's register-tiled rule: dh a multiple of 4, qkv, g and dqkv 16-byte
// aligned, and the tiled layout's shared memory within a block's; the
// scalar kernel takes the rest.
inline bool self_bwd_tiled(int n, int dh, bool aligned) {
  return dh % 4 == 0 && aligned &&
         self_bwd_tiled_smem_bytes(n, dh) <= kMaxSmem;
}

// Shared memory of K4's register-tiled long-query kernel: k and v [m4,
// lk_ld(dh)], the rows' q and g [rows4, lk_ld(dh)], their weights and ds
// [rows4, m4] (m4, rows4: m and rows rounded up to 4); f32.
inline size_t cross_bwd_lq_tiled_smem_bytes(int m, int dh, int rows) {
  const size_t m4 = (m + 3) / 4 * 4, r4 = (rows + 3) / 4 * 4;
  return sizeof(float) * (2 * m4 * lk_ld(dh) + 2 * r4 * lk_ld(dh) +
                          2 * r4 * m4);
}

// Shared memory of K4's register-tiled long-key kernels: q and g [n4,
// lk_ld(dh)], the chunk's k and v [kBwdKeys, lk_ld(dh)], the weights and ds
// [n4, kBwdKeys] and per row its max, sum and D (n4: n rounded up to 4); f32.
inline size_t cross_bwd_lk_tiled_smem_bytes(int n, int dh) {
  const size_t n4 = (n + 3) / 4 * 4;
  return sizeof(float) * (2 * n4 * lk_ld(dh) + 2 * (size_t)kBwdKeys *
                          lk_ld(dh) + 2 * n4 * kBwdKeys + 3 * (size_t)n);
}

// Shared memory of K4's register-tiled kernels in the schedule `rows` names
// (rows query rows a block, or the long-key schedule where rows == 0).
inline size_t cross_bwd_tiled_smem_bytes(int n, int m, int dh, int rows) {
  return rows > 0 ? cross_bwd_lq_tiled_smem_bytes(m, dh, rows)
                  : cross_bwd_lk_tiled_smem_bytes(n, dh);
}

// K4's register-tiled rule: dh a multiple of 4, q, k, v and g 16-byte
// aligned, and the tiled kernels' shared memory within a block's; the scalar
// kernels take the rest.
inline bool cross_bwd_tiled(int n, int m, int dh, int rows, bool aligned) {
  return dh % 4 == 0 && aligned &&
         cross_bwd_tiled_smem_bytes(n, m, dh, rows) <= kMaxSmem;
}

// K5's split schedule: the largest cluster, and the widest clouds it takes
// (its row and column minima in shared memory).
constexpr int kCdMaxCluster = 8;
constexpr int kCdSplitMaxPoints = 2048;

// K5's split schedule's cluster size for p pairs on a card of sms SMs: of
// 2, 4, 8 the one whose busiest SM holds the fewest rows, ceil(p c / sms)
// blocks of n / c rows, the smaller on a tie.
inline int cd_cluster(int p, int sms) {
  int best = 2;
  long long best_blocks = ((long long)p * best + sms - 1) / sms;
  for (int c = 4; c <= kCdMaxCluster; c *= 2) {
    const long long blocks = ((long long)p * c + sms - 1) / sms;
    if (blocks * best < best_blocks * c) {  // blocks / c < best_blocks / best
      best = c;
      best_blocks = blocks;
    }
  }
  return best;
}

// K5's schedule rule: the split schedule where n, m <= kCdSplitMaxPoints,
// m % 4 == 0 and y is 16-byte aligned (its 16-byte loads of y), else the
// block schedule.
inline bool cd_split(int n, int m, bool y_aligned) {
  return n <= kCdSplitMaxPoints && m <= kCdSplitMaxPoints && m % 4 == 0 &&
         y_aligned;
}

// Exported by each library that includes this (one source a library).
extern "C" {

// K5's schedule for p pairs of n x m points on a card of sms SMs: the split
// schedule's cluster size, 0 for the block schedule (what
// ldt_pairwise_cd_means reports for the same launch).
int ldt_cd_schedule(int p, int n, int m, int y_aligned, int sms) {
  return cd_split(n, m, y_aligned != 0) ? cd_cluster(p, sms) : 0;
}

// K3 at n tokens of head width dh: 1 where it takes the register-tiled
// kernel (what ldt_packed_self_attention_bwd reports for the same launch),
// else 0.
int ldt_self_bwd_tiled(int n, int dh, int aligned) {
  return self_bwd_tiled(n, dh, aligned != 0) ? 1 : 0;
}

// K3's shared memory in bytes: the register-tiled kernel's where `tiled`,
// else the scalar kernel's (the entry refuses a shape where that passes a
// block's).
size_t ldt_self_bwd_smem_bytes(int n, int dh, int tiled) {
  return tiled ? self_bwd_tiled_smem_bytes(n, dh)
               : self_bwd_smem_bytes(n, dh);
}

// K4 with `rows` query rows a block (0: the long-key schedule): 1 where it
// takes the register-tiled kernels (what ldt_cross_attention_bwd reports
// for the same launch), else 0.
int ldt_cross_bwd_tiled(int n, int m, int dh, int rows, int aligned) {
  return cross_bwd_tiled(n, m, dh, rows, aligned != 0) ? 1 : 0;
}

// The tiled kernels' shared memory in bytes at that schedule.
size_t ldt_cross_bwd_tiled_smem_bytes(int n, int m, int dh, int rows) {
  return cross_bwd_tiled_smem_bytes(n, m, dh, rows);
}

}  // extern "C"

#endif  // LDT_TORCH_CSRC_RULES_H_
