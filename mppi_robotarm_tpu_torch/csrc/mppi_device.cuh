// Device helpers shared by the fused closed-loop kernel (sim_kernel.cu) and
// the per-step solve kernel (solve_kernel.cu).
//
// Each per-sample function has a plain-PyTorch twin of the same name in
// ops/cuda_rollout.py, written with the same operation order, and each
// ports a helper that the JAX package's Pallas kernels inline from
// mppi_robotarm_tpu/ops/pallas_rollout.py:
//
//   uniform_from_bits   <- _uniform_from_bits   (pallas_rollout.py:67)
//   box_muller          <- _box_muller          (pallas_rollout.py:79)
//   dynamics_step_trig  <- _dynamics_step_trig  (pallas_rollout.py:123)
//   dynamics_step       <- _dynamics_step       (pallas_rollout.py:178)
//   window_cost         <- _tracking_cost       (pallas_rollout.py:186),
//                          exact metric, unmasked (twin: tracking_cost)
//
// philox4x32_10 replaces the TPU's hardware PRNG, which has no CUDA twin: it
// is the Random123 Philox4x32-10 counter-based generator, so noise is a pure
// function of (seed, absolute step, sample, horizon step).
//
// Block-level pieces, device only: warp_sum / warp_min (xor-butterfly
// shuffles, so every lane holds the bitwise-same result) and reflect_median
// (scipy's reflect-mode median at one output, the TPU kernels' odd-even
// transposition network, pallas_sim.py:489-511 and pallas_rollout.py:
// 624-653, as a rank count).
//
// Every function is exact IEEE float32 arithmetic (no fast-math intrinsics);
// the file is compiled with --fmad=false so that no a*b+c is contracted into
// an FMA and the arithmetic stays the one the PyTorch twin performs.

#pragma once

#include <math.h>
#include <stdint.h>

#ifndef MPPI_HD
#define MPPI_HD __host__ __device__ __forceinline__
#endif

// Arm constants folded on the host in float64 and rounded to float32, in the
// grouping the JAX expressions give them (Python folds the constant
// sub-products before they meet a float32 array).
struct ArmConsts {
  float a11;    // m1*lc1^2 + l1
  float b11;    // l1^2 + lc2^2
  float c11;    // 2*l1*lc2
  float m2;
  float l2;
  float k12;    // m2*l1*lc2   (M12's cos term and h)
  float k12b;   // m2*lc2^2
  float m22;    // m2*lc2^2 + l2
  float g1a;    // m1*lc1*g
  float g1b;    // m2*g
  float lc2;
  float l1;
  float g2;     // m2*lc2*g
};

// One Philox4x32-10 block: counter c (in/out), key (k0, k1).
MPPI_HD void philox4x32_10(uint32_t c[4], uint32_t k0, uint32_t k1) {
  for (int r = 0; r < 10; ++r) {
    if (r) {
      k0 += 0x9E3779B9u;
      k1 += 0xBB67AE85u;
    }
    const uint64_t p0 = (uint64_t)0xD2511F53u * (uint64_t)c[0];
    const uint64_t p1 = (uint64_t)0xCD9E8D57u * (uint64_t)c[2];
    const uint32_t hi0 = (uint32_t)(p0 >> 32), lo0 = (uint32_t)p0;
    const uint32_t hi1 = (uint32_t)(p1 >> 32), lo1 = (uint32_t)p1;
    const uint32_t n0 = hi1 ^ c[1] ^ k0;
    const uint32_t n2 = hi0 ^ c[3] ^ k1;
    c[0] = n0;
    c[1] = lo1;
    c[2] = n2;
    c[3] = lo0;
  }
}

// uint32 -> float32 in (0, 1]: (bits >> 8) * 2^-24 + 2^-25.
MPPI_HD float uniform_from_bits(uint32_t bits) {
  const float b = (float)(int)(bits >> 8);
  return b * (1.0f / 16777216.0f) + (0.5f / 16777216.0f);
}

// Two standard normals from two uniforms in (0, 1].
MPPI_HD void box_muller(float u1, float u2, float& z1, float& z2) {
  const float r = sqrtf(-2.0f * logf(u1));
  const float theta = 6.283185307179586f * u2;
  z1 = r * cosf(theta);
  z2 = r * sinf(theta);
}

// Semi-implicit Euler step (control.py:241-259) with the trig of the CURRENT
// state from the caller: c1 = cos q1, c2 = cos q2, s2 = sin q2,
// c12 = cos(q1+q2).  Quirk Q1 lives in a11/l2; exact divide.
MPPI_HD void dynamics_step_trig(float& q1, float& q2, float& dq1, float& dq2,
                                float v1, float v2, float dt,
                                const ArmConsts& a, float c1, float c2,
                                float s2, float c12) {
  const float m11 = (a.a11 + a.m2 * (a.b11 + a.c11 * c2)) + a.l2;
  const float m12 = (a.k12 * c2 + a.k12b) + a.l2;
  const float m22 = a.m22;
  const float h = a.k12 * s2;
  const float g1 = a.g1a * c1 + a.g1b * (a.lc2 * c12 + a.l1 * c1);
  const float g2 = a.g2 * c12;
  const float nh = -h;
  const float r1 = (v1 - (nh * dq2 * dq1 + (nh * dq1 - h * dq2) * dq2)) - g1;
  const float r2 = (v2 - (h * dq1 * dq1)) - g2;
  const float det = m11 * m22 - m12 * m12;
  const float inv_det = 1.0f / det;
  const float ddq1 = (m22 * r1 - m12 * r2) * inv_det;
  const float ddq2 = (-m12 * r1 + m11 * r2) * inv_det;
  dq1 = dq1 + ddq1 * dt;
  dq2 = dq2 + ddq2 * dt;
  q1 = q1 + dq1 * dt;
  q2 = q2 + dq2 * dt;
}

// dynamics_step_trig with exact trig of the current state (the plant step).
MPPI_HD void dynamics_step(float& q1, float& q2, float& dq1, float& dq2,
                           float v1, float v2, float dt, const ArmConsts& a) {
  const float c1 = cosf(q1);
  const float c2 = cosf(q2);
  const float s2 = sinf(q2);
  const float c12 = cosf(q1 + q2);
  dynamics_step_trig(q1, q2, dq1, dq2, v1, v2, dt, a, c1, c2, s2, c12);
}

#ifdef __CUDACC__

constexpr unsigned kFullMask = 0xffffffffu;

__device__ __forceinline__ float warp_sum(float v) {
  // xor butterfly: every lane ends with the bitwise-same sum
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFullMask, v, o);
  return v;
}

__device__ __forceinline__ float warp_min(float v) {
  for (int o = 16; o > 0; o >>= 1) {
    v = fminf(v, __shfl_xor_sync(kFullMask, v, o));
  }
  return v;
}

// The window scan of the three closed-loop kernels (sim_kernel.cu,
// fleet_kernel.cu through sim_common.cuh, solve_kernel.cu): the
// nearest-waypoint tracking cost of the end-effector (x, y) against a
// clamped window of W float4 rows {x, y, dq1, dq2}, 16-byte aligned in
// shared memory.  The row is the first strict minimum of the distance
// (control.py:208-215; rows past the path end repeat the last row, so the
// unmasked scan selects what a masked one would).  Every schedule keeps
// that: each chain keeps its subset's first strict minimum (NaN never
// wins; an all-inf subset keeps its first row) and chains merge with ties
// to the lower row, so each picks the serial scan's row and the cost has
// the same bits.  Two schedules of the same compares (Scan):
//   kAhead:  two interleaved chains (even and odd rows), the next pass's two
//            rows loaded before this pass's compares, so the shared loads do
//            not stall the chain: for a latency-bound chain (one warp a
//            scheduler: sim_kernel.cu on a cluster; window_cost_lanes runs
//            it on each lane's rows);
//   kSerial: one chain, the fewest instructions, for an issue-bound card
//            whose many resident warps hide the chain (fleet_kernel.cu,
//            solve_kernel.cu at one lane a sample).  Two chains four rows a
//            pass without the load-ahead measured the same there (PERF.md).
//            At a compiled width kWin (kScanWidth; 0 = W read at run time)
//            the chain runs kScanPass rows a pass, a divisor of the width:
//            each row's load at an immediate offset from the pass's base,
//            each row's index the pass's plus an immediate, no remainder
//            pass; the same compares in the same order, so the same row.
//            The wrappers pick it from W and the lanes a sample alone
//            (ops/cuda_sim.py::scan_width).  Whole rows unrolled (30 a
//            pass) took 110 registers in solve_kernel.cu, which halved its
//            blocks an SM at the fleet's 4096 x K=128 (PERF.md).
enum class Scan { kAhead, kSerial };

// The window width the kSerial scan is compiled at, besides the run-time
// loop: the reference's search_idx_len, which every configuration runs
// (ops/cuda_sim.py::SCAN_WIDTH holds the same number); and its rows a
// pass.
constexpr int kScanWidth = 30;
constexpr int kScanPass = 6;

// The stage or terminal cost (weights w[4]) against window row r.
__device__ __forceinline__ float row_cost(float x, float y, float dq1,
                                          float dq2, float4 r, const float* w,
                                          float cost_scale) {
  const float ex = x - r.x;
  const float ey = y - r.y;
  const float e1 = dq1 - r.z;
  const float e2 = dq2 - r.w;
  return (w[0] * (ex * ex) + w[1] * (ey * ey) + w[2] * (e1 * e1) +
          w[3] * (e2 * e2)) * cost_scale;
}

// One row of a first-win chain: take row `row` if its distance is strictly
// below the chain's best b (then jb = row).
__device__ __forceinline__ void scan_take(float x, float y, float4 r,
                                          int row, float dist_scale,
                                          float& b, int& jb) {
  const float dx = x - r.x, dy = y - r.y;
  const float d = (dx * dx + dy * dy) * dist_scale;
  if (d < b) {
    b = d;
    jb = row;
  }
}

// The tracking cost on a window of float4 rows, scanned by one thread on
// the schedule kS; kSerial at kWin > 0 takes W == kWin rows.
template <Scan kS, int kWin = 0>
__device__ __forceinline__ float window_cost(float x, float y, float dq1,
                                             float dq2, const float4* win,
                                             int W, const float* w,
                                             float dist_scale,
                                             float cost_scale) {
  static_assert(kWin == 0 || kS == Scan::kSerial,
                "a compiled width is kSerial's");
  float b0 = INFINITY, b1 = INFINITY;
  int j0 = 0, j1 = 1;
  int j = 0;
  if constexpr (kS == Scan::kAhead) {
    float4 n0 = win[0], n1 = win[W > 1 ? 1 : 0];
    for (; j + 1 < W; j += 2) {
      const float4 r0 = n0, r1 = n1;
      if (j + 3 < W) {
        n0 = win[j + 2];
        n1 = win[j + 3];
      }
      const float dx0 = x - r0.x, dy0 = y - r0.y;
      const float dx1 = x - r1.x, dy1 = y - r1.y;
      const float d0 = (dx0 * dx0 + dy0 * dy0) * dist_scale;
      const float d1 = (dx1 * dx1 + dy1 * dy1) * dist_scale;
      if (d0 < b0) {
        b0 = d0;
        j0 = j;
      }
      if (d1 < b1) {
        b1 = d1;
        j1 = j + 1;
      }
    }
    if (j < W) {
      const float4 r0 = win[j];
      const float dx0 = x - r0.x, dy0 = y - r0.y;
      const float d0 = (dx0 * dx0 + dy0 * dy0) * dist_scale;
      if (d0 < b0) {
        b0 = d0;
        j0 = j;
      }
    }
    const float4 r = win[(b1 < b0 || (b1 == b0 && j1 < j0)) ? j1 : j0];
    const float ex = x - r.x;
    const float ey = y - r.y;
    const float e1 = dq1 - r.z;
    const float e2 = dq2 - r.w;
    return (w[0] * (ex * ex) + w[1] * (ey * ey) + w[2] * (e1 * e1) +
            w[3] * (e2 * e2)) * cost_scale;
  } else if constexpr (kWin > 0) {
    static_assert(kWin % kScanPass == 0, "no remainder pass");
#pragma unroll kScanPass
    for (int r = 0; r < kWin; ++r) {
      scan_take(x, y, win[r], r, dist_scale, b0, j0);
    }
    return row_cost(x, y, dq1, dq2, win[j0], w, cost_scale);
  } else {
    for (; j < W; ++j) scan_take(x, y, win[j], j, dist_scale, b0, j0);
    return row_cost(x, y, dq1, dq2, win[j0], w, cost_scale);
  }
}

// The tracking cost with one sample's scan split over L aligned lanes (L a
// power of two, lane `sub` of the group on rows sub, sub + L, ...; L = 1
// scans alone on kSerial, for a full card).  Each lane runs kAhead's two
// chains over its rows; a (d, j) butterfly over the group takes the
// smallest d, ties to the lower row, so every lane of the group picks the
// serial scan's row and returns the same bits.  `mask` holds every lane of
// the warp that calls it (whole groups).  A compiled width kWin is one
// lane's (L = 1).
template <int L, int kWin = 0>
__device__ __forceinline__ float window_cost_lanes(
    float x, float y, float dq1, float dq2, const float4* win, int W,
    const float* w, float dist_scale, float cost_scale, int sub,
    unsigned mask) {
  static_assert(kWin == 0 || L == 1, "a compiled width scans on one lane");
  if constexpr (L == 1) {
    return window_cost<Scan::kSerial, kWin>(x, y, dq1, dq2, win, W, w,
                                            dist_scale, cost_scale);
  } else {
    float b0 = INFINITY, b1 = INFINITY;
    int j0 = sub, j1 = sub + L;
    int j = sub;
    float4 n0 = win[sub < W ? sub : 0];
    float4 n1 = win[sub + L < W ? sub + L : 0];
    for (; j + L < W; j += 2 * L) {
      const float4 r0 = n0, r1 = n1;
      if (j + 3 * L < W) {
        n0 = win[j + 2 * L];
        n1 = win[j + 3 * L];
      }
      scan_take(x, y, r0, j, dist_scale, b0, j0);
      scan_take(x, y, r1, j + L, dist_scale, b1, j1);
    }
    if (j < W) scan_take(x, y, win[j], j, dist_scale, b0, j0);
    const bool odd = b1 < b0 || (b1 == b0 && j1 < j0);
    float best = odd ? b1 : b0;
    int bj = odd ? j1 : j0;
#pragma unroll
    for (int o = L / 2; o > 0; o >>= 1) {
      const float od = __shfl_xor_sync(mask, best, o);
      const int oj = __shfl_xor_sync(mask, bj, o);
      if (od < best || (od == best && oj < bj)) {
        best = od;
        bj = oj;
      }
    }
    return row_cost(x, y, dq1, dq2, win[bj], w, cost_scale);
  }
}

// scipy.ndimage.median_filter(size=fw, mode='reflect') at output t of the
// T-row series v: the window spans t - fw/2 .. t - fw/2 + fw - 1, reflected
// once at each edge (fw <= 2T, checked by the wrappers); the value of rank
// fw/2 is found by counting, which equals sorting and indexing.
__device__ __forceinline__ float reflect_median(const float* v, int T,
                                                int fw, int t) {
  const int left = fw / 2;
  const int rank = fw / 2;
  float result = 0.0f;
  for (int i = 0; i < fw; ++i) {
    int ji = t - left + i;
    ji = ji < 0 ? -1 - ji : (ji >= T ? 2 * T - 1 - ji : ji);
    const float vi = v[ji];
    int less = 0, leq = 0;
    for (int j = 0; j < fw; ++j) {
      int jj = t - left + j;
      jj = jj < 0 ? -1 - jj : (jj >= T ? 2 * T - 1 - jj : jj);
      const float vj = v[jj];
      less += vj < vi;
      leq += vj <= vi;
    }
    if (less <= rank && rank < leq) {
      result = vi;
      break;
    }
  }
  return result;
}

#endif  // __CUDACC__
