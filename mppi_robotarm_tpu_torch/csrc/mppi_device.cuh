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
//   tracking_cost       <- _tracking_cost       (pallas_rollout.py:186),
//                          exact metric, unmasked
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

// Nearest-waypoint tracking cost of the end-effector position (x, y) against
// the clamped (W, 4) window win[j*4 + {x, y, dq1, dq2}].  First-win strict <
// ties (control.py:208-215); rows past the path end repeat the last row, so
// the unmasked scan selects the same values as a masked one.
MPPI_HD float tracking_cost(float x, float y, float dq1, float dq2,
                            const float* win, int W, float w0, float w1,
                            float w2, float w3, float dist_scale,
                            float cost_scale) {
  float best = INFINITY;
  int bj = 0;
  for (int j = 0; j < W; ++j) {
    const float dx = x - win[4 * j];
    const float dy = y - win[4 * j + 1];
    const float d = (dx * dx + dy * dy) * dist_scale;
    if (d < best) {
      best = d;
      bj = j;
    }
  }
  const float ex = x - win[4 * bj];
  const float ey = y - win[4 * bj + 1];
  const float e1 = dq1 - win[4 * bj + 2];
  const float e2 = dq2 - win[4 * bj + 3];
  return (w0 * (ex * ex) + w1 * (ey * ey) + w2 * (e1 * e1) +
          w3 * (e2 * e2)) * cost_scale;
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
