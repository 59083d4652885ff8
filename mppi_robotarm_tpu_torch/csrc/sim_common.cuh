// What the two closed-loop kernels share: the parameter block and the
// per-sample rollout.
//
// sim_kernel.cu (a cluster of blocks per scenario, one thread per sample)
// and fleet_kernel.cu (one, two or four warps per scenario, up to two
// samples per lane) run the same closed loop and read the same SimParams.
// fleet_kernel.cu rolls a sample out through sample_step / sample_terminal
// below, which repeat sim_kernel.cu's inline rollout operation for
// operation; the window scan is mppi_device.cuh's window_cost on another
// schedule that picks the same row, so a sample's cost has the same bits in
// either kernel.  With the K-sums taken in the same order, the two give the
// same bits per scenario.

#pragma once

#include "mppi_device.cuh"

// Mirrored field for field by ops/cuda_sim.py::_SimParams (all fields are
// 4 bytes wide, so the layouts agree without padding).
struct SimParams {
  ArmConsts arm;
  float l1c, l2c;              // cost FK link lengths (MPPIConfig.l1/l2)
  float lam, gamma;
  float dt_c, dt_p;            // controller-model and plant dt (Q2)
  float cost_scale, dist_scale;
  float stage_w[4];
  float term_w[4];
  float exploit_thresh;        // (1 - exploration) * num_samples (Q9)
  float u_clamp;
  float dist1, dist2;          // plant disturbance torque
  float l11, l21, l22;         // chol(Σ)
  float sinv[4];               // Σ^-1, row-major
  float k_actual;              // float(K)
  int has_clamp;
  int K, T, W, fw;
  int n_ref, n_steps, use_prng;
};

constexpr int kRecLanes = 12;

// One rollout sample: the arm state, the carried trig of q1 and q1 + q2,
// and the running cost.
struct Sample {
  float q1, q2, dq1, dq2;
  float c1, s1, c12, s12;
  float s;
};

// PRNG-mode noise of sample k at horizon step t: Philox4x32-10 keyed
// (seed, absolute step) with counter (k, t, 0, 0), two normals, times
// chol(Σ).
__device__ __forceinline__ void philox_eps(const SimParams& p, uint32_t seed,
                                           uint32_t key1, int k, int t,
                                           float& e1, float& e2) {
  uint32_t c[4] = {(uint32_t)k, (uint32_t)t, 0u, 0u};
  philox4x32_10(c, seed, key1);
  float z1, z2;
  box_muller(uniform_from_bits(c[0]), uniform_from_bits(c[1]), z1, z2);
  e1 = p.l11 * z1;
  e2 = p.l21 * z1 + p.l22 * z2;
}

// One horizon step of a sample: control v = (u + ε | ε), clamp, the arm
// step with the trig carry and exact sincosf of the new angles, the stage
// cost against the window (W float4 rows; one scan chain, the fewest
// instructions, since fleet_kernel.cu fills the card: PERF.md), then
// γ·vᵀΣ⁻¹u.
__device__ __forceinline__ void sample_step(const SimParams& p, Sample& x,
                                            bool exploit, float e1, float e2,
                                            float u1r, float u2r,
                                            const float4* win) {
  float v1 = exploit ? u1r + e1 : e1;
  float v2 = exploit ? u2r + e2 : e2;
  if (p.has_clamp) {
    v1 = fminf(fmaxf(v1, -p.u_clamp), p.u_clamp);
    v2 = fminf(fmaxf(v2, -p.u_clamp), p.u_clamp);
  }
  // q2 = (q1 + q2) - q1: angle-difference identities
  const float c2 = x.c12 * x.c1 + x.s12 * x.s1;
  const float s2 = x.s12 * x.c1 - x.c12 * x.s1;
  dynamics_step_trig(x.q1, x.q2, x.dq1, x.dq2, v1, v2, p.dt_c, p.arm, x.c1,
                     c2, s2, x.c12);
  sincosf(x.q1, &x.s1, &x.c1);
  sincosf(x.q1 + x.q2, &x.s12, &x.c12);
  const float ex = p.l1c * x.c1 + p.l2c * x.c12;
  const float ey = p.l1c * x.s1 + p.l2c * x.s12;
  x.s = x.s + window_cost<Scan::kSerial>(ex, ey, x.dq1, x.dq2, win, p.W,
                                         p.stage_w, p.dist_scale,
                                         p.cost_scale);
  const float su1 = p.sinv[0] * u1r + p.sinv[1] * u2r;
  const float su2 = p.sinv[2] * u1r + p.sinv[3] * u2r;
  x.s = x.s + p.gamma * (v1 * su1 + v2 * su2);
}

// The sample's total cost: its running cost plus the terminal cost.
__device__ __forceinline__ float sample_terminal(const SimParams& p,
                                                 const Sample& x,
                                                 const float4* win) {
  const float ex = p.l1c * x.c1 + p.l2c * x.c12;
  const float ey = p.l1c * x.s1 + p.l2c * x.s12;
  return x.s + window_cost<Scan::kSerial>(ex, ey, x.dq1, x.dq2, win, p.W,
                                          p.term_w, p.dist_scale,
                                          p.cost_scale);
}

// (d, j) butterfly: every lane ends with the smallest d, ties to the
// lowest j.  With NaN masked to +inf beforehand it equals a serial
// first-win scan of strict < (an all-inf window gives lane 0's j).
__device__ __forceinline__ void warp_argmin(float& d, int& j) {
  for (int o = 16; o > 0; o >>= 1) {
    const float od = __shfl_xor_sync(kFullMask, d, o);
    const int oj = __shfl_xor_sync(kFullMask, j, o);
    if (od < d || (od == d && oj < j)) {
      d = od;
      j = oj;
    }
  }
}
