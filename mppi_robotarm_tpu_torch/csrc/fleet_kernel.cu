// The closed loop of a fleet of small-K scenarios: one warp per scenario.
//
// Replaces: mppi_robotarm_tpu/ops/pallas_sim.py::_sim_kernel_stacked, the
// TPU kernel that packs up to 8 scenarios of K <= 128 samples into the
// sublanes of one vreg.  That layout is a TPU trick and is not carried
// over: on Hopper a warp is the unit that runs 32 lanes in lockstep, so
// each scenario gets one warp and the CTA's `group` warps share nothing
// (no __syncthreads, only __syncwarp).  Plain PyTorch twin:
// ops/cuda_sim.py::fused_sim_reference_stacked; wrapper: ops/cuda_sim.py::
// fused_sim_run_batched(group > 1) for K <= 128.
//
// Contract: per scenario, records and u_final equal sim_kernel.cu's bit for
// bit, in both noise modes.  The per-sample arithmetic is sim_common.cuh's
// sample_step, which repeats sim_kernel.cu's rollout operation for
// operation (sim_kernel.cu scans the window in another order and picks the
// same row), and every K-sum is taken in sim_kernel.cu's order at
// K <= 128 (one sample per thread, round_up(K, 32) threads): lane l owns
// samples k = l + 32j, j < ceil(K/32), and slot j plays sim_kernel.cu's
// warp j.  Each slot is reduced with the xor-butterfly warp_sum / warp_min
// and the slot results are added in slot order; a missing sample adds 0 to
// the sums and +inf to the min.  Σwε already has this form in sim_kernel.cu
// (each lane sums its samples, then warp_sum).
//
// Per closed-loop step, inside one warp:
//   1. waypoint phase, lane-parallel: lane j computes window row j's
//      distance straight from the path; a butterfly over (d, j) finds the
//      strictly smallest d with ties to the lowest j (a serial first-win
//      scan's row; NaN never wins, an all-inf window gives 0);
//      the path-end freeze; lane j copies row j of the window at the
//      effective index to the warp's shared memory.  A frozen scenario
//      skips phases 2-5: a per-warp branch, no divergence inside the warp;
//   2. noise + rollout: every lane rolls out its up to 4 samples side by
//      side, one horizon step of each in turn (the trig carry, exact
//      sincosf, the tracking cost against the shared window);
//   3. softmax and stats: slot-wise butterflies, held by every lane;
//   4. Σwε: per horizon step, each lane sums e·ε over its samples, then
//      warp_sum; ε comes back from the ε store in PRNG mode and from the
//      caller's noise in eps mode;
//   5. reflect median, u update and warm-start shift, lane-parallel over
//      the 2T entries;
//   6. plant step (every lane computes the same scalar chain, so no
//      broadcast is needed) and the 12-float record row, lane i writing
//      float i.
//
// The ε store (PRNG mode).  Σwε needs each sample's ε after the softmax.
// It goes to a per-scenario global scratch laid out [slot][t][c][lane], so
// each warp access is one coalesced 128-byte line: 126 MB at 4096 × K=128,
// T=30, beyond the H100's 50 MB L2.  Shared memory (30 KB per scenario at
// that shape) and regenerating ε from Philox in phase 4 were built and
// timed against it on the card; both were slower (PERF.md).
//
// Arithmetic: as sim_kernel.cu, exact float32 (--fmad=false, libdevice
// sinf/cosf/expf/logf, IEEE divide).
//
// What bounds it: the rollout, K·T dependent arm steps of which each lane
// runs up to 4 independent chains, each step scanning the W-row
// window; the fixed per-step phases are warp-wide and take no block barrier.
// __launch_bounds__(256, 4) holds it to 64 registers (a small spill) so
// that 4 blocks of 8 scenarios are resident per SM: it ran faster than the
// unbounded 117 registers (PERF.md).

#include <cuda_runtime.h>

#include "sim_common.cuh"

namespace {

constexpr int kSlots = 4;            // samples per lane: K <= 128
constexpr int kMaxGroup = 8;         // warps (scenarios) per block
constexpr int kMinBlocks = 4;        // resident blocks per SM
constexpr int kMaxSmem = 227 * 1024;

// Shared floats per warp: u (2T), window (4W), Σwε (2T), median (2T).
__host__ __device__ int smem_floats_per_warp(const SimParams& p) {
  return 6 * p.T + 4 * p.W;
}

}  // namespace

__global__ void __launch_bounds__(32 * kMaxGroup, kMinBlocks)
fleet_kernel(const SimParams p, int B,
             const float* __restrict__ state_f,   // (B, 4) q1, q2, dq1, dq2
             const int* __restrict__ state_i,     // (B, 3) wp_idx, seed, step0
             const float* __restrict__ u0,        // (B, T, 2)
             const float* __restrict__ ref,       // (n_ref, 4)
             const float* eps_in,                 // (B, n_steps, K, T, 2) | null
             float* eps_scratch,                  // (B, slots, T, 2, 32) | null
             float* __restrict__ rec,             // (B, n_steps, 12)
             float* __restrict__ ufin) {          // (B, T, 2)
  extern __shared__ float smem[];
  const int K = p.K, T = p.T, W = p.W;
  const int lane = threadIdx.x & 31;
  const int wid = threadIdx.x >> 5;
  const int b = blockIdx.x * (blockDim.x >> 5) + wid;
  if (b >= B) return;                  // whole warps only: no block barrier
  const int slots = (K + 31) / 32;
  float* s_u = smem + (size_t)wid * smem_floats_per_warp(p);
  float* s_win = s_u + 2 * T;          // 4W
  float* s_weps = s_win + 4 * W;       // 2T
  float* s_med = s_weps + 2 * T;       // 2T
  // [((j*T + t)*2 + c)*32 + lane]
  float* store = p.use_prng ? eps_scratch + (size_t)b * slots * T * 2 * 32
                            : nullptr;

  const uint32_t seed = (uint32_t)state_i[3 * b + 1];
  const int step0 = state_i[3 * b + 2];
  const size_t ktw = (size_t)K * T * 2;
  float q1 = state_f[4 * b], q2 = state_f[4 * b + 1];
  float dq1 = state_f[4 * b + 2], dq2 = state_f[4 * b + 3];
  int wp = state_i[3 * b];
  bool done = false;
  float stats[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  for (int i = lane; i < 2 * T; i += 32) {
    s_u[(i & 1) * T + (i >> 1)] = u0[(size_t)b * 2 * T + i];
  }
  __syncwarp();

  for (int step = 0; step < p.n_steps; ++step) {
    // ---- 1. waypoint advance and freeze, lane j on window row j ----------
    const float xo = p.l1c * cosf(q1) + p.l2c * cosf(q1 + q2);
    const float yo = p.l1c * sinf(q1) + p.l2c * sinf(q1 + q2);
    float best = INFINITY;
    int off = lane;
    for (int j = lane; j < W; j += 32) {
      const int src = min(wp + j, p.n_ref - 1);
      const float dx = xo - ref[4 * src];
      const float dy = yo - ref[4 * src + 1];
      float d = (dx * dx + dy * dy) * p.dist_scale;
      if (!(wp + j < p.n_ref) || d != d) d = INFINITY;
      if (d < best) {
        best = d;
        off = j;
      }
    }
    warp_argmin(best, off);            // all-inf: lane 0's j = 0 wins the tie
    const int wn = wp + off;
    const bool frz = done || (wn >= p.n_ref - 1);
    if (!frz) wp = wn;                 // frozen keeps the old index
    done = frz;
    for (int j = lane; j < W; j += 32) {
      const int src = min(wp + j, p.n_ref - 1);
      s_win[4 * j] = ref[4 * src];
      s_win[4 * j + 1] = ref[4 * src + 1];
      s_win[4 * j + 2] = ref[4 * src + 2];
      s_win[4 * j + 3] = ref[4 * src + 3];
    }
    __syncwarp();

    if (!frz) {
      // ---- 2. noise + rollout + cost, up to 4 samples per lane -----------
      const float* eps_step =
          p.use_prng ? nullptr
                     : eps_in + ((size_t)b * p.n_steps + step) * ktw;
      const float c1_0 = cosf(q1), s1_0 = sinf(q1);
      const float c12_0 = cosf(q1 + q2), s12_0 = sinf(q1 + q2);
      const uint32_t key1 = (uint32_t)(step0 + step);
      Sample xs[kSlots];
#pragma unroll
      for (int j = 0; j < kSlots; ++j) {
        xs[j] = Sample{q1, q2, dq1, dq2, c1_0, s1_0, c12_0, s12_0, 0.0f};
      }
      for (int t = 0; t < T; ++t) {     // the lane's chains side by side
        const float u1r = s_u[t], u2r = s_u[T + t];
#pragma unroll
        for (int j = 0; j < kSlots; ++j) {
          const int k = lane + 32 * j;
          if (k < K) {
            float e1, e2;
            if (p.use_prng) {
              philox_eps(p, seed, key1, k, t, e1, e2);
              const int at = ((j * T + t) * 2) * 32 + lane;
              store[at] = e1;
              store[at + 32] = e2;
            } else {
              e1 = eps_step[((size_t)k * T + t) * 2];
              e2 = eps_step[((size_t)k * T + t) * 2 + 1];
            }
            sample_step(p, xs[j], (float)k < p.exploit_thresh, e1, e2, u1r,
                        u2r, s_win);
          }
        }
      }
      float sv[kSlots];
#pragma unroll
      for (int j = 0; j < kSlots; ++j) {
        sv[j] = lane + 32 * j < K ? sample_terminal(p, xs[j], s_win)
                                  : INFINITY;
      }

      // ---- 3. softmax and stats, slot j = sim_kernel.cu's warp j ---------
      float m = INFINITY;
#pragma unroll
      for (int j = 0; j < kSlots; ++j) {
        if (j < slots) {
          float mj = INFINITY;
          if (lane + 32 * j < K) mj = fminf(mj, sv[j]);
          mj = warp_min(mj);
          m = j == 0 ? mj : fminf(m, mj);
        }
      }
      float ew[kSlots];
      float eta = 0.0f, sum_ee = 0.0f, sum_s = 0.0f, sum_esm = 0.0f;
#pragma unroll
      for (int j = 0; j < kSlots; ++j) {
        ew[j] = 0.0f;
        if (j < slots) {
          float se = 0.0f, see = 0.0f, ss = 0.0f, sesm = 0.0f;
          if (lane + 32 * j < K) {
            const float s = sv[j];
            const float e = expf(-(s - m) / p.lam);
            se += e;
            see += e * e;
            ss += s;
            sesm += e * (s - m);
            ew[j] = e;
          }
          se = warp_sum(se);
          see = warp_sum(see);
          ss = warp_sum(ss);
          sesm = warp_sum(sesm);
          if (j == 0) {
            eta = se;
            sum_ee = see;
            sum_s = ss;
            sum_esm = sesm;
          } else {
            eta += se;
            sum_ee += see;
            sum_s += ss;
            sum_esm += sesm;
          }
        }
      }
      const float inv_eta = 1.0f / eta;
      stats[0] = m;
      stats[1] = sum_s / p.k_actual;
      stats[2] = (eta * eta) / sum_ee;
      stats[3] = logf(eta) + sum_esm * inv_eta / p.lam;

      // ---- 4. Σwε, rows t and T + t ---------------------------------------
      for (int t = 0; t < T; ++t) {
        float a1 = 0.0f, a2 = 0.0f;
#pragma unroll
        for (int j = 0; j < kSlots; ++j) {
          const int k = lane + 32 * j;
          if (k < K) {
            float e1, e2;
            if (p.use_prng) {
              const int at = ((j * T + t) * 2) * 32 + lane;
              e1 = store[at];
              e2 = store[at + 32];
            } else {
              e1 = eps_step[((size_t)k * T + t) * 2];
              e2 = eps_step[((size_t)k * T + t) * 2 + 1];
            }
            a1 += ew[j] * e1;
            a2 += ew[j] * e2;
          }
        }
        a1 = warp_sum(a1);
        a2 = warp_sum(a2);
        if (lane == 0) {
          s_weps[t] = a1 * inv_eta;
          s_weps[T + t] = a2 * inv_eta;
        }
      }
      __syncwarp();

      // ---- 5. median, u update and warm-start shift -----------------------
      for (int i = lane; i < 2 * T; i += 32) {
        const int c = i / T, t = i - c * T;
        s_med[i] = reflect_median(s_weps + c * T, T, p.fw, t);
      }
      __syncwarp();
      for (int i = lane; i < 2 * T; i += 32) {   // Σwε is spent: reuse it
        const int c = i / T, t = i - c * T;
        const int src = c * T + (t < T - 1 ? t + 1 : T - 1);
        s_weps[i] = s_u[src] + s_med[src];
      }
      __syncwarp();
      for (int i = lane; i < 2 * T; i += 32) s_u[i] = s_weps[i];
      __syncwarp();
    }

    // ---- 6. plant step and record row --------------------------------------
    const float u1 = s_u[0], u2 = s_u[T];    // shifted first element (Q3)
    if (!frz) {
      dynamics_step(q1, q2, dq1, dq2, u1 + p.dist1, u2 + p.dist2, p.dt_p,
                    p.arm);
    }
    if (lane < kRecLanes) {
      float v = q1;
      v = lane == 1 ? q2 : v;
      v = lane == 2 ? dq1 : v;
      v = lane == 3 ? dq2 : v;
      v = lane == 4 ? (frz ? 0.0f : u1) : v;
      v = lane == 5 ? (frz ? 0.0f : u2) : v;
      v = lane == 6 ? (float)wp : v;
      v = lane == 7 ? (frz ? 1.0f : 0.0f) : v;
      v = lane == 8 ? stats[0] : v;
      v = lane == 9 ? stats[1] : v;
      v = lane == 10 ? stats[2] : v;
      v = lane == 11 ? stats[3] : v;
      if (frz && lane >= 8) v = 0.0f;
      rec[((size_t)b * p.n_steps + step) * kRecLanes + lane] = v;
    }
    __syncwarp();
  }

  for (int i = lane; i < 2 * T; i += 32) {
    ufin[(size_t)b * 2 * T + i] = s_u[(i & 1) * T + (i >> 1)];
  }
}

extern "C" {

// Launch the fleet kernel on `stream`: B scenarios, `group` per block
// (fewer when their shared memory does not fit a block).  eps_scratch is
// mppi_fleet_scratch_floats() floats per scenario in PRNG mode, null in eps
// mode.  Returns the cudaError_t of the launch; cudaErrorInvalidValue when
// B % group != 0, group is outside 1..8 or K is outside 1..128.
int mppi_fleet_launch(const SimParams* params, int B, int group,
                      const float* state_f, const int* state_i,
                      const float* u0, const float* ref, const float* eps_in,
                      float* eps_scratch, float* rec, float* ufin,
                      void* stream) {
  const SimParams p = *params;
  if (p.K < 1 || p.K > 32 * kSlots || group < 1 || group > kMaxGroup ||
      B % group != 0) {
    return (int)cudaErrorInvalidValue;
  }
  int warps = group;
  while (warps > 1 &&
         sizeof(float) * (size_t)warps * smem_floats_per_warp(p) >
             (size_t)kMaxSmem) {
    --warps;
  }
  const size_t smem = sizeof(float) * (size_t)warps * smem_floats_per_warp(p);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        fleet_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  fleet_kernel<<<(B + warps - 1) / warps, 32 * warps, smem,
                 (cudaStream_t)stream>>>(p, B, state_f, state_i, u0, ref,
                                         eps_in, eps_scratch, rec, ufin);
  return (int)cudaGetLastError();
}

// Floats of ε scratch per scenario that PRNG mode needs.
int mppi_fleet_scratch_floats(const SimParams* params) {
  return (params->K + 31) / 32 * params->T * 2 * 32;
}

}  // extern "C"
