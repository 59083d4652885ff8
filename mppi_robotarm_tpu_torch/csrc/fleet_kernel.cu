// The closed loop of a fleet of small-K scenarios: one, two or four warps
// per scenario.
//
// Replaces: mppi_robotarm_tpu/ops/pallas_sim.py::_sim_kernel_stacked, the
// TPU kernel that packs up to 8 scenarios of K <= 128 samples into the
// sublanes of one vreg.  That layout is a TPU trick and is not carried
// over: on Hopper a warp is the unit that runs 32 lanes in lockstep, so
// each scenario gets kW warps (1, 2 or 4, ops/cuda_sim.py::fleet_warps)
// and the scenarios of a block share nothing (no __syncthreads; the warps
// of a scenario meet at their own named barrier, bar.sync id, 32 kW).
// Plain PyTorch twin:
// ops/cuda_sim.py::fused_sim_reference_stacked; wrapper: ops/cuda_sim.py::
// fused_sim_run_batched(group > 1) for K <= 128.
//
// Contract: per scenario, records and u_final equal sim_kernel.cu's bit for
// bit, in both noise modes.  The per-sample arithmetic is sim_common.cuh's
// sample_step, which repeats sim_kernel.cu's rollout operation for
// operation with a window scan that picks the same row (mppi_device.cuh's
// window_cost on its one-chain schedule), and
// every K-sum is taken in sim_kernel.cu's order at K <= 128 (one sample per
// thread, round_up(K, 32) threads): slot j (samples k = lane + 32j) plays
// sim_kernel.cu's warp j.  Warp h of a scenario holds slots h*kS .. h*kS +
// kS - 1, kS samples a lane.  Each slot is reduced with the xor-butterfly
// warp_sum / warp_min; the slot results meet in shared memory and every
// lane folds them in slot order; a missing sample adds 0 to the sums and
// +inf to the min.  Σwε keeps sim_kernel.cu's form: per row, each lane sums
// e·ε over its slots in slot order, then warp_sum; the rows are split
// between the warps of the scenario, the slots are not.
//
// Per closed-loop step, inside the scenario's warps:
//   1. waypoint phase, lane-parallel in every warp of the scenario (each
//      holds the scenario's state in registers, the same bits): lane j
//      computes window row j's distance straight from the path; a butterfly
//      over (d, j) finds the strictly smallest d with ties to the lowest j
//      (a serial first-win scan's row; NaN never wins, an all-inf window
//      gives 0); the path-end freeze; the scenario's threads copy the
//      window at the effective index to shared memory as float4 rows.  A
//      frozen scenario skips phases 2-5: a per-scenario branch, no
//      divergence inside a warp;
//   2. noise + rollout: every lane rolls out its kS samples side by side,
//      one horizon step of each in turn (the trig carry, exact sincosf, the
//      shared window scan), kS = 1 at K=128;
//   3. softmax and stats: slot-wise butterflies; the slot partials go to
//      shared memory and every lane folds them in slot order;
//   4. Σwε: per horizon row, each lane sums e·ε over all slots, then
//      warp_sum; ε comes back from the ε store in PRNG mode and from the
//      caller's noise in eps mode; e of the other warp's slots from shared
//      memory;
//   5. reflect median, u update and warm-start shift in one pass into a
//      second u buffer, lane-parallel over the 2T entries;
//   6. plant step (every lane computes the same scalar chain, so no
//      broadcast is needed) and the 12-float record row, lane i of warp 0
//      writing float i.
// With kW > 1 a step takes four scenario barriers (after the window copy,
// the min partials, the sum partials and Σwε, and the u update); each
// shared buffer's next write lies after a barrier that follows its last
// read.
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
// What bounds it: the rollout, K·T dependent arm steps, issue-bound on a
// full card (PERF.md).  __launch_bounds__(256, 4) holds it to 64 registers
// so that 32 warps are resident per SM.  At that budget a lane that
// carried four samples (36 registers of Sample) spilled, two samples spill
// a little and one does not, so fleet_warps gives K > 96 four warps, one
// sample a lane: sim_kernel.cu's thread-per-sample layout, with the
// one-chain scan of an issue-bound card (PERF.md has the A/Bs), at the
// window's compiled width where it has one (mppi_device.cuh's kScanWidth:
// each kW, kS has an instance at it and one at a run-time W).  A lane
// holds at most two samples.

#include <cuda_runtime.h>

#include "sim_common.cuh"

namespace {

constexpr int kMaxSlots = 4;         // K <= 128: sim_kernel.cu's 4 warps
constexpr int kMaxWarps = 8;         // warps per block
constexpr int kMinBlocks = 4;        // resident blocks per SM
constexpr int kMaxSmem = 227 * 1024;
constexpr int kPartFloats = 5 * kMaxSlots;   // min; Σe, Σe², ΣS, Σe(S-m)

// Shared floats per scenario, a multiple of 4 so that every scenario's
// window starts on a 16-byte boundary: window (4W, float4 rows), u and the
// next u (2 x 2T), Σwε rows (2T), slot partials, e of every slot (4 x 32).
__host__ __device__ int smem_floats_per_scenario(const SimParams& p) {
  return (4 * p.W + 6 * p.T + kPartFloats + 32 * kMaxSlots + 3) / 4 * 4;
}

// The scenario's barrier: its warp alone, or its kW warps' named barrier
// (ids 1 .. 8 / kW; 0 is __syncthreads').  bar.sync also orders the threads'
// shared and global memory accesses, which publishes the ε store.
template <int kW>
__device__ __forceinline__ void scenario_sync(int place) {
  if (kW == 1) {
    __syncwarp();
  } else {
    asm volatile("bar.sync %0, %1;" ::"r"(place + 1), "r"(32 * kW)
                 : "memory");
  }
}

}  // namespace

// kW warps per scenario, kS samples per lane (kW * kS * 32 >= K, kS <= 2);
// the window scans at the compiled width kWin (kScanWidth == W), or at W
// read at run time (kWin = 0).
template <int kW, int kS, int kWin>
__global__ void __launch_bounds__(32 * kMaxWarps, kMinBlocks)
fleet_kernel(const SimParams p, int B,
             const float* __restrict__ state_f,   // (B, 4) q1, q2, dq1, dq2
             const int* __restrict__ state_i,     // (B, 3) wp_idx, seed, step0
             const float* __restrict__ u0,        // (B, T, 2)
             const float* __restrict__ ref,       // (n_ref, 4)
             const float* eps_in,                 // (B, n_steps, K, T, 2) | null
             float* eps_scratch,                  // (B, slots, T, 2, 32) | null
             float* __restrict__ rec,             // (B, n_steps, 12)
             float* __restrict__ ufin) {          // (B, T, 2)
  extern __shared__ float4 smem4[];
  const int K = p.K, T = p.T, W = p.W;
  const int lane = threadIdx.x & 31;
  const int wid = threadIdx.x >> 5;
  const int place = wid / kW;           // the scenario's place in the block
  const int h = wid - place * kW;       // the warp's place in the scenario
  const int tid = h * 32 + lane;       // thread of the scenario
  const int b = blockIdx.x * (blockDim.x / (32 * kW)) + place;
  if (b >= B) return;                  // whole scenarios only
  const int slots = (K + 31) / 32;
  float* base = reinterpret_cast<float*>(smem4) +
                (size_t)place * smem_floats_per_scenario(p);
  const float4* s_win = reinterpret_cast<const float4*>(base);   // W rows
  float* s_u = base + 4 * W;           // 2T, dim-major: the current u
  float* s_un = s_u + 2 * T;           // 2T: the next u (swapped each step)
  float* s_weps = s_un + 2 * T;        // 2T: Σwε rows
  float* s_part = s_weps + 2 * T;      // slot partials: min [4], sums [4][4]
  float* s_e = s_part + kPartFloats;   // e[slot][lane]
  // [((j*T + t)*2 + c)*32 + lane]
  float* store = p.use_prng ? eps_scratch + (size_t)b * slots * T * 2 * 32
                            : nullptr;
  const float4* ref4 = reinterpret_cast<const float4*>(ref);

  const uint32_t seed = (uint32_t)state_i[3 * b + 1];
  const int step0 = state_i[3 * b + 2];
  const size_t ktw = (size_t)K * T * 2;
  float q1 = state_f[4 * b], q2 = state_f[4 * b + 1];
  float dq1 = state_f[4 * b + 2], dq2 = state_f[4 * b + 3];
  int wp = state_i[3 * b];
  bool done = false;
  float stats[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  for (int i = tid; i < 2 * T; i += 32 * kW) {
    s_u[(i & 1) * T + (i >> 1)] = u0[(size_t)b * 2 * T + i];
  }

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
    // A frozen step rewrites the window it had, and nothing reads it.
    for (int j = tid; j < W; j += 32 * kW) {
      reinterpret_cast<float4*>(base)[j] = ref4[min(wp + j, p.n_ref - 1)];
    }
    scenario_sync<kW>(place);

    if (!frz) {
      // ---- 2. noise + rollout + cost, kS samples per lane -----------------
      const float* eps_step =
          p.use_prng ? nullptr
                     : eps_in + ((size_t)b * p.n_steps + step) * ktw;
      const float c1_0 = cosf(q1), s1_0 = sinf(q1);
      const float c12_0 = cosf(q1 + q2), s12_0 = sinf(q1 + q2);
      const uint32_t key1 = (uint32_t)(step0 + step);
      Sample xs[kS];
#pragma unroll
      for (int i = 0; i < kS; ++i) {
        xs[i] = Sample{q1, q2, dq1, dq2, c1_0, s1_0, c12_0, s12_0, 0.0f};
      }
      for (int t = 0; t < T; ++t) {     // the lane's chains side by side
        const float u1r = s_u[t], u2r = s_u[T + t];
#pragma unroll
        for (int i = 0; i < kS; ++i) {
          const int j = h * kS + i;
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
            sample_step<kWin>(p, xs[i], (float)k < p.exploit_thresh, e1,
                              e2, u1r, u2r, s_win);
          }
        }
      }
      float sv[kS];
#pragma unroll
      for (int i = 0; i < kS; ++i) {
        sv[i] = lane + 32 * (h * kS + i) < K
                    ? sample_terminal<kWin>(p, xs[i], s_win) : INFINITY;
      }

      // ---- 3. softmax and stats, slot j = sim_kernel.cu's warp j ---------
#pragma unroll
      for (int i = 0; i < kS; ++i) {
        const int j = h * kS + i;
        if (j < slots) {
          // fminf(inf, S) as sim_kernel.cu's fold: a NaN cost counts as inf
          const float mj = warp_min(fminf(INFINITY, sv[i]));
          if (kW == 1) {
            if (i == 0) stats[0] = mj;
            else stats[0] = fminf(stats[0], mj);
          } else if (lane == 0) {
            s_part[j] = mj;
          }
        }
      }
      if (kW > 1) {
        scenario_sync<kW>(place);
        stats[0] = s_part[0];
        for (int j = 1; j < slots; ++j) stats[0] = fminf(stats[0], s_part[j]);
      }
      const float m = stats[0];
      float ew[kS];
      float sums[4] = {0.0f, 0.0f, 0.0f, 0.0f};   // Σe, Σe², ΣS, Σe(S-m)
#pragma unroll
      for (int i = 0; i < kS; ++i) {
        const int j = h * kS + i;
        ew[i] = 0.0f;
        if (j < slots) {
          float v[4] = {0.0f, 0.0f, 0.0f, 0.0f};
          if (lane + 32 * j < K) {
            const float s = sv[i];
            const float e = expf(-(s - m) / p.lam);
            v[0] += e;
            v[1] += e * e;
            v[2] += s;
            v[3] += e * (s - m);
            ew[i] = e;
          }
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            v[q] = warp_sum(v[q]);
            if (kW == 1) {
              sums[q] = i == 0 ? v[q] : sums[q] + v[q];
            } else if (lane == 0) {
              s_part[kMaxSlots + 4 * j + q] = v[q];
            }
          }
          if (kW > 1) s_e[32 * j + lane] = ew[i];
        }
      }
      if (kW > 1) {
        scenario_sync<kW>(place);   // also publishes e[] and the ε store
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          sums[q] = s_part[kMaxSlots + q];
          for (int j = 1; j < slots; ++j) {
            sums[q] += s_part[kMaxSlots + 4 * j + q];
          }
        }
      }
      const float eta = sums[0];
      const float inv_eta = 1.0f / eta;
      stats[1] = sums[2] / p.k_actual;
      stats[2] = (eta * eta) / sums[1];
      stats[3] = logf(eta) + sums[3] * inv_eta / p.lam;

      // ---- 4. Σwε, rows t and T + t, t split over the scenario's warps ---
      for (int t = h; t < T; t += kW) {
        float a1 = 0.0f, a2 = 0.0f;
#pragma unroll
        for (int j = 0; j < kMaxSlots; ++j) {
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
            const float e = kW == 1 ? ew[j < kS ? j : 0] : s_e[32 * j + lane];
            a1 += e * e1;
            a2 += e * e2;
          }
        }
        a1 = warp_sum(a1);
        a2 = warp_sum(a2);
        if (lane == 0) {
          s_weps[t] = a1 * inv_eta;
          s_weps[T + t] = a2 * inv_eta;
        }
      }
      scenario_sync<kW>(place);

      // ---- 5. median, u update and warm-start shift -----------------------
      for (int i = tid; i < 2 * T; i += 32 * kW) {
        const int c = i / T, t = i - c * T;
        const int ts = t < T - 1 ? t + 1 : T - 1;
        s_un[i] = s_u[c * T + ts] + reflect_median(s_weps + c * T, T, p.fw, ts);
      }
      scenario_sync<kW>(place);
      float* const spent = s_u;
      s_u = s_un;
      s_un = spent;
    }

    // ---- 6. plant step and record row --------------------------------------
    const float u1 = s_u[0], u2 = s_u[T];    // shifted first element (Q3)
    if (!frz) {
      dynamics_step(q1, q2, dq1, dq2, u1 + p.dist1, u2 + p.dist2, p.dt_p,
                    p.arm);
    }
    if (h == 0 && lane < kRecLanes) {
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
  }

  for (int i = tid; i < 2 * T; i += 32 * kW) {
    ufin[(size_t)b * 2 * T + i] = s_u[(i & 1) * T + (i >> 1)];
  }
}

namespace {

using FleetKernel = void (*)(const SimParams, int, const float*, const int*,
                             const float*, const float*, const float*,
                             float*, float*, float*);

// The instance for kW warps a scenario (ops/cuda_sim.py::fleet_warps): the
// fewest samples a lane that cover K.  Null when K does not fit: one warp
// holds one slot, two warps up to two slots a lane, four warps one.
template <int kWin>
FleetKernel fleet_instance(int warps, int K) {
  const int slots = (K + 31) / 32;
  if (warps == 1 && slots == 1) return fleet_kernel<1, 1, kWin>;
  if (warps == 2 && slots > 1 && slots <= 2) return fleet_kernel<2, 1, kWin>;
  if (warps == 2 && slots > 2 && slots <= 4) return fleet_kernel<2, 2, kWin>;
  if (warps == 4 && slots > 3 && slots <= 4) return fleet_kernel<4, 1, kWin>;
  return nullptr;
}

}  // namespace

extern "C" {

// Launch the fleet kernel on `stream`: B scenarios of `warps` warps each,
// `group` per block (fewer when the block would exceed 8 warps or its
// shared memory would not fit), the window scanned at the compiled width
// `scan_w` (kScanWidth, which must equal W) or, at 0, at W read at run
// time (ops/cuda_sim.py::scan_width picks).  eps_scratch is
// mppi_fleet_scratch_floats() floats per scenario in PRNG mode, null in
// eps mode.  Returns the cudaError_t of the launch; cudaErrorInvalidValue
// when B % group != 0, group is outside 1..8, K is outside 1..128,
// `warps` does not fit K or scan_w is neither 0 nor a compiled W.
int mppi_fleet_launch(const SimParams* params, int B, int group, int warps,
                      int scan_w, const float* state_f, const int* state_i,
                      const float* u0, const float* ref, const float* eps_in,
                      float* eps_scratch, float* rec, float* ufin,
                      void* stream) {
  const SimParams p = *params;
  const FleetKernel kernel =
      scan_w == 0 ? fleet_instance<0>(warps, p.K)
      : scan_w == kScanWidth && p.W == kScanWidth
          ? fleet_instance<kScanWidth>(warps, p.K) : nullptr;
  if (p.K < 1 || p.K > 32 * kMaxSlots || kernel == nullptr || group < 1 ||
      group > kMaxWarps || B % group != 0) {
    return (int)cudaErrorInvalidValue;
  }
  int per_block = group < kMaxWarps / warps ? group : kMaxWarps / warps;
  const size_t per = sizeof(float) * (size_t)smem_floats_per_scenario(p);
  while (per_block > 1 && per_block * per > (size_t)kMaxSmem) --per_block;
  const size_t smem = per_block * per;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  kernel<<<(B + per_block - 1) / per_block, 32 * warps * per_block, smem,
           (cudaStream_t)stream>>>(p, B, state_f, state_i, u0, ref, eps_in,
                                   eps_scratch, rec, ufin);
  return (int)cudaGetLastError();
}

// Floats of ε scratch per scenario that PRNG mode needs.
int mppi_fleet_scratch_floats(const SimParams* params) {
  return (params->K + 31) / 32 * params->T * 2 * 32;
}

}  // extern "C"
