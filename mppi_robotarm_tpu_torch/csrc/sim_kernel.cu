// The whole receding-horizon closed loop of B scenarios in one launch.
//
// Replaces: mppi_robotarm_tpu/ops/pallas_sim.py::_sim_kernel (with its scalar
// phases _init_scalar_state, _refresh_window, _wp_advance_scalar and
// _plant_record_scalar).  It ports WHAT that kernel computes, not its
// (8, 128) vreg layout.  Plain PyTorch twin: ops/cuda_sim.py::
// fused_sim_reference; wrapper: ops/cuda_sim.py::fused_sim_run_batched.
//
// Layout.  One block per scenario (grid = B), blockDim = min(1024,
// round_up(K, 32)); thread tid rolls out samples k = tid, tid + blockDim, ...
// so K up to 8192 works.  Dynamic shared memory holds the per-sample costs
// S[K] (overwritten by the softmax numerators e[K]), the (W, 4) waypoint
// window, the dim-major control rows u[c*T + t], Σwε and the median.  Per
// closed-loop step, separated by __syncthreads():
//   1. waypoint phase, thread 0: FK of the observed state, window at the
//      old index, masked first-win argmin, path-end freeze (Q5/Q6), window
//      at the effective index.  A frozen scenario skips phases 2-5, as the
//      JAX kernel's pl.when(any_active) does;
//   2. noise + rollout, one thread per sample: PRNG mode draws Philox4x32-10
//      normals keyed (seed, step0 + step), counter (k, t, 0, 0), scales them
//      by chol(Σ) and writes ε to a (B, K, T, 2) global scratch (400 KB at
//      K=1024, T=50: it stays in L2); eps mode reads the caller's
//      (B, n, K, T, 2) noise.  T steps of the arm model with the trig carry
//      (cos/sin of q2 from the carried q1 and q1+q2 pairs), exact sincosf
//      for the FK, the tracking cost against the window, γ·vᵀΣ⁻¹u, and the
//      terminal cost;
//   3. softmax and stats: block min, then e = exp(-(S-m)/λ) with Σe, Σe²,
//      ΣS and Σe(S-m) in one pass; warp-shuffle trees and a fixed-order sum
//      of the warp partials, so the result is deterministic;
//   4. Σwε: one warp per output row (2T rows strided over the warps), lanes
//      striding k, a shuffle reduce, times 1/η;
//   5. scipy-reflect median (single fold, rank fw/2), u += med, then the
//      warm-start shift; the applied control is the shifted first element
//      (Q3);
//   6. plant step at sim.dt plus the disturbance (Q2), thread 0, and one
//      12-float record row [q1,q2,dq1,dq2,u1,u2,wp,done,cost_min,cost_mean,
//      ess,entropy] written straight to global memory.
//
// Arithmetic.  Exact float32 throughout: IEEE divide and sqrt, libdevice
// sinf/cosf/expf/logf, no --use_fast_math.  The build passes --fmad=false:
// no a*b+c is contracted into an FMA, so each operation rounds as the
// PyTorch twin's separate elementwise operations do, and only the order of
// the K-sums differs between the two.  The TPU kernel's PRNG-mode levers
// (fast reciprocal, incremental-rotation trig, fast_select, ICDF noise,
// group interleave) are not ported: each is an H100 A/B for later work.
//
// What bounds it.  The closed loop is serial in the step, and at B=1 the
// whole of it runs as one block on 1 of the 132 SMs: a latency-bound chain
// of T dependent rollout steps per sample, six block barriers per step, and
// single-thread waypoint and plant phases.  Splitting K over a thread-block
// cluster is later work.  Fleets of K <= 128 scenarios run one warp each in
// fleet_kernel.cu, whose sample_step (sim_common.cuh) is the same sequence
// of float32 operations as the rollout below; this kernel keeps its own
// inline copy, because calling the helper made it 12 % slower at B=1
// (PERF.md).

#include <cuda_runtime.h>

#include "sim_common.cuh"

namespace {

// Copy ref rows [widx, widx + W) into the window, clamped to the last row.
__device__ void refresh_window(float* win, const float* __restrict__ ref,
                               int widx, int W, int n_ref) {
  for (int j = 0; j < W; ++j) {
    const int src = min(widx + j, n_ref - 1);
    win[4 * j] = ref[4 * src];
    win[4 * j + 1] = ref[4 * src + 1];
    win[4 * j + 2] = ref[4 * src + 2];
    win[4 * j + 3] = ref[4 * src + 3];
  }
}

}  // namespace

__global__ void __launch_bounds__(1024)
sim_kernel(const SimParams p,
           const float* __restrict__ state_f,   // (B, 4) q1, q2, dq1, dq2
           const int* __restrict__ state_i,     // (B, 3) wp_idx, seed, step0
           const float* __restrict__ u0,        // (B, T, 2)
           const float* __restrict__ ref,       // (n_ref, 4)
           const float* eps_in,                 // (B, n_steps, K, T, 2) | null
           float* eps_scratch,                  // (B, K, T, 2) | null
           float* __restrict__ rec,             // (B, n_steps, 12)
           float* __restrict__ ufin) {          // (B, T, 2)
  extern __shared__ float smem[];
  const int K = p.K, T = p.T, W = p.W;
  float* s_cost = smem;              // K: S, then e
  float* s_win = s_cost + K;         // 4W
  float* s_u = s_win + 4 * W;        // 2T, dim-major
  float* s_weps = s_u + 2 * T;       // 2T
  float* s_med = s_weps + 2 * T;     // 2T
  float* s_red = s_med + 2 * T;      // 4 x 32 warp partials

  __shared__ float s_st[4];          // q1, q2, dq1, dq2
  __shared__ float s_stats[4];       // cost_min, cost_mean, ess, entropy
  __shared__ float s_wp_lane;
  __shared__ int s_wp, s_done, s_frz;

  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int nthr = blockDim.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nwarp = nthr >> 5;
  const uint32_t seed = (uint32_t)state_i[3 * b + 1];
  const int step0 = state_i[3 * b + 2];
  const size_t ktw = (size_t)K * T * 2;
  float* eps_own = p.use_prng ? eps_scratch + (size_t)b * ktw : nullptr;

  if (tid == 0) {
    for (int i = 0; i < 4; ++i) s_st[i] = state_f[4 * b + i];
    for (int i = 0; i < 4; ++i) s_stats[i] = 0.0f;
    s_wp = state_i[3 * b];
    s_done = 0;
  }
  for (int i = tid; i < 2 * T; i += nthr) {
    s_u[(i & 1) * T + (i >> 1)] = u0[(size_t)b * 2 * T + i];
  }
  __syncthreads();

  for (int step = 0; step < p.n_steps; ++step) {
    // ---- 1. waypoint advance and freeze (_wp_advance_scalar) -------------
    if (tid == 0) {
      const float q1o = s_st[0], q2o = s_st[1];
      const int widx0 = s_wp;
      const float x = p.l1c * cosf(q1o) + p.l2c * cosf(q1o + q2o);
      const float y = p.l1c * sinf(q1o) + p.l2c * sinf(q1o + q2o);
      refresh_window(s_win, ref, widx0, W, p.n_ref);
      float best = INFINITY;
      int off = 0;
      for (int j = 0; j < W; ++j) {
        const float dx = x - s_win[4 * j];
        const float dy = y - s_win[4 * j + 1];
        float d = (dx * dx + dy * dy) * p.dist_scale;
        if (!(widx0 + j < p.n_ref)) d = INFINITY;
        if (d < best) {
          best = d;
          off = j;
        }
      }
      const int wn = widx0 + off;
      const int frz = s_done || (wn >= p.n_ref - 1);
      const int widx = frz ? widx0 : wn;   // frozen keeps the old index
      s_wp = widx;
      s_done = frz;
      s_frz = frz;
      s_wp_lane = (float)widx;
      refresh_window(s_win, ref, widx, W, p.n_ref);
    }
    __syncthreads();

    if (!s_frz) {
      // ---- 2. noise + rollout + cost, one thread per sample --------------
      const float* eps_step =
          p.use_prng ? eps_own
                     : eps_in + ((size_t)b * p.n_steps + step) * ktw;
      const float q1_0 = s_st[0], q2_0 = s_st[1];
      const float dq1_0 = s_st[2], dq2_0 = s_st[3];
      const float c1_0 = cosf(q1_0), s1_0 = sinf(q1_0);
      const float c12_0 = cosf(q1_0 + q2_0), s12_0 = sinf(q1_0 + q2_0);
      const uint32_t key1 = (uint32_t)(step0 + step);
      for (int k = tid; k < K; k += nthr) {
        float q1 = q1_0, q2 = q2_0, dq1 = dq1_0, dq2 = dq2_0, s = 0.0f;
        float c1 = c1_0, s1 = s1_0, c12 = c12_0, s12 = s12_0;
        const bool exploit = (float)k < p.exploit_thresh;
        for (int t = 0; t < T; ++t) {
          const size_t e_off = ((size_t)k * T + t) * 2;
          float e1, e2;
          if (p.use_prng) {
            uint32_t c[4] = {(uint32_t)k, (uint32_t)t, 0u, 0u};
            philox4x32_10(c, seed, key1);
            float z1, z2;
            box_muller(uniform_from_bits(c[0]), uniform_from_bits(c[1]), z1,
                       z2);
            e1 = p.l11 * z1;
            e2 = p.l21 * z1 + p.l22 * z2;
            eps_own[e_off] = e1;
            eps_own[e_off + 1] = e2;
          } else {
            e1 = eps_step[e_off];
            e2 = eps_step[e_off + 1];
          }
          const float u1r = s_u[t], u2r = s_u[T + t];
          float v1 = exploit ? u1r + e1 : e1;
          float v2 = exploit ? u2r + e2 : e2;
          if (p.has_clamp) {
            v1 = fminf(fmaxf(v1, -p.u_clamp), p.u_clamp);
            v2 = fminf(fmaxf(v2, -p.u_clamp), p.u_clamp);
          }
          // q2 = (q1 + q2) - q1: angle-difference identities
          const float c2 = c12 * c1 + s12 * s1;
          const float s2 = s12 * c1 - c12 * s1;
          dynamics_step_trig(q1, q2, dq1, dq2, v1, v2, p.dt_c, p.arm, c1, c2,
                             s2, c12);
          sincosf(q1, &s1, &c1);
          sincosf(q1 + q2, &s12, &c12);
          const float x = p.l1c * c1 + p.l2c * c12;
          const float y = p.l1c * s1 + p.l2c * s12;
          s = s + tracking_cost(x, y, dq1, dq2, s_win, W, p.stage_w[0],
                                p.stage_w[1], p.stage_w[2], p.stage_w[3],
                                p.dist_scale, p.cost_scale);
          const float su1 = p.sinv[0] * u1r + p.sinv[1] * u2r;
          const float su2 = p.sinv[2] * u1r + p.sinv[3] * u2r;
          s = s + p.gamma * (v1 * su1 + v2 * su2);
        }
        const float xT = p.l1c * c1 + p.l2c * c12;
        const float yT = p.l1c * s1 + p.l2c * s12;
        s = s + tracking_cost(xT, yT, dq1, dq2, s_win, W, p.term_w[0],
                              p.term_w[1], p.term_w[2], p.term_w[3],
                              p.dist_scale, p.cost_scale);
        s_cost[k] = s;
      }
      __syncthreads();

      // ---- 3. softmax and stats -------------------------------------------
      float m = INFINITY;
      for (int k = tid; k < K; k += nthr) m = fminf(m, s_cost[k]);
      m = warp_min(m);
      if (lane == 0) s_red[warp] = m;
      __syncthreads();
      m = s_red[0];
      for (int w = 1; w < nwarp; ++w) m = fminf(m, s_red[w]);
      __syncthreads();   // s_red is reused below

      float se = 0.0f, see = 0.0f, ss = 0.0f, sesm = 0.0f;
      for (int k = tid; k < K; k += nthr) {
        const float s = s_cost[k];
        const float e = expf(-(s - m) / p.lam);
        se += e;
        see += e * e;
        ss += s;
        sesm += e * (s - m);
        s_cost[k] = e;
      }
      se = warp_sum(se);
      see = warp_sum(see);
      ss = warp_sum(ss);
      sesm = warp_sum(sesm);
      if (lane == 0) {
        s_red[warp] = se;
        s_red[32 + warp] = see;
        s_red[64 + warp] = ss;
        s_red[96 + warp] = sesm;
      }
      __syncthreads();   // also publishes e[] and the PRNG-mode ε scratch
      float eta = s_red[0], sum_ee = s_red[32];
      float sum_s = s_red[64], sum_esm = s_red[96];
      for (int w = 1; w < nwarp; ++w) {
        eta += s_red[w];
        sum_ee += s_red[32 + w];
        sum_s += s_red[64 + w];
        sum_esm += s_red[96 + w];
      }
      const float inv_eta = 1.0f / eta;
      if (tid == 0) {
        s_stats[0] = m;
        s_stats[1] = sum_s / p.k_actual;
        s_stats[2] = (eta * eta) / sum_ee;
        s_stats[3] = logf(eta) + sum_esm * inv_eta / p.lam;
      }

      // ---- 4. Σwε: one warp per row r = c*T + t ---------------------------
      for (int r = warp; r < 2 * T; r += nwarp) {
        const int c = r / T, t = r - c * T;
        float acc = 0.0f;
        for (int k = lane; k < K; k += 32) {
          acc += s_cost[k] * eps_step[((size_t)k * T + t) * 2 + c];
        }
        acc = warp_sum(acc);
        if (lane == 0) s_weps[r] = acc * inv_eta;
      }
      __syncthreads();

      // ---- 5. median, u update and warm-start shift -----------------------
      for (int i = tid; i < 2 * T; i += nthr) {
        const int c = i / T, t = i - c * T;
        s_med[i] = reflect_median(s_weps + c * T, T, p.fw, t);
      }
      __syncthreads();
      for (int i = tid; i < 2 * T; i += nthr) {   // Σwε is spent: reuse it
        const int c = i / T, t = i - c * T;
        const int src = c * T + (t < T - 1 ? t + 1 : T - 1);
        s_weps[i] = s_u[src] + s_med[src];
      }
      __syncthreads();
      for (int i = tid; i < 2 * T; i += nthr) s_u[i] = s_weps[i];
      __syncthreads();
    }

    // ---- 6. plant step and record row (_plant_record_scalar) -------------
    if (tid == 0) {
      const int frz = s_frz;
      const float u1 = s_u[0], u2 = s_u[T];   // shifted first element (Q3)
      float q1 = s_st[0], q2 = s_st[1], dq1 = s_st[2], dq2 = s_st[3];
      if (!frz) {
        dynamics_step(q1, q2, dq1, dq2, u1 + p.dist1, u2 + p.dist2, p.dt_p,
                      p.arm);
        s_st[0] = q1;
        s_st[1] = q2;
        s_st[2] = dq1;
        s_st[3] = dq2;
      }
      float* row = rec + ((size_t)b * p.n_steps + step) * kRecLanes;
      row[0] = q1;
      row[1] = q2;
      row[2] = dq1;
      row[3] = dq2;
      row[4] = frz ? 0.0f : u1;
      row[5] = frz ? 0.0f : u2;
      row[6] = s_wp_lane;
      row[7] = frz ? 1.0f : 0.0f;
      for (int i = 0; i < 4; ++i) row[8 + i] = frz ? 0.0f : s_stats[i];
    }
    __syncthreads();
  }

  for (int i = tid; i < 2 * T; i += nthr) {
    ufin[(size_t)b * 2 * T + i] = s_u[(i & 1) * T + (i >> 1)];
  }
}

extern "C" {

// Launch the kernel on `stream`; returns the cudaError_t of the launch.
int mppi_sim_launch(const SimParams* params, int B, const float* state_f,
                    const int* state_i, const float* u0, const float* ref,
                    const float* eps_in, float* eps_scratch, float* rec,
                    float* ufin, void* stream) {
  const SimParams p = *params;
  const int rounded = ((p.K + 31) / 32) * 32;
  const int threads = rounded < 1024 ? rounded : 1024;
  const size_t smem = sizeof(float) * ((size_t)p.K + 4 * p.W + 6 * p.T + 128);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        sim_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  sim_kernel<<<B, threads, smem, (cudaStream_t)stream>>>(
      p, state_f, state_i, u0, ref, eps_in, eps_scratch, rec, ufin);
  return (int)cudaGetLastError();
}

const char* mppi_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// sizeof(SimParams), held against the ctypes mirror when the library loads.
int mppi_sim_params_size() { return (int)sizeof(SimParams); }

}  // extern "C"
