// The per-step loop's step body around the solve kernel: two launches a
// step, one before solve_kernel.cu and one after it.
//
// Replaces: no Pallas kernel.  In the JAX package, sim_step
// (mppi_robotarm_tpu/sim/loop.py:86) runs under simulate's jitted lax.scan
// (:122-163), and XLA compiles everything of a step but the solve into one
// fused program: the waypoint advance of solve_batched_pallas
// (mppi_robotarm_tpu/mppi/solver.py:215-221), the plant, the freeze, the
// warm-start shift and the record row.  The port's per-step loop ran that as
// about 136 small torch kernels a step inside its CUDA graphs; these two
// kernels run it instead.  Plain PyTorch versions:
// ops/cuda_step.py::step_head_plain and step_tail_plain; wrappers:
// ops/cuda_step.py::step_head and step_tail.
//
//   step_head_kernel, one warp a scenario, four a block: the observed
//   state x0 = [q, dq], the end effector (fk_ee with the cost model's link
//   lengths), the nearest row of the window ref[wp, wp + W) clamped at the
//   path end (rows past it masked to +inf), ties and NaN as torch.argmin
//   takes them (the first strict minimum, a NaN first of all), the new
//   index, the path-end flag and the window at the new index, which the
//   solve kernel reads.
//
//   step_tail_kernel, one block a scenario (blockDim from K alone): the
//   freeze flag done | path_end, the shifted warm start (kept where done),
//   the plant (dynamics_step at sim.dt, with the disturbance), the kept q,
//   dq, index and the step counter, then the record row of the step, in
//   place at its row of the record buffers: q, dq, u0, the elbow and end
//   effector (fk_full), the reference row ref[min(clock + 1, N - 1)], the
//   index, min S, mean S, the ESS and the entropy of the softmax weights of
//   S, and done, the u and statistic lanes zeroed where done.  `clock` is
//   the run's step counter (step0 + the steps taken, frozen ones too), so a
//   captured graph replays at any offset of the run.
//
// Arithmetic.  Exact float32 and --fmad=false, as the torch code it
// replaces: fk_ee, fk_full and the plant are its operations in its order
// (libdevice sinf/cosf, which give torch's bits on the card, as the solve
// kernel's S shows), and the argmin keeps torch's ties, so q, dq, u, the
// index, done and the window are the plain version's bits.  The statistics
// are sums over K in another order than torch's reductions: thread t of n
// sums samples t, t + n, ... in order, a warp folds its 32 sums by an xor
// butterfly, and the warps' sums are added in warp order; n =
// step_tail_threads(K), so a scenario's bits depend on K alone, not on the
// batch or the card.  The weights follow torch on the card: e = exp(-(S -
// min S) * fl(1/lam)) (torch divides by a scalar as a multiply by its
// reciprocal), w = e / Sum e, ESS = 1 / Sum w^2, entropy = -Sum w log w
// over w > 0, mean = Sum S * fl(1/K).
//
// What bounds them.  Both are tiny: bytes.  The head reads 2W rows of 16
// bytes a scenario and writes W; the tail reads S (4K bytes) and the
// controls (16T) and writes a few dozen words a scenario.  At B=1 a launch
// costs more than its work; what the two save is the ~136 launches, ~170 us
// a step at benchmark_preset, they replace (PERF.md).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "mppi_device.cuh"

// Mirrored field for field by ops/cuda_step.py::_StepParams (all fields
// are 4 bytes wide).
struct StepParams {
  ArmConsts arm;
  float l1c, l2c;          // the cost model's link lengths (fk_ee)
  float dist_scale;
  float dt_p;              // plant dt (sim.dt)
  float dist1, dist2;      // plant disturbance torque
  float inv_lam;           // fl(1 / lam)
  float inv_k;             // fl(1 / K)
  int K, T, W, n_ref;
};

// Mirrored by ops/cuda_step.py::_HeadArgs: the operands of one head launch.
struct HeadArgs {
  const float* q;          // (B, 2) rows q_stride floats apart
  const float* dq;         // (B, 2) rows dq_stride floats apart
  const long long* wp;     // (B,)
  const float* ref;        // (n_ref, 4)
  float* x0;               // (B, 4)
  long long* wp_out;       // (B,)
  bool* path_end;          // (B,)
  float* window;           // (B, W, 4)
  int q_stride, dq_stride;
};

// Mirrored by ops/cuda_step.py::_TailArgs: the operands of one tail launch.
// The record row's pointers are all null (no row) or all set.
struct TailArgs {
  const long long* step;   // the state before the step: (B,)
  const float* q;          // (B, 2)
  const float* dq;         // (B, 2)
  const float* u_prev;     // (B, T, 2)
  const long long* wp;     // (B,)
  const bool* done;        // (B,)
  const long long* wp_new; // the head's index and path end: (B,)
  const bool* path_end;    // (B,)
  const float* u_seq;      // the solve's updated controls: (B, T, 2)
  const float* s;          // the solve's costs: (B, K)
  const float* ref;        // (n_ref, 4)
  const long long* clock;  // the run's step counter: (B,) or null
  long long* step_out;     // the state after the step
  float* q_out;
  float* dq_out;
  float* u_out;
  long long* wp_out;
  bool* done_out;
  long long* clock_out;    // null with clock
  float* r_q;              // the record row (needs clock): (B, 2) each ...
  float* r_dq;
  float* r_u;
  float* r_ee;
  float* r_elbow;
  float* r_ref;
  long long* r_wp;         // ... (B,) each
  float* r_cmin;
  float* r_cmean;
  float* r_ess;
  float* r_ent;
  bool* r_done;
};

static const int kHeadThreads = 128;     // four scenarios a block

// (a, ia) before (b, ib) in torch.argmin's order: a NaN first, then the
// smaller value, ties to the lower index.
__device__ __forceinline__ bool argmin_before(float a, int ia, float b,
                                              int ib) {
  const bool an = a != a, bn = b != b;
  if (an || bn) return an && (!bn || ia < ib);
  return a < b || (a == b && ia < ib);
}

__global__ void __launch_bounds__(kHeadThreads)
step_head_kernel(const StepParams p, const HeadArgs a, int B) {
  const int lane = threadIdx.x & 31;
  const int b = blockIdx.x * (kHeadThreads / 32) + (threadIdx.x >> 5);
  if (b >= B) return;
  const float q1 = a.q[(size_t)b * a.q_stride];
  const float q2 = a.q[(size_t)b * a.q_stride + 1];
  if (lane < 4) {
    a.x0[4 * b + lane] = lane < 2 ? a.q[(size_t)b * a.q_stride + lane]
                                  : a.dq[(size_t)b * a.dq_stride + lane - 2];
  }
  // fk_ee (models/arm.py): l1 cos q1 + l2 cos(q1 + q2), the same for y
  const float x = p.l1c * cosf(q1) + p.l2c * cosf(q1 + q2);
  const float y = p.l1c * sinf(q1) + p.l2c * sinf(q1 + q2);
  const long long wp = a.wp[b];
  const long long last = p.n_ref - 1;
  float best = INFINITY;
  int bi = 0x7fffffff;
  for (int j = lane; j < p.W; j += 32) {
    const long long idx = wp + j;
    const float* r = a.ref + 4 * (idx < last ? idx : last);
    const float dx = x - r[0];
    const float dy = y - r[1];
    float d = (dx * dx + dy * dy) * p.dist_scale;
    if (idx > last) d = INFINITY;
    if (argmin_before(d, j, best, bi)) {
      best = d;
      bi = j;
    }
  }
  for (int o = 16; o > 0; o >>= 1) {
    const float od = __shfl_xor_sync(kFullMask, best, o);
    const int oi = __shfl_xor_sync(kFullMask, bi, o);
    if (argmin_before(od, oi, best, bi)) {
      best = od;
      bi = oi;
    }
  }
  const long long nw = wp + bi;
  if (lane == 0) {
    a.wp_out[b] = nw;
    a.path_end[b] = nw >= last;
  }
  float* win = a.window + (size_t)b * p.W * 4;
  for (int i = lane; i < 4 * p.W; i += 32) {
    const long long idx = nw + (i >> 2);
    win[i] = a.ref[4 * (idx < last ? idx : last) + (i & 3)];
  }
}

// torch.amin's NaN rule: a NaN anywhere makes the minimum NaN.
__device__ __forceinline__ float nan_min(float a, float b) {
  return a != a ? a : (b != b ? b : fminf(a, b));
}

// The block's sum of one value a thread, in a fixed order (see the header);
// every thread returns the same bits.  `red` holds a float a warp.
__device__ __forceinline__ float block_sum(float v, float* red) {
  v = warp_sum(v);
  __syncthreads();                       // red's last readers are done
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  float t = 0.0f;
  for (int i = 0; i < (int)(blockDim.x >> 5); ++i) t += red[i];
  return t;
}

__device__ __forceinline__ float block_min(float v, float* red) {
  for (int o = 16; o > 0; o >>= 1) {
    v = nan_min(v, __shfl_xor_sync(kFullMask, v, o));
  }
  __syncthreads();
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  float t = red[0];
  for (int i = 1; i < (int)(blockDim.x >> 5); ++i) t = nan_min(t, red[i]);
  return t;
}

__global__ void __launch_bounds__(1024)
step_tail_kernel(const StepParams p, const TailArgs a) {
  __shared__ float red[32];
  const int b = blockIdx.x;
  const int T2 = 2 * p.T;
  const bool done = a.done[b] || a.path_end[b];
  const float* us = a.u_seq + (size_t)b * T2;
  // the warm start shifted (solver.shift_warm_start), kept where done
  for (int i = threadIdx.x; i < T2; i += blockDim.x) {
    const int src = min((i >> 1) + 1, p.T - 1);
    a.u_out[(size_t)b * T2 + i] =
        done ? a.u_prev[(size_t)b * T2 + i] : us[2 * src + (i & 1)];
  }
  const bool row = a.r_q != nullptr;
  if (threadIdx.x == 0) {
    const int t0 = min(1, p.T - 1);      // u0: the shifted first control
    const float u1 = us[2 * t0], u2 = us[2 * t0 + 1];
    float q1 = a.q[2 * b], q2 = a.q[2 * b + 1];
    float dq1 = a.dq[2 * b], dq2 = a.dq[2 * b + 1];
    if (!done) {
      dynamics_step(q1, q2, dq1, dq2, u1 + p.dist1, u2 + p.dist2, p.dt_p,
                    p.arm);
    }
    const long long wp = done ? a.wp[b] : a.wp_new[b];
    a.q_out[2 * b] = q1;
    a.q_out[2 * b + 1] = q2;
    a.dq_out[2 * b] = dq1;
    a.dq_out[2 * b + 1] = dq2;
    a.wp_out[b] = wp;
    a.step_out[b] = a.step[b] + (done ? 0 : 1);
    a.done_out[b] = done;
    if (a.clock != nullptr) a.clock_out[b] = a.clock[b] + 1;
    if (row) {
      a.r_q[2 * b] = q1;
      a.r_q[2 * b + 1] = q2;
      a.r_dq[2 * b] = dq1;
      a.r_dq[2 * b + 1] = dq2;
      a.r_u[2 * b] = done ? 0.0f : u1;
      a.r_u[2 * b + 1] = done ? 0.0f : u2;
      // fk_full (models/arm.py)
      const float x1 = p.arm.l1 * cosf(q1);
      const float y1 = p.arm.l1 * sinf(q1);
      a.r_ee[2 * b] = x1 + p.arm.l2 * cosf(q1 + q2);
      a.r_ee[2 * b + 1] = y1 + p.arm.l2 * sinf(q1 + q2);
      a.r_elbow[2 * b] = x1;
      a.r_elbow[2 * b + 1] = y1;
      const long long last = p.n_ref - 1;
      const long long next = a.clock[b] + 1;
      const float* r = a.ref + 4 * (next < last ? next : last);
      a.r_ref[2 * b] = r[0];
      a.r_ref[2 * b + 1] = r[1];
      a.r_wp[b] = wp;
      a.r_done[b] = done;
    }
  }
  if (!row) return;                      // the same for every thread
  // the statistics of the step's costs, each pass a fixed-order sum
  const float* s = a.s + (size_t)b * p.K;
  float mn = INFINITY, sum = 0.0f;
  for (int k = threadIdx.x; k < p.K; k += blockDim.x) {
    mn = nan_min(mn, s[k]);
    sum += s[k];
  }
  const float rho = block_min(mn, red);
  const float mean = block_sum(sum, red) * p.inv_k;
  float eta = 0.0f;
  for (int k = threadIdx.x; k < p.K; k += blockDim.x) {
    eta += expf(-(s[k] - rho) * p.inv_lam);
  }
  eta = block_sum(eta, red);
  float w2 = 0.0f, wlw = 0.0f;
  for (int k = threadIdx.x; k < p.K; k += blockDim.x) {
    const float w = expf(-(s[k] - rho) * p.inv_lam) / eta;
    w2 += w * w;
    wlw += w > 0.0f ? w * logf(fmaxf(w, 1e-38f)) : 0.0f;
  }
  w2 = block_sum(w2, red);
  wlw = block_sum(wlw, red);
  if (threadIdx.x == 0) {
    a.r_cmin[b] = done ? 0.0f : rho;
    a.r_cmean[b] = done ? 0.0f : mean;
    a.r_ess[b] = done ? 0.0f : 1.0f / w2;
    a.r_ent[b] = done ? 0.0f : -wlw;
  }
}

extern "C" {

// The head of B scenarios on `stream`; returns the cudaError_t of the
// launch, cudaErrorInvalidValue for arguments the kernel does not take.
int mppi_step_head_launch(const StepParams* params, const HeadArgs* args,
                          int B, void* stream) {
  const StepParams p = *params;
  if (B < 1 || p.W < 1 || p.n_ref < 1) return (int)cudaErrorInvalidValue;
  const int per = kHeadThreads / 32;
  step_head_kernel<<<(B + per - 1) / per, kHeadThreads, 0,
                     (cudaStream_t)stream>>>(p, *args, B);
  return (int)cudaGetLastError();
}

// The tail of B scenarios on `stream`, `threads` threads a scenario (a
// multiple of 32, at most 1024); returns the cudaError_t of the launch.
int mppi_step_tail_launch(const StepParams* params, const TailArgs* args,
                          int B, int threads, void* stream) {
  const StepParams p = *params;
  if (B < 1 || p.K < 1 || p.T < 1 || p.n_ref < 1 || threads < 32 ||
      threads > 1024 || threads % 32 != 0) {
    return (int)cudaErrorInvalidValue;
  }
  step_tail_kernel<<<B, threads, 0, (cudaStream_t)stream>>>(p, *args);
  return (int)cudaGetLastError();
}

// sizeof of the structs, held against the ctypes mirrors when the library
// loads.
int mppi_step_params_size() { return (int)sizeof(StepParams); }
int mppi_step_head_args_size() { return (int)sizeof(HeadArgs); }
int mppi_step_tail_args_size() { return (int)sizeof(TailArgs); }

}  // extern "C"
