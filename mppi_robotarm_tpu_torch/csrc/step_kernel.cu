// The per-step loop's step body around the solve kernel: a chunk of the
// loop is one head launch, then two launches a step, solve_kernel.cu and
// the tail, which also runs the next step's head.
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
//   step_head_kernel, one warp a scenario, four a block: the head (see
//   head_body): the observed state x0 = [q, dq], the end effector (fk_ee
//   with the cost model's link lengths), the nearest row of the window
//   ref[wp, wp + W) clamped at the path end (rows past it masked to +inf),
//   ties and NaN as torch.argmin takes them (the first strict minimum, a
//   NaN first of all), the new index, the path-end flag and the window at
//   the new index, which the solve kernel reads.
//
//   step_tail_kernel, a control warp and `ns` statistics warps a scenario,
//   `group` scenarios a block.  The control warp: the freeze flag done |
//   path_end, the shifted warm start (kept where done), the plant
//   (dynamics_step at sim.dt, with the disturbance), the kept q, dq, index
//   and the step counter, the record row's scalar lanes in place at its
//   row of the record buffers (q, dq, u0, the elbow and end effector by
//   fk_full, the reference row ref[min(clock + 1, N - 1)], the index,
//   done), and, given the next head's outputs, head_body on the new state,
//   still in registers: the head of step i + 1 at the end of step i.  The
//   statistics warps: min S, mean S, the ESS and the entropy of the softmax
//   weights of S, zeroed where done, written by the statistics' first warp.
//   The two parts share nothing but their inputs, so neither waits for the
//   other.  `clock` is the run's step counter (step0 + the steps taken,
//   frozen ones too), so a captured graph replays at any offset of the run.
//
// Arithmetic.  Exact float32 and --fmad=false, as the torch code it
// replaces: fk_ee, fk_full and the plant are its operations in its order
// (libdevice sinf/cosf, which give torch's bits on the card, as the solve
// kernel's S shows, and sincosf where both of one angle are needed, which
// gives the same bits; fk_full and fk_ee share the four values), and the
// argmin keeps torch's ties, so q, dq, u, the index, done and the window
// are the plain version's bits.  The statistics are sums over K in another
// order than torch's reductions, fixed by n = step_tail_threads(K) logical
// lanes, which depend on K alone: logical lane t sums samples t, t + n, ...
// in order, a logical warp of 32 folds its sums by an xor butterfly, and
// the logical warps' sums are added in warp order, so a scenario's bits do
// not depend on the batch, the layout or the card
// (ops/cuda_step.py::tail_stats_ordered is the order in torch).  A physical
// lane holds L logical lanes (logical warp w on statistics warp w / L,
// register set w % L) and runs the butterfly on each set; the logical
// warps' sums meet in shared memory (one named barrier a round) or, on one
// statistics warp, in registers.  The weights follow torch on the card: e
// = exp(-(S - min S) * fl(1/lam)) (torch divides by a scalar as a multiply
// by its reciprocal), w = e / Sum e, ESS = 1 / Sum w^2, entropy = -Sum w
// log w over w > 0, mean = Sum S * fl(1/K).
//
// What bounds them.  Both are tiny: bytes, and at B=1 latency.  The head
// reads 2W rows of 16 bytes a scenario and writes W; the tail reads S (4K
// bytes) and the controls (16T) and writes a few dozen words a scenario.
// So the tail reads S once, into registers (a sample a logical lane up to
// K = 1024; above that each pass reads S again), computes each weight's
// exp once, and needs three exchange rounds, which the
// dependencies force (rho before e, eta before w); each round's fold of
// the logical warps' sums loads all 32 slots at once (those past the
// scenario's warps hold the sum's identity) and runs one chain.  The
// plant, a chain of dependent scalar operations, runs on its own warp
// beside them, its loads (the path rows of the head it carries among
// them) all in flight before it.  The head, whose inputs are the tail's
// outputs, costs no launch of its own but one a chunk.  No work sits
// behind a per-sample branch but an exact division with a nonzero
// dividend.  At B=1 the statistics' three rounds are the critical path;
// on a fleet, issue and the SMs' occupancy (PERF.md).

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

// Mirrored by ops/cuda_step.py::_HeadArgs: the operands of one head launch,
// or the outputs of the head a tail carries (then q, dq, wp and ref are
// null: its state is the tail's, its path the tail's).
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
static const int kMaxLanes = 1024;       // step_tail_threads' largest n
static const int kRedFloats = 160;       // a scenario's exchange slots
static const int kMaxBarrierGroup = 15;  // named barriers 1..15

// (a, ia) before (b, ib) in torch.argmin's order: a NaN first, then the
// smaller value, ties to the lower index (selects, no branch).
__device__ __forceinline__ bool argmin_before(float a, int ia, float b,
                                              int ib) {
  const bool an = a != a, bn = b != b;
  const bool nan_first = an && (!bn || ia < ib);
  const bool lower = a < b || (a == b && ia < ib);
  return (an || bn) ? nan_first : lower;
}

// dst[i] = src(i) for i < n on one warp, a lane's loads of each round of
// 128 all in flight before its stores (the compiler cannot move a load
// above a store that may alias it).
template <class F>
__device__ __forceinline__ void warp_copy(float* dst, int n, int lane,
                                          F src) {
  for (int base = 0; base < n; base += 128) {
    float v[4];
#pragma unroll
    for (int m = 0; m < 4; ++m) {
      const int i = base + 32 * m + lane;
      v[m] = i < n ? src(i) : 0.0f;
    }
#pragma unroll
    for (int m = 0; m < 4; ++m) {
      const int i = base + 32 * m + lane;
      if (i < n) dst[i] = v[m];
    }
  }
}

// A head's path rows: row j is ref[min(wp + j, last)], j < 2W - 1 (the
// scan's W and the window's W from the argmin's row).  StagedRows reads
// the warp's copy of kStagedRows of them in shared memory (W <= 32: the
// loads go out early, as HeadLoad, and land there before the head runs);
// PathRows reads the path itself.
static const int kStagedRows = 64;

struct StagedRows {
  const float* sm;
  __device__ __forceinline__ float at(int j, int c) const {
    return sm[4 * j + c];
  }
};

struct PathRows {
  const float* ref;
  long long wp, last;
  __device__ __forceinline__ float at(int j, int c) const {
    const long long idx = wp + j;
    return ref[4 * (idx < last ? idx : last) + c];
  }
};

// A lane's share of the staged rows in flight: floats lane + 32k of the
// block, so each of the eight loads is coalesced.
struct HeadLoad {
  float v[8];
  __device__ __forceinline__ void load(const PathRows& rows, int lane) {
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const int e = lane + 32 * k;
      v[k] = rows.at(e >> 2, e & 3);
    }
  }
  __device__ __forceinline__ StagedRows stage(float* sm, int lane) const {
#pragma unroll
    for (int k = 0; k < 8; ++k) sm[lane + 32 * k] = v[k];
    __syncwarp();
    return StagedRows{sm};
  }
};

// The head of one scenario on one warp, from its state (q1, q2, dq1, dq2),
// the trig of it (c1 = cos q1, s1 = sin q1, c12 = cos(q1 + q2), s12 =
// sin(q1 + q2)), its index wp and its path rows, all the same in every
// lane; writes x0[4], *wp_out, *path_end and win[W * 4].
template <class Rows>
__device__ __forceinline__ void head_body(const StepParams& p,
                                          const Rows& rows, int lane,
                                          float q1, float q2, float dq1,
                                          float dq2, float c1, float s1,
                                          float c12, float s12, long long wp,
                                          float* x0, long long* wp_out,
                                          bool* path_end, float* win) {
  if (lane < 4) x0[lane] = lane == 0 ? q1 : lane == 1 ? q2 : lane == 2 ? dq1
                                                                      : dq2;
  // fk_ee (models/arm.py): l1 cos q1 + l2 cos(q1 + q2), the same for y
  const float x = p.l1c * c1 + p.l2c * c12;
  const float y = p.l1c * s1 + p.l2c * s12;
  const long long last = p.n_ref - 1;
  float best = INFINITY;
  int bi = 0x7fffffff;
  for (int j = lane; j < p.W; j += 32) {
    const float dx = x - rows.at(j, 0);
    const float dy = y - rows.at(j, 1);
    float d = (dx * dx + dy * dy) * p.dist_scale;
    if (wp + j > last) d = INFINITY;
    const bool take = argmin_before(d, j, best, bi);
    best = take ? d : best;
    bi = take ? j : bi;
  }
  for (int o = 16; o > 0; o >>= 1) {
    const float od = __shfl_xor_sync(kFullMask, best, o);
    const int oi = __shfl_xor_sync(kFullMask, bi, o);
    const bool take = argmin_before(od, oi, best, bi);
    best = take ? od : best;
    bi = take ? oi : bi;
  }
  const long long nw = wp + bi;
  if (lane == 0) {
    *wp_out = nw;
    *path_end = nw >= last;
  }
  warp_copy(win, 4 * p.W, lane,
            [&](int i) { return rows.at(bi + (i >> 2), i & 3); });
}

__global__ void __launch_bounds__(kHeadThreads)
step_head_kernel(const StepParams p, const HeadArgs a, int B) {
  __shared__ float staged[kHeadThreads / 32][4 * kStagedRows];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int b = blockIdx.x * (kHeadThreads / 32) + warp;
  if (b >= B) return;
  const float* q = a.q + (size_t)b * a.q_stride;
  const float* dq = a.dq + (size_t)b * a.dq_stride;
  const float q1 = q[0], q2 = q[1];
  const float q12 = q1 + q2;
  const PathRows path{a.ref, a.wp[b], p.n_ref - 1};
  float c1, s1, c12, s12;
  sincosf(q1, &s1, &c1);
  sincosf(q12, &s12, &c12);
  float* x0 = a.x0 + 4 * b;
  float* win = a.window + (size_t)b * p.W * 4;
  if (2 * p.W - 1 <= kStagedRows) {
    HeadLoad hl;
    hl.load(path, lane);
    head_body(p, hl.stage(staged[warp], lane), lane, q1, q2, dq[0], dq[1],
              c1, s1, c12, s12, path.wp, x0, a.wp_out + b, a.path_end + b,
              win);
  } else {
    head_body(p, path, lane, q1, q2, dq[0], dq[1], c1, s1, c12, s12,
              path.wp, x0, a.wp_out + b, a.path_end + b, win);
  }
}

// torch.amin's NaN rule: a NaN anywhere makes the minimum NaN (a's if
// both are); selects, no branch.
__device__ __forceinline__ float nan_min(float a, float b) {
  const float m = fminf(a, b);
  const float mb = b != b ? b : m;
  return a != a ? a : mb;
}

// The control warp of scenario b: everything of the tail but the
// statistics, and with `carry` the head of h on the new state, its path
// rows staged in `sm` (4 * kStagedRows floats) where they fit.  Every lane
// runs the plant (the same bits; the warp issues it once), lane 0 stores.
// Every load goes out first, the plant runs while they are in flight, and
// the stores of what they fetched come after it (a warp issues in order,
// so a store waiting on a load would hold the plant back).
__device__ __forceinline__ void tail_control(const StepParams& p,
                                             const TailArgs& a,
                                             const HeadArgs& h, bool carry,
                                             int b, int lane, float* sm) {
  const int T2 = 2 * p.T;
  const bool row = a.r_q != nullptr;
  const bool done = a.done[b] || a.path_end[b];
  const long long wp_kept = a.wp[b], wp_next = a.wp_new[b];
  const float* us = a.u_seq + (size_t)b * T2;
  const float* up = a.u_prev + (size_t)b * T2;
  const int t0 = min(1, p.T - 1);        // u0: the shifted first control
  const float u1 = us[2 * t0], u2 = us[2 * t0 + 1];
  float q1 = a.q[2 * b], q2 = a.q[2 * b + 1];
  float dq1 = a.dq[2 * b], dq2 = a.dq[2 * b + 1];
  const long long step = a.step[b];
  const long long clock = a.clock != nullptr ? a.clock[b] : 0;
  // the warm start shifted (solver.shift_warm_start), kept where done:
  // the first 128 floats' two candidates
  float keep[4], shifted[4];
#pragma unroll
  for (int m = 0; m < 4; ++m) {
    const int i = 32 * m + lane;
    keep[m] = i < T2 ? up[i] : 0.0f;
    shifted[m] = i < T2 ? us[2 * min((i >> 1) + 1, p.T - 1) + (i & 1)] : 0.0f;
  }
  const long long wp = done ? wp_kept : wp_next;
  const long long last = p.n_ref - 1;
  float rx = 0.0f, ry = 0.0f;            // the record's reference row
  if (row) {
    const float* r = a.ref + 4 * (clock + 1 < last ? clock + 1 : last);
    rx = r[0];
    ry = r[1];
  }
  const PathRows path{a.ref, wp, last};
  const bool staged = carry && 2 * p.W - 1 <= kStagedRows;
  HeadLoad hl;
  if (staged) hl.load(path, lane);
  if (!done) {                           // dynamics_step, one sincosf
    float s2, c2;
    sincosf(q2, &s2, &c2);
    dynamics_step_trig(q1, q2, dq1, dq2, u1 + p.dist1, u2 + p.dist2, p.dt_p,
                       p.arm, cosf(q1), c2, s2, cosf(q1 + q2));
  }
  if (lane == 0) {
    a.q_out[2 * b] = q1;
    a.q_out[2 * b + 1] = q2;
    a.dq_out[2 * b] = dq1;
    a.dq_out[2 * b + 1] = dq2;
    a.wp_out[b] = wp;
    a.step_out[b] = step + (done ? 0 : 1);
    a.done_out[b] = done;
    if (a.clock != nullptr) a.clock_out[b] = clock + 1;
  }
  float* u_out = a.u_out + (size_t)b * T2;
#pragma unroll
  for (int m = 0; m < 4; ++m) {
    const int i = 32 * m + lane;
    if (i < T2) u_out[i] = done ? keep[m] : shifted[m];
  }
  if (T2 > 128) {
    warp_copy(u_out + 128, T2 - 128, lane, [&](int i) {
      i += 128;
      return done ? up[i] : us[2 * min((i >> 1) + 1, p.T - 1) + (i & 1)];
    });
  }
  if (!row && !carry) return;
  float c1, s1, c12, s12;
  sincosf(q1, &s1, &c1);
  sincosf(q1 + q2, &s12, &c12);
  if (row && lane == 0) {
    a.r_q[2 * b] = q1;
    a.r_q[2 * b + 1] = q2;
    a.r_dq[2 * b] = dq1;
    a.r_dq[2 * b + 1] = dq2;
    a.r_u[2 * b] = done ? 0.0f : u1;
    a.r_u[2 * b + 1] = done ? 0.0f : u2;
    // fk_full (models/arm.py)
    const float x1 = p.arm.l1 * c1;
    const float y1 = p.arm.l1 * s1;
    a.r_ee[2 * b] = x1 + p.arm.l2 * c12;
    a.r_ee[2 * b + 1] = y1 + p.arm.l2 * s12;
    a.r_elbow[2 * b] = x1;
    a.r_elbow[2 * b + 1] = y1;
    a.r_ref[2 * b] = rx;
    a.r_ref[2 * b + 1] = ry;
    a.r_wp[b] = wp;
    a.r_done[b] = done;
  }
  if (!carry) return;
  float* x0 = h.x0 + 4 * b;
  float* win = h.window + (size_t)b * p.W * 4;
  if (staged) {
    head_body(p, hl.stage(sm, lane), lane, q1, q2, dq1, dq2, c1, s1, c12,
              s12, wp, x0, h.wp_out + b, h.path_end + b, win);
  } else {
    head_body(p, path, lane, q1, q2, dq1, dq2, c1, s1, c12, s12, wp, x0,
              h.wp_out + b, h.path_end + b, win);
  }
}

// Named barrier `id` of the `threads` threads of a scenario's statistics
// warps: every warp waits (sync) or only signals its stores (arrive).
__device__ __forceinline__ void stats_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(threads) : "memory");
}
__device__ __forceinline__ void stats_arrive(int id, int threads) {
  asm volatile("bar.arrive %0, %1;" ::"r"(id), "r"(threads) : "memory");
}

// Statistics warp `sw` of the `ns` of scenario b, L logical lanes a lane,
// CAP samples a logical lane in registers (0: each pass reads S again).
// `n` logical lanes, `red` the scenario's kRedFloats exchange slots, `bar`
// its named barrier.  A slot past K takes part as the identity of each sum
// (0; +inf for the min), so no sample's work sits behind a branch: a
// logical lane's sums start at +0 and never become -0, so adding +0
// leaves them as they are, as skipping the slot would.
template <int L, int CAP>
__device__ __forceinline__ void tail_stats(const StepParams& p,
                                           const TailArgs& a, int b, int sw,
                                           int ns, int n, int lane,
                                           float* red, int bar) {
  constexpr int R = CAP > 0 ? CAP : 1;
  const int K = p.K;
  const int nw = n >> 5;                 // logical warps
  const float* s = a.s + (size_t)b * K;
  int t[L];                              // each set's logical lane
#pragma unroll
  for (int j = 0; j < L; ++j) t[j] = ((sw * L + j) << 5) + lane;
  // S, read once: logical lane t[j]'s samples t[j] + i n, i < CAP
  float v[L][R];
  bool ok[L][R];
#pragma unroll
  for (int j = 0; j < L; ++j) {
#pragma unroll
    for (int i = 0; i < R; ++i) {
      const int k = t[j] + i * n;
      ok[j][i] = CAP > 0 && k < K;
      v[j][i] = ok[j][i] ? s[k] : 0.0f;
    }
  }
  // round 1: (min, sum), a logical lane's samples in order
  float mn[L], sm[L];
#pragma unroll
  for (int j = 0; j < L; ++j) {
    mn[j] = INFINITY;
    sm[j] = 0.0f;
    if constexpr (CAP > 0) {
#pragma unroll
      for (int i = 0; i < R; ++i) {
        mn[j] = nan_min(mn[j], ok[j][i] ? v[j][i] : INFINITY);
        sm[j] += v[j][i];
      }
    } else {
      for (int k = t[j]; k < K; k += n) {
        mn[j] = nan_min(mn[j], s[k]);
        sm[j] += s[k];
      }
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    float om[L], os[L];
#pragma unroll
    for (int j = 0; j < L; ++j) {
      om[j] = __shfl_xor_sync(kFullMask, mn[j], o);
      os[j] = __shfl_xor_sync(kFullMask, sm[j], o);
    }
#pragma unroll
    for (int j = 0; j < L; ++j) {
      mn[j] = nan_min(mn[j], om[j]);
      sm[j] += os[j];
    }
  }
#pragma unroll
  for (int j = 0; j < L; ++j) {          // lane 0's (a NaN's bits may vary)
    mn[j] = __shfl_sync(kFullMask, mn[j], 0);
  }
  float rho, total = 0.0f;
  if (ns == 1) {
    rho = mn[0];
#pragma unroll
    for (int j = 0; j < L; ++j) {
      if (j > 0) rho = j < nw ? nan_min(rho, mn[j]) : rho;
      total = j < nw ? total + sm[j] : total;
    }
  } else {
    float2* r1 = reinterpret_cast<float2*>(red);
    if (lane == 0) {
#pragma unroll
      for (int j = 0; j < L; ++j) {
        const int w = sw * L + j;
        if (w < nw) r1[w] = make_float2(mn[j], sm[j]);
      }
    }
    if (sw == 0 && lane >= nw) {         // the rounds' identities past nw
      r1[lane] = make_float2(INFINITY, 0.0f);
      red[64 + lane] = 0.0f;
      reinterpret_cast<float2*>(red + 96)[lane] = make_float2(0.0f, 0.0f);
    }
    stats_sync(bar, ns * 32);
    // all 32 slots in flight at once; nan_min over the warps in order is
    // the first NaN among them, if any, else the fminf chain
    float g[64];
#pragma unroll
    for (int w = 0; w < 16; ++w) {
      const float4 f = reinterpret_cast<const float4*>(red)[w];
      g[4 * w] = f.x;
      g[4 * w + 1] = f.y;
      g[4 * w + 2] = f.z;
      g[4 * w + 3] = f.w;
    }
    // past nw the slots hold (+inf, 0), which change neither chain
    float m = g[0];
    total += g[1];
#pragma unroll
    for (int w = 1; w < 32; ++w) {
      m = fminf(m, g[2 * w]);
      total += g[2 * w + 1];
    }
    float first = INFINITY;                    // the first NaN, if any
#pragma unroll
    for (int w = 31; w >= 0; --w) {
      first = g[2 * w] != g[2 * w] ? g[2 * w] : first;
    }
    rho = first != first ? first : m;
  }
  // round 2: eta, each weight's exp once (kept in v; +0 past K)
  float et[L];
#pragma unroll
  for (int j = 0; j < L; ++j) {
    et[j] = 0.0f;
    if constexpr (CAP > 0) {
#pragma unroll
      for (int i = 0; i < R; ++i) {
        const float e = expf(-(v[j][i] - rho) * p.inv_lam);
        v[j][i] = ok[j][i] ? e : 0.0f;
        et[j] += v[j][i];
      }
    } else {
      for (int k = t[j]; k < K; k += n) {
        et[j] += expf(-(s[k] - rho) * p.inv_lam);
      }
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    float oe[L];
#pragma unroll
    for (int j = 0; j < L; ++j) oe[j] = __shfl_xor_sync(kFullMask, et[j], o);
#pragma unroll
    for (int j = 0; j < L; ++j) et[j] += oe[j];
  }
  float eta = 0.0f;
  if (ns == 1) {
#pragma unroll
    for (int j = 0; j < L; ++j) eta = j < nw ? eta + et[j] : eta;
  } else {
    float* r2 = red + 64;
    if (lane == 0) {
#pragma unroll
      for (int j = 0; j < L; ++j) {
        const int w = sw * L + j;
        if (w < nw) r2[w] = et[j];
      }
    }
    stats_sync(bar, ns * 32);
    float g[32];
#pragma unroll
    for (int w = 0; w < 8; ++w) {
      const float4 f = reinterpret_cast<const float4*>(r2)[w];
      g[4 * w] = f.x;
      g[4 * w + 1] = f.y;
      g[4 * w + 2] = f.z;
      g[4 * w + 3] = f.w;
    }
#pragma unroll
    for (int w = 0; w < 32; ++w) eta += g[w];   // +0 past nw
  }
  // round 3: (Sum w^2, Sum w log w) from the kept weights (w = 0 past K)
  float w2[L], wl[L];
#pragma unroll
  for (int j = 0; j < L; ++j) {
    w2[j] = 0.0f;
    wl[j] = 0.0f;
    if constexpr (CAP > 0) {
#pragma unroll
      for (int i = 0; i < R; ++i) {
        // 0 / eta is +0: no division (its zero dividend takes the slow
        // path of an exact one), as for most weights of a sharp softmax
        float w = 0.0f;
        if (v[j][i] != 0.0f) w = v[j][i] / eta;
        const float lw = w * logf(fmaxf(w, 1e-38f));
        w2[j] += ok[j][i] ? w * w : 0.0f;
        wl[j] += ok[j][i] && w > 0.0f ? lw : 0.0f;
      }
    } else {
      for (int k = t[j]; k < K; k += n) {
        const float w = expf(-(s[k] - rho) * p.inv_lam) / eta;
        w2[j] += w * w;
        wl[j] += w > 0.0f ? w * logf(fmaxf(w, 1e-38f)) : 0.0f;
      }
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    float o2[L], ol[L];
#pragma unroll
    for (int j = 0; j < L; ++j) {
      o2[j] = __shfl_xor_sync(kFullMask, w2[j], o);
      ol[j] = __shfl_xor_sync(kFullMask, wl[j], o);
    }
#pragma unroll
    for (int j = 0; j < L; ++j) {
      w2[j] += o2[j];
      wl[j] += ol[j];
    }
  }
  float sw2 = 0.0f, swl = 0.0f;
  if (ns == 1) {
#pragma unroll
    for (int j = 0; j < L; ++j) {
      sw2 = j < nw ? sw2 + w2[j] : sw2;
      swl = j < nw ? swl + wl[j] : swl;
    }
  } else {
    float2* r3 = reinterpret_cast<float2*>(red + 96);
    if (lane == 0) {
#pragma unroll
      for (int j = 0; j < L; ++j) {
        const int w = sw * L + j;
        if (w < nw) r3[w] = make_float2(w2[j], wl[j]);
      }
    }
    if (sw != 0) {                       // the first warp writes the row
      stats_arrive(bar, ns * 32);
      return;
    }
    stats_sync(bar, ns * 32);
    float g[64];
#pragma unroll
    for (int w = 0; w < 16; ++w) {
      const float4 f = reinterpret_cast<const float4*>(r3)[w];
      g[4 * w] = f.x;
      g[4 * w + 1] = f.y;
      g[4 * w + 2] = f.z;
      g[4 * w + 3] = f.w;
    }
#pragma unroll
    for (int w = 0; w < 32; ++w) {             // +0 past nw
      sw2 += g[2 * w];
      swl += g[2 * w + 1];
    }
  }
  if (lane == 0) {
    const bool done = a.done[b] || a.path_end[b];
    a.r_cmin[b] = done ? 0.0f : rho;
    a.r_cmean[b] = done ? 0.0f : total * p.inv_k;
    a.r_ess[b] = done ? 0.0f : 1.0f / sw2;
    a.r_ent[b] = done ? 0.0f : -swl;
  }
}

// The block threads a build of step_tail_kernel takes at most, which set
// the registers a thread may hold: with several statistics warps a
// scenario (a short batch; its latency counts) or S read each pass (K >
// 1024) 576, so 112 registers keep a warp's loads in flight and its sets
// in registers; with one of a sample a logical lane (a fleet: throughput,
// which wants many scenarios on an SM) 1024, so 64.  The library holds
// two (L, CAP): (4, 1) up to K = 1024 and (2, 0) at any K.
__host__ __device__ constexpr int tail_bound(bool wide) {
  return wide ? 576 : 1024;
}

// `group` scenarios a block, each a run of ns + 1 warps: ns statistics
// warps, then the control warp.  `h` holds the carried head's outputs, or
// its x0 is null.
template <int L, int CAP, bool WIDE>
__global__ void __launch_bounds__(tail_bound(WIDE))
step_tail_kernel(const StepParams p, const TailArgs a, const HeadArgs h,
                 int B, int n, int ns) {
  extern __shared__ float red[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int per = ns + 1;
  const int g = warp / per, role = warp - g * per;
  const int b = blockIdx.x * (blockDim.x / (32 * per)) + g;
  if (b >= B) return;                    // the scenario's warps alike
  float* mine = red + g * (kRedFloats + 4 * kStagedRows);
  if (role == ns) {
    tail_control(p, a, h, h.x0 != nullptr, b, lane, mine + kRedFloats);
  } else if (a.r_q != nullptr) {
    tail_stats<L, CAP>(p, a, b, role, ns, n, lane, mine, 1 + g);
  }
}

template <int L, int CAP, bool WIDE>
static int launch_tail(const StepParams& p, const TailArgs& a,
                       const HeadArgs& h, int B, int n, int ns, int group,
                       cudaStream_t stream) {
  const size_t smem =
      group * (kRedFloats + 4 * kStagedRows) * sizeof(float);
  step_tail_kernel<L, CAP, WIDE><<<(B + group - 1) / group,
                                   group * (ns + 1) * 32, smem, stream>>>(
      p, a, h, B, n, ns);
  return (int)cudaGetLastError();
}

// The build of (L, CAP) for ns statistics warps: narrow with one and CAP
// 1, wide otherwise.
template <int L, int CAP>
static int launch_tail(const StepParams& p, const TailArgs& a,
                       const HeadArgs& h, int B, int n, int group,
                       cudaStream_t stream) {
  const int ns = (n / 32 + L - 1) / L;
  const bool narrow = CAP == 1 && ns == 1;
  if (group * (ns + 1) * 32 > tail_bound(!narrow) ||
      (ns > 1 && group > kMaxBarrierGroup) ||
      (CAP > 0 && (p.K + n - 1) / n > CAP)) {
    return (int)cudaErrorInvalidValue;
  }
  if constexpr (CAP == 1) {
    if (narrow) {
      return launch_tail<L, CAP, false>(p, a, h, B, n, ns, group, stream);
    }
  }
  return launch_tail<L, CAP, true>(p, a, h, B, n, ns, group, stream);
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

// The tail of B scenarios on `stream`, carrying the next step's head when
// `head` is not null, in the layout ops/cuda_step.py::step_tail_layout
// gives: `n` logical lanes (step_tail_threads(K): a multiple of 32, at most
// 1024), `lanes` of them a physical lane, `cap` samples a logical lane in
// registers (0: S read again each pass), `group` scenarios a block.
// Returns the cudaError_t of the launch, cudaErrorInvalidValue for a
// layout the kernel is not built for or arguments it does not take.
int mppi_step_tail_launch(const StepParams* params, const TailArgs* args,
                          const HeadArgs* head, int B, int n, int lanes,
                          int cap, int group, void* stream) {
  const StepParams p = *params;
  if (B < 1 || p.K < 1 || p.T < 1 || p.n_ref < 1 || n < 32 ||
      n > kMaxLanes || n % 32 != 0 || group < 1 ||
      (head != nullptr && (head->x0 == nullptr || p.W < 1))) {
    return (int)cudaErrorInvalidValue;
  }
  HeadArgs h = {};
  if (head != nullptr) h = *head;
  const cudaStream_t st = (cudaStream_t)stream;
  if (lanes == 4 && cap == 1) {
    return launch_tail<4, 1>(p, *args, h, B, n, group, st);
  }
  if (lanes == 2 && cap == 0) {
    return launch_tail<2, 0>(p, *args, h, B, n, group, st);
  }
  return (int)cudaErrorInvalidValue;
}

// sizeof of the structs, held against the ctypes mirrors when the library
// loads.
int mppi_step_params_size() { return (int)sizeof(StepParams); }
int mppi_step_head_args_size() { return (int)sizeof(HeadArgs); }
int mppi_step_tail_args_size() { return (int)sizeof(TailArgs); }

}  // extern "C"
