// The per-step loop's step body around the solve kernel: a chunk of the
// loop is one head launch, then two launches a step, solve_kernel.cu and
// the tail, which also runs the next step's head; above K = 1024, where
// the solve leaves SMs free, the tail's statistics run as a third launch
// a step on a branch of the chunk's graph, beside the next solve.
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
//   `group` scenarios a block, or a scenario a cluster of CTAs of `ns`
//   statistics warps each, the control warp on the first.  The control
//   warp: the freeze flag done | path_end, the shifted warm start (kept
//   where done), the plant (dynamics_step at sim.dt, with the
//   disturbance), the kept q, dq, index and the step counter, the record
//   row's scalar lanes in place at its row of the record buffers (q, dq,
//   u0, the elbow and end effector by fk_full, the reference row
//   ref[min(clock + 1, N - 1)], the index, done), and, given the next
//   head's outputs, head_body on the new state, still in registers: the
//   head of step i + 1 at the end of step i.  The
//   statistics warps: min S, mean S, the ESS and the entropy of the softmax
//   weights of S, zeroed where done, written by the statistics' first warp.
//   The two parts share nothing but their inputs, so neither waits for the
//   other, and each can run alone: the control warp without statistics
//   warps (the control tail), and the statistics in step_stats_kernel, the
//   same code in the same layouts with the control warp idle, reading the
//   freeze flag from the record row's done lane that the control tail
//   wrote (ops/cuda_step.py::stats_branch says where the loop splits
//   them).  `clock` is the run's step counter (step0 + the steps taken,
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
// warps' sums meet in shared memory (one named barrier a round), in the
// shared memory of a cluster's CTAs (one cluster barrier a round) or, on
// one statistics warp, in registers.  The weights follow torch on the
// card: e = exp(-(S - min S) * fl(1/lam)) (torch divides by a scalar as a
// multiply by its reciprocal), w = e / Sum e, ESS = 1 / Sum w^2, entropy
// = -Sum w log w over w > 0, mean = Sum S * fl(1/K).
//
// What bounds them.  Both are tiny: bytes, and at B=1 latency.  The head
// reads 2W rows of 16 bytes a scenario and writes W; the tail reads S (4K
// bytes) and the controls (16T) and writes a few dozen words a scenario.
// So the tail reads S once, computes each weight's exp once, and needs
// three exchange rounds, which the dependencies force (rho before e, eta
// before w); each round's fold of the logical warps' sums loads all 32
// slots at once (those past the scenario's warps hold the sum's identity)
// and runs one chain.  Up to K = 1024 a logical lane holds one sample in
// registers, four logical lanes a lane, in one block.  Above it (n = 1024
// logical lanes) one block on one SM walks K / 1024 samples a logical
// lane three times, so from 16 samples a logical lane, for as many waves
// of clusters as a logical lane has 16 samples (a wave: the card's slots,
// mppi_step_tail_cluster_slots, 15 on the H100), a scenario runs on a
// thread-block cluster of 8 CTAs, CTA r holding logical warps 4r .. 4r +
// 3, one logical lane a lane, and their up to 64 samples a logical lane
// in its shared memory (K <= 65536): its 16 statistics warps load, exp,
// divide and log them, 16 samples a thread, and the 4 owner warps sum
// them in order (one warp a scheduler holding its 64 samples in registers
// waited on each sample's latency, in code too long for the instruction
// cache).  The control warp runs on CTA 0; each round every CTA writes
// its logical warps' sums into its own shared memory and reads all 32
// from the CTAs that hold them after a cluster barrier, and one more
// barrier keeps every CTA until the last round's reads are done.
// Otherwise (fewer samples, a large fleet, K > 65536) each pass reads S
// again, two logical lanes a lane in one block.  On the H100 a wave of
// clusters takes 10-14 us, one block a scenario 6.6 at K = 4096, 15-17 at
// 16384 and 72-80 at 65536; PERF.md has the sweep, the clustered tail's
// phases and the layouts tried.  The plant, a chain of dependent scalar
// operations, runs on its own warp beside them, its loads (the path rows
// of the head it carries among them) all in flight before it.  The head,
// whose inputs are the tail's outputs, costs no launch of its own but one
// a chunk.  No work sits behind a per-sample branch but an exact division
// with a nonzero dividend.  At B=1 the statistics' three rounds are the
// critical path; on a fleet, issue and the SMs' occupancy (PERF.md).

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "mppi_device.cuh"

namespace cg = cooperative_groups;

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
static const int kMaxCluster = 8;        // the portable cluster size limit
static const int kClusterThreads = 544;  // a CTA of the clustered build:
static const int kClusterStats = 512;    // its statistics threads
static const int kMaxDevices = 64;       // cluster slots asked once each

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

// The cluster's barrier, split: arrive releases the thread's stores, wait
// returns once every thread of the cluster has arrived and acquires
// theirs, in every CTA's shared memory.
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive;" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait;" ::: "memory");
}
__device__ __forceinline__ void cluster_sync() {
  cluster_arrive();
  cluster_wait();
}

// An exchange round's barrier: the scenario's statistics warps' named
// barrier, or on a cluster (CL) the cluster's.
template <bool CL>
__device__ __forceinline__ void stats_round(int bar, int threads) {
  if constexpr (CL) {
    cluster_sync();
  } else {
    stats_sync(bar, threads);
  }
}

// Float4 q of an exchange round's slots `r`, `f` floats a logical warp, as
// the CTA that wrote them holds it: this block, or on a cluster (CL) the
// CTA of those logical warps, `per` of them a CTA (a multiple of 4 / f,
// so a float4 lies in one CTA).
template <bool CL>
__device__ __forceinline__ float4 slots4(float* r, int q, int f, int per) {
  if constexpr (CL) r = cg::this_cluster().map_shared_rank(r, 4 * q / f / per);
  return reinterpret_cast<const float4*>(r)[q];
}

// A CTA's samples kept in shared memory (the clustered build): slot i of
// its logical lane lo (lo < lanes, the CTA's logical lanes from `first`)
// at at[i * lanes + lo], and a second value a sample at at2; the CTA's
// `threads` statistics threads (this one `g`, a multiple of `lanes`)
// share the per-sample work and meet at named barrier `bar` before the
// logical lanes' own threads sum the kept values in order.
struct Kept {
  float* at;
  float* at2;
  int first, lanes, g, threads, bar;
};

// Statistics warp `sw` of scenario b, `ns` of them a block, L logical
// lanes a lane, CAP samples a logical lane kept on chip (0: each pass
// reads S again; 1: in registers; more, L = 1 only: in shared memory,
// `kept`, where every statistics thread of the CTA loads, exps, divides
// and logs 1 / (threads / lanes) of the samples, so four warps a
// scheduler hide the latency one warp's unrolled 64 samples could not,
// and the sums stay with their logical lanes).  `n` logical lanes, `red`
// the block's kRedFloats exchange slots of the scenario, `bar` its named
// barrier; on a cluster (CL) `sw` counts the statistics warps of the CTAs
// before this one too (a warp that owns no logical warp has sw >= n /
// 32), each CTA writes its logical warps' slots in its own `red` and the
// rounds meet at the cluster's barrier.  A slot past K takes part as the
// identity of each sum (0; +inf for the min), so no sample's work sits
// behind a branch: a logical lane's sums start at +0 and never become -0,
// so adding +0 leaves them as they are, as skipping the slot would (the
// kept slots past K in every logical lane are skipped).
template <int L, int CAP, bool CL>
__device__ __forceinline__ void tail_stats(const StepParams& p,
                                           const TailArgs& a, int b, int sw,
                                           int ns, int n, int lane,
                                           float* red, int bar,
                                           const Kept& kept = Kept{}) {
  static_assert(CAP <= 1 || L == 1, "samples kept in shared memory: L = 1");
  constexpr bool KEPT = CAP > 1;
  constexpr int R = 1;                   // CAP 1: a sample in registers
  constexpr int M = 16;                  // kept samples a thread at most
  const int K = p.K;
  const int nw = n >> 5;                 // logical warps
  const int per = ns * L;                // logical warps a CTA (CL)
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
      ok[j][i] = CAP == 1 && k < K;
      v[j][i] = ok[j][i] ? s[k] : 0.0f;
    }
  }
  // kept: this thread's share, slots r0 + m * dr of the CTA's logical lane
  // lo, sample k0 + i n; `mine` those of a logical lane this warp owns
  const int used = KEPT ? (K + n - 1) / n : 0;   // kept slots below K
  const int lo = KEPT ? kept.g % kept.lanes : 0;
  const int r0 = KEPT ? kept.g / kept.lanes : 0;
  const int dr = KEPT ? kept.threads / kept.lanes : 1;
  const int k0 = kept.first + lo, ld = kept.lanes;
  float* const col = kept.at + lo;       // slot i at col[i * ld]
  float* const col2 = kept.at2 + lo;
  const bool mine = t[0] < n;
  if constexpr (KEPT) {                  // all loads in flight, then kept
    float x[M];
#pragma unroll
    for (int m = 0; m < M; ++m) {
      const int i = r0 + m * dr, k = k0 + i * n;
      x[m] = i < used && k < K ? s[k] : 0.0f;
    }
#pragma unroll
    for (int m = 0; m < M; ++m) {
      const int i = r0 + m * dr;
      if (i < used) col[i * ld] = x[m];
    }
    stats_sync(kept.bar, kept.threads);
  }
  // round 1: (min, sum), a logical lane's samples in order
  float mn[L], sm[L];
#pragma unroll
  for (int j = 0; j < L; ++j) {
    mn[j] = INFINITY;
    sm[j] = 0.0f;
    if constexpr (KEPT) {
      if (mine) {
#pragma unroll 8
        for (int i = 0; i < used; ++i) {
          const float x = col[i * ld];
          mn[j] = nan_min(mn[j], t[j] + i * n < K ? x : INFINITY);
          sm[j] += x;
        }
      }
    } else if constexpr (CAP > 0) {
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
  if (!CL && ns == 1) {
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
    stats_round<CL>(bar, ns * 32);
    // all 32 slots in flight at once; nan_min over the warps in order is
    // the first NaN among them, if any, else the fminf chain
    float g[64];
#pragma unroll
    for (int w = 0; w < 16; ++w) {
      const float4 f = slots4<CL>(red, w, 2, per);
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
    if constexpr (KEPT) {
      float x[M];
#pragma unroll
      for (int m = 0; m < M; ++m) {
        const int i = r0 + m * dr;
        x[m] = i < used ? col[i * ld] : 0.0f;
      }
#pragma unroll
      for (int m = 0; m < M; ++m) {
        const int i = r0 + m * dr;
        const float e = expf(-(x[m] - rho) * p.inv_lam);
        if (i < used) col[i * ld] = k0 + i * n < K ? e : 0.0f;
      }
      stats_sync(kept.bar, kept.threads);
      if (mine) {
#pragma unroll 8
        for (int i = 0; i < used; ++i) et[j] += col[i * ld];
      }
    } else if constexpr (CAP > 0) {
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
  if (!CL && ns == 1) {
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
    stats_round<CL>(bar, ns * 32);
    float g[32];
#pragma unroll
    for (int w = 0; w < 8; ++w) {
      const float4 f = slots4<CL>(r2, w, 1, per);
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
    if constexpr (KEPT) {                // the terms as below, then summed
      float x[M];
#pragma unroll
      for (int m = 0; m < M; ++m) {
        const int i = r0 + m * dr;
        x[m] = i < used ? col[i * ld] : 0.0f;
      }
#pragma unroll
      for (int m = 0; m < M; ++m) {
        const int i = r0 + m * dr;
        const bool ok1 = k0 + i * n < K;
        float w = 0.0f;
        if (x[m] != 0.0f) w = x[m] / eta;
        const float lw = w * logf(fmaxf(w, 1e-38f));
        if (i < used) {
          col[i * ld] = ok1 ? w * w : 0.0f;
          col2[i * ld] = ok1 && w > 0.0f ? lw : 0.0f;
        }
      }
      stats_sync(kept.bar, kept.threads);
      if (mine) {
#pragma unroll 8
        for (int i = 0; i < used; ++i) {
          w2[j] += col[i * ld];
          wl[j] += col2[i * ld];
        }
      }
    } else if constexpr (CAP > 0) {
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
  if (!CL && ns == 1) {
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
    if constexpr (CL) {                  // the first warp writes the row
      cluster_sync();
      if (sw != 0) return;
    } else {
      if (sw != 0) {
        stats_arrive(bar, ns * 32);
        return;
      }
      stats_sync(bar, ns * 32);
    }
    float g[64];
#pragma unroll
    for (int w = 0; w < 16; ++w) {
      const float4 f = slots4<CL>(red + 96, w, 2, per);
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
// which wants many scenarios on an SM) 1024, so 64; on a cluster
// kClusterThreads.  The library holds three (L, CAP): (4, 1) up to K =
// 1024, (2, 0) at any K, and (1, 64) on a cluster up to K = 65536, its
// samples in shared memory.
__host__ __device__ constexpr int tail_bound(bool wide) {
  return wide ? 576 : 1024;
}

// The body of both S2 kernels.  `group` scenarios a block, each a run of
// ns + 1 warps: ns statistics warps, then the control warp, which runs
// tail_control where `control` (step_tail_kernel) and nothing where not
// (step_stats_kernel).  `h` holds the carried head's outputs, or its x0
// is null.  On a cluster (CL) a scenario takes the cluster's CTAs, one
// group each, kClusterStats statistics threads (ns warps owning logical
// warps, the rest sharing their per-sample work) and the control warp,
// CTA 0's running the control and the others' doing nothing but the
// cluster's barriers, which every thread takes alike: the control warp
// arrives at round 1's before its work.
template <int L, int CAP, bool CL>
__device__ __forceinline__ void tail_block(const StepParams& p,
                                           const TailArgs& a,
                                           const HeadArgs& h, int B, int n,
                                           int ns, bool control) {
  extern __shared__ float red[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if constexpr (CL) {
    const cg::cluster_group cluster = cg::this_cluster();
    const int rank = (int)cluster.block_rank();
    const int b = blockIdx.x / (int)cluster.num_blocks();
    const bool stats = a.r_q != nullptr;
    if (warp == kClusterStats / 32) {
      if (stats) cluster_arrive();
      if (control && rank == 0) {
        tail_control(p, a, h, h.x0 != nullptr, b, lane, red + kRedFloats);
      }
      if (stats) {                       // rounds 1 to 3
        cluster_wait();
        cluster_sync();
        cluster_sync();
      }
    } else if (stats) {                  // warps past ns share the work
      float* at = red + kRedFloats + 4 * kStagedRows;
      const int lanes = ns * L * 32;
      tail_stats<L, CAP, true>(
          p, a, b, warp < ns ? rank * ns + warp : n / 32, ns, n, lane, red,
          0, Kept{at, at + CAP * lanes, rank * lanes, lanes, (int)threadIdx.x,
                  kClusterStats, 1});
    }
    // no CTA leaves while another may read its shared memory
    if (stats) cluster_sync();
  } else {
    const int per = ns + 1;
    const int g = warp / per, role = warp - g * per;
    const int b = blockIdx.x * (blockDim.x / (32 * per)) + g;
    if (b >= B) return;                  // the scenario's warps alike
    float* mine = red + g * (kRedFloats + 4 * kStagedRows);
    if (role == ns) {
      if (control) {
        tail_control(p, a, h, h.x0 != nullptr, b, lane, mine + kRedFloats);
      }
    } else if (a.r_q != nullptr) {
      tail_stats<L, CAP, false>(p, a, b, role, ns, n, lane, mine, 1 + g);
    }
  }
}

// The whole tail (ns > 0: the control warp and the statistics) or, with
// ns = 0, the control warp alone: the tail whose statistics run beside
// it in step_stats_kernel.
template <int L, int CAP, bool WIDE, bool CL>
__global__ void __launch_bounds__(CL ? kClusterThreads : tail_bound(WIDE))
step_tail_kernel(const StepParams p, const TailArgs a, const HeadArgs h,
                 int B, int n, int ns) {
  tail_block<L, CAP, CL>(p, a, h, B, n, ns, true);
}

// The tail's statistics alone, in the tail's layout (its control warp
// idle): min S, mean S, ESS and entropy into the record row, zeroed
// where the row's done lane, which the control tail wrote, is set.
template <int L, int CAP, bool WIDE, bool CL>
__global__ void __launch_bounds__(CL ? kClusterThreads : tail_bound(WIDE))
step_stats_kernel(const StepParams p, const TailArgs a, int B, int n,
                  int ns) {
  tail_block<L, CAP, CL>(p, a, HeadArgs{}, B, n, ns, false);
}

// What a launch of mppi_step_tail_launch runs of the tail: all of it
// (step_tail_kernel), its control warp alone (step_tail_kernel with no
// statistics warps), or its statistics alone (step_stats_kernel).
enum TailPart { kWhole = 0, kControl = 1, kStats = 2 };

template <int L, int CAP, bool WIDE>
static int launch_tail(const StepParams& p, const TailArgs& a,
                       const HeadArgs& h, int B, int n, int ns, int group,
                       bool stats_only, cudaStream_t stream) {
  const size_t smem =
      group * (kRedFloats + 4 * kStagedRows) * sizeof(float);
  const dim3 grid((B + group - 1) / group), block(group * (ns + 1) * 32);
  if (stats_only) {
    step_stats_kernel<L, CAP, WIDE, false><<<grid, block, smem, stream>>>(
        p, a, B, n, ns);
  } else {
    step_tail_kernel<L, CAP, WIDE, false><<<grid, block, smem, stream>>>(
        p, a, h, B, n, ns);
  }
  return (int)cudaGetLastError();
}

// The build of (L, CAP) for ns statistics warps (none for the control
// alone): narrow with one and CAP 1, wide otherwise.
template <int L, int CAP>
static int launch_tail(const StepParams& p, const TailArgs& a,
                       const HeadArgs& h, int B, int n, int group, int part,
                       cudaStream_t stream) {
  const int ns = part == kControl ? 0 : (n / 32 + L - 1) / L;
  const bool narrow = CAP == 1 && ns == 1;
  if (group * (ns + 1) * 32 > tail_bound(!narrow) ||
      (ns > 1 && group > kMaxBarrierGroup) ||
      (CAP > 0 && (p.K + n - 1) / n > CAP)) {
    return (int)cudaErrorInvalidValue;
  }
  const bool stats_only = part == kStats;
  if constexpr (CAP == 1) {
    if (narrow) {
      return launch_tail<L, CAP, false>(p, a, h, B, n, ns, group, stats_only,
                                        stream);
    }
  }
  return launch_tail<L, CAP, true>(p, a, h, B, n, ns, group, stats_only,
                                   stream);
}

// The clustered build, (L, CAP) = (1, 64), on clusters of kMaxCluster
// CTAs: all 32 logical warps (n = kMaxLanes) split evenly over the CTAs,
// kClusterNs of them a CTA beside the warps that share its per-sample
// work (kClusterStats threads in all, 16 samples each at most, so CAP <=
// 16 kClusterStats / (32 kClusterNs)) and the control warp, two floats a
// sample kept in the CTA's shared memory.
static const int kClusterCap = 64;
static const int kClusterNs = kMaxLanes / 32 / kMaxCluster;
static_assert(kClusterCap * 32 * kClusterNs <= 16 * kClusterStats,
              "a statistics thread keeps at most 16 samples");

static void cluster_config(cudaLaunchConfig_t* cfg,
                           cudaLaunchAttribute* attrs, int B,
                           cudaStream_t stream) {
  attrs[0].id = cudaLaunchAttributeClusterDimension;
  attrs[0].val.clusterDim.x = kMaxCluster;
  attrs[0].val.clusterDim.y = 1;
  attrs[0].val.clusterDim.z = 1;
  attrs[1].id = cudaLaunchAttributeClusterSchedulingPolicyPreference;
  attrs[1].val.clusterSchedulingPolicyPreference =
      cudaClusterSchedulingPolicySpread;
  *cfg = {};
  cfg->gridDim = dim3(B * kMaxCluster);
  cfg->blockDim = dim3(kClusterThreads);
  cfg->dynamicSmemBytes = (kRedFloats + 4 * kStagedRows +
                           2 * kClusterCap * kClusterNs * 32) *
                          sizeof(float);
  cfg->stream = stream;
  cfg->attrs = attrs;
  cfg->numAttrs = 2;
}

// How many clusters of the clustered build the current device holds at
// once (cudaOccupancyMaxActiveClusters; 0: it cannot place one), asked
// once a device, with the shared memory limit the build needs raised for
// both of its kernels.
static int cluster_slots(int* slots) {
  static int known[kMaxDevices];         // slots + 1; 0: not asked yet
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (dev < kMaxDevices && known[dev] > 0) {
    *slots = known[dev] - 1;
    return 0;
  }
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attrs[2];
  cluster_config(&cfg, attrs, 1, nullptr);
  auto* kernel = step_tail_kernel<1, kClusterCap, true, true>;
  e = cudaFuncSetAttribute(kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)cfg.dynamicSmemBytes);
  if (e != cudaSuccess) return (int)e;
  auto* stats = step_stats_kernel<1, kClusterCap, true, true>;
  e = cudaFuncSetAttribute(stats, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)cfg.dynamicSmemBytes);
  if (e != cudaSuccess) return (int)e;
  int clusters = 0;
  e = cudaOccupancyMaxActiveClusters(&clusters, (const void*)kernel, &cfg);
  if (e != cudaSuccess) return (int)e;
  if (dev < kMaxDevices) known[dev] = clusters + 1;
  *slots = clusters;
  return 0;
}

// B scenarios of K <= kClusterCap * kMaxLanes samples on the clustered
// build, the whole tail or its statistics alone; cudaErrorInvalidClusterSize
// where the device cannot place a cluster.
static int launch_tail_cluster(const StepParams& p, const TailArgs& a,
                               const HeadArgs& h, int B, int n,
                               bool stats_only, cudaStream_t stream) {
  if (n != kMaxLanes || (p.K + n - 1) / n > kClusterCap) {
    return (int)cudaErrorInvalidValue;
  }
  int slots = 0;
  int e = cluster_slots(&slots);
  if (e != 0) return e;
  if (slots < 1) return (int)cudaErrorInvalidClusterSize;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attrs[2];
  cluster_config(&cfg, attrs, B, stream);
  if (stats_only) {
    e = (int)cudaLaunchKernelEx(
        &cfg, step_stats_kernel<1, kClusterCap, true, true>, p, a, B, n,
        kClusterNs);
  } else {
    e = (int)cudaLaunchKernelEx(
        &cfg, step_tail_kernel<1, kClusterCap, true, true>, p, a, h, B, n,
        kClusterNs);
  }
  if (e != 0) return e;
  return (int)cudaGetLastError();
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
// registers (0: S read again each pass), `group` scenarios a block, and
// `cluster` CTAs a scenario, which the build fixes: kMaxCluster for the
// clustered one (lanes 1, cap kClusterCap, group 1), 1 for the others.
// `part` (TailPart) runs all of the tail, its control alone (in one
// block, no cluster; a record row's statistics lanes left as they are),
// or its statistics alone (no head; the row's done lane, which the
// control wrote, is the freeze flag they read).  Returns the cudaError_t
// of the launch, cudaErrorInvalidValue for a layout the kernel is not
// built for or arguments it does not take.
int mppi_step_tail_launch(const StepParams* params, const TailArgs* args,
                          const HeadArgs* head, int B, int n, int lanes,
                          int cap, int group, int cluster, int part,
                          void* stream) {
  const StepParams p = *params;
  if (B < 1 || p.K < 1 || p.T < 1 || p.n_ref < 1 || n < 32 ||
      n > kMaxLanes || n % 32 != 0 || group < 1 || part < kWhole ||
      part > kStats ||
      (head != nullptr && (head->x0 == nullptr || p.W < 1)) ||
      (part == kStats && (head != nullptr || args->r_done == nullptr))) {
    return (int)cudaErrorInvalidValue;
  }
  HeadArgs h = {};
  if (head != nullptr) h = *head;
  TailArgs a = *args;
  if (part == kStats) a.done = a.path_end = a.r_done;
  const cudaStream_t st = (cudaStream_t)stream;
  const bool clustered = lanes == 1 && cap == kClusterCap;
  if (cluster != (clustered ? kMaxCluster : 1)) {
    return (int)cudaErrorInvalidValue;
  }
  if (clustered) {
    if (group != 1 || part == kControl) return (int)cudaErrorInvalidValue;
    return launch_tail_cluster(p, a, h, B, n, part == kStats, st);
  }
  if (lanes == 4 && cap == 1) {
    return launch_tail<4, 1>(p, a, h, B, n, group, part, st);
  }
  if (lanes == 2 && cap == 0) {
    return launch_tail<2, 0>(p, a, h, B, n, group, part, st);
  }
  return (int)cudaErrorInvalidValue;
}

// How many clusters of the clustered tail (lanes 1, cap kClusterCap,
// cluster kMaxCluster) the current device holds at once, into `slots` (0:
// it cannot place one; ops/cuda_step.py::step_tail_layout then keeps a
// scenario in one block).  Returns the cudaError_t of the query.
int mppi_step_tail_cluster_slots(int* slots) { return cluster_slots(slots); }

// sizeof of the structs, held against the ctypes mirrors when the library
// loads.
int mppi_step_params_size() { return (int)sizeof(StepParams); }
int mppi_step_head_args_size() { return (int)sizeof(HeadArgs); }
int mppi_step_tail_args_size() { return (int)sizeof(TailArgs); }

}  // extern "C"
