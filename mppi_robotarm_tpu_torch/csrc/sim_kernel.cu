// The whole receding-horizon closed loop of B scenarios in one launch.
//
// Replaces: mppi_robotarm_tpu/ops/pallas_sim.py::_sim_kernel (with its scalar
// phases _init_scalar_state, _refresh_window, _wp_advance_scalar and
// _plant_record_scalar).  It ports WHAT that kernel computes, not its
// (8, 128) vreg layout.  Plain PyTorch twin: ops/cuda_sim.py::
// fused_sim_reference; wrapper: ops/cuda_sim.py::fused_sim_run_batched.
//
// Layout.  A scenario runs on a thread-block cluster of C CTAs (grid =
// B * C, C in {1, 2, 4, 8}, chosen by ops/cuda_sim.py::cluster_size).
// Its virtual block has nthr = min(1024, round_up(K, 32)) threads: virtual
// thread g rolls out samples k = g, g + nthr, ... (so K up to 8192 works)
// and virtual warp w = g / 32.  CTA r of the cluster holds virtual threads
// [r * nthr / C, (r + 1) * nthr / C), so every warp partial below is the
// number a single 1024-thread block would form, and every C gives the same
// bits.  Dynamic shared memory of each CTA holds the (W, 4) waypoint window
// as float4 rows, the per-sample costs S[K] (its own samples, overwritten by
// the softmax numerators e[K]), two dim-major control buffers u[c*T + t],
// its own Σwε rows, all 2T Σwε rows and the 5 x 32 warp partials.  Per
// closed-loop step:
//   1. waypoint phase, warp 0 of every CTA: FK of the observed state, lane j
//      on window row j straight from the path, a first-win (d, j) butterfly
//      (NaN never wins), the path-end freeze (Q5/Q6), lane j copying row j
//      of the window at the effective index.  Every CTA computes the same
//      bits, so nothing is broadcast.  A frozen scenario skips phases 2-5,
//      as the JAX kernel's pl.when(any_active) does;
//   2. noise + rollout, one thread per sample: PRNG mode draws Philox4x32-10
//      normals keyed (seed, step0 + step), counter (k, t, 0, 0), scales them
//      by chol(Σ) and writes ε to a per-scenario global scratch laid out
//      [c*T + t][k] (400 KB at K=1024, T=50: it stays in L2), so that the
//      Σwε rows read it coalesced; eps mode reads the caller's
//      (B, n, K, T, 2) noise.  T steps of the arm model with the trig carry
//      (cos/sin of q2 from the carried q1 and q1+q2 pairs), exact sincosf
//      for the FK, the tracking cost against the window (window_cost: two
//      interleaved first-win chains over the rows, the next pass's rows
//      loaded ahead), γ·vᵀΣ⁻¹u, and the terminal cost;
//   3. softmax and stats: each warp's min, then (after a cluster barrier)
//      every warp of every CTA reads all nwarp partials over distributed
//      shared memory and folds them in warp order 0..nwarp-1; the same for
//      Σe, Σe², ΣS and Σe(S-m) after e = exp(-(S-m)/λ).  Every CTA holds the
//      same m, η and stats, with no broadcast;
//   4. Σwε: one virtual warp per row r = c*T + t (2T rows strided over the
//      cluster's warps), lanes striding k over all K, a shuffle reduce,
//      times 1/η.  e[k] of the other CTAs' samples is first gathered once
//      into the CTA's own e[] over distributed shared memory;
//   5. every CTA gathers the 2T rows, takes the scipy-reflect median (single
//      fold, rank fw/2), u += med and the warm-start shift in one pass; the
//      applied control is the shifted first element (Q3);
//   6. plant step at sim.dt plus the disturbance (Q2), by every lane of
//      warp 0 of every CTA on its register copy of the state, and one
//      12-float record row [q1,q2,dq1,dq2,u1,u2,wp,done,cost_min,cost_mean,
//      ess,entropy] written by CTA 0 straight to global memory.
// Three cluster barriers a step (after the min partials, after the sum
// partials, after the Σwε rows) and four block barriers.  No CTA writes a
// shared buffer that another may still read: each remote read of a step
// lies between two of its cluster barriers and the next write of that
// buffer lies after the later one; a last cluster barrier keeps every CTA
// resident until the others are done reading it.
//
// Arithmetic.  Exact float32 throughout: IEEE divide and sqrt, libdevice
// sinf/cosf/expf/logf, no --use_fast_math.  The build passes --fmad=false:
// no a*b+c is contracted into an FMA, so each operation rounds as the
// PyTorch twin's separate elementwise operations do, and only the order of
// the K-sums differs between the two.  The TPU kernel's PRNG-mode levers
// (fast reciprocal, incremental-rotation trig, fast_select, ICDF noise,
// group interleave) are not ported: each is an H100 A/B for later work.
//
// What bounds it.  The closed loop is serial in the step, and each sample's
// rollout is a chain of T dependent arm steps.  In one block of 1024
// threads at B=1 the 32 warps share one SM's four schedulers, so the step
// is issue-bound on 1 of 132 SMs; a cluster of C CTAs gives the warps C
// SMs, until one warp per scheduler is left (C=8 at K=1024) and the
// chain's latency sets the pace: there the window scan is the largest part
// of the chain, the reason for window_cost's layout (PERF.md has the split
// and the A/Bs).  Fleets of K <= 128 scenarios run one warp each in
// fleet_kernel.cu, whose sample_step (sim_common.cuh) is the same sequence
// of float32 operations as the rollout below; this kernel keeps its own
// inline copy, because calling the helper made it 12 % slower at B=1
// (PERF.md).

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "sim_common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kMaxCluster = 8;       // the portable cluster size limit
constexpr int kSlotMin = 0;          // s_red slots of 32 warp partials each
constexpr int kSlotSum = 1;          // Σe, Σe², ΣS, Σe(S-m): slots 1..4
constexpr int kRedFloats = 5 * 32;

// Lane w (< nwarp) of the calling warp reads virtual warp w's partial in
// `slot` from the shared memory of the CTA that holds warp w.
__device__ __forceinline__ float cluster_partial(const cg::cluster_group& cl,
                                                 float* s_red, int slot,
                                                 int lane, int nwarp,
                                                 int wpc) {
  if (lane >= nwarp) return 0.0f;
  const float* src = cl.map_shared_rank(s_red, lane / wpc);
  return src[32 * slot + lane % wpc];
}

// The partials held one per lane, folded in warp order; every lane ends
// with the same bits.
__device__ __forceinline__ float fold_min(float v, int nwarp) {
  float m = __shfl_sync(kFullMask, v, 0);
  for (int w = 1; w < nwarp; ++w) m = fminf(m, __shfl_sync(kFullMask, v, w));
  return m;
}

__device__ __forceinline__ float fold_sum(float v, int nwarp) {
  float s = __shfl_sync(kFullMask, v, 0);
  for (int w = 1; w < nwarp; ++w) s += __shfl_sync(kFullMask, v, w);
  return s;
}

// Shared floats per CTA: S/e (K), window (4W), u and its update (2 x 2T),
// own and gathered Σwε rows (2 x 2T), warp partials.
__host__ __device__ size_t smem_floats(const SimParams& p) {
  return (size_t)p.K + 4 * p.W + 8 * p.T + kRedFloats;
}

// tracking_cost (mppi_device.cuh) on a window of float4 rows, scanned as
// two interleaved first-win chains (even and odd rows) merged with ties to
// the lower row.  Each chain keeps its subset's first strict minimum (NaN
// never wins), so the merge picks the row the serial scan picks, and the
// cost has the same bits with half the dependent compare chain; the next
// pass's two rows are loaded before this pass's compares, so the shared
// loads do not stall the chain.
__device__ __forceinline__ float window_cost(float x, float y, float dq1,
                                             float dq2, const float4* win,
                                             int W, const float* w,
                                             float dist_scale,
                                             float cost_scale) {
  float b0 = INFINITY, b1 = INFINITY;
  int j0 = 0, j1 = 1;
  int j = 0;
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
}

}  // namespace

__global__ void __launch_bounds__(1024)
sim_kernel(const SimParams p,
           const float* __restrict__ state_f,   // (B, 4) q1, q2, dq1, dq2
           const int* __restrict__ state_i,     // (B, 3) wp_idx, seed, step0
           const float* __restrict__ u0,        // (B, T, 2)
           const float* __restrict__ ref,       // (n_ref, 4)
           const float* eps_in,                 // (B, n_steps, K, T, 2) | null
           float* eps_scratch,                  // (B, 2T, K) | null
           float* __restrict__ rec,             // (B, n_steps, 12)
           float* __restrict__ ufin) {          // (B, T, 2)
  extern __shared__ float smem[];
  const cg::cluster_group cluster = cg::this_cluster();
  const int K = p.K, T = p.T, W = p.W;
  float4* s_win = reinterpret_cast<float4*>(smem);   // W rows
  float* s_cost = smem + 4 * W;      // K: S, then e
  float* s_u = s_cost + K;           // 2T, dim-major: the current u
  float* s_un = s_u + 2 * T;         // 2T: the next u (swapped each step)
  float* s_weps = s_un + 2 * T;      // 2T: this CTA's Σwε rows
  float* s_wall = s_weps + 2 * T;    // 2T: all Σwε rows
  float* s_red = s_wall + 2 * T;     // 5 x 32 warp partials

  __shared__ float s_st[4];          // q1, q2, dq1, dq2 of the step
  __shared__ int s_frz;

  const int C = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int b = blockIdx.x / C;
  const int lt = threadIdx.x;
  const int cta = blockDim.x;
  const int nthr = cta * C;          // the virtual block
  const int g = rank * cta + lt;     // virtual thread
  const int lane = lt & 31;
  const int lwarp = lt >> 5;
  const int wpc = cta >> 5;          // warps per CTA
  const int nwarp = nthr >> 5;
  const int vwarp = rank * wpc + lwarp;
  const uint32_t seed = (uint32_t)state_i[3 * b + 1];
  const int step0 = state_i[3 * b + 2];
  const size_t ktw = (size_t)K * T * 2;
  float* eps_own = p.use_prng ? eps_scratch + (size_t)b * ktw : nullptr;

  // warp 0 carries the scenario's scalar state in registers, every lane
  // the same bits
  float pq1 = state_f[4 * b], pq2 = state_f[4 * b + 1];
  float pdq1 = state_f[4 * b + 2], pdq2 = state_f[4 * b + 3];
  int wp = state_i[3 * b];
  bool done = false;
  float stats[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  for (int i = lt; i < 2 * T; i += cta) {
    s_u[(i & 1) * T + (i >> 1)] = u0[(size_t)b * 2 * T + i];
  }

  for (int step = 0; step < p.n_steps; ++step) {
    // ---- 1. waypoint advance and freeze, warp 0, lane j on row j --------
    if (lwarp == 0) {
      const float x = p.l1c * cosf(pq1) + p.l2c * cosf(pq1 + pq2);
      const float y = p.l1c * sinf(pq1) + p.l2c * sinf(pq1 + pq2);
      float best = INFINITY;
      int off = lane;
      for (int j = lane; j < W; j += 32) {
        const int src = min(wp + j, p.n_ref - 1);
        const float dx = x - ref[4 * src];
        const float dy = y - ref[4 * src + 1];
        float d = (dx * dx + dy * dy) * p.dist_scale;
        if (!(wp + j < p.n_ref) || d != d) d = INFINITY;
        if (d < best) {
          best = d;
          off = j;
        }
      }
      warp_argmin(best, off);          // all-inf: lane 0's j = 0 wins the tie
      const int wn = wp + off;
      const bool frz = done || (wn >= p.n_ref - 1);
      if (!frz) wp = wn;               // frozen keeps the old index
      done = frz;
      for (int j = lane; j < W; j += 32) {
        const int src = min(wp + j, p.n_ref - 1);
        s_win[j] = reinterpret_cast<const float4*>(ref)[src];
      }
      // After a frozen step no barrier separates these writes from the
      // other warps' reads of the last step's values; a frozen scenario
      // stays frozen and keeps its state, so they rewrite the same bits.
      if (lane == 0) {
        s_st[0] = pq1;
        s_st[1] = pq2;
        s_st[2] = pdq1;
        s_st[3] = pdq2;
        s_frz = frz;
      }
    }
    __syncthreads();
    const bool frz = s_frz;

    if (!frz) {
      // ---- 2. noise + rollout + cost, one thread per sample --------------
      const float* eps_step =
          p.use_prng ? eps_own
                     : eps_in + ((size_t)b * p.n_steps + step) * ktw;
      const float q1_0 = s_st[0], q2_0 = s_st[1];
      const float dq1_0 = s_st[2], dq2_0 = s_st[3];
      const float c1_0 = cosf(q1_0), s1_0 = sinf(q1_0);
      const float c12_0 = cosf(q1_0 + q2_0), s12_0 = sinf(q1_0 + q2_0);
      const uint32_t key1 = (uint32_t)(step0 + step);
      for (int k = g; k < K; k += nthr) {
        float q1 = q1_0, q2 = q2_0, dq1 = dq1_0, dq2 = dq2_0, s = 0.0f;
        float c1 = c1_0, s1 = s1_0, c12 = c12_0, s12 = s12_0;
        const bool exploit = (float)k < p.exploit_thresh;
        for (int t = 0; t < T; ++t) {
          float e1, e2;
          if (p.use_prng) {
            uint32_t c[4] = {(uint32_t)k, (uint32_t)t, 0u, 0u};
            philox4x32_10(c, seed, key1);
            float z1, z2;
            box_muller(uniform_from_bits(c[0]), uniform_from_bits(c[1]), z1,
                       z2);
            e1 = p.l11 * z1;
            e2 = p.l21 * z1 + p.l22 * z2;
            eps_own[(size_t)t * K + k] = e1;
            eps_own[(size_t)(T + t) * K + k] = e2;
          } else {
            const size_t e_off = ((size_t)k * T + t) * 2;
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
          s = s + window_cost(x, y, dq1, dq2, s_win, W, p.stage_w,
                              p.dist_scale, p.cost_scale);
          const float su1 = p.sinv[0] * u1r + p.sinv[1] * u2r;
          const float su2 = p.sinv[2] * u1r + p.sinv[3] * u2r;
          s = s + p.gamma * (v1 * su1 + v2 * su2);
        }
        const float xT = p.l1c * c1 + p.l2c * c12;
        const float yT = p.l1c * s1 + p.l2c * s12;
        s = s + window_cost(xT, yT, dq1, dq2, s_win, W, p.term_w,
                            p.dist_scale, p.cost_scale);
        s_cost[k] = s;
      }

      // ---- 3. softmax and stats, partials folded in warp order ----------
      float m = INFINITY;
      for (int k = g; k < K; k += nthr) m = fminf(m, s_cost[k]);
      m = warp_min(m);
      if (lane == 0) s_red[32 * kSlotMin + lwarp] = m;
      cluster.sync();
      m = fold_min(cluster_partial(cluster, s_red, kSlotMin, lane, nwarp, wpc),
                   nwarp);

      float se = 0.0f, see = 0.0f, ss = 0.0f, sesm = 0.0f;
      for (int k = g; k < K; k += nthr) {
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
        s_red[32 * kSlotSum + lwarp] = se;
        s_red[32 * (kSlotSum + 1) + lwarp] = see;
        s_red[32 * (kSlotSum + 2) + lwarp] = ss;
        s_red[32 * (kSlotSum + 3) + lwarp] = sesm;
      }
      cluster.sync();   // also publishes e[] and the PRNG-mode ε scratch
      float sums[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        sums[i] = fold_sum(cluster_partial(cluster, s_red, kSlotSum + i, lane,
                                           nwarp, wpc),
                           nwarp);
      }
      const float eta = sums[0], sum_ee = sums[1];
      const float sum_s = sums[2], sum_esm = sums[3];
      const float inv_eta = 1.0f / eta;
      if (lwarp == 0) {
        stats[0] = m;
        stats[1] = sum_s / p.k_actual;
        stats[2] = (eta * eta) / sum_ee;
        stats[3] = logf(eta) + sum_esm * inv_eta / p.lam;
      }
      if (C > 1) {                     // e[] of the other CTAs' samples
        for (int k = lt; k < K; k += cta) {
          const int owner = (k % nthr) / cta;
          if (owner != rank) {
            s_cost[k] = cluster.map_shared_rank(s_cost, owner)[k];
          }
        }
        __syncthreads();
      }

      // ---- 4. Σwε: one virtual warp per row r = c*T + t ------------------
      for (int r = vwarp; r < 2 * T; r += nwarp) {
        const int c = r / T, t = r - c * T;
        float acc = 0.0f;
        if (p.use_prng) {              // L2: other CTAs wrote the rows
          const float* row = eps_own + (size_t)r * K;
          for (int k = lane; k < K; k += 32) {
            acc += s_cost[k] * __ldcg(row + k);
          }
        } else {
          for (int k = lane; k < K; k += 32) {
            acc += s_cost[k] * eps_step[((size_t)k * T + t) * 2 + c];
          }
        }
        acc = warp_sum(acc);
        if (lane == 0) s_weps[r] = acc * inv_eta;
      }
      cluster.sync();

      // ---- 5. gather the rows; median, u update and warm-start shift -----
      for (int i = lt; i < 2 * T; i += cta) {
        s_wall[i] = cluster.map_shared_rank(s_weps, (i % nwarp) / wpc)[i];
      }
      __syncthreads();
      for (int i = lt; i < 2 * T; i += cta) {
        const int c = i / T, t = i - c * T;
        const int ts = t < T - 1 ? t + 1 : T - 1;
        s_un[i] =
            s_u[c * T + ts] + reflect_median(s_wall + c * T, T, p.fw, ts);
      }
      __syncthreads();
      float* const spent = s_u;
      s_u = s_un;
      s_un = spent;
    }

    // ---- 6. plant step and record row (_plant_record_scalar) -------------
    if (lwarp == 0) {
      const float u1 = s_u[0], u2 = s_u[T];   // shifted first element (Q3)
      if (!frz) {
        dynamics_step(pq1, pq2, pdq1, pdq2, u1 + p.dist1, u2 + p.dist2,
                      p.dt_p, p.arm);
      }
      if (rank == 0 && lane < kRecLanes) {
        float v = pq1;
        v = lane == 1 ? pq2 : v;
        v = lane == 2 ? pdq1 : v;
        v = lane == 3 ? pdq2 : v;
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
  }

  if (rank == 0) {
    for (int i = lt; i < 2 * T; i += cta) {
      ufin[(size_t)b * 2 * T + i] = s_u[(i & 1) * T + (i >> 1)];
    }
  }
  cluster.sync();   // no CTA leaves while another may read its shared memory
}

extern "C" {

// Launch the kernel on `stream` as B clusters of `cluster` CTAs.  Returns
// the cudaError_t of the launch: cudaErrorInvalidValue when `cluster` is
// not a power of two up to 8 that divides nthr / 32, and
// cudaErrorInvalidClusterSize when the card cannot place such a cluster.
int mppi_sim_launch(const SimParams* params, int B, int cluster,
                    const float* state_f, const int* state_i, const float* u0,
                    const float* ref, const float* eps_in, float* eps_scratch,
                    float* rec, float* ufin, void* stream) {
  const SimParams p = *params;
  const int rounded = ((p.K + 31) / 32) * 32;
  const int nthr = rounded < 1024 ? rounded : 1024;
  if (cluster < 1 || cluster > kMaxCluster || (cluster & (cluster - 1)) ||
      (nthr / 32) % cluster) {
    return (int)cudaErrorInvalidValue;
  }
  const size_t smem = sizeof(float) * smem_floats(p);
  cudaError_t e;
  if (smem > 48 * 1024) {
    e = cudaFuncSetAttribute(
        sim_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  cudaLaunchAttribute attrs[2];
  attrs[0].id = cudaLaunchAttributeClusterDimension;
  attrs[0].val.clusterDim.x = cluster;
  attrs[0].val.clusterDim.y = 1;
  attrs[0].val.clusterDim.z = 1;
  attrs[1].id = cudaLaunchAttributeClusterSchedulingPolicyPreference;
  attrs[1].val.clusterSchedulingPolicyPreference =
      cudaClusterSchedulingPolicySpread;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(B * cluster);
  cfg.blockDim = dim3(nthr / cluster);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = (cudaStream_t)stream;
  cfg.attrs = attrs;
  cfg.numAttrs = 2;
  int placeable = 0;
  e = cudaOccupancyMaxActiveClusters(&placeable, (const void*)sim_kernel,
                                     &cfg);
  if (e != cudaSuccess) return (int)e;
  if (placeable < 1) return (int)cudaErrorInvalidClusterSize;
  e = cudaLaunchKernelEx(&cfg, sim_kernel, p, state_f, state_i, u0, ref,
                         eps_in, eps_scratch, rec, ufin);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

const char* mppi_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// sizeof(SimParams), held against the ctypes mirror when the library loads.
int mppi_sim_params_size() { return (int)sizeof(SimParams); }

}  // extern "C"
