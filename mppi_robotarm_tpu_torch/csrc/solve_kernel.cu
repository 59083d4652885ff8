// One MPPI solve for B scenarios: K noisy rollouts, their costs, the softmax
// over the samples and the weighted noise, in one launch.
//
// Replaces: mppi_robotarm_tpu/ops/pallas_rollout.py::_solve_kernel (reached
// through pallas_solve_batched and pallas_solve_core): its tile steps
// (pallas_rollout.py:380) and its finalize at the last grid step
// (pallas_rollout.py:585-659).  It ports WHAT that kernel computes, not its
// sequential (B x K-tile) grid.  Plain PyTorch twin: ops/cuda_solve.py::
// solve_batched_reference; wrapper: ops/cuda_solve.py::solve_batched.
//
// The TPU kernel runs its grid in order on one core and carries the online
// softmax (running min m, running eta, running Sum e*eps) in scratch from one
// K-tile to the next, initialising at the first tile and finalising at the
// last.  CUDA blocks run at the same time in no order, so each tile reduces
// its own softmax and one block per scenario combines the tiles:
//
//   solve_tile_kernel<L>, grid (n_tiles / G, B), G tiles a block and L
//   threads per sample (blockDim = G x tile x L, tile a multiple of 32, at
//   most 512 threads; the tiles of a block share the scenario's window and
//   controls, and reduce apart):
//     1. noise: PRNG mode draws Philox4x32-10 normals keyed (seed, step) with
//        counter (k_offset + k, t, 0, 0) -- the stream of philox_epsilon and
//        of the fused loop, independent of the tile size and with no tile
//        cap -- scaled by chol(Sigma); eps mode reads the caller's noise.
//        Either way the tile's eps goes to shared memory (2T x tile floats,
//        laid out [2t + c][lane] so both writes and reads are conflict-free)
//        for step 3, and PRNG mode also writes it out when asked;
//     2. the T-step rollout with the trig carry and the tracking cost, the
//        exploration split on the global index k_offset + k (Q9), the
//        terminal cost, the per-sample S written out; padding samples of
//        the last tile take S = +inf and weight 0;
//     3. the tile's own softmax: m_p = min S, e = exp(-(S - m_p)/lam),
//        eta_p = Sum e, and the 2T rows Sum e*eps (one warp per horizon
//        step and one for eta_p, lanes striding the tile's samples, so
//        no sum depends on the lanes per sample), the tile's partial
//        (2T rows, m_p, eta_p);
//     4. the combine, on one block per scenario: m = min m_p, then in tile
//        order eta = Sum eta_p * exp((m - m_p)/lam) and the rows rescaled
//        the same way (the two-level combine of parallel/sharded.py:
//        139-145); then Sum w*eps = rows / eta, or the raw rows
//        (normalize=0), or with fuse_update the reflect median of
//        rows * (1/eta) added to u (pallas_rollout.py:618-659).
//        - One tile a scenario (n_tiles == 1: the fleet's K=128, every
//          K <= 128): the block combines its own partial from shared
//          memory, with the same expressions (scale = exp((m - m_p)/lam),
//          0 + row * scale; never shortened, as 0 + (-0) is +0).
//        - Several tiles: each block writes its tiles' partials to a
//          (B, n_tiles, 2T + 2) workspace; after a barrier one thread
//          fences and adds one to the scenario's arrival counter.  The
//          block that brings it to the scenario's block count combines:
//          it stages the partials in its shared memory with cp.async (the
//          launch sizes the region past the eps to hold them; a chunk at a
//          time where a block cannot), folds each row over the tiles in
//          tile order, and puts the counter back to 0, so the next launch
//          and every replay of a captured graph start from zero with no
//          memset.
//        The combine is out of line (combine_solve) and its median counts
//        ranks in registers (reflect_median_regs), both for time (below).
//      The counters (int32, one a scenario) are the wrapper's: one slot
//      of them for each (device, stream), zeroed once when allocated
//      (ops/cuda_solve.py::_arrival_counters), so solves in flight on two
//      streams never share one.
//   No float atomics anywhere, and every sum has a fixed order, so a solve
//   gives the same bits on every run, and the bits of the two-launch
//   combine this kernel replaces.
//
// Where eps waits between the rollout and Sum e*eps was decided on an H100
// (PERF.md): shared memory beat a (B, K, T, 2) global scratch and
// regenerating it from the counter-based stream at every main-path shape
// (K=1024 and K=65536 at H=50, 4096 scenarios at K=128, T=30).
//
// Arithmetic.  Exact float32 as in sim_kernel.cu: IEEE divide, libdevice
// sinf/cosf/expf, --fmad=false; the rollout is the same per-sample code as
// the fused loop's (mppi_device.cuh), so S matches the plain twin bit for
// bit and only the order of the K-sums differs.  The TPU kernel's PRNG-mode
// levers (trig_carry/poly_trig, fast_select, packed_select, approx_recip,
// icdf_noise) are not ported; each is an H100 A/B for later work.
//
// What bounds it.  Each sample is a dependent chain of T rollout steps
// (about 30 compare-selects of the window scan, two sincosf, one divide per
// step).  Where the samples leave SMs idle (K=1024: one thread a sample
// fills 8 SMs) the chain's latency bounds the solve, so the wrapper
// (ops/cuda_solve.py::solve_layout) gives each sample L = 2 or 4 lanes
// that split its window scans (window_cost_lanes) and blocks of 128
// threads, one warp a scheduler (K=1024: 32 blocks on 32 SMs).  Where a
// batch leaves a tile fewer than 128 threads, G tiles share a block of 128
// (B=64 at K=1024: 512 blocks of four 32-sample tiles, which ran 1.5x
// faster than 2048 blocks of one warp; PERF.md).  Where the
// chains fill the card (K=65536: 128 blocks of 512 threads on 132 SMs, one
// block per SM for its 200 KB of shared eps; the fleet's 4096 x K=128)
// issue rate bounds it, and one lane a sample scans alone on one chain,
// the fewest instructions (PERF.md), at the window's compiled width where
// it has one (solve_tile_kernel<1, kScanWidth>: about 90 instructions a
// sample-step fewer at W = 30).  The combine does almost no work (at
// most ~128 tiles' partials: the wrapper grows the tile with K), so its
// cost is latency: as a second launch, a launch's gap and 5.9-14.6 us of
// kernel on an H100.  In the last block it is a few microseconds of
// latency (PERF.md: tools/combine_clocks.py splits it): the arrival's
// fence and atomic, one round trip for all partials (cp.async, none
// waiting on another; register staging through L2 took 5x as long), the
// folds, and the median, whose serial form's worst output waits on fw * fw
// shared loads.  Inlined, the combine moved the tile pass's own time by
// up to 5 % at some shapes, so it stays out of line.

#include <cuda_runtime.h>

#include "mppi_device.cuh"

// Mirrored field for field by ops/cuda_solve.py::_SolveParams (all fields
// are 4 bytes wide, so the layouts agree without padding; the wrapper checks
// sizeof against ctypes.sizeof when the library loads).
struct SolveParams {
  ArmConsts arm;
  float l1c, l2c;              // cost FK link lengths (MPPIConfig.l1/l2)
  float lam, gamma;
  float dt_c;                  // controller-model dt (Q2)
  float cost_scale, dist_scale;
  float stage_w[4];
  float term_w[4];
  float exploit_thresh;        // (1 - exploration) * num_samples (Q9)
  float u_clamp;
  float l11, l21, l22;         // chol(Sigma)
  float sinv[4];               // Sigma^-1, row-major
  int has_clamp;
  int K;                       // samples of this call (k_local)
  int T, W, fw;
  int tile, n_tiles;
  int use_prng;
  int normalize, fuse_update;
  int step_stride;             // 0: one step for every scenario; 1: (B,)
  int lanes;                   // threads per sample of the tile pass: 1, 2, 4
  int group;                   // tiles per block of the tile pass (G)
};

// Fold n tiles' partials, staged in shared memory at `chunk` (stride
// 2T + 2: the 2T rows, m_p at 2T, eta_p at 2T + 1), into acc: each row and
// eta (column 2T + 1) is one thread's sum over the tiles in tile order,
// acc = acc + x * exp((m - m_p)/lam), from 0 when `first`, else continuing
// acc -- the expressions and order of the combine pass this replaces
// (pallas_rollout.py:585-617).  Each staged m_p is replaced by its scale.
// `chunk` may be `acc` itself (one tile): a thread reads its column before
// it writes it.  Every thread of the block calls it.
__device__ void fold_tiles(float* chunk, int n, bool first, float m,
                           float lam, int T, float* acc) {
  const int stride = 2 * T + 2;
  __syncthreads();                   // the staged partials, and m, are read
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    float* mp = chunk + (size_t)i * stride + 2 * T;
    *mp = expf((m - *mp) / lam);     // <= 1
  }
  __syncthreads();
  for (int r = threadIdx.x; r <= 2 * T; r += blockDim.x) {
    const int col = r < 2 * T ? r : 2 * T + 1;
    float a = first ? 0.0f : acc[col];
#pragma unroll 4
    for (int i = 0; i < n; ++i) {
      const float* pt = chunk + (size_t)i * stride;
      a = a + pt[col] * pt[2 * T];
    }
    acc[col] = a;
  }
}

// reflect_median (mppi_device.cuh) for fw <= kRegWindow, the same value
// bit for bit: the window's fw values are loaded once into registers
// (the rest NaN, which no comparison counts), and each candidate's ranks
// are counted there, fully unrolled, so no shared load waits inside the
// count; the first candidate in window order whose value has rank fw/2
// wins, as there.  The serial form's worst output, which sets the block's
// time, waits on fw * fw shared loads.
constexpr int kRegWindow = 12;

__device__ __forceinline__ float reflect_median_regs(const float* v, int T,
                                                     int fw, int t) {
  const int left = fw / 2;
  const int rank = fw / 2;
  float w[kRegWindow];
#pragma unroll
  for (int i = 0; i < kRegWindow; ++i) {
    int ji = t - left + i;
    ji = ji < 0 ? -1 - ji : (ji >= T ? 2 * T - 1 - ji : ji);
    w[i] = i < fw ? v[ji] : NAN;
  }
  float result = 0.0f;
  bool found = false;
#pragma unroll
  for (int i = 0; i < kRegWindow; ++i) {
    int less = 0, leq = 0;
#pragma unroll
    for (int j = 0; j < kRegWindow; ++j) {
      less += w[j] < w[i];
      leq += w[j] <= w[i];
    }
    const bool hit = i < fw && !found && less <= rank && rank < leq;
    result = hit ? w[i] : result;
    found = found || hit;
  }
  return result;
}

// The combine's last step on the folded acc (rows dim-major, eta at
// 2T + 1): Sum w*eps = rows / eta, the raw rows, or with fuse_update
// u + the reflect median of rows * (1/eta); then m and eta.  Every thread
// of the block calls it.
__device__ void finish_solve(int T, int fw, int normalize, int fuse_update,
                             float* acc, float m, const float* ub, float* ob,
                             float* m_out, float* eta_out, int b) {
  __syncthreads();                   // the folds are done
  const float eta = acc[2 * T + 1];
  if (fuse_update) {
    const float inv_eta = 1.0f / eta;
    for (int r = threadIdx.x; r < 2 * T; r += blockDim.x) {
      acc[r] = acc[r] * inv_eta;
    }
    __syncthreads();
    for (int r = threadIdx.x; r < 2 * T; r += blockDim.x) {
      const int c = r / T, t = r - c * T;
      const float* const v = acc + c * T;
      ob[2 * t + c] = ub[2 * t + c] + (fw <= kRegWindow
                                           ? reflect_median_regs(v, T, fw, t)
                                           : reflect_median(v, T, fw, t));
    }
  } else {
    for (int r = threadIdx.x; r < 2 * T; r += blockDim.x) {
      const int c = r / T, t = r - c * T;
      ob[2 * t + c] = normalize ? acc[r] / eta : acc[r];
    }
  }
  if (threadIdx.x == 0) {
    m_out[b] = m;
    eta_out[b] = eta;
  }
}

// Copy n floats from global `src` to shared memory at `dst` (a shared
// address) with asynchronous 4-byte copies through L2, every thread's in
// flight at once, then wait for them; the block's threads all call it.
__device__ __forceinline__ void stage_partials(unsigned dst, const float* src,
                                               int n) {
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;"
                 :: "r"(dst + 4u * i), "l"(src + i) : "memory");
  }
  asm volatile("cp.async.wait_all;" ::: "memory");
  __syncthreads();
}

// ---- 4. the combine, on one block per scenario -------------------------
// Out of line, so that its code stays out of the tile pass's register
// allocation: inlined, it moved the rollout loop's time by up to 5 %
// (PERF.md).  Every thread of the block calls it once the tile's partial
// is in s_fin (one tile a scenario) or in `part`.  The block's shared
// memory is addressed from its own extern declaration, so every access
// here is a shared one: s_red (16 floats) at fin_off - 16, s_fin at
// fin_off, and past it s_reg, free by now.
__device__ __noinline__ void combine_solve(
    int T, int n_tiles, int fw, float lam, int normalize, int fuse_update,
    int fin_off, const float* part, int* count, const float* ub, float* ob,
    float* m_out, float* eta_out) {
  extern __shared__ float4 smem4[];
  float* const s_fin = reinterpret_cast<float*>(smem4) + fin_off;
  float* const s_red = s_fin - 16;
  float* const s_reg = s_fin + 2 * T + 2;
  const int T2 = 2 * T, b = blockIdx.y, lt = threadIdx.x, lane = lt & 31;
  if (n_tiles == 1) {                // the block's own partial, in s_fin
    __syncthreads();
    const float m1 = s_fin[T2];
    fold_tiles(s_fin, 1, true, m1, lam, T, s_fin);
    finish_solve(T, fw, normalize, fuse_update, s_fin, m1, ub, ob, m_out,
                 eta_out, b);
    return;
  }
  // Several tiles: the scenario's last block to arrive combines them.
  // The barrier orders the block's partials before thread 0's release
  // fence and arrival; its acquire fence and the barrier after it order
  // the combining block's reads after every block's partials (the grid
  // barrier's pattern).  A scenario on one block needs only the barrier.
  __shared__ int s_last;
  __syncthreads();
  if (gridDim.x > 1) {
    if (lt == 0) {
      __threadfence();
      s_last = atomicAdd(count + b, 1) == (int)gridDim.x - 1;
      if (s_last) count[b] = 0;      // all arrived: ready for the next launch
      __threadfence();
    }
    __syncthreads();
    if (!s_last) return;
  }
  // Stage the partials in s_reg with asynchronous 4-byte copies, all in
  // flight at once (the launch sizes s_reg to hold them all where they fit
  // a block; else a chunk of `cap` tiles at a time), and take m = min m_p,
  // exact in any order: from the staged copy when one chunk holds every
  // tile, else from global memory.
  const int stride = T2 + 2;
  const float* const pb = part + (size_t)b * n_tiles * stride;
  unsigned dyn;
  asm("mov.u32 %0, %%dynamic_smem_size;" : "=r"(dyn));
  const int cap = (int)((dyn / sizeof(float) - (fin_off + stride)) / stride);
  const unsigned s_reg_addr =
      static_cast<unsigned>(__cvta_generic_to_shared(s_reg));
  const bool one_chunk = n_tiles <= cap;
  float mg;
  if (one_chunk) {
    stage_partials(s_reg_addr, pb, n_tiles * stride);
    mg = s_reg[T2];
    for (int i = lt; i < n_tiles; i += blockDim.x) {
      mg = fminf(mg, s_reg[(size_t)i * stride + T2]);
    }
  } else {
    mg = __ldcg(pb + T2);
    for (int i = lt; i < n_tiles; i += blockDim.x) {
      mg = fminf(mg, __ldcg(pb + (size_t)i * stride + T2));
    }
  }
  mg = warp_min(mg);
  if (lane == 0) s_red[lt >> 5] = mg;
  __syncthreads();
  mg = s_red[0];
  for (int w = 1; w < (int)(blockDim.x >> 5); ++w) mg = fminf(mg, s_red[w]);
  for (int c0 = 0; c0 < n_tiles; c0 += cap) {
    const int n = min(cap, n_tiles - c0);
    if (!one_chunk) {
      __syncthreads();               // the last chunk's folds are done
      stage_partials(s_reg_addr, pb + (size_t)c0 * stride, n * stride);
    }
    fold_tiles(s_reg, n, c0 == 0, mg, lam, T, s_fin);
  }
  finish_solve(T, fw, normalize, fuse_update, s_fin, mg, ub, ob, m_out,
               eta_out, b);
}

// Samples of a tile: `tile`, each on L consecutive threads (L a power of
// two); a block holds G tiles of the same scenario, tile g on threads
// [g tile L, (g + 1) tile L), whole warps.  With L > 1 the lanes of a sample
// all run its rollout (the same bits in each) and split its window scans
// (window_cost_lanes); lane 0 of the group writes its noise, cost and e.
// Every sum of a tile runs over its samples in one order, on its own warps
// and shared memory, so neither L nor G changes any bit of any result; the
// tile does (the wrapper picks it from K alone, so a scenario gives the
// same bits alone and in a batch, on every card).  The window scans at the
// compiled width kWin (L = 1 and W == kScanWidth) or, at kWin = 0, at W
// read at run time.
template <int L, int kWin = 0>
__global__ void __launch_bounds__(512)
solve_tile_kernel(const SolveParams p,
                  const float* __restrict__ x0,        // (B, 4)
                  const float* __restrict__ u,         // (B, T, 2)
                  const float* __restrict__ win,       // (B, W, 4)
                  const long long* __restrict__ seed,  // (B,) | null
                  const long long* __restrict__ step,  // (B,), (1,) | null
                  const long long* __restrict__ koff,  // (B,) | null
                  const float* __restrict__ eps_in,    // (B, K, T, 2) | null
                  float* __restrict__ eps_out,  // (B, K, T, 2) | null
                  float* __restrict__ s_out,           // (B, K)
                  float* __restrict__ part,   // (B, n_tiles, 2T+2) | null
                  int* __restrict__ count,             // (>= B,) arrivals
                  float* __restrict__ out,             // (B, T, 2)
                  float* __restrict__ m_out,           // (B,)
                  float* __restrict__ eta_out) {       // (B,)
  extern __shared__ float4 smem4[];
  const int K = p.K, T = p.T, W = p.W, tile = p.tile;
  const float4* s_win = smem4;       // W rows
  float* s_u = reinterpret_cast<float*>(smem4 + W);   // 2T, dim-major
  float* s_red = s_u + 2 * T;        // 16 warp partials
  float* const s_fin = s_red + 16;   // the combine's 2T + 2 floats
  // the rest: G x tile softmax numerators, then G x 2T x tile:
  // eps[2t + c][sample]; then the combine's staged partials
  float* const s_reg = s_fin + 2 * T + 2;
  const int lt = threadIdx.x;
  const int g = lt / (tile * L);     // the thread's tile in the block
  float* s_e = s_reg + g * tile;
  float* s_eps = s_reg + p.group * tile + (size_t)g * 2 * T * tile;

  const int b = blockIdx.y;
  const int tp = blockIdx.x * p.group + g;   // past n_tiles: all padding
  const int lk = lt / L - g * tile;  // the thread's sample in its tile
  const int sub = (lt & (L - 1));    // its lane in the sample's group
  const int lane = lt & 31;
  const int wpt = tile * L >> 5;     // warps a tile
  const int w0 = g * wpt;            // the tile's first warp
  const int wt = (lt >> 5) - w0;     // the warp's place in its tile
  const int k = tp * tile + lk;
  const bool valid = k < K;
  const long long k0 = koff ? koff[b] : 0;
  const uint32_t seed32 = p.use_prng ? (uint32_t)seed[b] : 0u;
  const uint32_t step32 =   // no step tensor: step 0
      (p.use_prng && step) ? (uint32_t)step[(size_t)p.step_stride * b] : 0u;

  float* const win_f = reinterpret_cast<float*>(smem4);
  for (int i = lt; i < 4 * W; i += blockDim.x) {
    win_f[i] = win[(size_t)b * 4 * W + i];
  }
  for (int i = lt; i < 2 * T; i += blockDim.x) {
    s_u[(i & 1) * T + (i >> 1)] = u[(size_t)b * 2 * T + i];
  }
  __syncthreads();
  // the lanes of whole valid samples: the groups' shuffles run under it
  const unsigned mask = L > 1 ? __ballot_sync(kFullMask, valid) : kFullMask;

  // ---- 1-2. noise, rollout and cost, one sample per group of L lanes -----
  float s = INFINITY;
  if (valid) {
    const float q1_0 = x0[4 * b], q2_0 = x0[4 * b + 1];
    float q1 = q1_0, q2 = q2_0, dq1 = x0[4 * b + 2], dq2 = x0[4 * b + 3];
    float c1 = cosf(q1_0), s1 = sinf(q1_0);
    float c12 = cosf(q1_0 + q2_0), s12 = sinf(q1_0 + q2_0);
    const long long kg = k0 + k;
    const bool exploit = (float)kg < p.exploit_thresh;
    s = 0.0f;
    for (int t = 0; t < T; ++t) {
      const size_t e_off = (((size_t)b * K + k) * T + t) * 2;
      float e1, e2;
      if (p.use_prng) {
        uint32_t c[4] = {(uint32_t)kg, (uint32_t)t, 0u, 0u};
        philox4x32_10(c, seed32, step32);
        float z1, z2;
        box_muller(uniform_from_bits(c[0]), uniform_from_bits(c[1]), z1, z2);
        e1 = p.l11 * z1;
        e2 = p.l21 * z1 + p.l22 * z2;
        if (eps_out && sub == 0) {
          eps_out[e_off] = e1;
          eps_out[e_off + 1] = e2;
        }
      } else {
        e1 = eps_in[e_off];
        e2 = eps_in[e_off + 1];
      }
      if (sub == 0) {
        s_eps[(2 * t) * tile + lk] = e1;
        s_eps[(2 * t + 1) * tile + lk] = e2;
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
      dynamics_step_trig(q1, q2, dq1, dq2, v1, v2, p.dt_c, p.arm, c1, c2, s2,
                         c12);
      sincosf(q1, &s1, &c1);
      sincosf(q1 + q2, &s12, &c12);
      const float x = p.l1c * c1 + p.l2c * c12;
      const float y = p.l1c * s1 + p.l2c * s12;
      s = s + window_cost_lanes<L, kWin>(x, y, dq1, dq2, s_win, W,
                                         p.stage_w, p.dist_scale,
                                         p.cost_scale, sub, mask);
      const float su1 = p.sinv[0] * u1r + p.sinv[1] * u2r;
      const float su2 = p.sinv[2] * u1r + p.sinv[3] * u2r;
      s = s + p.gamma * (v1 * su1 + v2 * su2);
    }
    const float xT = p.l1c * c1 + p.l2c * c12;
    const float yT = p.l1c * s1 + p.l2c * s12;
    s = s + window_cost_lanes<L, kWin>(xT, yT, dq1, dq2, s_win, W, p.term_w,
                                       p.dist_scale, p.cost_scale, sub,
                                       mask);
    if (sub == 0) s_out[(size_t)b * K + k] = s;
  }

  // ---- 3. the tile's softmax: m_p, then each sample's e -----------------
  float m = warp_min(s);
  if (lane == 0) s_red[w0 + wt] = m;
  __syncthreads();
  m = s_red[w0];
  for (int w = 1; w < wpt; ++w) m = fminf(m, s_red[w0 + w]);
  const float e = valid && sub == 0 ? expf(-(s - m) / p.lam) : 0.0f;
  if (sub == 0) s_e[lk] = e;
  __syncthreads();   // publishes s_e and s_eps

  // ---- 3. Sum e*eps and eta_p: one of the tile's warps per row (2T rows
  // of Sum e*eps, both control dims of a horizon step together, then
  // eta_p), lanes striding the tile's samples, so no sum depends on the
  // lanes a sample or the tiles a block; the tile's partial goes to s_fin
  // when it is the scenario's one tile, else to the workspace
  const int T2 = 2 * T;
  if (tp < p.n_tiles) {              // not a padding tile of the last block
    float* const dst = p.n_tiles == 1
        ? s_fin : part + ((size_t)b * p.n_tiles + tp) * (T2 + 2);
    const int n_here = min(tile, K - tp * tile);   // >= 1 below n_tiles
    for (int t = wt; t <= T; t += wpt) {
      float a1 = 0.0f, a2 = 0.0f;
      if (t < T) {
        for (int j = lane; j < n_here; j += 32) {
          const float ej = s_e[j];
          a1 = a1 + ej * s_eps[(2 * t) * tile + j];
          a2 = a2 + ej * s_eps[(2 * t + 1) * tile + j];
        }
        a1 = warp_sum(a1);
        a2 = warp_sum(a2);
        if (lane == 0) {
          dst[t] = a1;
          dst[T + t] = a2;
        }
      } else {
        for (int j = lane; j < n_here; j += 32) a1 = a1 + s_e[j];
        a1 = warp_sum(a1);
        if (lane == 0) dst[T2 + 1] = a1;
      }
    }
    if (wt == 0 && lane == 0) dst[T2] = m;
  }
  combine_solve(T, p.n_tiles, p.fw, p.lam, p.normalize, p.fuse_update,
                (int)(s_fin - win_f), part, count,
                u + (size_t)b * T2, out + (size_t)b * T2, m_out, eta_out);
}

// Raise a kernel's dynamic shared-memory limit to `smem` when a launch needs
// more than the default 48 KB and more than was already set on the current
// device (`set`, bytes per device).  The attribute persists, so a closed loop
// calls cudaFuncSetAttribute once, at its first step.
static const int kDevices = 64;
static const size_t kSmemBytes = 232448;   // a block's most, on Hopper
static cudaError_t fit_smem(const void* fn, size_t smem, size_t* set) {
  if (smem <= 48 * 1024) return cudaSuccess;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev < kDevices && smem <= set[dev]) return cudaSuccess;
  e = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)smem);
  if (e == cudaSuccess && dev < kDevices) set[dev] = smem;
  return e;
}

static size_t tile_smem_set[4][kDevices];

extern "C" {

// Launch the solve on `stream`, the window scanned at the compiled width
// `scan_w` (kScanWidth at one lane a sample, which must equal W) or, at 0,
// at W read at run time (ops/cuda_sim.py::scan_width picks); returns the
// cudaError_t of the launch (cudaErrorInvalidValue for lanes outside 1,
// 2, 4, a group below 1 or more than 512 threads a block, a scan_w that
// is neither 0 nor a compiled W at one lane, or several tiles a scenario
// without the workspace `part` and the arrival counters `count`, which
// must hold B zeros).
int mppi_solve_launch(const SolveParams* params, int B, const float* x0,
                      const float* u, const float* win, const long long* seed,
                      const long long* step, const long long* koff,
                      const float* eps_in, float* eps_out, float* s_out,
                      float* part, int* count, float* out, float* m_out,
                      float* eta_out, int scan_w, void* stream) {
  const SolveParams p = *params;
  const cudaStream_t st = (cudaStream_t)stream;
  const int li = p.lanes == 1 ? (scan_w ? 3 : 0)
                 : p.lanes == 2 ? 1 : p.lanes == 4 ? 2 : -1;
  if (li < 0 || p.group < 1 || p.group * p.tile * p.lanes > 512 ||
      (scan_w != 0 && (scan_w != kScanWidth || p.W != scan_w ||
                       p.lanes != 1)) ||
      (p.n_tiles > 1 && (part == nullptr || count == nullptr))) {
    return (int)cudaErrorInvalidValue;
  }
  const void* const tiles[4] = {
      (const void*)solve_tile_kernel<1>, (const void*)solve_tile_kernel<2>,
      (const void*)solve_tile_kernel<4>,
      (const void*)solve_tile_kernel<1, kScanWidth>};
  // the window, controls, warp partials and the combine's 2T + 2, then
  // the larger of the G tiles' e and eps and, where a block can hold
  // them, the scenario's tile partials (else the kernel stages them in
  // chunks of what the eps region holds)
  const size_t fixed = (size_t)4 * p.W + 2 * p.T + 16 + 2 * p.T + 2;
  const size_t eps_region = (size_t)p.group * p.tile * (2 * p.T + 1);
  const size_t staged = (size_t)p.n_tiles * (2 * p.T + 2);
  const size_t region =
      p.n_tiles > 1 && staged > eps_region &&
              sizeof(float) * (fixed + staged) <= kSmemBytes
          ? staged : eps_region;
  const size_t smem = sizeof(float) * (fixed + region);
  cudaError_t e = fit_smem(tiles[li], smem, tile_smem_set[li]);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((p.n_tiles + p.group - 1) / p.group, B);
  const int threads = p.group * p.tile * p.lanes;
  if (li == 3) {
    solve_tile_kernel<1, kScanWidth><<<grid, threads, smem, st>>>(
        p, x0, u, win, seed, step, koff, eps_in, eps_out, s_out, part, count,
        out, m_out, eta_out);
  } else if (p.lanes == 1) {
    solve_tile_kernel<1><<<grid, threads, smem, st>>>(
        p, x0, u, win, seed, step, koff, eps_in, eps_out, s_out, part, count,
        out, m_out, eta_out);
  } else if (p.lanes == 2) {
    solve_tile_kernel<2><<<grid, threads, smem, st>>>(
        p, x0, u, win, seed, step, koff, eps_in, eps_out, s_out, part, count,
        out, m_out, eta_out);
  } else {
    solve_tile_kernel<4><<<grid, threads, smem, st>>>(
        p, x0, u, win, seed, step, koff, eps_in, eps_out, s_out, part, count,
        out, m_out, eta_out);
  }
  return (int)cudaGetLastError();
}

// sizeof(SolveParams), held against the ctypes mirror when the library loads.
int mppi_solve_params_size() { return (int)sizeof(SolveParams); }

}  // extern "C"
