// The sample-sharded step's combine around its two all-reduces: a rank's
// step is the step head, the solve kernel (normalize=False, its samples at
// k_offset), MIN on m, shard_scale_kernel, SUM on the packed message,
// shard_finish_kernel, then the step tail (step_kernel.cu).
//
// Replaces: no Pallas kernel.  In the JAX package the sample-sharded step
// (mppi_robotarm_tpu/parallel/sharded.py::make_sharded_sim_step with
// backend='pallas', :213-310) is one jitted shard_map program around the
// Pallas solve, and XLA fuses what lies between its collectives
// (_solve_local_pallas, :139-152): the rescale of a shard's partials to the
// common minimum before the psum, then Σwε = A / η, the median filter and
// the u update after it (the shift, plant and freeze are the step tail's).
// The port ran that as eager torch kernels; these two kernels run it
// instead.  Plain PyTorch versions:
// ops/cuda_shard.py::shard_scale_plain and shard_finish_plain; wrappers:
// ops/cuda_shard.py::shard_scale and shard_finish.
//
//   shard_scale_kernel, a warp a row (a scenario of a shard): s =
//   exp((m - m_s) * fl(1/lam)), then the packed message [η_s·s, A_s·s],
//   1 + 2T floats, which the SUM all-reduce adds over the shards.
//
//   shard_finish_kernel, a block a row, a thread an output: η and A from
//   the summed message, Σwε = A / η and its reflected window series into
//   shared memory, then for each of the 2T outputs the median over the
//   horizon (scipy.ndimage.median_filter(size=fw, mode='reflect'), at any
//   fw >= 1) and u_seq = u_prev + median.
//
// Arithmetic.  Exact float32 and --fmad=false, the plain versions'
// operations in their order as torch runs them on the card: torch divides a
// tensor by a Python scalar as a multiply by the scalar's float32
// reciprocal, so the scale is (m - m_s) * fl(1/lam) (ops/cuda_step.py's
// inv_lam); expf gives torch's card exp's bits; A / η is an IEEE division
// of two tensors; the median is an exact selection.  So both kernels give
// the plain versions' bits on the card.  The median is the value of rank
// fw/2 of the window, found by counting under torch.sort's order (NaN
// above every number): a candidate x is the median when fewer than rank+1
// window values sort below it and more than rank sort at or below it.  The
// window of output t is the indices t - fw/2 ... t - fw/2 + fw - 1 of the
// series reflected with period 2T (..., b, a | a, b, ..., y, z | z, y,
// ...), as ops/filters.py::median_filter_reflect builds it.  With q = fw /
// 2T whole periods in the window every value appears 2q times in them, so
// the count takes the T values once, times 2q, plus the r = fw - 2Tq
// indices left over: O(T + r) a candidate at any fw, not O(fw).  Those r
// indices of output t are t .. t + r - 1 of the series ext, the reflected
// values from index -fw/2 on (T + r - 1 < 3T of them), staged once.
//
// What bounds them: bytes and latency.  At B = 1, T = 50 the scale reads
// 404 bytes and writes 404, the finish reads 808 and writes 400: far below
// a launch's fixed cost.  A warp a scenario keeps the scale's loads and
// stores coalesced.  The finish is a chain of compares (at most fw * fw
// an output for fw <= 2T, 100 at fw = 10): on a warp a row, with the
// reflection's index arithmetic in its inner loop, it took 38.3 us on an
// H100 at B = 1, T = 50, fw = 10 (PERF.md), so a row takes a block of up
// to 128 threads, an output a thread, and the window is read from the
// staged series without index arithmetic: 4.1 us.

#include <cuda_runtime.h>
#include <math.h>

static const int kShardThreads = 128;   // the scale: four rows a block
static const int kFinishThreads = 128;  // the finish: a row's outputs
static const int kFinishSmemFloats = 12288;   // 48 KB: Σwε and ext

__global__ void __launch_bounds__(kShardThreads)
shard_scale_kernel(const float* __restrict__ m, const float* __restrict__ ms,
                   const float* __restrict__ eta,
                   const float* __restrict__ a, float* __restrict__ packed,
                   int n, int t2, float inv_lam) {
  const int row = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  if (row >= n) return;
  const int lane = threadIdx.x & 31;
  const float s = expf((m[row] - ms[row]) * inv_lam);
  float* out = packed + (size_t)row * (t2 + 1);
  const float* ar = a + (size_t)row * t2;
  if (lane == 0) out[0] = eta[row] * s;
  for (int j = lane; j < t2; j += 32) out[1 + j] = ar[j] * s;
}

// torch.sort's order: NaN above every number.
__device__ __forceinline__ bool sorts_below(float a, float b) {
  return a < b || (b != b && a == a);
}
__device__ __forceinline__ bool sorts_at_or_below(float a, float b) {
  return a <= b || b != b;
}

// Index k of the series of T values reflected with period 2T.
__device__ __forceinline__ int reflect_index(int k, int T) {
  const int p = 2 * T;
  int j = k % p;
  if (j < 0) j += p;
  return j < T ? j : p - 1 - j;
}

// The median filter's output t of the T values v, with ext the reflected
// series from index -fw/2 (see the header).
__device__ float reflect_median_any(const float* v, const float* ext, int T,
                                    int fw, int t) {
  const int p = 2 * T, q = fw / p, r = fw - q * p, rank = fw / 2;
  const float* win = ext + t;            // the r indices left over
  const int candidates = q > 0 ? T : r;
  for (int c = 0; c < candidates; ++c) {
    const float x = q > 0 ? v[c] : win[c];
    int below = 0, at_or_below = 0;
    if (q > 0) {
      for (int j = 0; j < T; ++j) {
        below += sorts_below(v[j], x);
        at_or_below += sorts_at_or_below(v[j], x);
      }
      below *= 2 * q;
      at_or_below *= 2 * q;
    }
    for (int k = 0; k < r; ++k) {
      below += sorts_below(win[k], x);
      at_or_below += sorts_at_or_below(win[k], x);
    }
    if (below <= rank && rank < at_or_below) return x;
  }
  return v[0];   // not reached: some value of the window holds the rank
}

// The reflected series' length a control dimension: T + r - 1, r the
// indices of a window beyond its whole periods.
__host__ __device__ __forceinline__ int ext_len(int T, int fw) {
  const int p = 2 * T, r = fw / p > 0 ? fw % p : fw;
  return T + r - 1;
}

__global__ void __launch_bounds__(kFinishThreads)
shard_finish_kernel(const float* __restrict__ packed,
                    const float* __restrict__ u_prev,
                    float* __restrict__ u_seq, int T, int fw) {
  extern __shared__ float smem[];
  const int row = blockIdx.x, t2 = 2 * T, e = ext_len(T, fw);
  float* w = smem;                       // w[d * T + t] = Σwε[t, d]
  float* ext = smem + t2;                // ext[d * e + k]
  const float* pr = packed + (size_t)row * (t2 + 1);
  const float eta = pr[0];
  for (int j = threadIdx.x; j < t2; j += blockDim.x) {
    w[(j & 1) * T + (j >> 1)] = pr[1 + j] / eta;
  }
  __syncthreads();
  for (int k = threadIdx.x; k < 2 * e; k += blockDim.x) {
    const int d = k / e, i = k - d * e;
    ext[k] = w[d * T + reflect_index(i - fw / 2, T)];
  }
  __syncthreads();
  const float* up = u_prev + (size_t)row * t2;
  float* us = u_seq + (size_t)row * t2;
  for (int j = threadIdx.x; j < t2; j += blockDim.x) {
    const int d = j & 1;
    us[j] = up[j] + reflect_median_any(w + d * T, ext + d * e, T, fw, j >> 1);
  }
}

extern "C" {

// The packed message of n rows of horizon T on `stream`: packed (n, 1 + 2T)
// from m, m_s, η_s (n,) and A_s (n, T, 2); returns the cudaError_t of the
// launch, cudaErrorInvalidValue for arguments the kernel does not take.
int mppi_shard_scale_launch(const float* m, const float* m_s,
                            const float* eta_s, const float* a_s,
                            float* packed, int n, int T, float inv_lam,
                            void* stream) {
  if (n < 1 || T < 1) return (int)cudaErrorInvalidValue;
  const int per = kShardThreads / 32;
  shard_scale_kernel<<<(n + per - 1) / per, kShardThreads, 0,
                       (cudaStream_t)stream>>>(m, m_s, eta_s, a_s, packed, n,
                                               2 * T, inv_lam);
  return (int)cudaGetLastError();
}

// u_seq (n, T, 2) = u_prev + the median (window fw) of A / η from the summed
// packed (n, 1 + 2T), on `stream`: a block a row, a thread an output (up to
// 128), Σwε and the reflected series in shared memory (at most 48 KB).
// Returns the cudaError_t of the launch, cudaErrorInvalidValue for
// arguments the kernel does not take.
int mppi_shard_finish_launch(const float* packed, const float* u_prev,
                             float* u_seq, int n, int T, int fw,
                             void* stream) {
  if (n < 1 || T < 1 || fw < 1 ||
      2 * T + 2 * ext_len(T, fw) > kFinishSmemFloats) {
    return (int)cudaErrorInvalidValue;
  }
  const int threads = 2 * T < kFinishThreads ? (2 * T + 31) / 32 * 32
                                             : kFinishThreads;
  shard_finish_kernel<<<n, threads,
                        (2 * T + 2 * ext_len(T, fw)) * sizeof(float),
                        (cudaStream_t)stream>>>(packed, u_prev, u_seq, T,
                                                fw);
  return (int)cudaGetLastError();
}

}  // extern "C"
