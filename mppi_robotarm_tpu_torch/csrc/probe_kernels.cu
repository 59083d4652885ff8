// Launch-overhead probes: two kernels that do almost nothing, so that their
// time on the card is the fixed cost of a launch and of a large output.
//
// Replaces: tools/tpu_overhead.py's two Pallas kernels,
//   probe_scale_kernel <- triv_kernel (tools/tpu_overhead.py:45): o = i * 1.000001
//   probe_big_kernel   <- big_kernel  (tools/tpu_overhead.py:59): the same o,
//                         and a (100, 8, 128) float32 output of zeros.
// Plain PyTorch versions: ops/cuda_probe.py::probe_scale_reference and
// probe_big_reference; wrappers: ops/cuda_probe.py::probe_scale, probe_big.
//
// The TPU kernel zeroes a 400 KB VMEM scratch and copies it to its HBM
// output.  400 KB does not fit in a Hopper block's 227 KB of shared memory,
// and staging a store of zeros through shared memory buys nothing, so
// probe_big_kernel writes the 409,600 bytes straight from registers, one
// 16-byte store per thread per pass, from one block an SM (the wrapper
// passes the card's SM count); block 0 also writes o.
//
// What bounds them: bytes.  At the probe shape P1 moves 8 KB (0.002 us at
// 3.35 TB/s) and P2 416 KB (0.12 us); both are far below a launch's fixed
// cost (P1's 1.07 us on an H100), which is what they measure.  Measured
// on an H100 (PERF.md): the stores from 132 blocks took P2 from 1.84 us
// (25 blocks) to 1.70; a bulk copy of shared zeros from each SM
// (fence.proxy.async, cp.async.bulk, then wait for the engine's read
// before the block exits) took 1.79-1.80.

#include <cuda_runtime.h>

// 1.000001 rounded to float32, as JAX rounds the weak-typed Python scalar.
#define PROBE_SCALE 1.000001f

__global__ void __launch_bounds__(256)
probe_scale_kernel(const float* __restrict__ x, float* __restrict__ o,
                   int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) o[i] = x[i] * PROBE_SCALE;
}

static const int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
probe_big_kernel(const float* __restrict__ x, float* __restrict__ o, int n,
                 float4* __restrict__ big, int n_big4) {
  const float4 zero = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < n_big4;
       i += gridDim.x * blockDim.x) {
    big[i] = zero;
  }
  if (blockIdx.x == 0) {
    for (int i = threadIdx.x; i < n; i += blockDim.x) o[i] = x[i] * PROBE_SCALE;
  }
}

extern "C" {

// o[i] = x[i] * 1.000001f for i < n, on `stream`; returns the cudaError_t of
// the launch, cudaErrorInvalidValue for n < 1.
int mppi_probe_scale_launch(const float* x, float* o, int n, void* stream) {
  if (n < 1) return (int)cudaErrorInvalidValue;
  const int blocks = (int)(((long long)n + kThreads - 1) / kThreads);
  probe_scale_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(x, o, n);
  return (int)cudaGetLastError();
}

// probe_scale's o, and n_big floats of zeros at `big` (16-byte aligned,
// n_big a multiple of 4), from `blocks` blocks (one an SM), on `stream`;
// returns the cudaError_t of the launch, cudaErrorInvalidValue for
// arguments the kernel does not take.
int mppi_probe_big_launch(const float* x, float* o, int n, float* big,
                          int n_big, int blocks, void* stream) {
  if (n < 1 || n_big < 4 || n_big % 4 != 0 || blocks < 1 ||
      reinterpret_cast<size_t>(big) % 16 != 0) {
    return (int)cudaErrorInvalidValue;
  }
  probe_big_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      x, o, n, reinterpret_cast<float4*>(big), n_big / 4);
  return (int)cudaGetLastError();
}

}  // extern "C"
