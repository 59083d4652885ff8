// The legacy computed-torque closed loop that synthesises a reference path
// (sim/pathgen.py::generate_circle_path): from the IK targets r, dr, ddr of
// every step, the outer-loop PD law, the feedback-linearization torque, the
// plant's ddq, a semi-implicit Euler step and the EE position, one row
// [x, y, dq1, dq2, u1, u2] a step.
//
// Replaces: no Pallas kernel.  The JAX package compiles the loop as one
// jitted lax.scan (mppi_robotarm_tpu/sim/pathgen.py:31, body :55-69, scan
// :71), which XLA runs as one device program; the port ran it as a Python
// loop of N dependent steps of small torch kernels.  Plain PyTorch version:
// ops/cuda_pathgen.py::pathgen_reference; wrapper: ops/cuda_pathgen.py::
// pathgen.  The targets stay batched torch calls before the loop (their
// vmap/jacfwd over θ depends on the step alone).
//
// Arithmetic.  Exact float32 (or float64) and --fmad=false, in the plain
// version's operations and their order as torch runs them on the card:
// models/arm.py's pd_outer_loop, feedback_linearization, arm_ddq (with
// mass_matrix and gravity_vector) and fk_ee, where every tensor op rounds
// once, a Python scalar enters as its value in the tensor's type (the
// wrapper computes each scalar product of the arm's constants in double as
// Python does, PathgenParams), 1.0 / det is torch's reciprocal (an IEEE
// division), and cosf/sinf are the functions torch's card kernels call.
// The feedback law and the plant read the same M, G, h and C·dq, which
// torch computes twice on the same state and this kernel once.
//
// What bounds it: latency.  The recurrence is a dependent chain over two
// joints, step after step, so one thread runs it, with q and dq in
// registers; the next step's targets are loaded while the current step
// computes, and each row is stored as it is made.  At N = 2000 it moves 96
// KB (the targets in, the rows out: 0.03 us at 3.35 TB/s), far below the
// chain's few hundred ns a step.

#include <cuda_runtime.h>
#include <math.h>

// The arm's scalar constants as the plain version forms them in Python
// double, each named by its expression (models/arm.py).
struct PathgenParams {
  double m11_a;     // p.m1 * p.lc1 ** 2 + p.l1
  double m11_b;     // p.l1 ** 2 + p.lc2 ** 2
  double m11_c;     // 2.0 * p.l1 * p.lc2
  double m2;        // p.m2
  double l2;        // p.l2
  double m2l1lc2;   // p.m2 * p.l1 * p.lc2 (m12's factor, and h's)
  double m2lc2sq;   // p.m2 * p.lc2 ** 2
  double m22;       // p.m2 * p.lc2 ** 2 + p.l2 (a Python float in torch)
  double m1lc1g;    // p.m1 * p.lc1 * p.g
  double m2g;       // p.m2 * p.g
  double lc2;       // p.lc2
  double l1;        // p.l1
  double m2lc2g;    // p.m2 * p.lc2 * p.g
  double kp, kd, dt;
  double fk_l1, fk_l2;   // fk_ee's l1, l2
};

__device__ __forceinline__ float cos_of(float x) { return cosf(x); }
__device__ __forceinline__ float sin_of(float x) { return sinf(x); }
__device__ __forceinline__ double cos_of(double x) { return cos(x); }
__device__ __forceinline__ double sin_of(double x) { return sin(x); }

template <typename scalar_t>
__global__ void __launch_bounds__(32)
pathgen_kernel(const scalar_t* __restrict__ r,
               const scalar_t* __restrict__ dr,
               const scalar_t* __restrict__ ddr,
               const scalar_t* __restrict__ q0,
               scalar_t* __restrict__ rows, int n, PathgenParams p) {
  if (threadIdx.x != 0 || blockIdx.x != 0) return;
  typedef scalar_t S;
  // each Python scalar as torch takes it into a tensor op of this type
  const S m11_a = (S)p.m11_a, m11_b = (S)p.m11_b, m11_c = (S)p.m11_c;
  const S m2 = (S)p.m2, l2 = (S)p.l2, m2l1lc2 = (S)p.m2l1lc2;
  const S m2lc2sq = (S)p.m2lc2sq, m22 = (S)p.m22, m1lc1g = (S)p.m1lc1g;
  const S m2g = (S)p.m2g, lc2 = (S)p.lc2, l1 = (S)p.l1;
  const S m2lc2g = (S)p.m2lc2g, kp = (S)p.kp, kd = (S)p.kd, dt = (S)p.dt;
  const S fk_l1 = (S)p.fk_l1, fk_l2 = (S)p.fk_l2;

  S q1 = q0[0], q2 = q0[1], dq1 = (S)0, dq2 = (S)0;
  S tr[6] = {r[0], r[1], dr[0], dr[1], ddr[0], ddr[1]};
  for (int i = 0; i < n; ++i) {
    const S r1 = tr[0], r2 = tr[1], dr1 = tr[2], dr2 = tr[3];
    const S ddr1 = tr[4], ddr2 = tr[5];
    if (i + 1 < n) {          // the next step's targets, off the chain
      const int j = 2 * (i + 1);
      tr[0] = r[j]; tr[1] = r[j + 1]; tr[2] = dr[j]; tr[3] = dr[j + 1];
      tr[4] = ddr[j]; tr[5] = ddr[j + 1];
    }
    // pd_outer_loop: v = ddr - kd * (dq - dr) - kp * (q - r)
    const S v1 = (ddr1 - kd * (dq1 - dr1)) - kp * (q1 - r1);
    const S v2 = (ddr2 - kd * (dq2 - dr2)) - kp * (q2 - r2);
    // mass_matrix(q2)
    const S c2 = cos_of(q2);
    const S m11 = ((m2 * (m11_c * c2 + m11_b)) + m11_a) + l2;
    const S m12 = ((m2l1lc2 * c2) + m2lc2sq) + l2;
    // gravity_vector(q1, q2)
    const S c1 = cos_of(q1);
    const S c12 = cos_of(q1 + q2);
    const S g1 = m1lc1g * c1 + m2g * (lc2 * c12 + l1 * c1);
    const S g2 = m2lc2g * c12;
    // Coriolis: h, C·dq
    const S h = m2l1lc2 * sin_of(q2);
    const S cdq1 = ((-h) * dq2) * dq1 + (((-h) * dq1) - h * dq2) * dq2;
    const S cdq2 = (h * dq1) * dq1;
    // feedback_linearization: u = M·v + C·dq + G
    const S u1 = ((m11 * v1 + m12 * v2) + cdq1) + g1;
    const S u2 = ((m12 * v1 + m22 * v2) + cdq2) + g2;
    // arm_ddq: M^-1 (u - C·dq - G)
    const S e1 = (u1 - cdq1) - g1;
    const S e2 = (u2 - cdq2) - g2;
    const S det = m11 * m22 - m12 * m12;
    const S inv_det = (S)1 / det;
    const S ddq1 = (m22 * e1 - m12 * e2) * inv_det;
    const S ddq2 = ((-m12) * e1 + m11 * e2) * inv_det;
    // forward Euler: dq += dt * ddq, then q += dt * dq
    dq1 = dq1 + dt * ddq1;
    dq2 = dq2 + dt * ddq2;
    q1 = q1 + dt * dq1;
    q2 = q2 + dt * dq2;
    // fk_ee, and the row
    const S q12 = q1 + q2;
    S* row = rows + 6 * i;
    row[0] = fk_l1 * cos_of(q1) + fk_l2 * cos_of(q12);
    row[1] = fk_l1 * sin_of(q1) + fk_l2 * sin_of(q12);
    row[2] = dq1;
    row[3] = dq2;
    row[4] = u1;
    row[5] = u2;
  }
}

extern "C" {

// rows (n, 6) of the closed loop from q0 (2,) and the targets r, dr, ddr
// (n, 2), all float32 (is_double 0) or float64 (1), on `stream`: one
// thread.  Returns the cudaError_t of the launch, cudaErrorInvalidValue for
// arguments the kernel does not take.
int mppi_pathgen_launch(const void* r, const void* dr, const void* ddr,
                        const void* q0, void* rows, int n, int is_double,
                        const PathgenParams* params, void* stream) {
  if (n < 1 || params == nullptr) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (is_double) {
    pathgen_kernel<double><<<1, 32, 0, s>>>(
        (const double*)r, (const double*)dr, (const double*)ddr,
        (const double*)q0, (double*)rows, n, *params);
  } else {
    pathgen_kernel<float><<<1, 32, 0, s>>>(
        (const float*)r, (const float*)dr, (const float*)ddr,
        (const float*)q0, (float*)rows, n, *params);
  }
  return (int)cudaGetLastError();
}

// sizeof(PathgenParams), held against the ctypes mirror when the library
// loads.
int mppi_pathgen_params_size() { return (int)sizeof(PathgenParams); }

}  // extern "C"
