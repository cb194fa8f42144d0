// Double-float (two f32) arithmetic shared by the EFT kernels K5
// (residual_df_norm.cu) and K6 (df_step.cu): one definition of the
// two-sum, of df_add and of the compensated residual, as the JAX package
// keeps one _eft_residual (multigrid_parallel_tpu/ops/pallas3d.py), plus
// the deterministic two-stage sum both use for ||r||^2.
//
// Exact only as written: built with --fmad=false and without fast math,
// one IEEE f32 operation per expression, no reassociation.
#pragma once

#include "stencil.cuh"

namespace mg {

// threads of the one block that sums the per-block partials
constexpr int kReduceThreads = 1024;

// Knuth's error-free transformation: a + b = s + err exactly.
__device__ inline void two_sum(float a, float b, float& s, float& err) {
  s = a + b;
  const float bb = s - a;
  err = (a - (s - bb)) + (b - bb);
}

// (hi, lo) + d renormalized: the JAX package's df_add.
__device__ inline void df_add(float hi, float lo, float d, float& out_hi,
                              float& out_lo) {
  float s, err;
  two_sum(hi, d, s, err);
  two_sum(s, lo + err, out_hi, out_lo);
}

// Compensated residual of u = u_hi + u_lo against f = f_hi + f_lo at one
// interior point, in the operation order of the JAX _eft_residual:
//   hi: two-sum chain over the 8 terms (6 neighbours, -4u, -2u; the
//       products are exact power-of-two scalings) with a compensation c;
//   lo: plain left-to-right sum of the same 8 terms;
//   r, e1 = two_sum(f_hi, -inv_h2 * s_hi)
//   out   = r + ((f_lo - inv_h2 * (c_hi + s_lo)) + e1)
// Neighbours come in nbr_sum order (i-1, i+1, j-1, j+1, k-1, k+1).
// inv_h2 is 1 / h^2 computed in f64 and rounded once to f32 by the
// wrapper, as the JAX package's weak-typed scalar is: its scalings are
// exact only on dyadic grids (h = 2^-k); on others (the electrospray's
// h = 3e-4 / (n - 1)) they round as in JAX and in the plain version.
__device__ inline float eft_residual(float fh, float fl, float ch,
                                     const float (&nh)[6], float cl,
                                     const float (&nl)[6], float inv_h2) {
  const float th[8] = {nh[0], nh[1], nh[2], nh[3], nh[4], nh[5],
                       -4.0f * ch, -2.0f * ch};
  float s_hi = th[0];
  float c_hi = 0.0f;
#pragma unroll
  for (int m = 1; m < 8; ++m) {
    float s, err;
    two_sum(s_hi, th[m], s, err);
    s_hi = s;
    c_hi = c_hi + err;
  }
  float s_lo = nl[0];
#pragma unroll
  for (int m = 1; m < 6; ++m) s_lo = s_lo + nl[m];
  s_lo = s_lo + (-4.0f * cl);
  s_lo = s_lo + (-2.0f * cl);
  float r, e1;
  two_sum(fh, -inv_h2 * s_hi, r, e1);
  return r + ((fl - inv_h2 * (c_hi + s_lo)) + e1);
}

// The six face neighbours of interior point p, in nbr_sum order.
__device__ inline void load_nbrs(const float* u, int p, int n, float (&v)[6]) {
  const int nn = n * n;
  v[0] = u[p - nn];
  v[1] = u[p + nn];
  v[2] = u[p - n];
  v[3] = u[p + n];
  v[4] = u[p - 1];
  v[5] = u[p + 1];
}

// First stage of the norm: the block's kThreads values summed by a fixed
// shared-memory tree into partials[blockIdx.x]. Every thread of the
// block must call it (it synchronises the block).
__device__ inline void block_partial(double v, double* partials) {
  __shared__ double acc[kThreads];
  acc[threadIdx.x] = v;
  __syncthreads();
  for (int w = kThreads / 2; w > 0; w >>= 1) {
    if (threadIdx.x < w) acc[threadIdx.x] = acc[threadIdx.x] + acc[threadIdx.x + w];
    __syncthreads();
  }
  if (threadIdx.x == 0) partials[blockIdx.x] = acc[0];
}

}  // namespace mg

namespace {

// Second stage: one block of kReduceThreads sums the m partials in a
// fixed order and writes the f32 result. No atomics: every run gives the
// same bits.
__global__ void sum_partials_kernel(const double* __restrict__ partials,
                                    int m, float* __restrict__ nrm2) {
  __shared__ double acc[mg::kReduceThreads];
  double s = 0.0;
  for (int q = threadIdx.x; q < m; q += mg::kReduceThreads) s = s + partials[q];
  acc[threadIdx.x] = s;
  __syncthreads();
  for (int w = mg::kReduceThreads / 2; w > 0; w >>= 1) {
    if (threadIdx.x < w) acc[threadIdx.x] = acc[threadIdx.x] + acc[threadIdx.x + w];
    __syncthreads();
  }
  if (threadIdx.x == 0) nrm2[0] = (float)acc[0];
}

}  // namespace
