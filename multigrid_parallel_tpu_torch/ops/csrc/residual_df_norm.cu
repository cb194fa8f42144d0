// Compensated (EFT) residual of a double-float solution plus ||r||^2.
//
// Replaces the Pallas kernel multigrid_parallel_tpu/ops/pallas3d.py:
// residual_df_norm_fused_padded (K5), with the operation order of its
// _eft_residual: u = u_hi + u_lo, f = f_hi + f_lo,
//   hi: two-sum chain over the 8 terms (6 neighbours, -4u, -2u; the
//       products are exact powers-of-two scalings) with a compensation c;
//   lo: plain left-to-right sum of the same 8 terms;
//   r, e1 = two_sum(f_hi, -inv_h2 * s_hi)
//   out   = r + ((f_lo - inv_h2 * (c_hi + s_lo)) + e1)
// on interior points, 0 on the boundary. inv_h2 is an exact power of
// two (h = 2^-k), so every scaling is exact.
//
// The TPU kernel carries the norm across its sequential grid in SMEM.
// Hopper blocks run in no order, so the norm here is a deterministic
// two-stage reduction: each block writes its partial sum (a fixed shared
// memory tree), then a second launch of one block sums the partials in a
// fixed order. No atomics, so the result is the same on every run.
// Partials are accumulated in f64: r * r of an f32 r is exact in f64, so
// the only rounding is in the sum, and the f32 result differs from the
// plain version only by the order of that sum.
//
// Bound: device-memory bytes, 20 per point at best (read u_hi, u_lo,
// f_hi, f_lo, write r), plus 8 bytes per 256 points of partials. One
// thread per point, k fastest, coalesced rows; the i +- 1 / j +- 1 rows
// of u_hi and u_lo come from L2 for the neighbouring blocks.
#include "stencil.cuh"

namespace {

constexpr int kReduceThreads = 1024;

// Knuth's error-free transformation: a + b = s + err exactly.
__device__ inline void two_sum(float a, float b, float& s, float& err) {
  s = a + b;
  const float bb = s - a;
  err = (a - (s - bb)) + (b - bb);
}

__device__ inline float eft_residual(const float* uh, const float* ul,
                                     float fh, float fl, int p, int n,
                                     float inv_h2) {
  const int nn = n * n;
  const float ch = uh[p];
  const float th[8] = {uh[p - nn], uh[p + nn], uh[p - n], uh[p + n],
                       uh[p - 1],  uh[p + 1],  -4.0f * ch, -2.0f * ch};
  float s_hi = th[0];
  float c_hi = 0.0f;
#pragma unroll
  for (int m = 1; m < 8; ++m) {
    float s, err;
    two_sum(s_hi, th[m], s, err);
    s_hi = s;
    c_hi = c_hi + err;
  }
  const float cl = ul[p];
  float s_lo = ul[p - nn];
  s_lo = s_lo + ul[p + nn];
  s_lo = s_lo + ul[p - n];
  s_lo = s_lo + ul[p + n];
  s_lo = s_lo + ul[p - 1];
  s_lo = s_lo + ul[p + 1];
  s_lo = s_lo + (-4.0f * cl);
  s_lo = s_lo + (-2.0f * cl);
  float r, e1;
  two_sum(fh, -inv_h2 * s_hi, r, e1);
  return r + ((fl - inv_h2 * (c_hi + s_lo)) + e1);
}

__global__ void residual_df_partials_kernel(
    float* __restrict__ out, double* __restrict__ partials,
    const float* __restrict__ uh, const float* __restrict__ ul,
    const float* __restrict__ fh, const float* __restrict__ fl, int n,
    float inv_h2) {
  __shared__ double acc[mg::kThreads];
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  int i, j, k;
  double rr = 0.0;
  if (mg::decode(p, n, i, j, k)) {
    float v = 0.0f;
    if (mg::is_interior(i, j, k, n)) {
      v = eft_residual(uh, ul, fh[p], fl[p], p, n, inv_h2);
    }
    out[p] = v;
    rr = (double)v * (double)v;
  }
  acc[threadIdx.x] = rr;
  __syncthreads();
  for (int w = mg::kThreads / 2; w > 0; w >>= 1) {
    if (threadIdx.x < w) acc[threadIdx.x] = acc[threadIdx.x] + acc[threadIdx.x + w];
    __syncthreads();
  }
  if (threadIdx.x == 0) partials[blockIdx.x] = acc[0];
}

__global__ void sum_partials_kernel(const double* __restrict__ partials,
                                    int m, float* __restrict__ nrm2) {
  __shared__ double acc[kReduceThreads];
  double s = 0.0;
  for (int q = threadIdx.x; q < m; q += kReduceThreads) s = s + partials[q];
  acc[threadIdx.x] = s;
  __syncthreads();
  for (int w = kReduceThreads / 2; w > 0; w >>= 1) {
    if (threadIdx.x < w) acc[threadIdx.x] = acc[threadIdx.x] + acc[threadIdx.x + w];
    __syncthreads();
  }
  if (threadIdx.x == 0) nrm2[0] = (float)acc[0];
}

}  // namespace

// Number of f64 partials the caller allocates for an n^3 field.
extern "C" int mg_residual_df_norm_partials(int n) {
  return mg::point_blocks(n);
}

extern "C" int mg_residual_df_norm(float* r, float* nrm2, double* partials,
                                   const float* u_hi, const float* u_lo,
                                   const float* f_hi, const float* f_lo,
                                   int n, float inv_h2, cudaStream_t stream) {
  const int blocks = mg::point_blocks(n);
  residual_df_partials_kernel<<<blocks, mg::kThreads, 0, stream>>>(
      r, partials, u_hi, u_lo, f_hi, f_lo, n, inv_h2);
  int err = (int)cudaGetLastError();
  if (err != 0) return err;
  sum_partials_kernel<<<1, kReduceThreads, 0, stream>>>(partials, blocks, nrm2);
  return (int)cudaGetLastError();
}
