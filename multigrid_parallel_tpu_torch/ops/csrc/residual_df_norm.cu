// Compensated (EFT) residual of a double-float solution plus ||r||^2
// (K5), and the same residual alone (K27).
//
// Replaces the Pallas kernels multigrid_parallel_tpu/ops/pallas3d.py:
// residual_df_norm_fused_padded (K5) and residual_df_fused_padded (K27,
// K5 without the norm: one launch that writes r and skips the partial
// sums). Both compute the compensated residual of
// u = u_hi + u_lo against f = f_hi + f_lo (mg::eft_residual in eft.cuh,
// the operation order of the JAX _eft_residual) on interior points, 0 on
// the boundary.
//
// The TPU kernel carries the norm across its sequential grid in SMEM.
// Hopper blocks run in no order, so the norm here is a deterministic
// two-stage reduction (eft.cuh): each block writes its partial sum (a
// fixed shared memory tree), then a second launch of one block sums the
// partials in a fixed order. No atomics, so the result is the same on
// every run.
// Partials are accumulated in f64: r * r of an f32 r is exact in f64, so
// the only rounding is in the sum, and the f32 result differs from the
// plain version only by the order of that sum.
//
// Bound: device-memory bytes, 20 per point at best (read u_hi, u_lo,
// f_hi, f_lo, write r), plus 8 bytes per 256 points of partials. One
// thread per point, k fastest, coalesced rows; the i +- 1 / j +- 1 rows
// of u_hi and u_lo come from L2 for the neighbouring blocks.
#include "eft.cuh"

namespace {

__global__ void residual_df_partials_kernel(
    float* __restrict__ out, double* __restrict__ partials,
    const float* __restrict__ uh, const float* __restrict__ ul,
    const float* __restrict__ fh, const float* __restrict__ fl, int n,
    float inv_h2) {
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  int i, j, k;
  double rr = 0.0;
  if (mg::decode(p, n, i, j, k)) {
    float v = 0.0f;
    if (mg::is_interior(i, j, k, n)) {
      float nh[6], nl[6];
      mg::load_nbrs(uh, p, n, nh);
      mg::load_nbrs(ul, p, n, nl);
      v = mg::eft_residual(fh[p], fl[p], uh[p], nh, ul[p], nl, inv_h2);
    }
    out[p] = v;
    rr = (double)v * (double)v;
  }
  mg::block_partial(rr, partials);
}

__global__ void residual_df_kernel(float* __restrict__ out, const float* __restrict__ uh,
                                   const float* __restrict__ ul,
                                   const float* __restrict__ fh,
                                   const float* __restrict__ fl, int n, float inv_h2) {
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  int i, j, k;
  if (!mg::decode(p, n, i, j, k)) return;
  float v = 0.0f;
  if (mg::is_interior(i, j, k, n)) {
    float nh[6], nl[6];
    mg::load_nbrs(uh, p, n, nh);
    mg::load_nbrs(ul, p, n, nl);
    v = mg::eft_residual(fh[p], fl[p], uh[p], nh, ul[p], nl, inv_h2);
  }
  out[p] = v;
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
  sum_partials_kernel<<<1, mg::kReduceThreads, 0, stream>>>(partials, blocks, nrm2);
  return (int)cudaGetLastError();
}

// K27: the compensated residual alone, r as K5 writes it.
extern "C" int mg_residual_df(float* r, const float* u_hi, const float* u_lo,
                              const float* f_hi, const float* f_lo, int n, float inv_h2,
                              cudaStream_t stream) {
  residual_df_kernel<<<mg::point_blocks(n), mg::kThreads, 0, stream>>>(
      r, u_hi, u_lo, f_hi, f_lo, n, inv_h2);
  return (int)cudaGetLastError();
}
