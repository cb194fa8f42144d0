// Compensated (EFT) residual of a double-float solution on one rank's
// segmented block, and the rank's partial ||r||^2 (K32).
//
// Replaces the Pallas kernels multigrid_parallel_tpu/ops/pallas_sharded.py:
// residual_df_norm_ext and residual_df_norm_halo. The residual is K5's
// (residual_df_norm.cu: mg::eft_residual, the operation order of the JAX
// _eft_residual) on the rank's owned rows, the i neighbours of rows 0 and
// L - 1 from the one-plane halos of u_hi and u_lo, interior and pad masks
// on global plane indices; every owned point equals K5's on the whole
// field bit for bit. The partial sum is K5's deterministic two-stage f64
// reduction over the owned points only (block partials, then one block
// sums them in a fixed order), so it differs from K5's norm only by the
// order of the sum. The caller all-reduces the partials of the ranks.
//
// Bound: device-memory bytes, 20 per owned point at best (read u_hi,
// u_lo, f_hi, f_lo, write r), plus 8 bytes per 256 points of partials.
#include "eft.cuh"
#include "seg.cuh"

namespace {

__global__ void seg_residual_df_partials_kernel(float* __restrict__ out,
                                                double* __restrict__ partials, mg::Seg uh,
                                                mg::Seg ul, const float* __restrict__ fh,
                                                const float* __restrict__ fl, int n, int g0,
                                                int L, float inv_h2) {
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  int t, j, k, jk;
  double rr = 0.0;
  if (mg::decode_seg(p, L, 0, n, t, j, k, jk)) {
    float v = 0.0f;
    if (mg::is_interior(g0 + t, j, k, n)) {
      float nh[6], nl[6];
      mg::seg_load_nbrs(uh, t, jk, n, nh);
      mg::seg_load_nbrs(ul, t, jk, n, nl);
      v = mg::eft_residual(fh[p], fl[p], uh.row(t)[jk], nh, ul.row(t)[jk], nl, inv_h2);
    }
    out[p] = v;
    rr = (double)v * (double)v;
  }
  mg::block_partial(rr, partials);
}

}  // namespace

// Number of f64 partials the caller allocates for L owned planes of n^2.
extern "C" int mg_seg_residual_df_norm_partials(int L, int n) {
  return mg::seg_blocks(L, n * n);
}

// r (L, n, n) and nrm2 <- the compensated residual on the owned rows and
// its partial ||r||^2 (u_hi / u_lo segments with halo 1 on both sides;
// f_hi / f_lo the owned rows).
extern "C" int mg_seg_residual_df_norm(float* r, float* nrm2, double* partials, float* uh_lh,
                                       float* uh_body, float* uh_rh, int uh_roff,
                                       float* ul_lh, float* ul_body, float* ul_rh,
                                       int ul_roff, const float* f_hi, const float* f_lo,
                                       int L, int n, int g0, float inv_h2,
                                       cudaStream_t stream) {
  const int nn = n * n;
  const mg::Seg uh = mg::make_seg(uh_lh, uh_body, uh_rh, 1, L, 1, uh_roff, nn);
  const mg::Seg ul = mg::make_seg(ul_lh, ul_body, ul_rh, 1, L, 1, ul_roff, nn);
  const int blocks = mg::seg_blocks(L, nn);
  seg_residual_df_partials_kernel<<<blocks, mg::kThreads, 0, stream>>>(
      r, partials, uh, ul, f_hi, f_lo, n, g0, L, inv_h2);
  int err = (int)cudaGetLastError();
  if (err != 0) return err;
  sum_partials_kernel<<<1, mg::kReduceThreads, 0, stream>>>(partials, blocks, nrm2);
  return (int)cudaGetLastError();
}
