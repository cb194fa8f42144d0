// Compensated (EFT) residual of a double-float solution on one rank's
// segmented block, and the rank's partial ||r||^2 (K32, and K41 on an
// (i, j) block).
//
// Replaces the Pallas kernels multigrid_parallel_tpu/ops/pallas_sharded.py:
// residual_df_norm_ext and residual_df_norm_halo, and their (i, j) twins
// of pallas_sharded2d.py, residual_df_norm_ext2d and
// residual_df_norm_halo2d. The residual is K5's (residual_df_norm.cu:
// mg::eft_residual, the operation order of the JAX _eft_residual) on the
// rank's owned points, the neighbours across the block's edges from the
// one-deep halos of u_hi and u_lo, interior and pad masks on global
// indices; every owned point equals K5's on the whole field bit for bit.
// The partial sum is K5's deterministic two-stage f64 reduction over the
// owned points only (block partials, then one block sums them in a fixed
// order), so it differs from K5's norm only by the order of the sum. The
// caller all-reduces the partials of the ranks.
//
// Bound: device-memory bytes, 20 per owned point at best (read u_hi,
// u_lo, f_hi, f_lo, write r), plus 8 bytes per 256 points of partials.
#include "eft.cuh"
#include "seg2d.cuh"

namespace {

template <class S>
__global__ void seg_residual_df_partials_kernel(float* __restrict__ out,
                                                double* __restrict__ partials, S uh, S ul, S fh,
                                                S fl, mg::Span sp, int n, int g0, int gj0,
                                                float inv_h2) {
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  int t, j, k;
  double rr = 0.0;
  if (mg::decode_span(p, sp, n, t, j, k)) {
    float v = 0.0f;
    if (mg::is_interior(g0 + t, gj0 + j, k, n)) {
      float nh[6], nl[6];
      mg::load_nbrs_at(uh, t, j, k, n, nh);
      mg::load_nbrs_at(ul, t, j, k, n, nl);
      v = mg::eft_residual(mg::seg_at(fh, t, j, n)[k], mg::seg_at(fl, t, j, n)[k],
                           mg::seg_at(uh, t, j, n)[k], nh, mg::seg_at(ul, t, j, n)[k], nl,
                           inv_h2);
    }
    out[p] = v;
    rr = (double)v * (double)v;
  }
  mg::block_partial(rr, partials);
}

template <class S>
int launch_residual_df_norm(float* r, float* nrm2, double* partials, const S& uh, const S& ul,
                            const S& fh, const S& fl, const mg::Span& sp, int n, int g0,
                            int gj0, float inv_h2, cudaStream_t stream) {
  const int blocks = mg::span_blocks(sp, n);
  seg_residual_df_partials_kernel<<<blocks, mg::kThreads, 0, stream>>>(
      r, partials, uh, ul, fh, fl, sp, n, g0, gj0, inv_h2);
  int err = (int)cudaGetLastError();
  if (err != 0) return err;
  sum_partials_kernel<<<1, mg::kReduceThreads, 0, stream>>>(partials, blocks, nrm2);
  return (int)cudaGetLastError();
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
  float* fh = const_cast<float*>(f_hi);
  float* fl = const_cast<float*>(f_lo);
  const mg::Seg fhs = mg::make_seg(fh, fh, fh, 0, L, 0, 0, nn);  // owned rows only
  const mg::Seg fls = mg::make_seg(fl, fl, fl, 0, L, 0, 0, nn);
  return launch_residual_df_norm(r, nrm2, partials, uh, ul, fhs, fls, mg::Span{0, L, 0, n}, n,
                                 g0, 0, inv_h2, stream);
}

// Number of f64 partials K41 takes for an (L, Lj, n) block.
extern "C" int mg_seg2d_residual_df_norm_partials(int L, int Lj, int n) {
  return mg::span_blocks(mg::Span{0, L, 0, Lj}, n);
}

// K41: r (L, Lj, n) and nrm2 <- the same on (i, j) descriptors: u_hi /
// u_lo with halo 1 in i and j, f_hi / f_lo (only their owned points are
// read); (g0, gj0) = global indices of body row and column 0.
extern "C" int mg_seg2d_residual_df_norm(float* r, float* nrm2, double* partials,
                                         const long long* uh_desc, const long long* ul_desc,
                                         const long long* fh_desc, const long long* fl_desc,
                                         int L, int Lj, int n, int g0, int gj0, float inv_h2,
                                         cudaStream_t stream) {
  return launch_residual_df_norm(
      r, nrm2, partials, mg::seg2_from_desc(uh_desc, L, Lj), mg::seg2_from_desc(ul_desc, L, Lj),
      mg::seg2_from_desc(fh_desc, L, Lj), mg::seg2_from_desc(fl_desc, L, Lj),
      mg::Span{0, L, 0, Lj}, n, g0, gj0, inv_h2, stream);
}
