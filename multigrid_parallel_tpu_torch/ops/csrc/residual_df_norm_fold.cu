// Compensated (EFT) residual of a double-float solution plus ||r||^2, on
// the fold layout (mixed.cuh: (n, n, n - 2), slot kk holding grid plane
// k = kk + 1).
//
// Replaces the Pallas kernel multigrid_parallel_tpu/ops/pallas_mixed_fold.py:
// residual_df_norm_fold (K20), which is K5 (residual_df_norm.cu) with the
// k-edge reads folded: the k - 1 neighbour of a point at k = 1 and the
// k + 1 neighbour of one at k = n-2 are the point's own hi and lo values
// (exact Neumann copies, so exact in double-float too). The i and j
// neighbours read the stored x and y faces, which hold the live Dirichlet
// patch values. The residual is eft.cuh's mg::eft_residual on interior
// points (every stored k; i, j interior), 0 on the stored x and y faces;
// the norm is K5's deterministic two-stage f64 sum (eft.cuh), so the same
// on every run.
//
// Bound: device-memory bytes, 20 per stored point at best (read u_hi,
// u_lo, f_hi, f_lo, write r), plus 8 bytes per 256 points of partials.
// One thread per stored point, k fastest, coalesced rows, as K5.
#include "eft.cuh"
#include "mixed.cuh"

namespace {

// The six face neighbours of the point at flat index p, grid plane k, in
// nbr_sum order, the k-edge reads folded to the point's own value.
__device__ inline void load_fold_nbrs(const float* u, int p, int n, int k,
                                      float (&v)[6]) {
  const int nk = n - 2, ni = n * nk;
  v[0] = u[p - ni];
  v[1] = u[p + ni];
  v[2] = u[p - nk];
  v[3] = u[p + nk];
  v[4] = k == 1 ? u[p] : u[p - 1];
  v[5] = k == n - 2 ? u[p] : u[p + 1];
}

__global__ void residual_df_fold_partials_kernel(
    float* __restrict__ out, double* __restrict__ partials,
    const float* __restrict__ uh, const float* __restrict__ ul,
    const float* __restrict__ fh, const float* __restrict__ fl, int n,
    float inv_h2) {
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  int i, j, k;
  double rr = 0.0;
  if (mg::decode_fold(p, n, i, j, k)) {
    float v = 0.0f;
    if (mg::is_interior_ij(i, j, n)) {
      float nh[6], nl[6];
      load_fold_nbrs(uh, p, n, k, nh);
      load_fold_nbrs(ul, p, n, k, nl);
      v = mg::eft_residual(fh[p], fl[p], uh[p], nh, ul[p], nl, inv_h2);
    }
    out[p] = v;
    rr = (double)v * (double)v;
  }
  mg::block_partial(rr, partials);
}

}  // namespace

// Number of f64 partials the caller allocates for an n-point fold field.
extern "C" int mg_residual_df_norm_fold_partials(int n) {
  return mg::fold_blocks(n);
}

extern "C" int mg_residual_df_norm_fold(float* r, float* nrm2, double* partials,
                                        const float* u_hi, const float* u_lo,
                                        const float* f_hi, const float* f_lo,
                                        int n, float inv_h2, cudaStream_t stream) {
  const int blocks = mg::fold_blocks(n);
  residual_df_fold_partials_kernel<<<blocks, mg::kThreads, 0, stream>>>(
      r, partials, u_hi, u_lo, f_hi, f_lo, n, inv_h2);
  int err = (int)cudaGetLastError();
  if (err != 0) return err;
  sum_partials_kernel<<<1, mg::kReduceThreads, 0, stream>>>(partials, blocks, nrm2);
  return (int)cudaGetLastError();
}
