// Compensated (EFT) residual of a double-float solution pair plus ||r||^2,
// on split pairs of the mixed-BC solve (msplit.cuh).
//
// Replaces the Pallas kernel multigrid_parallel_tpu/ops/pallas_mixed_split.py:
// residual_df_norm_msplit (K25), which reaches pl.pallas_call through
// pallas_split.py's streaming template: K12 (df_split.cu) with K20's edge
// rule. The six neighbours come in mixed.cuh's order (i-1, i+1, j-1, j+1,
// k-1, k+1, pallas_mixed_split.py:897-905): the i and j neighbours read
// the stored x and y boundary rows (the outer step's BC pass holds the live
// Dirichlet patch values there), the k-edge reads fold to the point's own
// hi and lo values (exact Neumann copies, so exact in double-float too).
// The residual is eft.cuh's mg::eft_residual at live interior slots, 0
// elsewhere; one thread per slot computes both colours there, and the
// norm is K5's deterministic two-stage f64 sum of r_red^2 + r_black^2.
//
// Bound: device-memory bytes, 20 B per grid point of the pair at best
// (read the u and f pairs, write r), plus 8 bytes per 256 slots of
// partials. The neighbour rows come from L1/L2.
#include "eft.cuh"
#include "msplit.cuh"

namespace {

using namespace mg::split;
using mg::msplit::PairAt;

// The six neighbours of grid point (i, j, k), the k-edge reads folded.
__device__ inline void load_pair_nbrs(const PairAt& u, int i, int j, int k, int n,
                                      float cen, float (&v)[6]) {
  v[0] = u(i - 1, j, k);
  v[1] = u(i + 1, j, k);
  v[2] = u(i, j - 1, k);
  v[3] = u(i, j + 1, k);
  v[4] = k == 1 ? cen : u(i, j, k - 1);
  v[5] = k == n - 2 ? cen : u(i, j, k + 1);
}

__global__ void msplit_residual_df_partials_kernel(
    float* __restrict__ r_r, float* __restrict__ r_b, double* __restrict__ partials,
    const float* __restrict__ uhr, const float* __restrict__ uhb,
    const float* __restrict__ ulr, const float* __restrict__ ulb,
    const float* __restrict__ fhr, const float* __restrict__ fhb,
    const float* __restrict__ flr, const float* __restrict__ flb, int n, float inv_h2) {
  const int S = slots(n);
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  int i, j, kk;
  double rr = 0.0;
  if (decode(idx, n, S, i, j, kk)) {
    const PairAt uh{uhr, uhb, n}, ul{ulr, ulb, n};
    float v[2];
#pragma unroll
    for (int c = 0; c < 2; ++c) {  // c = 0: red, 1: black
      const int p = parity(i, j, c == 0 ? kRed : kBlack);
      v[c] = 0.0f;
      if (live_interior(i, j, kk, p, n)) {
        const int k = 2 * kk + 1 + p;
        const float ch = (c == 0 ? uhr : uhb)[idx], cl = (c == 0 ? ulr : ulb)[idx];
        float nh[6], nl[6];
        load_pair_nbrs(uh, i, j, k, n, ch, nh);
        load_pair_nbrs(ul, i, j, k, n, cl, nl);
        v[c] = mg::eft_residual((c == 0 ? fhr : fhb)[idx], (c == 0 ? flr : flb)[idx], ch, nh,
                                cl, nl, inv_h2);
      }
    }
    r_r[idx] = v[0];
    r_b[idx] = v[1];
    rr = (double)v[0] * (double)v[0] + (double)v[1] * (double)v[1];
  }
  mg::block_partial(rr, partials);
}

}  // namespace

// Number of f64 partials the caller allocates for an n-point pair.
extern "C" int mg_msplit_residual_df_norm_partials(int n) { return mg::split::slot_blocks(n); }

extern "C" int mg_msplit_residual_df_norm(
    float* r_r, float* r_b, float* nrm2, double* partials, const float* u_hr,
    const float* u_hb, const float* u_lr, const float* u_lb, const float* f_hr,
    const float* f_hb, const float* f_lr, const float* f_lb, int n, float inv_h2,
    cudaStream_t stream) {
  const int blocks = mg::split::slot_blocks(n);
  msplit_residual_df_partials_kernel<<<blocks, mg::kThreads, 0, stream>>>(
      r_r, r_b, partials, u_hr, u_hb, u_lr, u_lb, f_hr, f_hb, f_lr, f_lb, n, inv_h2);
  int err = (int)cudaGetLastError();
  if (err != 0) return err;
  sum_partials_kernel<<<1, mg::kReduceThreads, 0, stream>>>(partials, blocks, nrm2);
  return (int)cudaGetLastError();
}
