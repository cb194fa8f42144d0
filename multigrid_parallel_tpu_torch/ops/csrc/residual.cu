// Interior residual r = f - (1/h^2) (sum6(u) - 6 u), zero on the
// boundary, of an (n, n, n) f32 field.
//
// Replaces the Pallas kernel multigrid_parallel_tpu/ops/pallas3d.py:
// residual_fused_pipelined (R), the unfused half of K3.
//
// Bound: device-memory bytes, 12 per point at best (read u and f, write
// r). One thread per point, k fastest: the row loads of a warp are
// coalesced and the i +- 1 / j +- 1 rows are re-read from L2 by the
// neighbouring blocks, so the kernel streams each field about once.
//
// The second entry, K33, is the same residual on one rank's segmented
// block (seg.cuh), replacing multigrid_parallel_tpu/ops/pallas_sharded.py:
// residual_ext: the owned rows, the i neighbours of rows 0 and L - 1 from
// one-plane halos, interior on global plane indices; every owned point
// equals R's on the whole field bit for bit. As in the JAX package, no
// solve path launches it.
#include "seg.cuh"

namespace {

__global__ void residual_kernel(float* __restrict__ r,
                                const float* __restrict__ u,
                                const float* __restrict__ f, int n,
                                float inv_h2) {
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  int i, j, k;
  if (!mg::decode(p, n, i, j, k)) return;
  float v = 0.0f;
  if (mg::is_interior(i, j, k, n)) {
    const float nbr = mg::nbr_sum(u, p, n);
    v = f[p] - inv_h2 * (nbr - 6.0f * u[p]);
  }
  r[p] = v;
}

__global__ void seg_residual_kernel(float* __restrict__ r, mg::Seg u,
                                    const float* __restrict__ f, int n, int g0, int L,
                                    float inv_h2) {
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  int t, j, k, jk;
  if (!mg::decode_seg(p, L, 0, n, t, j, k, jk)) return;
  float v = 0.0f;
  if (mg::is_interior(g0 + t, j, k, n)) {
    const float nbr = mg::seg_nbr_sum(u, t, jk, n);
    v = f[p] - inv_h2 * (nbr - 6.0f * u.row(t)[jk]);
  }
  r[p] = v;
}

}  // namespace

extern "C" int mg_residual(float* r, const float* u, const float* f, int n,
                           float inv_h2, cudaStream_t stream) {
  residual_kernel<<<mg::point_blocks(n), mg::kThreads, 0, stream>>>(
      r, u, f, n, inv_h2);
  return (int)cudaGetLastError();
}

// K33: r (L, n, n) <- the residual on the owned rows of the segment u
// (halo 1 on both sides) against f's owned rows.
extern "C" int mg_seg_residual(float* r, float* u_lh, float* u_body, float* u_rh,
                               int u_roff, const float* f, int L, int n, int g0,
                               float inv_h2, cudaStream_t stream) {
  const int nn = n * n;
  const mg::Seg u = mg::make_seg(u_lh, u_body, u_rh, 1, L, 1, u_roff, nn);
  seg_residual_kernel<<<mg::seg_blocks(L, nn), mg::kThreads, 0, stream>>>(
      r, u, f, n, g0, L, inv_h2);
  return (int)cudaGetLastError();
}
