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
#include "stencil.cuh"

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

}  // namespace

extern "C" int mg_residual(float* r, const float* u, const float* f, int n,
                           float inv_h2, cudaStream_t stream) {
  residual_kernel<<<mg::point_blocks(n), mg::kThreads, 0, stream>>>(
      r, u, f, n, inv_h2);
  return (int)cudaGetLastError();
}
