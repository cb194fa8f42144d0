// Interior residual and full-weighting restriction in one kernel, fold
// layout in and out: fine (n, n, n - 2) e, r -> coarse (nc, nc, nc - 2)
// RHS, nc = (n + 1) / 2 (mixed.cuh: stored slot kk holds grid plane
// k = kk + 1), without the fine residual ever reaching device memory.
//
// Replaces the Pallas kernel multigrid_parallel_tpu/ops/pallas_mixed_fold.py:
// residual_restrict_fold (K18), which is K3 (residual_restrict.cu) with
// the k-edge reads folded: the k - 1 neighbour of a point at k = 1 and
// the k + 1 neighbour of one at k = n-2 are k-face nodes, not stored,
// whose BC value is the reader's own. The i and j neighbours read the
// stored x and y faces the smoother's BC pass maintained. The same
// operations in the same order as K3:
//   rr(q)  = r[q] - inv_h2 * (nbr_sum(e, q) - 6 e[q])
//   then the 3-tap [1/4, 1/2, 1/4] weights along i, then j, then k, each
//   as (0.25 a + 0.5 b) + 0.25 c, left to right.
// (The TPU kernel applies the j and k taps as MXU band products in the
// compiler's sum order.) Coarse points on the x and y faces are 0; every
// stored coarse k is interior.
//
// One thread per stored coarse point, k fastest; its 27 fine residuals
// lie on the fine interior, 216 loads mostly from L1/L2, as K3. Bound:
// device-memory bytes, 8 B per stored fine point (e and r read once)
// plus 4 B per coarse point written.
#include "mixed.cuh"

namespace {

__device__ inline float tap3(float a, float b, float c) {
  return (0.25f * a + 0.5f * b) + 0.25f * c;
}

__global__ void residual_restrict_fold_kernel(float* __restrict__ out,
                                              const float* __restrict__ e,
                                              const float* __restrict__ r, int n,
                                              float inv_h2) {
  const int nc = (n + 1) / 2;
  const int q = blockIdx.x * blockDim.x + threadIdx.x;
  int ci, cj, ck;
  if (!mg::decode_fold(q, nc, ci, cj, ck)) return;
  if (!mg::is_interior_ij(ci, cj, nc)) {
    out[q] = 0.0f;
    return;
  }
  const int nk = n - 2, ni = n * nk;
  // i taps first: plane[dj][dk] combines fine planes 2ci-1, 2ci, 2ci+1
  float plane[3][3];
#pragma unroll
  for (int dj = 0; dj < 3; ++dj) {
#pragma unroll
    for (int dk = 0; dk < 3; ++dk) {
      const int k = 2 * ck - 1 + dk;  // grid plane, 1 .. n-2
      float rr[3];
#pragma unroll
      for (int di = 0; di < 3; ++di) {
        const int p = (2 * ci - 1 + di) * ni + (2 * cj - 1 + dj) * nk + (k - 1);
        const float cen = e[p];
        float s = e[p - ni];
        s = s + e[p + ni];
        s = s + e[p - nk];
        s = s + e[p + nk];
        s = s + (k == 1 ? cen : e[p - 1]);
        s = s + (k == n - 2 ? cen : e[p + 1]);
        rr[di] = r[p] - inv_h2 * (s - 6.0f * cen);
      }
      plane[dj][dk] = tap3(rr[0], rr[1], rr[2]);
    }
  }
  // then j, then k
  float y[3];
#pragma unroll
  for (int dk = 0; dk < 3; ++dk) y[dk] = tap3(plane[0][dk], plane[1][dk], plane[2][dk]);
  out[q] = tap3(y[0], y[1], y[2]);
}

}  // namespace

extern "C" int mg_residual_restrict_fold(float* out, const float* e, const float* r,
                                         int n, float inv_h2, cudaStream_t stream) {
  residual_restrict_fold_kernel<<<mg::fold_blocks((n + 1) / 2), mg::kThreads, 0,
                                  stream>>>(out, e, r, n, inv_h2);
  return (int)cudaGetLastError();
}
