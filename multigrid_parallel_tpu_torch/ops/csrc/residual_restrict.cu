// Interior residual and full-weighting restriction in one kernel: fine
// (n, n, n) e, r -> coarse (nc, nc, nc) RHS, nc = (n + 1) / 2, without
// the fine residual ever reaching device memory.
//
// Replaces the Pallas kernel multigrid_parallel_tpu/ops/pallas3d.py:
// residual_restrict_fused_padded (K3), in its operation order:
//   rr(q)  = r[q] - inv_h2 * (nbr_sum(e, q) - 6 e[q])   (R, zero off the interior)
//   then the 3-tap [1/4, 1/2, 1/4] weights along i, then j, then k, each
//   as (0.25 a + 0.5 b) + 0.25 c, left to right.
// The TPU kernel applies the j and k taps as band-matrix products on its
// MXU, whose sum order is the compiler's; this kernel, and its plain
// version, fix the left-to-right order above. The 0.25 / 0.5 scalings
// are exact, so each 3-tap rounds twice. The taps are computed here, in
// the kernel's own body (no library matrix product). Coarse points on
// the coarse boundary are 0 (correction semantics).
//
// One thread per coarse point, k fastest. An interior coarse point
// combines the 27 fine residuals of its (2c-1 .. 2c+1)^3 cone; all of
// them lie on the fine interior. Each fine residual reads 7 points of e
// and one of r, so a thread makes 216 loads, most of which hit L1/L2
// (neighbouring threads share the cone's faces). Bound: those loads
// through L1 rather than device memory, whose floor here is 8 B per fine
// point (e and r read once) plus 4 B per coarse point written. The
// unfused R moves 12 B per fine point and the three matrix products of
// the restriction read and write the residual again.
#include "stencil.cuh"

namespace {

__device__ inline float tap3(float a, float b, float c) {
  return (0.25f * a + 0.5f * b) + 0.25f * c;
}

__global__ void residual_restrict_kernel(float* __restrict__ out,
                                         const float* __restrict__ e,
                                         const float* __restrict__ r, int n,
                                         float inv_h2) {
  const int nc = (n + 1) / 2;
  const int q = blockIdx.x * blockDim.x + threadIdx.x;
  int ci, cj, ck;
  if (!mg::decode(q, nc, ci, cj, ck)) return;
  if (!mg::is_interior(ci, cj, ck, nc)) {
    out[q] = 0.0f;
    return;
  }
  const int nn = n * n;
  // i taps first: plane[dj][dk] combines fine planes 2ci-1, 2ci, 2ci+1
  float plane[3][3];
#pragma unroll
  for (int dj = 0; dj < 3; ++dj) {
#pragma unroll
    for (int dk = 0; dk < 3; ++dk) {
      float rr[3];
#pragma unroll
      for (int di = 0; di < 3; ++di) {
        const int p = (2 * ci - 1 + di) * nn + (2 * cj - 1 + dj) * n + (2 * ck - 1 + dk);
        rr[di] = r[p] - inv_h2 * (mg::nbr_sum(e, p, n) - 6.0f * e[p]);
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

extern "C" int mg_residual_restrict(float* out, const float* e, const float* r,
                                    int n, float inv_h2, cudaStream_t stream) {
  residual_restrict_kernel<<<mg::point_blocks((n + 1) / 2), mg::kThreads, 0,
                             stream>>>(out, e, r, n, inv_h2);
  return (int)cudaGetLastError();
}
