// Mixed-BC interior residual and full-weighting restriction in one kernel:
// split pair in (msplit.cuh), coarse FOLD RHS out (mixed.cuh: (nc, nc,
// nc - 2), slot a holding coarse plane kc = a + 1), nc = (n + 1) / 2,
// without the fine residual ever reaching device memory.
//
// Replaces the Pallas kernel multigrid_parallel_tpu/ops/pallas_mixed_split.py:
// residual_restrict_msplit (K23). Its operations in its order
// (pallas_mixed_split.py:567-599):
//   res(i, j, k) = r - inv_h2 * (nbr - 6 e),  nbr in mixed.cuh's order,
//       the i and j neighbours read from the stored boundary rows the BC
//       pass maintained, the k-edge reads folded to the centre;
//   k taps per fine row into coarse slot a: 0.25 (O[a] + O[a + 1]) +
//       0.5 E[a], O / E the colour holding the row's odd / even k's, i.e.
//       0.25 (res(2a + 1) + res(2a + 3)) + 0.5 res(2a + 2);
//   then the 3-tap weights along i, then along j, each (0.25 a + 0.5 b) +
//       0.25 c (the TPU kernel applies the j taps as an MXU band product in
//       the compiler's sum order).
// Coarse points on the x and y faces are 0; every stored coarse k is
// interior. The coarse field is indexed by its own shape: the fine pair
// has S = (n - 1) / 2 slots and the coarse fold nc - 2 = S - 1 (the TPU's
// 128-lane round-up makes the two widths equal there).
//
// One thread per stored coarse point; its 27 fine residuals lie on the
// fine interior (216 loads, mostly from L1/L2, as K18). Bound: device-
// memory bytes, 8 B per fine grid point (the e and r pairs read once)
// plus 4 B per coarse point written.
#include "msplit.cuh"

namespace {

using mg::msplit::PairAt;

__device__ inline float tap3(float a, float b, float c) {
  return (0.25f * a + 0.5f * b) + 0.25f * c;
}

__device__ inline float residual(const PairAt& e, const PairAt& r, int i, int j, int k,
                                 int n, float inv_h2) {
  const float cen = e(i, j, k);
  float s = e(i - 1, j, k);
  s = s + e(i + 1, j, k);
  s = s + e(i, j - 1, k);
  s = s + e(i, j + 1, k);
  s = s + (k == 1 ? cen : e(i, j, k - 1));
  s = s + (k == n - 2 ? cen : e(i, j, k + 1));
  return r(i, j, k) - inv_h2 * (s - 6.0f * cen);
}

__global__ void residual_restrict_msplit_kernel(float* __restrict__ out,
                                                const float* __restrict__ er,
                                                const float* __restrict__ eb,
                                                const float* __restrict__ rr,
                                                const float* __restrict__ rb, int n,
                                                float inv_h2) {
  const int nc = (n + 1) / 2;
  const int q = blockIdx.x * blockDim.x + threadIdx.x;
  int ci, cj, ck;
  if (!mg::decode_fold(q, nc, ci, cj, ck)) return;
  if (!mg::is_interior_ij(ci, cj, nc)) {
    out[q] = 0.0f;
    return;
  }
  const PairAt e{er, eb, n}, r{rr, rb, n};
  const int k0 = 2 * ck - 1;  // fine k of the coarse plane's lower tap
  float y[3];
#pragma unroll
  for (int dj = 0; dj < 3; ++dj) {
    const int j = 2 * cj - 1 + dj;
    float t[3];
#pragma unroll
    for (int di = 0; di < 3; ++di) {
      const int i = 2 * ci - 1 + di;
      const float lo = residual(e, r, i, j, k0, n, inv_h2);
      const float mid = residual(e, r, i, j, k0 + 1, n, inv_h2);
      const float hi = residual(e, r, i, j, k0 + 2, n, inv_h2);
      t[di] = 0.25f * (lo + hi) + 0.5f * mid;  // k taps
    }
    y[dj] = tap3(t[0], t[1], t[2]);  // i taps
  }
  out[q] = tap3(y[0], y[1], y[2]);  // j taps
}

}  // namespace

extern "C" int mg_msplit_residual_restrict(float* out, const float* er, const float* eb,
                                           const float* rr, const float* rb, int n,
                                           float inv_h2, cudaStream_t stream) {
  residual_restrict_msplit_kernel<<<mg::fold_blocks((n + 1) / 2), mg::kThreads, 0,
                                    stream>>>(out, er, eb, rr, rb, n, inv_h2);
  return (int)cudaGetLastError();
}
