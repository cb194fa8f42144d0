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
// Two forms, one launch a call each, both bit for bit the plain version:
// - the streaming stage (restrict.cuh's Fold layout, on the plan of
//   pallas_split._restrict_plan): e and r through rings in shared memory,
//   each fine residual computed once, the i taps' partial sums in
//   registers, only the coarse RHS written; the levels from
//   pallas_split.FOLD_RESTRICT_STAGE_MIN_N up, where it is the faster.
// - the first form below that: one thread per stored coarse point, k
//   fastest; its 27 fine residuals lie on the fine interior, 216 loads
//   mostly from L1/L2, as K3's first form. On a small level a launch is
//   latency: the stage's prologue and 2 bci + 1 barrier steps cost more
//   than the loads they save.
// Bound: device-memory bytes, 8 B per stored fine point (e and r read
// once) plus 4 B per coarse point written.
#include "mixed.cuh"
#include "restrict.cuh"

namespace {

using mg::restriction::Args;
using mg::restriction::tap3;

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

template <int C>
__global__ void __launch_bounds__(mg::restriction::kMaxThreads, 2) fold_restrict_kernel(Args a) {
  extern __shared__ __align__(16) float tile[];
  mg::restriction::restrict_body<mg::restriction::Fold, C>(a, tile);
}

}  // namespace

// The first form: out <- the coarse fold RHS of (e, r), one thread a
// stored coarse point.
extern "C" int mg_residual_restrict_fold(float* out, const float* e, const float* r,
                                         int n, float inv_h2, cudaStream_t stream) {
  residual_restrict_fold_kernel<<<mg::fold_blocks((n + 1) / 2), mg::kThreads, 0,
                                  stream>>>(out, e, r, n, inv_h2);
  return (int)cudaGetLastError();
}

// The streaming stage: out <- the coarse fold RHS of (e, r) on the plan
// (bci, bcj, bck, chunks, threads, smem) of pallas_split._restrict_plan
// (fold); out must not alias e or r.
extern "C" int mg_fold_residual_restrict(float* out, const float* e, const float* r, int n,
                                         float inv_h2, int bci, int bcj, int bck, int chunks,
                                         int threads, int smem, cudaStream_t stream) {
  using namespace mg::restriction;
  const Args a{out, {e, nullptr}, {r, nullptr}, n, inv_h2, bci, bcj, bck, 0};
  if (const int err = plan_error(a, false, chunks, threads, smem)) return err;
  return chunks == 1 ? launch(fold_restrict_kernel<1>, a, threads, smem, stream)
                     : launch(fold_restrict_kernel<kMaxChunks>, a, threads, smem, stream);
}
