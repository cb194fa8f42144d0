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
// version, fix the left-to-right order above. The taps are computed here,
// in the kernel's own body (no library matrix product). Coarse points on
// the coarse boundary are 0 (correction semantics).
//
// The kernel is restrict.cuh's streaming stage on a plain field (Rect):
// as the Pallas kernel streams a slab of 2 bi + 3 fine planes through
// VMEM, a block streams its cone's fine planes through a ring in shared
// memory, computes each fine residual once, keeps the i taps' partial
// sums in registers and writes only the coarse RHS. Bound: device memory,
// 8 B a fine point read and 4 B a coarse point written (restrict.cuh).
#include "restrict.cuh"

namespace {

using mg::restriction::Args;

template <int C>
__global__ void __launch_bounds__(mg::restriction::kMaxThreads, 2) rect_restrict_kernel(Args a) {
  extern __shared__ __align__(16) float tile[];
  mg::restriction::restrict_body<mg::restriction::Rect, C>(a, tile);
}

}  // namespace

// out <- the coarse RHS of (e, r) on the plan (bci, bcj, bck, chunks,
// threads, smem) of pallas_split._restrict_plan; out must not alias e or r.
extern "C" int mg_residual_restrict(float* out, const float* e, const float* r, int n,
                                    float inv_h2, int bci, int bcj, int bck, int chunks,
                                    int threads, int smem, cudaStream_t stream) {
  using namespace mg::restriction;
  const Args a{out, {e, nullptr}, {r, nullptr}, n, inv_h2, bci, bcj, bck, 0};
  if (const int err = plan_error(a, false, chunks, threads, smem)) return err;
  return chunks == 1 ? launch(rect_restrict_kernel<1>, a, threads, smem, stream)
                     : launch(rect_restrict_kernel<kMaxChunks>, a, threads, smem, stream);
}
