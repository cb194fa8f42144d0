// The electrospray full tier's mixed-BC smoothing on (n, n, n) f32
// correction fields: one one-pass stage for K13 (from a loaded correction)
// and K14 (from zero).
//
// Replaces the Pallas kernels multigrid_parallel_tpu/ops/pallas_mixed.py:
// mixed_rb_smooth_fused (K13) and mixed_rb_smooth_from_zero_fused (K14).
// Those run all 2 * n_iter half-sweeps of a stage in one pass over HBM
// with the copy-BC folded into the stencil (mixed.cuh), then one BC pass.
//
// Each is one launch of rect.cuh's stage on the full layout (kMixed; the
// wavefront, or up to 129^3 the box; the plan pallas_split._stage_plan,
// rect) for n_iter <= 2, into a fresh field: the tile loaded from u (K13)
// or starting as zeros (K14; the folded reads of a zero field are zero),
// every half-sweep reads the neighbours across a face as the reader's own
// value (0 at a pinned x-face node), never the tile's k-face slots (which
// hold u's loaded faces for K13), and the BC pass is the stage's store:
// each boundary node, the z faces too, gets u[c(i), c(j), c(k)], or 0 at a
// pinned x-face node, from its source's final value. n_iter > 2 is
// ceil(n_iter / 2) launches, each later one the same stage on the field so
// far (mixed_stage_kernel, ZERO false). Bound: device-memory bytes, r read
// and the output written, 8 B a point (12 B for K13, u read too), the pins
// of the two x faces read (K14 0.0407 ms at 257^3, 3.35 TB/s; chip_smoke.py,
// bound). The design answers the first forms' costs (a launch a half-sweep
// of ~10 B a point each, in place, and a BC-pass launch, ~40 B a point at
// n_iter 2): one pass, the half-sweeps in shared memory.
#include "mixed.cuh"
#include "rect.cuh"

namespace {

template <int NITER, bool ZERO, bool BOX>
__global__ void __launch_bounds__(mg::rect::kStageMaxThreads)
    mixed_stage_kernel(mg::rect::StageArgs a) {
  extern __shared__ __align__(16) float tile[];
  if constexpr (BOX) {
    mg::rect::box_body<NITER, ZERO, mg::rect::Layout::kMixed>(a, tile, mg::split::NoPrep{});
  } else {
    mg::rect::stage_body<NITER, ZERO, mg::rect::Layout::kMixed>(a, tile,
                                                                mg::split::NoPrep{});
  }
}

template <int NITER, bool ZERO>
int launch_mixed_stage(const mg::rect::StageArgs& a, int box, int threads, int smem,
                       cudaStream_t stream) {
  using mg::rect::launch_stage;
  return box ? launch_stage(mixed_stage_kernel<NITER, ZERO, true>, a, threads, smem, stream)
             : launch_stage(mixed_stage_kernel<NITER, ZERO, false>, a, threads, smem, stream);
}

}  // namespace

// The full-layout mixed stage (K13 where u is given, and the launches past
// the first of K13, K14 and K15; K14 where u is null): out <- n_iter (1 or
// 2) mixed RB-GS iterations of u (a zero field where u is null) against r,
// red first or black first, ending with the BC pass, on the plan (bi, bj,
// bk, k_halo, threads, smem, box) of pallas_split._stage_plan (rect). out
// must meet neither u nor r.
extern "C" int mg_mixed_stage(float* out, const float* u, const float* r, const float* pin, int n,
                              float h2, int red_first, int n_iter, int bi, int bj, int bk,
                              int k_halo, int threads, int smem, int box, cudaStream_t stream) {
  using namespace mg::rect;
  StageArgs a{};
  a.out = out;
  a.in = u;
  a.f = r;
  a.pin = pin;
  a.color0 = red_first ? mg::split::kRed : mg::split::kBlack;
  a.n = n;
  a.h2 = h2;
  a.bi = bi;
  a.bj = bj;
  a.bk = bk;
  a.k_halo = k_halo;
  const long long count = (long long)n * n * n;
  if (out == nullptr || r == nullptr || pin == nullptr || mg::meet(out, count, r, count) ||
      (u != nullptr && mg::meet(out, count, u, count)))
    return (int)cudaErrorInvalidValue;
  if (const int err = stage_plan_error(a, n_iter, threads, smem, box)) return err;
  if (u == nullptr) {
    return n_iter == 1 ? launch_mixed_stage<1, true>(a, box, threads, smem, stream)
                       : launch_mixed_stage<2, true>(a, box, threads, smem, stream);
  }
  return n_iter == 1 ? launch_mixed_stage<1, false>(a, box, threads, smem, stream)
                     : launch_mixed_stage<2, false>(a, box, threads, smem, stream);
}
