// The electrospray fold layout's mixed-BC smoothing, on (n, n, n - 2) f32
// correction fields (mixed.cuh: stored slot kk holds grid plane k = kk +
// 1): the one-pass stage of K16 and K17.
//
// Replaces the Pallas kernels multigrid_parallel_tpu/ops/pallas_mixed_fold.py:
// mixed_rb_smooth_fold (K16) and mixed_rb_smooth_from_zero_fold (K17).
// Those run all 2 * n_iter half-sweeps of a stage in one pass over HBM
// with the copy-BC folded into the stencil, then one BC pass without z
// faces.
//
// Both are launches of rect.cuh's stage on the fold layout (kFold; the
// wavefront, or up to 129^3 the box; the plan pallas_split._stage_plan,
// rect), n_iter <= 2 a launch, into a fresh field. K17's tile starts as
// zeros (the folded reads of a zero field are zero); K16's is loaded from
// the field so far (ZERO false), as are the launches past the first of a
// K17 or K19 call (n_iter > 2). Every half-sweep reads the neighbours
// across a face as the reader's own value (0 at a pinned x-face node), so
// only the loaded interior counts: a given field's x and y faces are never
// read. The BC pass is the stage's store: each stored boundary node gets
// u[c(i), c(j), kk], or 0 at a pinned x-face node, from its source's final
// value. Bound: device-memory bytes, r read and the output written (and
// K16's field read), 8 B (12 B) a stored point, the pins of the two x
// faces read (K17 0.0404 ms at 257^3, 3.35 TB/s; chip_smoke.py, bound).
//
// K16's first form, one in-place launch a half-sweep and a BC-pass
// launch, gave way to the stage: one launch a call where it took five.
#include "rect.cuh"

namespace {

template <int NITER, bool ZERO, bool BOX>
__global__ void __launch_bounds__(mg::rect::kStageMaxThreads)
    fold_stage_kernel(mg::rect::StageArgs a) {
  extern __shared__ __align__(16) float tile[];
  if constexpr (BOX) {
    mg::rect::box_body<NITER, ZERO, mg::rect::Layout::kFold>(a, tile, mg::split::NoPrep{});
  } else {
    mg::rect::stage_body<NITER, ZERO, mg::rect::Layout::kFold>(a, tile,
                                                               mg::split::NoPrep{});
  }
}

template <int NITER, bool ZERO>
int launch_fold_stage(const mg::rect::StageArgs& a, int box, int threads, int smem,
                      cudaStream_t stream) {
  using mg::rect::launch_stage;
  return box ? launch_stage(fold_stage_kernel<NITER, ZERO, true>, a, threads, smem, stream)
             : launch_stage(fold_stage_kernel<NITER, ZERO, false>, a, threads, smem, stream);
}

}  // namespace

// The fold stage (K17 where u is null; K16, and K17's and K19's launches
// past the first, where u is given): out <- n_iter (1 or 2) mixed RB-GS
// iterations of u (a zero field where u is null) against r, red first or
// black first, ending with the fold BC pass, on the plan (bi, bj, bk,
// k_halo, threads, smem, box) of pallas_split._stage_plan (rect). Only
// u's interior is read. out must not alias u.
extern "C" int mg_fold_stage(float* out, const float* u, const float* r, const float* pin, int n,
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
  if (pin == nullptr) return (int)cudaErrorInvalidValue;
  if (const int err = stage_plan_error(a, n_iter, threads, smem, box)) return err;
  if (u == nullptr) {
    return n_iter == 1 ? launch_fold_stage<1, true>(a, box, threads, smem, stream)
                       : launch_fold_stage<2, true>(a, box, threads, smem, stream);
  }
  return n_iter == 1 ? launch_fold_stage<1, false>(a, box, threads, smem, stream)
                     : launch_fold_stage<2, false>(a, box, threads, smem, stream);
}
