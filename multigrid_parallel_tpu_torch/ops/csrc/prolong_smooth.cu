// Trilinear prolongation of the coarse correction, added to the fine
// correction, and the black-first RB smoothing stage on the result (K4):
// one launch, one pass, a fresh fine field.
//
// Replaces the Pallas kernel multigrid_parallel_tpu/ops/pallas3d.py:
// prolong_smooth_fused_padded (K4, :1075), which computes rb_smooth(e + P
// ec, r, h, n_iter, black first) in one pass over HBM.
//
// The stage is rect.cuh's tile body (black first; the wavefront, or up to
// 129^3 the box) with one step more as each plane of e arrives in shared
// memory: every point of the loaded box, of both colours and on the
// boundary too, becomes e + P ec, computed once (the plain version adds P
// ec everywhere and keeps the boundary values).
//
// That step is rect.cuh's ProlongPrep, which K15 (mixed_prolong_smooth.cu)
// shares: interpolation in mg::interp_at's order, j, then k, then i, one
// rounding a step, from the coarse planes in a ring of 3 in shared memory.
//
// Bound: device-memory bytes, those the function needs: e and r read, the
// output written, 12 B a fine point, and ec read, 4 B a coarse point:
// 212.3 MB at 257^3, 0.0634 ms at 3.35 TB/s (chip_smoke.py, bound). The
// design answers the first form's costs (a correction launch that
// recomputed the interpolation of every neighbour of a black point, six
// times a point, then 2 n_iter - 1 K1 half-sweep launches, each a pass over
// e, r and the field): one pass, each corrected value computed once,
// neighbours from shared memory, one launch a call. n_iter > 2 continues
// with ceil(n_iter / 2) - 1 launches of K2's stage kernel on its initial
// guess, black first (rb_smooth.cu, mg_rect_stage), counted as K4's.
#include "rect.cuh"

namespace {

using namespace mg::rect;

template <int NITER, bool BOX>
__global__ void __launch_bounds__(kStageMaxThreads) rect_prolong_stage_kernel(StageArgs a,
                                                                              ProlongPrep prep) {
  extern __shared__ __align__(16) float tile[];
  if constexpr (BOX) {
    box_body<NITER, false>(a, tile, prep);
  } else {
    stage_body<NITER, false>(a, tile, prep);
  }
}

template <int NITER>
int launch_prolong_stage(const StageArgs& a, int box, int threads, int smem, cudaStream_t stream,
                         const ProlongPrep& prep) {
  return box ? launch_stage(rect_prolong_stage_kernel<NITER, true>, a, threads, smem, stream, prep)
             : launch_stage(rect_prolong_stage_kernel<NITER, false>, a, threads, smem, stream,
                            prep);
}

}  // namespace

// The K4 stage: out <- n_iter (1 or 2) black-first RB-GS iterations of e +
// P ec against r, on the plan (bi, bj, bk, k_halo, threads, smem, box) of
// pallas_split._stage_plan (rect, prolong). out must not alias e.
extern "C" int mg_rect_prolong_stage(float* out, const float* ec, const float* e, const float* r,
                                     int n, float h2, int n_iter, int bi, int bj, int bk,
                                     int k_halo, int threads, int smem, int box,
                                     cudaStream_t stream) {
  StageArgs a{};
  a.out = out;
  a.in = e;
  a.f = r;
  a.color0 = mg::split::kBlack;
  a.n = n;
  a.h2 = h2;
  a.bi = bi;
  a.bj = bj;
  a.bk = bk;
  a.k_halo = k_halo;
  const int rows = coarse_rows(bj, 2 * n_iter), width = coarse_width(tile_width(n, bk, k_halo));
  const int depth = coarse_planes(bi, 2 * n_iter, box);
  if (n % 2 == 0 || e == nullptr) return (int)cudaErrorInvalidValue;
  if (const int err = stage_plan_error(a, n_iter, threads,
                                       smem - (long long)depth * rows * width * 4, box))
    return err;
  const ProlongPrep prep{ec, (n + 1) / 2, rows, width, depth, nullptr, 0, 0};
  return n_iter == 1 ? launch_prolong_stage<1>(a, box, threads, smem, stream, prep)
                     : launch_prolong_stage<2>(a, box, threads, smem, stream, prep);
}
