// Mixed-BC prolongation of the coarse correction, added to the fine one,
// and the black-first mixed smoothing stage on the result (K15), on the
// electrospray's full layout: one launch, one pass, a fresh fine (n, n, n)
// field from the coarse (nc, nc, nc) correction ec.
//
// Replaces the Pallas kernel multigrid_parallel_tpu/ops/pallas_mixed.py:
// mixed_prolong_smooth_fused (K15), which computes the black-first mixed
// stage of e + P ec in one pass: trilinear interpolation with the coarse
// BOUNDARY taking part (the mixed correction's Neumann boundaries are
// nonzero), j then k then i, then the folded half-sweeps (mixed.cuh) and
// one BC pass.
//
// The stage is rect.cuh's on the full layout (kMixed: the folded reads in
// the sweeps, the BC pass at store time, the z faces included; the
// wavefront, or up to 129^3 the box), black first, with K4's step
// (rect.cuh, ProlongPrep) as each plane of e arrives in shared memory:
// every point of the loaded box becomes e + P ec, computed once, from the
// coarse planes in a ring of 3 (the box holds all it needs), each coarse
// point read as it is stored, the live coarse boundary too. The fine
// boundary's e + P ec is never read (the selects) and the store overwrites
// it with its source's final value, so no BC pass is needed between the
// correction and the first half-sweep.
//
// Bound: device-memory bytes, those the function needs: e and r read, the
// output written, 12 B a fine point, ec read, 4 B a coarse point, and the
// pins of the two x faces (0.0635 ms at 257^3, 3.35 TB/s; chip_smoke.py,
// bound). The design answers the first form's costs (a correction launch
// that recomputed the interpolation of every neighbour of a black point,
// then 2 n_iter - 1 K13 half-sweep launches and a BC-pass launch): one
// pass, each corrected value computed once, neighbours from shared memory,
// one launch a call. n_iter > 2 continues with ceil(n_iter / 2) - 1
// launches of K14's stage kernel on its initial guess, black first
// (mixed_rb_smooth.cu, mg_mixed_stage), counted as K15's.
#include "mixed.cuh"
#include "rect.cuh"

namespace {

using namespace mg::rect;

template <int NITER, bool BOX>
__global__ void __launch_bounds__(kStageMaxThreads)
    mixed_prolong_stage_kernel(StageArgs a, ProlongPrep prep) {
  extern __shared__ __align__(16) float tile[];
  if constexpr (BOX) {
    box_body<NITER, false, Layout::kMixed>(a, tile, prep);
  } else {
    stage_body<NITER, false, Layout::kMixed>(a, tile, prep);
  }
}

template <int NITER>
int launch_mixed_prolong_stage(const StageArgs& a, int box, int threads, int smem,
                               cudaStream_t stream, const ProlongPrep& prep) {
  return box ? launch_stage(mixed_prolong_stage_kernel<NITER, true>, a, threads, smem, stream,
                            prep)
             : launch_stage(mixed_prolong_stage_kernel<NITER, false>, a, threads, smem, stream,
                            prep);
}

}  // namespace

// The K15 stage: out <- n_iter (1 or 2) black-first mixed RB-GS iterations
// of e + P ec against r, ending with the BC pass, on the plan (bi, bj, bk,
// k_halo, threads, smem, box) of pallas_split._stage_plan (rect, prolong).
// out must not alias e.
extern "C" int mg_mixed_prolong_stage(float* out, const float* ec, const float* e, const float* r,
                                      const float* pin, int n, float h2, int n_iter, int bi,
                                      int bj, int bk, int k_halo, int threads, int smem, int box,
                                      cudaStream_t stream) {
  StageArgs a{};
  a.out = out;
  a.in = e;
  a.f = r;
  a.pin = pin;
  a.color0 = mg::split::kBlack;
  a.n = n;
  a.h2 = h2;
  a.bi = bi;
  a.bj = bj;
  a.bk = bk;
  a.k_halo = k_halo;
  const int rows = coarse_rows(bj, 2 * n_iter), width = coarse_width(tile_width(n, bk, k_halo));
  const int depth = coarse_planes(bi, 2 * n_iter, box);
  if (n % 2 == 0 || e == nullptr || pin == nullptr) return (int)cudaErrorInvalidValue;
  if (const int err = stage_plan_error(a, n_iter, threads,
                                       smem - (long long)depth * rows * width * 4, box))
    return err;
  const ProlongPrep prep{ec, (n + 1) / 2, rows, width, depth, nullptr, 0, 0};
  return n_iter == 1 ? launch_mixed_prolong_stage<1>(a, box, threads, smem, stream, prep)
                     : launch_mixed_prolong_stage<2>(a, box, threads, smem, stream, prep);
}
