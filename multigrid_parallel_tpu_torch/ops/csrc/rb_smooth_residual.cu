// A red-black smoothing stage and the residual of its result, on an (n, n,
// n) f32 field (K26).
//
// Replaces the Pallas kernel multigrid_parallel_tpu/ops/pallas3d.py:
// rb_smooth_residual_fused_padded (K26), which runs all 2 * n_iter
// half-sweeps of a pre-smoothing stage and the residual of the smoothed
// field in one pass (halo 2 * n_iter + 1 planes in VMEM) and writes
// (u', r).
//
// K26 is one launch of rect.cuh's stage for n_iter <= 2 (RESID: K1's
// stage with u loaded, the wavefront, or up to 129^3 the box), into two
// fresh fields: u' and r = f - (1/h^2)(sum6(u') - 6 u') on the interior, 0
// on the boundary, where u' keeps u. u is only read. The stage's halos are
// one deeper than K1's (H + 1 = 2 n_iter + 1 planes, rows and k_halo >= H +
// 1 slots), so both colours are final one point past the owned box, and
// each plane's residual is taken from the tile a step after the next
// plane's last half-sweep (rect.cuh, the header); the neighbours are
// summed in ops3.neighbor_sum's order, so (u', r) equal K1's u' and R's
// residual of it bit for bit. The plan is pallas_split._stage_plan(...,
// rect=True, resid=True). n_iter > 2: K1's stage launches for the leading
// chunks of pallas_split._stage_chunks, then this one for the last, all
// counted as K26's. Bound: device-memory bytes, u and f read, u' and r
// written, 16 bytes a point (0.0811 ms at 257^3, 3.35 TB/s).
//
// Its first form (2 n_iter - 1 in-place half-sweeps of K1's per-sweep
// kernel, then one launch that swept the last colour in place and wrote r,
// recomputing each neighbour of the other colour) is gone: on a copy of u,
// which the fresh (u', r) contract needs, it took more device time than
// the stage at every size 9^3-513^3 but 33^3, where they tie (PERF.md).
#include "rect.cuh"

namespace {

template <int NITER, bool BOX>
__global__ void __launch_bounds__(mg::rect::kStageMaxThreads)
    rect_resid_stage_kernel(mg::rect::ResidStageArgs a) {
  extern __shared__ __align__(16) float tile[];
  using mg::rect::Layout;
  if constexpr (BOX) {
    mg::rect::box_body<NITER, false, Layout::kRect, true>(a, tile, mg::split::NoPrep{});
  } else {
    mg::rect::stage_body<NITER, false, Layout::kRect, true>(a, tile, mg::split::NoPrep{});
  }
}

template <int NITER>
int launch_resid_stage(const mg::rect::ResidStageArgs& a, int box, int threads, int smem,
                       cudaStream_t stream) {
  using mg::rect::launch_stage;
  return box ? launch_stage(rect_resid_stage_kernel<NITER, true>, a, threads, smem, stream)
             : launch_stage(rect_resid_stage_kernel<NITER, false>, a, threads, smem, stream);
}

}  // namespace

// The K26 stage: out <- n_iter (1 or 2) RB-GS iterations of u against f,
// red first or black first, and r <- the interior residual of out (0 on
// the boundary), on the plan (bi, bj, bk, k_halo, threads, smem, box) of
// pallas_split._stage_plan (rect, resid). out and r must meet neither each
// other nor u or f.
extern "C" int mg_rect_resid_stage(float* out, float* r, const float* u, const float* f, int n,
                                   float h2, float inv_h2, int red_first, int n_iter, int bi,
                                   int bj, int bk, int k_halo, int threads, int smem, int box,
                                   cudaStream_t stream) {
  const long long size = (long long)n * n * n;
  if (u == nullptr || mg::meet(out, size, r, size) || mg::meet(out, size, u, size) ||
      mg::meet(out, size, f, size) || mg::meet(r, size, u, size) || mg::meet(r, size, f, size))
    return (int)cudaErrorInvalidValue;
  mg::rect::ResidStageArgs a{};
  a.out = out;
  a.r = r;
  a.in = u;
  a.f = f;
  a.color0 = red_first ? mg::split::kRed : mg::split::kBlack;
  a.n = n;
  a.h2 = h2;
  a.inv_h2 = inv_h2;
  a.bi = bi;
  a.bj = bj;
  a.bk = bk;
  a.k_halo = k_halo;
  if (const int err = mg::rect::stage_plan_error(a, n_iter, threads, smem, box,
                                                 mg::rect::kStageMaxThreads, true))
    return err;
  return n_iter == 1 ? launch_resid_stage<1>(a, box, threads, smem, stream)
                     : launch_resid_stage<2>(a, box, threads, smem, stream);
}
