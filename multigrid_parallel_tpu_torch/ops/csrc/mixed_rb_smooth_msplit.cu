// The mixed-BC red-black Gauss-Seidel smoothing stage on a split pair
// (msplit.cuh) from a zero pair (K22) or from a loaded one (K21).
//
// Replaces the Pallas kernels multigrid_parallel_tpu/ops/pallas_mixed_split.py:
// mixed_rb_smooth_from_zero_msplit (K22, :479 -> :394) and
// mixed_rb_smooth_msplit (K21, :448 -> :394), which run all 2 * n_iter
// half-sweeps of a stage in one pass over HBM, then the BC pass.
//
// K22 is one launch of split.cuh's stage_body with MIXED and ZERO set
// (mg_msplit_stage with no initial pair), on K8's plan (pallas_split.
// _stage_plan with msplit; up to 65^3 the fewest-steps plan, _steps_plan):
// all 2 n_iter half-sweeps of a call on tiles of both colours in shared
// memory, the faces' neighbours as selects of the slot's own value (0 at a
// pinned x-face node) in mixed_nbr_sum's order, so the iterates equal the
// fold's (K16, K17) bit for bit, and the cross-colour BC pass done at
// store time: a fresh pair, bit for bit the plain version's. The tile
// planes start as zeros, so a select returns +0 and half-sweep 1 computes
// (+0 - h^2 f) (1/6), as the plain version does from a zero pair.
// K21 is the same launch with the pair loaded (ZERO false, the same
// plan) at every size: its tiles start as e, and since every neighbour across a face is a
// select and every stored face row and dead slot is written by the
// store's BC pass, only e's live interior slots reach the output,
// whatever its boundary rows and dead slots hold (the plain version's
// BC pass before its sweeps discards them too). n_iter > 2:
// ceil(n_iter / 2) launches, each later one the stage on the pair so far
// (K22's and K24's later launches too). K22's first form was 2 n_iter + 1
// launches a call, each a pass over the pair: a from-zero half-sweep,
// 2 n_iter - 1 half-sweeps in place and the BC pass; K21's, 2 n_iter
// half-sweeps in place and the BC pass. Below 257^3 the stage takes more
// device time than those five passes (device ms a call at n_iter 2, one
// NVIDIA H100 80GB HBM3 at 700 W, utils/stage_plans.py: 0.0148 against
// 0.0072 at 9^3, 0.0652 against 0.0409 at 129^3; 0.1678 against 0.2835 at
// 257^3), but it is one launch instead of five, and the electrospray's
// small levels are launch- and host-bound (PERF.md).
// Bound: device-memory bytes (chip_smoke.bound: each input read once, the
// output written once): f and the pin packs read, the pair written, 135.8
// MB at 257^3, 0.0405 ms at 3.35 TB/s. The arithmetic (8 f32 operations a
// point and half-sweep, and the selects) is two orders of magnitude under.
// What the mixed mode costs over K8's stage, and what the design does:
// the selects. Rows with a face neighbour in i or j (j = 1, n - 2, planes
// 1, n - 2) are a warp-uniform branch of their own, and the k-edge selects
// (slots 0 and S - 1 of the rows of parity 0) are folded into the loads of
// the k neighbours, so the other rows sum as K8 does: a select in every
// slot's six terms took 0.1815 ms a call at 257^3 in the solve, this form
// 0.1583 (PERF.md). The store writes both colours of a plane at one step.
// nvcc -Xptxas -v (CUDA 12.8, sm_90a; launch bound 640 threads): the eight
// msplit_stage_kernel instantiations 67-96 registers, no spills, no stack
// frame; shared memory all dynamic, the plan's (225,280 B at 257^3,
// n_iter 2).
#include "msplit.cuh"

namespace {

using namespace mg::split;

template <int NITER, bool VEC, bool ZERO>
__global__ void __launch_bounds__(kStageMaxThreads) msplit_stage_kernel(StageArgs a) {
  extern __shared__ __align__(16) float tile[];
  stage_body<NITER, VEC, ZERO, true>(a, tile, NoPrep{});
}

template <bool ZERO>
int launch_msplit_stage(const StageArgs& a, int n_iter, int threads, int smem,
                        cudaStream_t stream) {
  if (const int err = stage_plan_error(a, n_iter, threads, smem)) return err;
  const bool vec = stage_vec(a);
  if (n_iter == 1) {
    return vec ? launch_stage(msplit_stage_kernel<1, true, ZERO>, a, threads, smem, stream)
               : launch_stage(msplit_stage_kernel<1, false, ZERO>, a, threads, smem, stream);
  }
  return vec ? launch_stage(msplit_stage_kernel<2, true, ZERO>, a, threads, smem, stream)
             : launch_stage(msplit_stage_kernel<2, false, ZERO>, a, threads, smem, stream);
}

}  // namespace

// The mixed-BC stage on a pair: n_iter (1 or 2) RB-GS iterations of (er,
// eb) against (fr, fb), red first or black first, with the x-face pins
// `packs`, into the fresh pair (out_r, out_b), the BC pass done at store
// time; er and eb null for a zero initial pair (K22), else the pair
// loaded (K21, and the later launches of a K22 or K24 call). The plan (bi,
// bj, bk, k_halo, threads, smem) is pallas_split._stage_plan's with
// msplit; cudaErrorInvalidValue for another, or for an output that meets
// an input or the other output.
extern "C" int mg_msplit_stage(float* out_r, float* out_b, const float* er, const float* eb,
                               const float* fr, const float* fb, const float* packs, int n,
                               float h2, int red_first, int n_iter, int bi, int bj, int bk,
                               int k_halo, int threads, int smem, cudaStream_t stream) {
  const long long count = (long long)n * n * slots(n), pack = 4LL * n * slots(n);
  for (const float* o : {out_r, out_b})
    for (const float* in : {er, eb, fr, fb})
      if (mg::meet(o, count, in, count)) return (int)cudaErrorInvalidValue;
  if (mg::meet(out_r, count, out_b, count) || mg::meet(out_r, count, packs, pack) ||
      mg::meet(out_b, count, packs, pack))
    return (int)cudaErrorInvalidValue;
  StageArgs a;
  const int c0 = red_first ? kRed : kBlack;
  float* out[2] = {out_b, out_r};  // by colour: [kBlack], [kRed]
  const float* in[2] = {eb, er};
  const float* f[2] = {fb, fr};
  for (int c = 0; c < 2; ++c) {
    const int color = c ? 1 - c0 : c0;
    a.out[c] = out[color];
    a.in[c] = in[color];
    a.f[c] = f[color];
  }
  a.packs = packs;
  a.color0 = c0;
  a.n = n;
  a.h2 = h2;
  a.bi = bi;
  a.bj = bj;
  a.bk = bk;
  a.k_halo = k_halo;
  return er ? launch_msplit_stage<false>(a, n_iter, threads, smem, stream)
            : launch_msplit_stage<true>(a, n_iter, threads, smem, stream);
}
