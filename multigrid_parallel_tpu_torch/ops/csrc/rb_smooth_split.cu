// Red-black Gauss-Seidel smoothing stage on a split-colour pair (K7), the
// same stage from a zero pair (K8), and K7's per-sweep form (split.cuh).
//
// Replaces the Pallas kernels multigrid_parallel_tpu/ops/pallas_split.py:
// rb_smooth_split (K7, :406) and rb_smooth_split_from_zero (K8, :434),
// which run all 2 * n_iter half-sweeps of a stage in one pass over HBM,
// whole (j, k) planes in VMEM with a trapezoidal halo of 2 * 2 * n_iter
// planes (:414).
//
// K7 is one launch of stage_body (split.cuh) for n_iter <= 2: one pass
// over device memory. Bound: device-memory bytes, those the function needs
// (chip_smoke.split_stage_bytes, in 32-byte sectors): the fresh pair
// written and the second colour read whole, of each f its live slots, and
// of the first colour only what no half-sweep rewrites (boundary rows and
// dead slots, 4.6% of it): 169.6 MB at 257^3, 0.0506 ms at 3.35 TB/s; the
// arithmetic (8 f32 operations a point and half-sweep) is two orders of
// magnitude under that. What the design does about the
// per-sweep form's costs (K7's first form, one launch a half-sweep, still
// here as mg_split_half_sweep, the stage bench's yardstick):
//  - Passes. The per-sweep form read the other colour and f and wrote the
//    active colour in each of its 2 n_iter launches: 406 MB a call at
//    n_iter 2. Here a block streams its box of planes through rings in
//    shared memory and runs every half-sweep there (temporal blocking):
//    it reads its box with halos of 2 n_iter rows and planes once, f once
//    a half-sweep of its colour (from L2 after the first), and writes its
//    box once. It reads the first colour whole, 33.8 MB more than the
//    bound counts: a loader of only its fixed slots (K10's) spilled 8
//    bytes in the n_iter 2, 16-byte instantiation and took 0.1725 against
//    0.1472 ms a call in the split solve (utils/split_trace.py, both
//    builds in one call on an H100 80GB HBM3 at 700 W). The halos cost: at 257^3, n_iter 2, a block of 12 rows x 43
//    planes reads 20 x 51 of each colour.
//  - Neighbour loads. The six neighbours of a slot come from the tile, 16
//    bytes a lane, consecutive across a warp; the per-sweep form read them
//    from L1 / L2, its i +- 1 neighbours a plane (131 KB) away.
//  - Latency. cp.async fetches plane p + 1 of both colours while the block
//    sweeps; the skewed wavefront makes a step's half-sweeps independent
//    (two barriers a step, not one a half-sweep), and each warp's f rows
//    are fetched into registers a step ahead.
//  - Launches. One a call, not 2 n_iter: the solve is host-launch bound.
// What still bounds it on the card (timed with phases cut out of the
// kernel): the tile's compute, about two thirds of the time at 257^3, a
// warp a tile row doing ~110 instructions for 4 slots of one half-sweep,
// latency-bound between the step's barriers with one block of 20 warps an
// SM (the rings take ~220 KB); then the device-memory traffic, which the
// halos inflate: a block reads 20 rows x 51 planes for its 12 x 43.
// The plan (block box, halos, threads, shared memory) is computed in
// Python (pallas_split._stage_plan), where the CPU tests check it: at
// 257^3, n_iter 2, 12 rows x whole k rows x 43 planes a block, 640
// threads, 225,280 B of shared memory, 132 blocks. n_iter > 2 is
// ceil(n_iter / 2) launches, ping-ponging pairs.
// nvcc -Xptxas -v (CUDA 12.8, sm_90a; launch bound 640 threads): the four
// split_stage_kernel instantiations 82-96 registers, no spills; shared
// memory all dynamic, the plan's (225,280 B at 257^3, n_iter 2).
//
// K8 is the same launch with the template's ZERO set
// (mg_split_stage_from_zero): nothing is read from an initial pair, both
// colours' tile planes start as zeros (zero-filling cp.async, as K2's rect
// tile), so half-sweep 1 computes (+0 - h^2 f) (1/6) at every live slot,
// as the plain version does from a zero pair, and every other slot (dead
// slots, boundary rows) is written out as 0: the fresh pair needs no
// initialising. Bound: device-memory bytes, the live slots of each f read
// and the pair written (chip_smoke.split_stage_bytes, from_zero): 134.2 MB
// at 257^3, 0.0401 ms at 3.35 TB/s. Its first form was four
// launches a call at n_iter 2, a half-sweep from zero, a fresh one and two
// in place, each a pass over a colour, f and the other colour. n_iter > 2:
// the first launch from zero, then K7 stage launches on the pair so far.
#include "split.cuh"

namespace {

using namespace mg::split;

__global__ void split_half_sweep_kernel(float* __restrict__ dst,
                                        const float* __restrict__ src,
                                        const float* __restrict__ f, int n,
                                        float h2, int color) {
  const int S = slots(n);
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  int i, j, kk;
  if (!decode(idx, n, S, i, j, kk)) return;
  const int p = parity(i, j, color);
  if (live_interior(i, j, kk, p, n)) dst[idx] = sweep_value(src, f, idx, n, S, kk, p, h2);
}

template <int NITER, bool VEC, bool ZERO>
__global__ void __launch_bounds__(kStageMaxThreads) split_stage_kernel(StageArgs a) {
  extern __shared__ __align__(16) float tile[];
  stage_body<NITER, VEC, ZERO>(a, tile, NoPrep{});
}

// The stage's arguments by stage colour ([0] the first half-sweep's); er
// and eb null for a zero initial pair.
StageArgs stage_args(float* out_r, float* out_b, const float* er, const float* eb,
                     const float* fr, const float* fb, int n, float h2, int red_first, int bi,
                     int bj, int bk, int k_halo) {
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
  a.color0 = c0;
  a.n = n;
  a.h2 = h2;
  a.bi = bi;
  a.bj = bj;
  a.bk = bk;
  a.k_halo = k_halo;
  return a;
}

template <bool ZERO>
int launch_split_stage(const StageArgs& a, int n_iter, int threads, int smem,
                       cudaStream_t stream) {
  if (const int err = stage_plan_error(a, n_iter, threads, smem)) return err;
  const bool vec = stage_vec(a);
  if (n_iter == 1) {
    return vec ? launch_stage(split_stage_kernel<1, true, ZERO>, a, threads, smem, stream)
               : launch_stage(split_stage_kernel<1, false, ZERO>, a, threads, smem, stream);
  }
  return vec ? launch_stage(split_stage_kernel<2, true, ZERO>, a, threads, smem, stream)
             : launch_stage(split_stage_kernel<2, false, ZERO>, a, threads, smem, stream);
}

}  // namespace

// The K7 stage: n_iter (1 or 2) RB-GS iterations of (er, eb) against (fr,
// fb), red first or black first, into the fresh pair (out_r, out_b), on
// the plan (bi, bj, bk, k_halo, threads, smem) of pallas_split._stage_plan.
extern "C" int mg_split_stage(float* out_r, float* out_b, const float* er, const float* eb,
                              const float* fr, const float* fb, int n, float h2,
                              int red_first, int n_iter, int bi, int bj, int bk, int k_halo,
                              int threads, int smem, cudaStream_t stream) {
  return launch_split_stage<false>(
      stage_args(out_r, out_b, er, eb, fr, fb, n, h2, red_first, bi, bj, bk, k_halo), n_iter,
      threads, smem, stream);
}

// The K8 stage: the K7 stage from a zero initial pair, on the same plan;
// every slot of (out_r, out_b) written.
extern "C" int mg_split_stage_from_zero(float* out_r, float* out_b, const float* fr,
                                        const float* fb, int n, float h2, int red_first,
                                        int n_iter, int bi, int bj, int bk, int k_halo,
                                        int threads, int smem, cudaStream_t stream) {
  return launch_split_stage<true>(
      stage_args(out_r, out_b, nullptr, nullptr, fr, fb, n, h2, red_first, bi, bj, bk, k_halo),
      n_iter, threads, smem, stream);
}

// One in-place half-sweep of `color` (1 = RED, 0 = BLACK): dst (that
// colour) from src (the other colour) and f (dst's RHS), its live interior
// slots only. K7's per-sweep form (pallas_split.rb_smooth_split_per_sweep,
// the stage bench's yardstick).
extern "C" int mg_split_half_sweep(float* dst, const float* src, const float* f,
                                   int n, float h2, int color, cudaStream_t stream) {
  split_half_sweep_kernel<<<mg::split::slot_blocks(n), mg::kThreads, 0, stream>>>(
      dst, src, f, n, h2, color);
  return (int)cudaGetLastError();
}
