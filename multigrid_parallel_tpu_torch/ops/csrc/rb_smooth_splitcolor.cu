// Red-black Gauss-Seidel smoothing stage on a packed split-colour array
// (K42), and its first form, one launch a half-sweep.
//
// Replaces the Pallas kernel multigrid_parallel_tpu/ops/pallas_splitcolor.py:
// rb_smooth_split_fused, which runs all 2 * n_iter half-sweeps of a stage
// in one pass over HBM (a slab of block_i + 4 n_iter planes in VMEM).
//
// The packed array is one contiguous f32 tensor (n, 2n, S), S = (n - 1) / 2:
// the split pair of split.cuh joined along j, red rows [0, n), black rows
// [n, 2n). Flat index ((i * 2n + half * n + j) * S + kk), half 0 = red,
// 1 = black. The i +- 1 neighbours are +- 2nS away, j +- 1 are +- S, and
// the other colour at the same (i, j, kk) is +- nS. Slot map, parity,
// liveness and the dead-slot invariant are the pair's (split.cuh).
//
// K42 is one launch of split.cuh's stage_body for n_iter <= 2 with K7's
// schedule and K7's plan (pallas_split._stage_plan): each colour of the
// packed array is a pair colour of (n, n, S) planes whose plane pitch is
// 2 n S floats (PACKED, split.cuh row_at), at base offsets 0 (red) and n S
// (black). The stage writes a fresh array; its input is only read (blocks'
// loaded halos overlap other blocks' owned boxes, so in place would race).
// The half-sweeps take K42's order of additions, i - 1, i + 1, j - 1,
// j + 1 left to right, then the same-slot value and the other k neighbour
// summed first and added as one term (tile_nbr_sum<true>), which keeps the
// stage bit for bit with the plain version; every slot a half-sweep does
// not update (dead slots, boundary rows) keeps its loaded value, so the
// pair's invariant and the zero k faces carry over. n_iter > 2 is
// ceil(n_iter / 2) launches, each on the array so far. Bound: device-memory
// bytes, as K7's: the fresh array written, the second colour read whole,
// of the first only what no half-sweep rewrites, of f its live slots
// (utils.timing.split_stage_bytes, packed): 0.0506 ms at 257^3 and
// 3.35 TB/s.
//
// The first form (pallas_splitcolor.rb_smooth_split_fused_per_sweep, the
// stage bench's per-sweep row) runs one launch per half-sweep, in place (a
// colour reads only the other colour), one thread per slot of the active
// colour, kk fastest: 6 B per grid point a launch, twice the one-pass
// stage's bytes at n_iter = 2.
#include "split.cuh"

namespace {

using namespace mg::split;

// split.cuh numbers the colours RED = 1, BLACK = 0; the packed layout puts
// red first. This is the one place that maps a colour to its half.
__host__ __device__ inline int packed_half(int color) {
  return color == kRed ? 0 : 1;
}

__global__ void splitcolor_half_sweep_kernel(float* __restrict__ u,
                                             const float* __restrict__ f,
                                             int n, float h2, int color) {
  const int S = slots(n);
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  int i, j, kk;
  if (!decode(idx, n, S, i, j, kk)) return;
  const int p = parity(i, j, color);
  if (!live_interior(i, j, kk, p, n)) return;
  const int half = packed_half(color);
  const int nS = n * S;
  const int pos = (i * 2 * n + half * n + j) * S + kk;
  const int o = half == 0 ? pos + nS : pos - nS;  // the other colour, same slot
  // k-neighbours: the other colour at {kk - 1, kk} where p = 0 and
  // {kk, kk + 1} where p = 1; past either end of the row, the zero k face
  float k_other;
  if (p == 0) {
    k_other = kk > 0 ? u[o - 1] : 0.0f;
  } else {
    k_other = kk + 1 < S ? u[o + 1] : 0.0f;
  }
  // the Pallas splitcolor order: i - 1, i + 1, j - 1, j + 1 left to right,
  // then the k pair summed first and added as one term
  float s = u[o - 2 * nS] + u[o + 2 * nS];
  s = s + u[o - S];
  s = s + u[o + S];
  s = s + (u[o] + k_other);
  u[pos] = (s - h2 * f[pos]) * (1.0f / 6.0f);
}

template <int NITER, bool VEC>
__global__ void __launch_bounds__(kStageMaxThreads) splitcolor_stage_kernel(StageArgs a) {
  extern __shared__ __align__(16) float tile[];
  stage_body<NITER, VEC, false, false, true>(a, tile, NoPrep{});
}

}  // namespace

// One in-place half-sweep of `color` (1 = RED, 0 = BLACK) on the packed
// array u with its packed RHS f (K42's first form).
extern "C" int mg_splitcolor_half_sweep(float* u, const float* f, int n, float h2,
                                        int color, cudaStream_t stream) {
  splitcolor_half_sweep_kernel<<<mg::split::slot_blocks(n), mg::kThreads, 0, stream>>>(
      u, f, n, h2, color);
  return (int)cudaGetLastError();
}

// The K42 stage: n_iter (1 or 2) RB-GS iterations of the packed array u
// against f, red first or black first, into the fresh packed array out, on
// K7's plan (bi, bj, bk, k_halo, threads, smem) of pallas_split._stage_plan.
// out must meet neither u nor f.
extern "C" int mg_splitcolor_stage(float* out, const float* u, const float* f, int n, float h2,
                                   int red_first, int n_iter, int bi, int bj, int bk, int k_halo,
                                   int threads, int smem, cudaStream_t stream) {
  const long long nS = (long long)n * slots(n), size = 2 * n * nS;
  if (mg::meet(out, size, u, size) || mg::meet(out, size, f, size))
    return (int)cudaErrorInvalidValue;
  StageArgs a{};
  a.color0 = red_first ? kRed : kBlack;
  for (int c = 0; c < 2; ++c) {  // by stage colour: [0] the first half-sweep's
    const long long base = packed_half(c ? 1 - a.color0 : a.color0) * nS;
    a.out[c] = out + base;
    a.in[c] = u + base;
    a.f[c] = f + base;
  }
  a.n = n;
  a.h2 = h2;
  a.bi = bi;
  a.bj = bj;
  a.bk = bk;
  a.k_halo = k_halo;
  if (const int err = stage_plan_error(a, n_iter, threads, smem)) return err;
  const bool vec = stage_vec(a);
  if (n_iter == 1) {
    return vec ? launch_stage(splitcolor_stage_kernel<1, true>, a, threads, smem, stream)
               : launch_stage(splitcolor_stage_kernel<1, false>, a, threads, smem, stream);
  }
  return vec ? launch_stage(splitcolor_stage_kernel<2, true>, a, threads, smem, stream)
             : launch_stage(splitcolor_stage_kernel<2, false>, a, threads, smem, stream);
}
