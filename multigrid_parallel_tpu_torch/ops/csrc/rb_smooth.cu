// Red-black Gauss-Seidel on an (n, n, n) f32 field: the half-sweeps of K1
// and the one-pass smoothing stage of K2 (and of K4 past n_iter = 2).
//
// Replaces the Pallas kernels multigrid_parallel_tpu/ops/pallas3d.py:
// rb_smooth_fused_pipelined (K1) and rb_smooth_from_zero_fused (K2, :412).
// Those run all 2 * n_iter half-sweeps of a smoothing stage in one pass
// over HBM (trapezoidal halo in VMEM).
//
// K1 runs one launch per half-sweep, which is race-free in place because a
// colour reads only the other colour:
//   u <- (sum6(u) - h^2 f) * (1/6)   on interior points of `color`.
// Bound: device-memory bytes. One half-sweep reads u's neighbours and f
// and writes the active half of u, at least 4 + 4 + 2 = 10 bytes per
// point (every 32-byte sector of u and f is touched, though only half of
// f is used), so a stage of 2 * n_iter half-sweeps moves ~10 * 2 * n_iter
// bytes per point where the fused Pallas stage moves 12: one thread per
// point, k fastest, the six neighbour loads of a warp coalesced rows that
// the i +- 1 and j +- 1 rows of later blocks find in L2.
//
// K2 is one launch of rect.cuh's stage (rect_stage_kernel: the wavefront,
// or up to 129^3 the box) for n_iter <= 2. Its tile starts as zeros in
// shared memory (nothing is loaded), so its first half-sweep is (+0 - h^2
// f) (1/6) at every live point of its colour, as the plain version computes
// from a zero field, and the whole output, a fresh field with a zero
// boundary, is written. Bound: device-memory bytes, f read and the output
// written, 8 bytes a point (0.0405 ms at 257^3, 3.35 TB/s; chip_smoke.py,
// bound): one pass instead of four launches that each moved ~10 bytes a
// point. n_iter > 2 is ceil(n_iter / 2) launches, each later one the same
// stage kernel on the field so far. The first half-sweep of K2's first
// form (mg_rb_half_sweep_from_zero) still serves K14 (pallas_mixed.py).
#include "rect.cuh"
#include "stencil.cuh"

namespace {

__global__ void rb_half_sweep_kernel(float* __restrict__ u,
                                     const float* __restrict__ f, int n,
                                     float h2, int color) {
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  int i, j, k;
  if (!mg::decode(p, n, i, j, k)) return;
  if (!mg::is_interior(i, j, k, n) || ((i + j + k) & 1) != color) return;
  const float nbr = mg::nbr_sum(u, p, n);
  u[p] = (nbr - h2 * f[p]) * (1.0f / 6.0f);
}

__global__ void rb_half_sweep_from_zero_kernel(float* __restrict__ out,
                                               const float* __restrict__ f,
                                               int n, float h2, int color) {
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  int i, j, k;
  if (!mg::decode(p, n, i, j, k)) return;
  float v = 0.0f;
  if (mg::is_interior(i, j, k, n) && ((i + j + k) & 1) == color) {
    const float nbr = 0.0f;  // six zero neighbours, summed: +0
    v = (nbr - h2 * f[p]) * (1.0f / 6.0f);
  }
  out[p] = v;
}

template <int NITER, bool ZERO, bool BOX>
__global__ void __launch_bounds__(mg::rect::kStageMaxThreads)
    rect_stage_kernel(mg::rect::StageArgs a) {
  extern __shared__ __align__(16) float tile[];
  if constexpr (BOX) {
    mg::rect::box_body<NITER, ZERO>(a, tile, mg::split::NoPrep{});
  } else {
    mg::rect::stage_body<NITER, ZERO>(a, tile, mg::split::NoPrep{});
  }
}

template <int NITER, bool ZERO>
int launch_rect_stage(const mg::rect::StageArgs& a, int box, int threads, int smem,
                      cudaStream_t stream) {
  using mg::rect::launch_stage;
  return box ? launch_stage(rect_stage_kernel<NITER, ZERO, true>, a, threads, smem, stream)
             : launch_stage(rect_stage_kernel<NITER, ZERO, false>, a, threads, smem, stream);
}

}  // namespace

// One in-place half-sweep of `color` (1 = RED = (i+j+k) odd, 0 = BLACK).
extern "C" int mg_rb_half_sweep(float* u, const float* f, int n, float h2,
                                int color, cudaStream_t stream) {
  rb_half_sweep_kernel<<<mg::point_blocks(n), mg::kThreads, 0, stream>>>(
      u, f, n, h2, color);
  return (int)cudaGetLastError();
}

// First half-sweep from a zero initial guess: writes all of `out`.
extern "C" int mg_rb_half_sweep_from_zero(float* out, const float* f, int n,
                                          float h2, int color,
                                          cudaStream_t stream) {
  rb_half_sweep_from_zero_kernel<<<mg::point_blocks(n), mg::kThreads, 0,
                                   stream>>>(out, f, n, h2, color);
  return (int)cudaGetLastError();
}

// The rect stage (K2; K4's launches past its first): out <- n_iter (1 or 2)
// RB-GS iterations of u (a zero field where u is null) against f, red
// first or black first, on the plan (bi, bj, bk, k_halo, threads, smem,
// box: the box schedule, else the wavefront) of pallas_split._stage_plan
// (rect). out must not alias u.
extern "C" int mg_rect_stage(float* out, const float* u, const float* f, int n, float h2,
                             int red_first, int n_iter, int bi, int bj, int bk, int k_halo,
                             int threads, int smem, int box, cudaStream_t stream) {
  using namespace mg::rect;
  StageArgs a;
  a.out = out;
  a.in = u;
  a.f = f;
  a.color0 = red_first ? mg::split::kRed : mg::split::kBlack;
  a.n = n;
  a.h2 = h2;
  a.bi = bi;
  a.bj = bj;
  a.bk = bk;
  a.k_halo = k_halo;
  if (const int err = stage_plan_error(a, n_iter, threads, smem, box)) return err;
  if (u == nullptr) {
    return n_iter == 1 ? launch_rect_stage<1, true>(a, box, threads, smem, stream)
                       : launch_rect_stage<2, true>(a, box, threads, smem, stream);
  }
  return n_iter == 1 ? launch_rect_stage<1, false>(a, box, threads, smem, stream)
                     : launch_rect_stage<2, false>(a, box, threads, smem, stream);
}
