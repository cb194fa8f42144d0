// Red-black Gauss-Seidel on an (n, n, n) f32 field: the one-pass smoothing
// stage of K1 and K2 (and of K4 past n_iter = 2), and the half-sweeps of
// K1's per-sweep form.
//
// Replaces the Pallas kernels multigrid_parallel_tpu/ops/pallas3d.py:
// rb_smooth_fused_pipelined (K1, :515 -> :479; rb_smooth_fused_padded
// :556, the cube wrapper :1618 -> :174) and rb_smooth_from_zero_fused (K2,
// :412). Those run all 2 * n_iter half-sweeps of a smoothing stage in one
// pass over HBM (trapezoidal halo in VMEM).
//
// K1 and K2 are one launch of rect.cuh's stage (rect_stage_kernel: the
// wavefront, or up to 129^3 the box) for n_iter <= 2, into a fresh field.
// K1's tile is loaded from its initial guess u, boundary included, which
// the stage carries to the output unchanged; u is not written. Bound:
// device-memory bytes, u and f read and the output written, 12 bytes a
// point (0.0608 ms at 257^3, 3.35 TB/s; chip_smoke.py, bound), the
// arithmetic (8 f32 operations a point and half-sweep) two orders of
// magnitude under that. K2's tile starts as zeros in shared memory
// (nothing is loaded, ZERO), so its first half-sweep is (+0 - h^2 f) (1/6)
// at every live point of its colour, as the plain version computes from a
// zero field, and the whole output, a fresh field with a zero boundary, is
// written: f read and the output written, 8 bytes a point (0.0405 ms at
// 257^3). n_iter > 2 is ceil(n_iter / 2) launches, each later one K1's
// stage on the field so far.
//
// K1's per-sweep form (pallas3d.rb_smooth_fused_per_sweep, the yardstick
// of its timings) runs one launch per half-sweep, race-free in place
// because a colour reads only the other colour:
//   u <- (sum6(u) - h^2 f) * (1/6)   on interior points of `color`,
// one thread a point, ~10 bytes a point a launch, 4 launches a call at
// n_iter 2. K26 (rb_smooth_residual.cu) runs its stage on that half-sweep
// too. The first half-sweep from zero (mg_rb_half_sweep_from_zero) serves
// K14 (pallas_mixed.py).
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

// The rect stage (K1; K2 where u is null; K4's launches past its first):
// out <- n_iter (1 or 2) RB-GS iterations of u (a zero field where u is
// null) against f, red first or black first, on the plan (bi, bj, bk,
// k_halo, threads, smem, box: the box schedule, else the wavefront) of
// pallas_split._stage_plan (rect). out must not alias u.
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
