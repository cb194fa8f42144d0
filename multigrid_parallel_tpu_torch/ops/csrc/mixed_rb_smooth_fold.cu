// The electrospray fold layout's mixed-BC smoothing, on (n, n, n - 2) f32
// correction fields (mixed.cuh: stored slot kk holds grid plane k = kk +
// 1): K17's one-pass stage, and K16's half-sweeps and BC pass.
//
// Replaces the Pallas kernels multigrid_parallel_tpu/ops/pallas_mixed_fold.py:
// mixed_rb_smooth_fold (K16) and mixed_rb_smooth_from_zero_fold (K17).
// Those run all 2 * n_iter half-sweeps of a stage in one pass over HBM
// with the copy-BC folded into the stencil, then one BC pass without z
// faces.
//
// K17 is one launch of rect.cuh's stage on the fold layout (kFold; the
// wavefront, or up to 129^3 the box; the plan pallas_split._stage_plan,
// rect) for n_iter <= 2, into a fresh field: the tile starts as zeros (the
// folded reads of a zero field are zero), every half-sweep reads the
// neighbours across a face as the reader's own value (0 at a pinned
// x-face node), and the BC pass is the stage's store: each stored
// boundary node gets u[c(i), c(j), kk], or 0 at a pinned x-face node, from
// its source's final value. n_iter > 2 is ceil(n_iter / 2) launches, each
// later one the same stage on the field so far (fold_stage_kernel, ZERO
// false). Bound: device-memory bytes, r read and the output written, 8 B a
// stored point, the pins of the two x faces read (0.0404 ms at 257^3,
// 3.35 TB/s; chip_smoke.py, bound).
//
// K16 keeps its first form, one launch per half-sweep, in place:
//   u <- (mixed_nbr_sum(u) - h^2 r) * (1/6)   on interior points of `color`,
// with (i + j + k) & 1 the colour of grid plane k = kk + 1. The k-edge
// reads at kk = 0 and n-3 fold to the reader's own value, as K13's do at
// k = 1 and n-2, so the iterates equal K13's on every stored node. Then
// one BC-pass launch, a gather with one thread per stored boundary node:
// the two x faces whole and the two y faces without their x-face rows,
// out = u[c(i), c(j), kk], or 0 at a pinned x-face node. There are no z
// faces, the nodes K13's pass reaches one per row (a strided store each).
// Bound: ~10 B per stored point per half-sweep (u's neighbours and r read,
// the active half of u written); the BC pass touches ~4 n (n - 2) boundary
// nodes and the rows next to them.
#include "mixed.cuh"
#include "rect.cuh"

namespace {

__global__ void mixed_fold_half_sweep_kernel(float* __restrict__ u,
                                             const float* __restrict__ r,
                                             const float* __restrict__ pin,
                                             int n, float h2, int color) {
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  int i, j, k;
  if (!mg::decode_fold(p, n, i, j, k)) return;
  if (!mg::is_interior_ij(i, j, n) || ((i + j + k) & 1) != color) return;
  const float nbr = mg::mixed_nbr_sum(mg::FoldAt{u, n}, mg::fold_pins(pin, n), i, j, k, n);
  u[p] = (nbr - h2 * r[p]) * (1.0f / 6.0f);
}

// Stored boundary nodes of an n-point fold field, 2 n (n-2) + 2 (n-2)^2 of
// them, numbered: the two x faces whole, then the two y faces without
// their x-face rows. kk is the stored slot.
__device__ inline bool decode_fold_boundary(int q, int n, int& i, int& j, int& kk) {
  const int nk = n - 2;
  const int x_face = n * nk, y_face = (n - 2) * nk;
  if (q < 2 * x_face) {
    i = q < x_face ? 0 : n - 1;
    const int rem = q % x_face;
    j = rem / nk;
    kk = rem % nk;
    return true;
  }
  q -= 2 * x_face;
  if (q < 2 * y_face) {
    j = q < y_face ? 0 : n - 1;
    const int rem = q % y_face;
    i = 1 + rem / nk;
    kk = rem % nk;
    return true;
  }
  return false;
}

__global__ void mixed_fold_bc_pass_kernel(float* __restrict__ u,
                                          const float* __restrict__ pin, int n) {
  const int q = blockIdx.x * blockDim.x + threadIdx.x;
  int i, j, kk;
  if (!decode_fold_boundary(q, n, i, j, kk)) return;
  const int nk = n - 2;
  u[(i * n + j) * nk + kk] =
      mg::pinned(mg::fold_pins(pin, n), i, j, kk + 1, n)
          ? 0.0f
          : u[(mg::copy_source(i, n) * n + mg::copy_source(j, n)) * nk + kk];
}

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

// One in-place mixed fold half-sweep of `color` (1 = RED = (i+j+k) odd).
extern "C" int mg_mixed_fold_half_sweep(float* u, const float* r, const float* pin,
                                        int n, float h2, int color,
                                        cudaStream_t stream) {
  mixed_fold_half_sweep_kernel<<<mg::fold_blocks(n), mg::kThreads, 0, stream>>>(
      u, r, pin, n, h2, color);
  return (int)cudaGetLastError();
}

// The fold BC pass, in place: x and y Neumann copies and the zero pin.
extern "C" int mg_mixed_fold_bc_pass(float* u, const float* pin, int n,
                                     cudaStream_t stream) {
  const long long count = 2LL * n * (n - 2) + 2LL * (n - 2) * (n - 2);
  const int blocks = (int)((count + mg::kThreads - 1) / mg::kThreads);
  mixed_fold_bc_pass_kernel<<<blocks, mg::kThreads, 0, stream>>>(u, pin, n);
  return (int)cudaGetLastError();
}

// The fold stage (K17; its launches past the first where u is given): out
// <- n_iter (1 or 2) mixed RB-GS iterations of u (a zero field where u is
// null) against r, red first or black first, ending with the fold BC
// pass, on the plan (bi, bj, bk, k_halo, threads, smem, box) of
// pallas_split._stage_plan (rect). out must not alias u.
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
