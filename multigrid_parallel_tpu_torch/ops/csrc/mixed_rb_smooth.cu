// The electrospray full tier's mixed-BC smoothing on (n, n, n) f32
// correction fields: K14's one-pass stage, and K13's half-sweeps and BC
// pass.
//
// Replaces the Pallas kernels multigrid_parallel_tpu/ops/pallas_mixed.py:
// mixed_rb_smooth_fused (K13) and mixed_rb_smooth_from_zero_fused (K14).
// Those run all 2 * n_iter half-sweeps of a stage in one pass over HBM
// with the copy-BC folded into the stencil (mixed.cuh), then one BC pass.
//
// K14 is one launch of rect.cuh's stage on the full layout (kMixed; the
// wavefront, or up to 129^3 the box; the plan pallas_split._stage_plan,
// rect) for n_iter <= 2, into a fresh field: the tile starts as zeros (the
// folded reads of a zero field are zero), every half-sweep reads the
// neighbours across a face as the reader's own value (0 at a pinned
// x-face node), never the tile's k-face slots, and the BC pass is the
// stage's store: each boundary node, the z faces too, gets u[c(i), c(j),
// c(k)], or 0 at a pinned x-face node, from its source's final value.
// n_iter > 2 is ceil(n_iter / 2) launches, each later one the same stage on
// the field so far (mixed_stage_kernel, ZERO false). Bound: device-memory
// bytes, r read and the output written, 8 B a point, the pins of the two x
// faces read (0.0407 ms at 257^3, 3.35 TB/s; chip_smoke.py, bound). The
// design answers the first form's costs (a from-zero launch, 2 n_iter - 1
// in-place half-sweep launches of ~10 B a point each and a BC-pass launch,
// ~40 B a point at n_iter 2): one pass, the half-sweeps in shared memory.
//
// K13 keeps its first form, one launch per half-sweep, in place (a colour
// reads only the other colour and itself):
//   u <- (mixed_nbr_sum(u) - h^2 r) * (1/6)   on interior points of `color`,
// then one BC-pass launch with one thread per boundary node, each written
// once: out = u[c(i), c(j), c(k)], or 0 at a pinned x-face node. The pass
// reads only interior nodes and writes only boundary ones, so it runs in
// place too. Bound: ~10 B per point per half-sweep (u's neighbours and r
// read, the active half of u written); the BC pass touches ~6 n^2
// boundary nodes and the rows next to them.
#include "mixed.cuh"
#include "rect.cuh"

namespace {

__global__ void mixed_half_sweep_kernel(float* __restrict__ u,
                                        const float* __restrict__ r,
                                        const float* __restrict__ pin, int n,
                                        float h2, int color) {
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  int i, j, k;
  if (!mg::decode(p, n, i, j, k)) return;
  if (!mg::is_interior(i, j, k, n) || ((i + j + k) & 1) != color) return;
  const float nbr = mg::mixed_nbr_sum(mg::FieldAt{u, n}, mg::full_pins(pin, n), i, j, k, n);
  u[p] = (nbr - h2 * r[p]) * (1.0f / 6.0f);
}

// Boundary nodes of an n^3 cube, n^3 - (n-2)^3 of them, numbered: the
// two x faces whole, then the two y faces without x-face nodes, then the
// two z faces of the remaining interior rows.
__device__ inline bool decode_boundary(int q, int n, int& i, int& j, int& k) {
  const int m = n - 2;
  const int x_face = n * n, y_face = m * n, z_face = m * m;
  if (q < 2 * x_face) {
    i = q < x_face ? 0 : n - 1;
    const int rem = q % x_face;
    j = rem / n;
    k = rem % n;
    return true;
  }
  q -= 2 * x_face;
  if (q < 2 * y_face) {
    j = q < y_face ? 0 : n - 1;
    const int rem = q % y_face;
    i = 1 + rem / n;
    k = rem % n;
    return true;
  }
  q -= 2 * y_face;
  if (q < 2 * z_face) {
    k = q < z_face ? 0 : n - 1;
    const int rem = q % z_face;
    i = 1 + rem / m;
    j = 1 + rem % m;
    return true;
  }
  return false;
}

__global__ void mixed_bc_pass_kernel(float* __restrict__ u,
                                     const float* __restrict__ pin, int n) {
  const int q = blockIdx.x * blockDim.x + threadIdx.x;
  int i, j, k;
  if (!decode_boundary(q, n, i, j, k)) return;
  const int p = (i * n + j) * n + k;
  u[p] = mg::pinned(mg::full_pins(pin, n), i, j, k, n)
             ? 0.0f
             : u[(mg::copy_source(i, n) * n + mg::copy_source(j, n)) * n +
                 mg::copy_source(k, n)];
}

template <int NITER, bool ZERO, bool BOX>
__global__ void __launch_bounds__(mg::rect::kStageMaxThreads)
    mixed_stage_kernel(mg::rect::StageArgs a) {
  extern __shared__ __align__(16) float tile[];
  if constexpr (BOX) {
    mg::rect::box_body<NITER, ZERO, mg::rect::Layout::kMixed>(a, tile, mg::split::NoPrep{});
  } else {
    mg::rect::stage_body<NITER, ZERO, mg::rect::Layout::kMixed>(a, tile,
                                                                mg::split::NoPrep{});
  }
}

template <int NITER, bool ZERO>
int launch_mixed_stage(const mg::rect::StageArgs& a, int box, int threads, int smem,
                       cudaStream_t stream) {
  using mg::rect::launch_stage;
  return box ? launch_stage(mixed_stage_kernel<NITER, ZERO, true>, a, threads, smem, stream)
             : launch_stage(mixed_stage_kernel<NITER, ZERO, false>, a, threads, smem, stream);
}

}  // namespace

// One in-place mixed half-sweep of `color` (1 = RED = (i+j+k) odd).
extern "C" int mg_mixed_half_sweep(float* u, const float* r, const float* pin,
                                   int n, float h2, int color,
                                   cudaStream_t stream) {
  mixed_half_sweep_kernel<<<mg::point_blocks(n), mg::kThreads, 0, stream>>>(
      u, r, pin, n, h2, color);
  return (int)cudaGetLastError();
}

// The BC pass, in place: Neumann copies (x, y, z order) and the zero pin.
extern "C" int mg_mixed_bc_pass(float* u, const float* pin, int n,
                                cudaStream_t stream) {
  const long long m = n - 2;
  const long long count = (long long)n * n * n - m * m * m;
  const int blocks = (int)((count + mg::kThreads - 1) / mg::kThreads);
  mixed_bc_pass_kernel<<<blocks, mg::kThreads, 0, stream>>>(u, pin, n);
  return (int)cudaGetLastError();
}

// The full-layout mixed stage (K14; its launches past the first, and K15's,
// where u is given): out <- n_iter (1 or 2) mixed RB-GS iterations of u (a
// zero field where u is null) against r, red first or black first, ending
// with the BC pass, on the plan (bi, bj, bk, k_halo, threads, smem, box) of
// pallas_split._stage_plan (rect). out must not alias u.
extern "C" int mg_mixed_stage(float* out, const float* u, const float* r, const float* pin, int n,
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
    return n_iter == 1 ? launch_mixed_stage<1, true>(a, box, threads, smem, stream)
                       : launch_mixed_stage<2, true>(a, box, threads, smem, stream);
  }
  return n_iter == 1 ? launch_mixed_stage<1, false>(a, box, threads, smem, stream)
                     : launch_mixed_stage<2, false>(a, box, threads, smem, stream);
}
