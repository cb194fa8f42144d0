// Mixed-BC smoothing on one rank's segmented block of an i-sharded
// correction field: the one-pass stage of K34 (from a loaded correction)
// and K35 (from zero), and the half-sweeps and BC pass of their first
// form, which they keep past n_iter 2.
//
// Replace the Pallas kernels multigrid_parallel_tpu/ops/pallas_mixed.py:
// mixed_rb_smooth_ext / mixed_rb_smooth_halo (K34) and
// mixed_rb_smooth_from_zero_ext / mixed_rb_smooth_from_zero_halo (K35),
// which run all 2 * n_iter half-sweeps of a stage, copy-BC folded
// (mixed.cuh), and one BC pass on a block with a 2 * n_iter plane halo in
// one pass.
//
// K34 and K35 (n_iter <= 2) are one launch of K13's and K14's stage
// (rect.cuh, the wavefront or up to 129^3 the box) on the segment:
// Layout::kSeg, u (K34) and f read through their segments at GLOBAL plane
// g0 + t, the tile loaded from u (K34) or starting as zeros (K35), the
// selects and the BC pass at the store as K14's, the blocks tiling the
// rank's planes clipped to n - 1 (and plane n - 2 from the left halo where
// plane n - 1 is row 0, whose copy there is its final value in the tile,
// not u's: the left halo is 2 n_iter + 1 planes), into a fresh (L, n, n)
// body, its pad rows (past n - 1) u's (K34) or zero (K35); a rank of pad
// rows only takes its launch too. The plan is pallas_split._stage_plan(rect,
// rows = the planes tiled). So the owned rows equal K13's and K14's on the
// whole field bit for bit. Bound: device-memory bytes, u's (K34) and f's
// rows and halos read and the body written, 8 B a point (12 B for K34),
// the pins of the x faces where the rank holds them. The design answers
// the first form's costs: 2 n_iter in-place half-sweep launches over the
// rows and halos (~10 B a point each; K35's first one K29's from-zero
// launch) and a BC-pass launch, 5 launches a call at n_iter 2.
//
// n_iter > 2 keeps that first form (no solve runs it): K34's in-place
// half-sweeps and BC pass here, on a copy of u's segment (K35: K29's
// from-zero half-sweep, mg_seg_half_sweep_from_zero, first, on a segment
// with scratch halo buffers).
//
// The first form, one launch per half-sweep over local rows [-kl + 1, L +
// kr - 2] of the segment, in place, then one BC-pass launch over the body
// rows. The segment is read at GLOBAL plane i = g0 + t (mg::SegFieldAt),
// so mixed.cuh's folded neighbour sum and pin selects serve it unchanged:
// the neighbour order, the global colour (RED = (i + j + k) odd), the
// global interior and the pins at i = 1 and n - 2. A stale halo row spoils
// one more row per half-sweep, so after the stage the rows from -kl + 2
// n_iter on are what K13 computes on the whole field. Its BC pass writes
// each boundary node of the body rows once: u[c(i), c(j), c(k)], or 0 at a
// pinned x-face node. Only its copy at global plane n - 1 reads another
// row, plane n - 2; where plane n - 1 is body row 0 that is row -1, so the
// caller gives that block a left halo of 2 n_iter + 1 rows, and row -1 is
// fresh at the end. Pad planes (i >= n) are never written. Bound:
// device-memory bytes: ~10 B per point and half-sweep over the L + kl + kr
// rows; the BC pass touches ~4 n boundary nodes a row.
#include "mixed.cuh"
#include "rect.cuh"
#include "seg.cuh"

namespace {

__global__ void seg_mixed_half_sweep_kernel(mg::Seg u, mg::Seg f, const float* __restrict__ pin,
                                            int n, int g0, float h2, int color, int t0,
                                            int rows) {
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  int t, j, k, jk;
  if (!mg::decode_seg(p, rows, t0, n, t, j, k, jk)) return;
  const int g = g0 + t;
  if (!mg::is_interior(g, j, k, n) || ((g + j + k) & 1) != color) return;
  const float nbr =
      mg::mixed_nbr_sum(mg::SegFieldAt{u, g0, n}, mg::full_pins(pin, n), g, j, k, n);
  u.row(t)[jk] = (nbr - h2 * f.row(t)[jk]) * (1.0f / 6.0f);
}

// blockIdx.y == 0: the y / z face nodes of body rows with 1 <= g <= n - 2,
// 4 (n - 1) a row (the two y faces whole, then the two z faces between
// them); blockIdx.y == 1: the two x-face planes, where the body holds them.
__global__ void seg_mixed_bc_pass_kernel(mg::Seg u, const float* __restrict__ pin, int n,
                                         int g0) {
  const int q = blockIdx.x * blockDim.x + threadIdx.x;
  int t, j, k;
  if (blockIdx.y == 0) {
    const int per_row = 4 * (n - 1);
    if (q >= u.L * per_row) return;
    t = q / per_row;
    int rem = q - t * per_row;
    if (rem < 2 * n) {
      j = rem < n ? 0 : n - 1;
      k = rem % n;
    } else {
      rem -= 2 * n;
      k = rem < n - 2 ? 0 : n - 1;
      j = 1 + rem % (n - 2);
    }
    const int g = g0 + t;
    if (g < 1 || g > n - 2) return;
  } else {
    const int nn = n * n;
    if (q >= 2 * nn) return;
    const int g = q < nn ? 0 : n - 1;
    t = g - g0;
    if (t < 0 || t >= u.L) return;
    j = (q % nn) / n;
    k = q % n;
  }
  const int g = g0 + t;
  u.row(t)[j * n + k] =
      mg::pinned(mg::full_pins(pin, n), g, j, k, n)
          ? 0.0f
          : u.row(mg::copy_source(g, n) - g0)[mg::copy_source(j, n) * n + mg::copy_source(k, n)];
}

// ZERO: K35, from a zero tile, pad rows 0; else K34, u loaded, pad rows u's.
template <int NITER, bool ZERO, bool BOX>
__global__ void __launch_bounds__(mg::rect::kSegStageMaxThreads)
    mixed_seg_stage_kernel(mg::rect::SegStageArgs a) {
  using namespace mg::rect;
  extern __shared__ __align__(16) float tile[];
  seg_pad_fill(a, !ZERO);
  if constexpr (BOX) {
    box_body<NITER, ZERO, Layout::kSeg>(a, tile, mg::split::NoPrep{});
  } else {
    stage_body<NITER, ZERO, Layout::kSeg>(a, tile, mg::split::NoPrep{});
  }
}

template <int NITER, bool ZERO>
int launch_mixed_seg_stage(const mg::rect::SegStageArgs& a, int box, int threads, int smem,
                           cudaStream_t stream) {
  using mg::rect::launch_stage;
  return box ? launch_stage(mixed_seg_stage_kernel<NITER, ZERO, true>, a, threads, smem, stream)
             : launch_stage(mixed_seg_stage_kernel<NITER, ZERO, false>, a, threads, smem,
                            stream);
}

}  // namespace

// The K34 and K35 stage: the (L, n, n) body out <- n_iter (1 or 2) mixed
// RB-GS iterations of the segment u (K34; a zero field where u_body is
// null, K35) against the segment f (both kl rows on the left, kr on the
// right; g0 = global plane of body row 0), red first or black first,
// ending with the BC pass, on the plan (bi, bj, bk, k_halo, threads, smem,
// box) of pallas_split._stage_plan (rect, rows = the planes the launch
// tiles). Pad rows are written as u's rows (K34) or 0 (K35). out must
// meet neither segment.
extern "C" int mg_seg_mixed_stage(float* out, float* u_lh, float* u_body, float* u_rh,
                                  int u_roff, float* f_lh, float* f_body, float* f_rh,
                                  int f_roff, const float* pin, int kl, int L, int kr, int n,
                                  int g0, float h2, int red_first, int n_iter, int bi, int bj,
                                  int bk, int k_halo, int threads, int smem, int box,
                                  cudaStream_t stream) {
  using namespace mg::rect;
  const int nn = n * n;
  SegStageArgs a{};
  a.out = out;
  a.in = u_body;
  a.f = f_body;
  if (u_body != nullptr) a.in_s = mg::make_seg(u_lh, u_body, u_rh, kl, L, kr, u_roff, nn);
  a.f_s = mg::make_seg(f_lh, f_body, f_rh, kl, L, kr, f_roff, nn);
  a.pin = pin;
  a.color0 = red_first ? mg::split::kRed : mg::split::kBlack;
  a.n = n;
  a.h2 = h2;
  a.bi = bi;
  a.bj = bj;
  a.bk = bk;
  a.k_halo = k_halo;
  const long long count = (long long)L * nn;
  if (out == nullptr || pin == nullptr || f_body == nullptr || mg::meets(out, count, a.f_s, kr) ||
      (u_body != nullptr && mg::meets(out, count, a.in_s, kr)))
    return (int)cudaErrorInvalidValue;
  if (const int err = seg_geometry(a, g0, L, kl, kr, 2 * n_iter)) return err;
  if (const int err = stage_plan_error(a, n_iter, threads, smem, box, kSegStageMaxThreads))
    return err;
  if (u_body == nullptr) {
    return n_iter == 1 ? launch_mixed_seg_stage<1, true>(a, box, threads, smem, stream)
                       : launch_mixed_seg_stage<2, true>(a, box, threads, smem, stream);
  }
  return n_iter == 1 ? launch_mixed_seg_stage<1, false>(a, box, threads, smem, stream)
                     : launch_mixed_seg_stage<2, false>(a, box, threads, smem, stream);
}

// One in-place mixed half-sweep of `color` (1 = RED) over local rows
// [-kl + 1, L + kr - 2] of the segment u, RHS segment f (same rows); g0 =
// global index of body row 0.
extern "C" int mg_seg_mixed_half_sweep(float* u_lh, float* u_body, float* u_rh, int u_roff,
                                       float* f_lh, float* f_body, float* f_rh, int f_roff,
                                       const float* pin, int kl, int L, int kr, int n, int g0,
                                       float h2, int color, cudaStream_t stream) {
  const int nn = n * n;
  const mg::Seg u = mg::make_seg(u_lh, u_body, u_rh, kl, L, kr, u_roff, nn);
  const mg::Seg f = mg::make_seg(f_lh, f_body, f_rh, kl, L, kr, f_roff, nn);
  const int rows = L + kl + kr - 2;
  seg_mixed_half_sweep_kernel<<<mg::seg_blocks(rows, nn), mg::kThreads, 0, stream>>>(
      u, f, pin, n, g0, h2, color, -kl + 1, rows);
  return (int)cudaGetLastError();
}

// The BC pass of the body rows, in place: Neumann copies (x, y, z order)
// and the zero pin; reads row -1 where plane n - 1 is body row 0.
extern "C" int mg_seg_mixed_bc_pass(float* u_lh, float* u_body, float* u_rh, int u_roff,
                                    const float* pin, int kl, int L, int kr, int n, int g0,
                                    cudaStream_t stream) {
  const mg::Seg u = mg::make_seg(u_lh, u_body, u_rh, kl, L, kr, u_roff, n * n);
  const long long faces = (long long)L * 4 * (n - 1), x_planes = 2LL * n * n;
  const long long count = faces > x_planes ? faces : x_planes;
  const dim3 grid((unsigned)((count + mg::kThreads - 1) / mg::kThreads), 2);
  seg_mixed_bc_pass_kernel<<<grid, mg::kThreads, 0, stream>>>(u, pin, n, g0);
  return (int)cudaGetLastError();
}
