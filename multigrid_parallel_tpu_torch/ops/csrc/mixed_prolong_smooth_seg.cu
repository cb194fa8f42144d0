// Mixed-BC prolongation of the coarse correction, added to the fine one,
// and the black-first mixed smoothing stage on the result (K36), on one
// rank's segmented block of an i-sharded correction field, writing a fresh
// (L, n, n) body.
//
// Replaces the Pallas kernels multigrid_parallel_tpu/ops/pallas_mixed.py:
// mixed_prolong_smooth_ext and mixed_prolong_smooth_halo, which compute
// the black-first mixed stage of e + P ec (the coarse BOUNDARY taking
// part, copy-BC folded, one BC pass) on a block with a fine halo H = 2 *
// n_iter and a coarse one of n_iter on the left and n_iter + 1 on the
// right, in one pass.
//
// For n_iter <= 2 it is one launch of K15's stage (rect.cuh, kMixed with
// K4's ProlongPrep) on the segments (Layout::kSeg): e and r read through
// their segments and the coarse correction through its own
// (SegProlongPrep: coarse plane c is the segment's row c - cg0, cg0 = g0 /
// 2), every point of the loaded box e + P ec as its plane
// arrives, the coarse boundary live, the blocks tiling the rank's planes
// clipped to n - 1 (and plane n - 2 from the halo where plane n - 1 is row
// 0: kl = H + 1, and the coarse segment n_iter + 1 planes on the left),
// the BC pass at the store, the rank's nodes only. Pad rows (past n - 1)
// are never loaded, so they take no correction: the launch copies e's
// rows there (zero in the cycle). So the owned rows equal K15's on the
// whole field bit for bit, in one launch a call, e's halo only read.
// Bound: device-memory bytes, e and r with their halos read and the body
// written, 12 B a fine point, the coarse rows read, 4 B a coarse point,
// and the pins. The design answers the first form's costs: a correction
// launch that recomputed six neighbours' interpolations at each black
// point, then 3 K34 half-sweep launches and a BC-pass launch.
//
// n_iter > 2 keeps that first form (no solve runs it): over output rows
// [-kl, L + kr), red and boundary points and the two edge rows get e + P
// ec, black interior points their first smoothed value from the corrected
// neighbours (each recomputed), through mixed.cuh's folded neighbour sum at
// GLOBAL indices, the coarse rows read through a second descriptor
// (mg::SegAt); the other 2 * n_iter - 1 half-sweeps and the BC pass are
// K34's launches on the output, whose halo buffers the caller allocates.
// Pad planes keep e's values there too.
#include "mixed.cuh"
#include "rect.cuh"
#include "seg.cuh"

namespace {

struct CorrectedSegAt {
  mg::SegFieldAt e;
  mg::SegAt ec;
  __device__ float operator()(int i, int j, int k) const {
    return e(i, j, k) + mg::interp_at(ec, i, j, k);
  }
};

__global__ void seg_mixed_prolong_correct_black_kernel(mg::Seg out, CorrectedSegAt at,
                                                       mg::Seg r, const float* __restrict__ pin,
                                                       int n, int g0, float h2, int t0, int rows,
                                                       int t_lo, int t_hi) {
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  int t, j, k, jk;
  if (!mg::decode_seg(p, rows, t0, n, t, j, k, jk)) return;
  const int g = g0 + t;
  if (g >= n) {  // a pad plane: e's (zero), no correction
    out.row(t)[jk] = at.e(g, j, k);
    return;
  }
  if (t < t_lo || t > t_hi || !mg::is_interior(g, j, k, n) || ((g + j + k) & 1) != 0) {
    out.row(t)[jk] = at(g, j, k);  // 0 = BLACK above
    return;
  }
  const float nbr = mg::mixed_nbr_sum(at, mg::full_pins(pin, n), g, j, k, n);
  out.row(t)[jk] = (nbr - h2 * r.row(t)[jk]) * (1.0f / 6.0f);
}

using namespace mg::rect;

template <int NITER, bool BOX>
__global__ void __launch_bounds__(kSegStageMaxThreads)
    mixed_seg_prolong_stage_kernel(SegStageArgs a, SegProlongPrep prep) {
  extern __shared__ __align__(16) float tile[];
  seg_pad_fill(a, true);
  if constexpr (BOX) {
    box_body<NITER, false, Layout::kSeg>(a, tile, prep);
  } else {
    stage_body<NITER, false, Layout::kSeg>(a, tile, prep);
  }
}

template <int NITER>
int launch_mixed_seg_prolong_stage(const SegStageArgs& a, int box, int threads, int smem,
                                   cudaStream_t stream, const SegProlongPrep& prep) {
  return box ? launch_stage(mixed_seg_prolong_stage_kernel<NITER, true>, a, threads, smem,
                            stream, prep)
             : launch_stage(mixed_seg_prolong_stage_kernel<NITER, false>, a, threads, smem,
                            stream, prep);
}

}  // namespace

// The K36 stage: the (L, n, n) body out <- n_iter (1 or 2) black-first
// mixed RB-GS iterations of e + P ec against r, ending with the BC pass,
// on the plan (bi, bj, bk, k_halo, threads, smem, box) of
// pallas_split._stage_plan (rect, prolong, rows = the planes the launch
// tiles). The fine segments e and r have kl rows on the left and kr on the
// right; the coarse segment ec kl_c and kr_c around its L / 2 rows; g0 =
// the global fine plane of body row 0 (even). Pad rows take e's.
extern "C" int mg_seg_mixed_prolong_stage(
    float* out, float* c_lh, float* c_body, float* c_rh, int c_roff, int kl_c, int kr_c,
    float* e_lh, float* e_body, float* e_rh, int e_roff, float* r_lh, float* r_body, float* r_rh,
    int r_roff, const float* pin, int kl, int L, int kr, int n, int g0, float h2, int n_iter,
    int bi, int bj, int bk, int k_halo, int threads, int smem, int box, cudaStream_t stream) {
  const int nn = n * n, nc = (n + 1) / 2, H = 2 * n_iter;
  SegStageArgs a{};
  a.out = out;
  a.in = e_body;
  a.f = r_body;
  a.in_s = mg::make_seg(e_lh, e_body, e_rh, kl, L, kr, e_roff, nn);
  a.f_s = mg::make_seg(r_lh, r_body, r_rh, kl, L, kr, r_roff, nn);
  a.pin = pin;
  a.color0 = mg::split::kBlack;
  a.n = n;
  a.h2 = h2;
  a.bi = bi;
  a.bj = bj;
  a.bk = bk;
  a.k_halo = k_halo;
  const int rows = coarse_rows(bj, H), width = coarse_width(tile_width(n, bk, k_halo));
  const int depth = coarse_planes(bi, H, box);
  if (n % 2 == 0 || g0 % 2 || L % 2 || e_body == nullptr || r_body == nullptr ||
      c_body == nullptr || pin == nullptr)
    return (int)cudaErrorInvalidValue;
  if (const int err = seg_geometry(a, g0, L, kl, kr, H)) return err;
  // the coarse planes the loaded boxes interpolate from: (ia >> 1) .. (ib >> 1)
  const int cg0 = g0 / 2, ia = a.c0 - H > 0 ? a.c0 - H : 0, ib = a.c1 + H < n ? a.c1 + H : n;
  if (a.c1 > a.c0 && ((ia >> 1) < cg0 - kl_c || (ib >> 1) >= cg0 + L / 2 + kr_c))
    return (int)cudaErrorInvalidValue;
  if (const int err = stage_plan_error(a, n_iter, threads,
                                       smem - (long long)depth * rows * width * 4, box,
                                       kSegStageMaxThreads))
    return err;
  SegProlongPrep prep{};
  prep.ec = c_body;
  prep.nc = nc;
  prep.rows = rows;
  prep.width = width;
  prep.depth = depth;
  prep.cs = mg::make_seg(c_lh, c_body, c_rh, kl_c, L / 2, kr_c, c_roff, nc * nc);
  prep.cg0 = cg0;
  return n_iter == 1 ? launch_mixed_seg_prolong_stage<1>(a, box, threads, smem, stream, prep)
                     : launch_mixed_seg_prolong_stage<2>(a, box, threads, smem, stream, prep);
}

// out rows [-kl, L + kr) <- e + P ec, black interior rows [-kl + 1, L + kr - 2]
// swept once; out must not alias e. The fine segments e, r, out have kl
// rows on the left and kr on the right; the coarse segment ec has kl_c and
// kr_c around its Lc = L / 2 rows. g0 = global fine index of body row 0 (even).
extern "C" int mg_seg_mixed_prolong_correct_black(
    float* o_lh, float* o_body, float* o_rh, float* c_lh, float* c_body, float* c_rh,
    int c_roff, int kl_c, int kr_c, float* e_lh, float* e_body, float* e_rh, int e_roff,
    float* r_lh, float* r_body, float* r_rh, int r_roff, const float* pin, int kl, int L,
    int kr, int n, int g0, float h2, cudaStream_t stream) {
  const int nn = n * n;
  const int nc = (n + 1) / 2;
  const mg::Seg out = mg::make_seg(o_lh, o_body, o_rh, kl, L, kr, 0, nn);
  const mg::Seg e = mg::make_seg(e_lh, e_body, e_rh, kl, L, kr, e_roff, nn);
  const mg::Seg r = mg::make_seg(r_lh, r_body, r_rh, kl, L, kr, r_roff, nn);
  const CorrectedSegAt at{
      mg::SegFieldAt{e, g0, n},
      mg::SegAt{mg::make_seg(c_lh, c_body, c_rh, kl_c, L / 2, kr_c, c_roff, nc * nc), g0 / 2,
                nc}};
  const int rows = L + kl + kr;
  seg_mixed_prolong_correct_black_kernel<<<mg::seg_blocks(rows, nn), mg::kThreads, 0,
                                           stream>>>(out, at, r, pin, n, g0, h2, -kl, rows,
                                                     -kl + 1, L + kr - 2);
  return (int)cudaGetLastError();
}
