// Trilinear prolongation of the coarse correction added to the fine one,
// and the black-first RB stage on the result, on one rank's segmented
// block (K31 on an i-sharded field, K40 on an (i, j)-sharded one), into a
// fresh owned body.
//
// Replaces the Pallas kernels multigrid_parallel_tpu/ops/pallas_sharded.py:
// prolong_smooth_ext and prolong_smooth_halo, and their (i, j) twins of
// pallas_sharded2d.py, prolong_smooth_ext2d and prolong_smooth_halo2d,
// which compute rb_smooth(e + P ec, r, h, n_iter, black first) on a block
// with a fine halo H = 2 * n_iter (coarse halo n_iter on the left, n_iter
// + 1 on the right; on an (i, j) block in j as in i) in one pass.
//
// For n_iter <= 2 it is one launch of K4's one-pass stage (rect.cuh,
// Layout::kSegRect with K4's ProlongPrep) on the segments: e and r read
// through their segments (a tile row's pointer looked up once, Seg::row or
// Seg2::at), the coarse block through its own (SegProlongPrep,
// Seg2ProlongPrep: coarse plane c is the segment's row c - cg0, cg0 = g0 /
// 2, and on Seg2 coarse column cj its column cj - gj0 / 2), every point of
// the loaded box e + P ec as its plane arrives, the Dirichlet sweeps (no
// boundary node swept), the blocks tiling the rank's planes and, on Seg2,
// its columns clipped to n - 1 (the loaded box clipped to the field only:
// a block at a rank's edge reads the halos and, on Seg2, the corner
// blocks), the store the rank's owned nodes only, into a fresh (L, n, n) or
// (L, Lj, n) body. The pad points past n - 1 are never loaded or swept:
// every block writes its share of them as the plain versions leave them,
// e + P ec from the coarse block's own pad rows (seg_pad_prolong). So the
// owned points equal K4's on the whole field bit for bit, in one launch a
// call, the halos only read. Bound: device-memory bytes, e and r read and
// the body written, 12 B a fine point, and the coarse block, 4 B a coarse
// point. The design answers the first form's costs: a correction launch
// that recomputed six neighbours' interpolations at each black point, each
// neighbour read through the descriptor at every point, then 2 n_iter - 1
// K28 (K37) half-sweep launches, each a pass over the segment's rows and
// halos.
//
// n_iter > 2 keeps that first form (no solve runs it): over the output
// points, red and boundary points and the edge rows and columns get e + P
// ec, black interior points their first smoothed value from the corrected
// neighbours (each recomputed). The coarse block is read through a second
// descriptor at GLOBAL coarse indices (mg::SegCoarseAt, mg::interp_coarse;
// its origin is the fine body origin halved), the fine parity of each point
// from its global indices; the other 2 * n_iter - 1 half-sweeps are K28
// (K37) launches on the output, whose halo buffers the caller allocates.
#include "rect.cuh"
#include "seg2d.cuh"

namespace {

using namespace mg::rect;

template <int NITER, bool BOX, class Args, class Prep>
__global__ void __launch_bounds__(kSegStageMaxThreads)
    seg_prolong_stage_kernel(Args a, Prep prep) {
  extern __shared__ __align__(16) float tile[];
  seg_pad_prolong(a, prep);
  if constexpr (BOX) {
    box_body<NITER, false, Layout::kSegRect>(a, tile, prep);
  } else {
    stage_body<NITER, false, Layout::kSegRect>(a, tile, prep);
  }
}

template <int NITER, class Args, class Prep>
int launch_seg_prolong_stage(const Args& a, int box, int threads, int smem, cudaStream_t stream,
                             const Prep& prep) {
  return box ? launch_stage(seg_prolong_stage_kernel<NITER, true, Args, Prep>, a, threads, smem,
                            stream, prep)
             : launch_stage(seg_prolong_stage_kernel<NITER, false, Args, Prep>, a, threads, smem,
                            stream, prep);
}

// The plan, the K4 prep's sizes and the launch of a K31 or K40 stage whose
// geometry is set: 0, or cudaErrorInvalidValue for a plan the kernels do
// not take (its shared memory not stage_smem_bytes plus the coarse tile's).
template <class Args, class Prep>
int seg_prolong_stage(Args& a, Prep& prep, int n_iter, int bi, int bj, int bk, int k_halo,
                      int threads, int smem, int box, cudaStream_t stream) {
  const int H = 2 * n_iter;
  a.color0 = mg::split::kBlack;
  a.bi = bi;
  a.bj = bj;
  a.bk = bk;
  a.k_halo = k_halo;
  prep.nc = (a.n + 1) / 2;
  prep.rows = coarse_rows(bj, H);
  prep.width = coarse_width(tile_width(a.n, bk, k_halo));
  prep.depth = coarse_planes(bi, H, box);
  if (const int err = stage_plan_error(a, n_iter, threads,
                                       smem - (long long)prep.depth * prep.rows * prep.width * 4,
                                       box, kSegStageMaxThreads))
    return err;
  return n_iter == 1 ? launch_seg_prolong_stage<1>(a, box, threads, smem, stream, prep)
                     : launch_seg_prolong_stage<2>(a, box, threads, smem, stream, prep);
}

// Whether a coarse block of len / 2 rows (or columns) from global cg0 = g0
// / 2, kl_c before it and kr_c after, holds the coarse rows that a launch
// tiling the fine rows [g0, c1) of an n-point axis reads: its loaded
// boxes' (g0 - H to c1 + H clipped to the axis, halved) and
// seg_pad_prolong's, for the pad rows [c1, g0 + len).
inline bool coarse_holds(int g0, int len, int c1, int n, int H, int kl_c, int kr_c) {
  const int cg0 = g0 / 2, lo_c = cg0 - kl_c, hi_c = cg0 + len / 2 + kr_c;
  if (c1 > g0) {
    const int ia = g0 - H > 0 ? g0 - H : 0, ib = c1 + H < n ? c1 + H : n;
    if ((ia >> 1) < lo_c || (ib >> 1) >= hi_c) return false;
  }
  return c1 >= g0 + len || ((c1 >> 1) >= lo_c && ((g0 + len) >> 1) < hi_c);
}

template <class S>
__device__ inline float corrected(const S& e, const mg::SegCoarseAt<S>& ec, int n, int t, int j,
                                  int g, int gj, int k) {
  return mg::seg_at(e, t, j, n)[k] + mg::interp_coarse(ec, g, gj, k);
}

template <class S>
__global__ void seg_prolong_correct_black_kernel(S out, mg::SegCoarseAt<S> ec, S e, S r,
                                                 mg::Span sp, int n, int g0, int gj0, float h2,
                                                 int t_lo, int t_hi, int j_lo, int j_hi) {
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  int t, j, k;
  if (!mg::decode_span(p, sp, n, t, j, k)) return;
  const int g = g0 + t, gj = gj0 + j;
  if (t < t_lo || t > t_hi || j < j_lo || j > j_hi || !mg::is_interior(g, gj, k, n) ||
      ((g + gj + k) & 1) != 0) {
    mg::seg_at(out, t, j, n)[k] = corrected(e, ec, n, t, j, g, gj, k);  // 0 = BLACK above
    return;
  }
  // nbr_sum order: i-1, i+1, j-1, j+1, k-1, k+1
  float s = corrected(e, ec, n, t - 1, j, g - 1, gj, k);
  s = s + corrected(e, ec, n, t + 1, j, g + 1, gj, k);
  s = s + corrected(e, ec, n, t, j - 1, g, gj - 1, k);
  s = s + corrected(e, ec, n, t, j + 1, g, gj + 1, k);
  s = s + corrected(e, ec, n, t, j, g, gj, k - 1);
  s = s + corrected(e, ec, n, t, j, g, gj, k + 1);
  mg::seg_at(out, t, j, n)[k] = (s - h2 * mg::seg_at(r, t, j, n)[k]) * (1.0f / 6.0f);
}

template <class S>
int launch_prolong_correct_black(const S& out, const S& c, const S& e, const S& r,
                                 const mg::Span& sp, int n, int g0, int gj0, float h2, int t_lo,
                                 int t_hi, int j_lo, int j_hi, cudaStream_t stream) {
  const mg::SegCoarseAt<S> ec{c, g0 / 2, gj0 / 2, (n + 1) / 2};
  seg_prolong_correct_black_kernel<<<mg::span_blocks(sp, n), mg::kThreads, 0, stream>>>(
      out, ec, e, r, sp, n, g0, gj0, h2, t_lo, t_hi, j_lo, j_hi);
  return (int)cudaGetLastError();
}

}  // namespace

// The K31 stage: the (L, n, n) body out <- n_iter (1 or 2) black-first
// RB-GS iterations of e + P ec against r on one rank's segments, on the
// plan (bi, bj, bk, k_halo, threads, smem, box) of pallas_split.
// _stage_plan (rect, prolong, seg_planes = the planes the launch tiles).
// The fine segments e and r have kl rows on the left and kr on the right
// (at least H = 2 n_iter); the coarse segment ec kl_c and kr_c around its
// L / 2 rows; g0 = the global fine plane of body row 0 (even). Pad rows
// (past n - 1) take e + P ec.
extern "C" int mg_seg_prolong_stage(float* out, float* c_lh, float* c_body, float* c_rh,
                                    int c_roff, int kl_c, int kr_c, float* e_lh, float* e_body,
                                    float* e_rh, int e_roff, float* r_lh, float* r_body,
                                    float* r_rh, int r_roff, int kl, int L, int kr, int n, int g0,
                                    float h2, int n_iter, int bi, int bj, int bk, int k_halo,
                                    int threads, int smem, int box, cudaStream_t stream) {
  const int nn = n * n, nc = (n + 1) / 2, H = 2 * n_iter;
  SegStageArgs a{};
  a.out = out;
  a.in = e_body;
  a.f = r_body;
  a.in_s = mg::make_seg(e_lh, e_body, e_rh, kl, L, kr, e_roff, nn);
  a.f_s = mg::make_seg(r_lh, r_body, r_rh, kl, L, kr, r_roff, nn);
  a.n = n;
  a.h2 = h2;
  if (n % 2 == 0 || g0 % 2 || L % 2 || out == nullptr || e_body == nullptr ||
      r_body == nullptr || c_body == nullptr || (n_iter != 1 && n_iter != 2))
    return (int)cudaErrorInvalidValue;
  if (const int err = seg_rect_geometry(a, g0, L, kl, kr, H)) return err;
  if (!coarse_holds(g0, L, a.o1, n, H, kl_c, kr_c)) return (int)cudaErrorInvalidValue;
  SegProlongPrep prep{};
  prep.ec = c_body;
  prep.cs = mg::make_seg(c_lh, c_body, c_rh, kl_c, L / 2, kr_c, c_roff, nc * nc);
  prep.cg0 = g0 / 2;
  return seg_prolong_stage(a, prep, n_iter, bi, bj, bk, k_halo, threads, smem, box, stream);
}

// The K40 stage: the (L, Lj, n) body out <- the same on one rank's (i, j)
// block. Descriptors (seg2d.cuh): e and r with halos of at least H rows
// and columns before the block (their kl and hj) and kr rows and hjr
// columns after it; the coarse block c of (L / 2, Lj / 2) with its kl and
// hj before it and kr_c rows and hjr_c columns after; (g0, gj0) = the
// global fine row and column of body point (0, 0) (both even); the plan of
// _stage_plan(rect, prolong, seg_planes, seg_cols). Pad rows and columns
// (past n - 1) take e + P ec.
extern "C" int mg_seg2d_prolong_stage(float* out, const long long* c_desc,
                                      const long long* e_desc, const long long* r_desc, int kr,
                                      int hjr, int kr_c, int hjr_c, int L, int Lj, int n, int g0,
                                      int gj0, float h2, int n_iter, int bi, int bj, int bk,
                                      int k_halo, int threads, int smem, int box,
                                      cudaStream_t stream) {
  const int H = 2 * n_iter;
  Seg2StageArgs a{};
  a.out = out;
  a.in_s = mg::seg2_from_desc(e_desc, L, Lj);
  a.f_s = mg::seg2_from_desc(r_desc, L, Lj);
  a.in = a.in_s.body;
  a.f = a.f_s.body;
  a.n = n;
  a.h2 = h2;
  const mg::Seg2 c = mg::seg2_from_desc(c_desc, L / 2, Lj / 2);
  if (n % 2 == 0 || g0 % 2 || gj0 % 2 || L % 2 || Lj % 2 || out == nullptr || a.in == nullptr ||
      a.f == nullptr || c.body == nullptr || (n_iter != 1 && n_iter != 2))
    return (int)cudaErrorInvalidValue;
  const int kl = a.in_s.kl < a.f_s.kl ? a.in_s.kl : a.f_s.kl;
  const int hjl = a.in_s.hj < a.f_s.hj ? a.in_s.hj : a.f_s.hj;
  if (const int err = seg_rect_geometry(a, g0, L, gj0, Lj, kl, kr, hjl, hjr, H)) return err;
  if (!coarse_holds(g0, L, a.o1, n, H, c.kl, kr_c) ||
      !coarse_holds(gj0, Lj, a.cj1, n, H, c.hj, hjr_c))
    return (int)cudaErrorInvalidValue;
  Seg2ProlongPrep prep{};
  prep.ec = c.body;
  prep.cs = c;
  prep.cg0 = g0 / 2;
  prep.cgj0 = gj0 / 2;
  return seg_prolong_stage(a, prep, n_iter, bi, bj, bk, k_halo, threads, smem, box, stream);
}

// The first form (n_iter > 2), K31's first launch:
// out rows [-H, L + H) <- e + P ec, black interior rows [-H + 1, L + H - 2]
// swept once; out must not alias e. Fine segments e, r, out have halo H on
// both sides; the coarse segment ec has kl_c on the left and kr_c on the
// right of its Lc = L / 2 rows. g0 = global fine index of body row 0.
extern "C" int mg_seg_prolong_correct_black(float* o_lh, float* o_body, float* o_rh,
                                            float* c_lh, float* c_body, float* c_rh,
                                            int c_roff, int kl_c, int kr_c, float* e_lh,
                                            float* e_body, float* e_rh, int e_roff,
                                            float* r_lh, float* r_body, float* r_rh,
                                            int r_roff, int H, int L, int n, int g0,
                                            float h2, cudaStream_t stream) {
  const int nn = n * n;
  const int nc = (n + 1) / 2;
  const mg::Seg out = mg::make_seg(o_lh, o_body, o_rh, H, L, H, 0, nn);
  const mg::Seg e = mg::make_seg(e_lh, e_body, e_rh, H, L, H, e_roff, nn);
  const mg::Seg r = mg::make_seg(r_lh, r_body, r_rh, H, L, H, r_roff, nn);
  const mg::Seg c = mg::make_seg(c_lh, c_body, c_rh, kl_c, L / 2, kr_c, c_roff, nc * nc);
  return launch_prolong_correct_black(out, c, e, r, mg::Span{-H, L + 2 * H, 0, n}, n, g0, 0,
                                      h2, -H + 1, L + H - 2, 0, n - 1, stream);
}

// The first form (n_iter > 2), K40's first launch: out rows [-H, L + H) x
// columns [-H, Lj + H) <- e + P
// ec, black interior points off the edge rows and columns swept once; out
// must not alias e. Descriptors (seg2d.cuh): e, r, out with halo H in i
// and j, the coarse block c of (L / 2, Lj / 2) with n_iter halo rows and
// columns before it and n_iter + 1 after; (g0, gj0) = global fine indices
// of body row and column 0 (both even).
extern "C" int mg_seg2d_prolong_correct_black(const long long* o_desc, const long long* c_desc,
                                              const long long* e_desc, const long long* r_desc,
                                              int H, int L, int Lj, int n, int g0, int gj0,
                                              float h2, cudaStream_t stream) {
  return launch_prolong_correct_black(
      mg::seg2_from_desc(o_desc, L, Lj), mg::seg2_from_desc(c_desc, L / 2, Lj / 2),
      mg::seg2_from_desc(e_desc, L, Lj), mg::seg2_from_desc(r_desc, L, Lj),
      mg::Span{-H, L + 2 * H, -H, Lj + 2 * H}, n, g0, gj0, h2, -H + 1, L + H - 2, -H + 1,
      Lj + H - 2, stream);
}
