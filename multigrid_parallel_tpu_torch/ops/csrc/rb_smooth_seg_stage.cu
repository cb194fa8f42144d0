// The red-black stage on one rank's segmented block, from a loaded initial
// guess (K1's one-pass stage: K28 on an i-sharded field, K37 on an (i,
// j)-sharded one) or from a zero one (K2's: K29 and K38), into a fresh
// owned body.
//
// Replaces the Pallas kernels multigrid_parallel_tpu/ops/pallas_sharded.py:
// rb_smooth_ext and rb_smooth_halo (K28), rb_smooth_from_zero_ext and
// rb_smooth_from_zero_halo (K29), and their (i, j) twins of
// pallas_sharded2d.py, rb_smooth_ext2d and rb_smooth_halo2d (K37),
// rb_smooth_from_zero_ext2d and rb_smooth_from_zero_halo2d (K38), which
// run all 2 n_iter half-sweeps of a smoothing stage on a block with a halo
// of H = 2 n_iter planes (on an (i, j) block in j as in i) in one pass.
//
// For n_iter <= 2 it is one launch of K1's one-pass stage (rect.cuh,
// Layout::kSegRect, no Prep) on the segments: u and f read through their
// segments (a tile row's pointer looked up once, Seg::row or Seg2::at), red
// or black first, the Dirichlet sweeps (no boundary node swept), the
// blocks tiling the rank's planes and, on Seg2, its columns clipped to n -
// 1 (the loaded box clipped to the field only: a block at a rank's edge
// reads the halos and, on Seg2, the corner blocks), the store the rank's
// owned nodes only, boundary nodes with their loaded values, into a fresh
// (L, n, n) or (L, Lj, n) body. The pad points past n - 1 are never loaded
// or swept: every warp of the launch copies its share of them from u's
// body, as the plain versions leave them (seg_pad_copy). So the owned
// points equal K1's on the whole field bit for bit, in one launch a call,
// u's segments only read. Bound: device-memory bytes, u and f read and the
// body written, 12 B a point. K29 and K38 are the same launch with ZERO
// (K2's stage): nothing of u is read, the tile planes start as zeros
// (tile_zero), f alone is read through its segments, the boundary nodes
// store the zero tile's 0, and every warp writes its share of the pad
// points as 0 (seg_pad_copy<true>); the owned points equal K2's on the
// whole field bit for bit. Bound: f read and the body written, 8 B a
// point. The design answers the first form's costs (rb_smooth_seg.cu,
// which every stage past n_iter 2 still launches): 2 n_iter launches a
// call, each a pass over the whole halo-extended block, every neighbour
// read through the descriptor, and K29's and K38's scratch halo buffers.
#include "rect.cuh"

namespace {

using namespace mg::rect;

template <int NITER, bool BOX, class Args>
__global__ void __launch_bounds__(kSegStageMaxThreads) seg_smooth_stage_kernel(Args a) {
  extern __shared__ __align__(16) float tile[];
  seg_pad_copy(a);
  if constexpr (BOX) {
    box_body<NITER, false, Layout::kSegRect>(a, tile, mg::split::NoPrep{});
  } else {
    stage_body<NITER, false, Layout::kSegRect>(a, tile, mg::split::NoPrep{});
  }
}

// K29's and K38's: the stage from a zero tile, the pad points 0. A kernel
// of its own name, which a trace tells from K28's without its arguments.
template <int NITER, bool BOX, class Args>
__global__ void __launch_bounds__(kSegStageMaxThreads) seg_smooth_from_zero_stage_kernel(Args a) {
  extern __shared__ __align__(16) float tile[];
  seg_pad_copy<true>(a);
  if constexpr (BOX) {
    box_body<NITER, true, Layout::kSegRect>(a, tile, mg::split::NoPrep{});
  } else {
    stage_body<NITER, true, Layout::kSegRect>(a, tile, mg::split::NoPrep{});
  }
}

template <int NITER, bool ZERO, class Args>
int launch_seg_smooth_stage(const Args& a, int box, int threads, int smem, cudaStream_t stream) {
  if constexpr (ZERO) {
    return box ? launch_stage(seg_smooth_from_zero_stage_kernel<NITER, true, Args>, a, threads,
                              smem, stream)
               : launch_stage(seg_smooth_from_zero_stage_kernel<NITER, false, Args>, a, threads,
                              smem, stream);
  } else {
    return box ? launch_stage(seg_smooth_stage_kernel<NITER, true, Args>, a, threads, smem,
                              stream)
               : launch_stage(seg_smooth_stage_kernel<NITER, false, Args>, a, threads, smem,
                              stream);
  }
}

// The plan and the launch of a K28 or K37 stage (ZERO: K29 or K38) whose
// geometry is set: 0, or cudaErrorInvalidValue for a plan the kernels do
// not take.
template <bool ZERO, class Args>
int seg_smooth_stage(Args& a, int red_first, int n_iter, int bi, int bj, int bk, int k_halo,
                     int threads, int smem, int box, cudaStream_t stream) {
  a.color0 = red_first ? mg::split::kRed : mg::split::kBlack;
  a.bi = bi;
  a.bj = bj;
  a.bk = bk;
  a.k_halo = k_halo;
  if (const int err = stage_plan_error(a, n_iter, threads, smem, box, kSegStageMaxThreads))
    return err;
  return n_iter == 1 ? launch_seg_smooth_stage<1, ZERO>(a, box, threads, smem, stream)
                     : launch_seg_smooth_stage<2, ZERO>(a, box, threads, smem, stream);
}

using mg::meets;

}  // namespace

// The K28 stage: the (L, n, n) body out <- n_iter (1 or 2) RB-GS
// iterations of u against f, red first or black first, on one rank's
// segments, on the plan (bi, bj, bk, k_halo, threads, smem, box) of
// pallas_split._stage_plan (rect, seg_planes = the planes the launch
// tiles). u and f have kl rows on the left and kr on the right (at least H
// = 2 n_iter); g0 = the global plane of body row 0. Pad rows (past n - 1)
// take u's. out must meet no part of u or f.
extern "C" int mg_seg_smooth_stage(float* out, float* u_lh, float* u_body, float* u_rh,
                                   int u_roff, float* f_lh, float* f_body, float* f_rh, int f_roff,
                                   int kl, int L, int kr, int n, int g0, float h2, int red_first,
                                   int n_iter, int bi, int bj, int bk, int k_halo, int threads,
                                   int smem, int box, cudaStream_t stream) {
  const int nn = n * n, H = 2 * n_iter;
  SegStageArgs a{};
  a.out = out;
  a.in = u_body;
  a.f = f_body;
  a.in_s = mg::make_seg(u_lh, u_body, u_rh, kl, L, kr, u_roff, nn);
  a.f_s = mg::make_seg(f_lh, f_body, f_rh, kl, L, kr, f_roff, nn);
  a.n = n;
  a.h2 = h2;
  const long long count = (long long)L * nn;
  if (n % 2 == 0 || out == nullptr || u_body == nullptr || f_body == nullptr ||
      (n_iter != 1 && n_iter != 2) || meets(out, count, a.in_s, kr) ||
      meets(out, count, a.f_s, kr))
    return (int)cudaErrorInvalidValue;
  if (const int err = seg_rect_geometry(a, g0, L, kl, kr, H)) return err;
  return seg_smooth_stage<false>(a, red_first, n_iter, bi, bj, bk, k_halo, threads, smem, box,
                                 stream);
}

// The K37 stage: the (L, Lj, n) body out <- the same on one rank's (i, j)
// block. Descriptors (seg2d.cuh): u and f with halos of at least H rows and
// columns before the block (their kl and hj) and kr rows and hjr columns
// after it; (g0, gj0) = the global row and column of body point (0, 0);
// the plan of _stage_plan(rect, seg_planes, seg_cols). Pad rows and columns
// (past n - 1) take u's. out must meet no part of u or f.
extern "C" int mg_seg2d_smooth_stage(float* out, const long long* u_desc,
                                     const long long* f_desc, int kr, int hjr, int L, int Lj,
                                     int n, int g0, int gj0, float h2, int red_first, int n_iter,
                                     int bi, int bj, int bk, int k_halo, int threads, int smem,
                                     int box, cudaStream_t stream) {
  const int H = 2 * n_iter;
  Seg2StageArgs a{};
  a.out = out;
  a.in_s = mg::seg2_from_desc(u_desc, L, Lj);
  a.f_s = mg::seg2_from_desc(f_desc, L, Lj);
  a.in = a.in_s.body;
  a.f = a.f_s.body;
  a.n = n;
  a.h2 = h2;
  const long long count = (long long)L * Lj * n;
  if (n % 2 == 0 || out == nullptr || a.in == nullptr || a.f == nullptr ||
      (n_iter != 1 && n_iter != 2) || meets(out, count, a.in_s, kr, hjr, n) ||
      meets(out, count, a.f_s, kr, hjr, n))
    return (int)cudaErrorInvalidValue;
  const int kl = a.in_s.kl < a.f_s.kl ? a.in_s.kl : a.f_s.kl;
  const int hjl = a.in_s.hj < a.f_s.hj ? a.in_s.hj : a.f_s.hj;
  if (const int err = seg_rect_geometry(a, g0, L, gj0, Lj, kl, kr, hjl, hjr, H)) return err;
  return seg_smooth_stage<false>(a, red_first, n_iter, bi, bj, bk, k_halo, threads, smem, box,
                                 stream);
}

// The K29 stage: the (L, n, n) body out <- n_iter (1 or 2) RB-GS
// iterations from a zero initial guess against f, red first or black
// first, on one rank's segments, on the plan of pallas_split._stage_plan
// (rect, seg_planes = the planes the launch tiles). f has kl rows on the
// left and kr on the right (at least H = 2 n_iter); g0 = the global plane
// of body row 0. Pad rows (past n - 1) are 0. out must meet no part of f.
extern "C" int mg_seg_smooth_from_zero_stage(float* out, float* f_lh, float* f_body, float* f_rh,
                                             int f_roff, int kl, int L, int kr, int n, int g0,
                                             float h2, int red_first, int n_iter, int bi, int bj,
                                             int bk, int k_halo, int threads, int smem, int box,
                                             cudaStream_t stream) {
  const int nn = n * n, H = 2 * n_iter;
  SegStageArgs a{};
  a.out = out;
  a.in = nullptr;  // a zero initial guess: in_s is never read
  a.f = f_body;    // also tile_zero's source address, which it never reads
  a.f_s = mg::make_seg(f_lh, f_body, f_rh, kl, L, kr, f_roff, nn);
  a.n = n;
  a.h2 = h2;
  const long long count = (long long)L * nn;
  if (n % 2 == 0 || out == nullptr || f_body == nullptr || (n_iter != 1 && n_iter != 2) ||
      meets(out, count, a.f_s, kr))
    return (int)cudaErrorInvalidValue;
  if (const int err = seg_rect_geometry(a, g0, L, kl, kr, H)) return err;
  return seg_smooth_stage<true>(a, red_first, n_iter, bi, bj, bk, k_halo, threads, smem, box,
                                stream);
}

// The K38 stage: the (L, Lj, n) body out <- the same on one rank's (i, j)
// block. f's descriptor (seg2d.cuh): a halo of at least H rows and columns
// before the block (its kl and hj) and kr rows and hjr columns after it;
// (g0, gj0) = the global row and column of body point (0, 0); the plan of
// _stage_plan(rect, seg_planes, seg_cols). Pad rows and columns (past n -
// 1) are 0. out must meet no part of f.
extern "C" int mg_seg2d_smooth_from_zero_stage(float* out, const long long* f_desc, int kr,
                                               int hjr, int L, int Lj, int n, int g0, int gj0,
                                               float h2, int red_first, int n_iter, int bi,
                                               int bj, int bk, int k_halo, int threads, int smem,
                                               int box, cudaStream_t stream) {
  const int H = 2 * n_iter;
  Seg2StageArgs a{};
  a.out = out;
  a.f_s = mg::seg2_from_desc(f_desc, L, Lj);
  a.in = nullptr;  // a zero initial guess: in_s is never read
  a.f = a.f_s.body;
  a.n = n;
  a.h2 = h2;
  const long long count = (long long)L * Lj * n;
  if (n % 2 == 0 || out == nullptr || a.f == nullptr || (n_iter != 1 && n_iter != 2) ||
      meets(out, count, a.f_s, kr, hjr, n))
    return (int)cudaErrorInvalidValue;
  if (const int err = seg_rect_geometry(a, g0, L, gj0, Lj, a.f_s.kl, kr, a.f_s.hj, hjr, H))
    return err;
  return seg_smooth_stage<true>(a, red_first, n_iter, bi, bj, bk, k_halo, threads, smem, box,
                                stream);
}
