// The one-pass smoothing stage on a plain (n, n, n) field (K2 and K4,
// rb_smooth.cu and prolong_smooth.cu): all 2 n_iter half-sweeps of a stage
// on a tile held in shared memory, in one launch.
//
// The tile de-interleaves the colours. A tile row holds a field row (i, j)
// as two rows of slots, one a colour: slot kk of a colour holds
// k = 2 kk + 1 + p, with p = (i + j) mod 2 for RED and 1 - that for BLACK
// (the split layout of split.cuh, where the colour with p = 1 also holds
// k = 0, at slot -1, and k = n - 1 at slot S - 1, S = n / 2 rounded down).
// So every lane of a sweep works on its colour, 4 slots a lane, 16-byte
// shared-memory loads and stores, and split.cuh's schedule applies as it
// is: a half-sweep reads the other colour at planes q - 1 .. q + 1, and at
// slots kk - 1 .. kk + 1. The field's rows are not 16-byte aligned (n is
// odd), so the loader copies 4 bytes a thread, consecutive k across a warp,
// each to its colour's row; the store writes both colours of a plane back,
// consecutive k across a warp, once its last half-sweep is done.
//
// Each slot sums its neighbours in the plain version's order (ops3.
// neighbor_sum: i - 1, i + 1, j - 1, j + 1, k - 1, k + 1), the k - 1 and
// k + 1 ones read from the tile at every k (the boundary values k = 0 and
// n - 1 are in it), then (sum - h^2 f) (1/6), one IEEE operation at a time:
// the stage equals its plain version bit for bit. f is read from device
// memory at each half-sweep (from L2 after the first), 4 bytes a slot.
//
// The tile of a block: planes [i0, i1), rows [j0, j1) and slots [k0, k1)
// owned, loaded with halos of H = 2 n_iter planes and rows and, where a row
// does not fit, k_halo >= H slots; a whole-row tile row is S rounded up to
// 4, plus 4 columns before slot 0 (slot -1 in the last of them), so every
// 4-slot group of every tile row starts on 16 bytes. The region of
// half-sweep s is the loaded box shrunk by s on every side that is not the
// field's edge (see split.cuh, stage_body).
//
// Two schedules run on that tile, the plan (pallas_split._stage_plan,
// rect) choosing by the level's size. The wavefront (stage_body, split.cuh's
// schedule) streams the block's planes through rings: a block takes
// i1 - i0 + 3 H + 1 steps of two barriers whatever its size, a floor of
// tens of microseconds a launch on a small level. The box (box_body), up to
// RECT_BOX_MAX_N (129^3 on the H100), holds every plane of its loaded box at
// once and runs the H half-sweeps one after another, a barrier each:
// fewer, larger steps where the blocks' boxes fit in shared memory. On both,
// a warp sweeps 32 / lanes tile rows at once (row_lanes), so that the
// levels of 64 slots a row and fewer keep every lane busy.
//
// The layout (Layout) says what the stage runs on. kRect: the plain
// field above (K1, K2, K4). The electrospray's mixed-BC stages run the same
// schedule with two changes, on one of three layouts (mixed.cuh):
//   kFold (K17, K19; mixed_rb_smooth_fold.cu, mixed_prolong_smooth_fold.cu):
//     an (n, n, n - 2) field whose stored slot kk holds grid plane
//     k = kk + 1. The colour rows place k = 1 .. n - 2 in the same slots;
//     the k-face slots (slot -1 and, for n odd, slot S - 1 of the colour
//     with p = 1) hold no stored point. The loader, the store and f
//     address fold rows; the pins are (2, n, n - 2) fold columns.
//   kMixed (K13, K14, K15; mixed_rb_smooth.cu, mixed_prolong_smooth.cu):
//     the plain (n, n, n) field's addressing; the k-face slots hold the
//     loaded k = 0 and n - 1 values (zeros for K14); the pins are (2, n, n).
//   kSeg (K34, K35, K36; mixed_rb_smooth_seg.cu, mixed_prolong_smooth_seg.cu):
//     kMixed on one rank's segmented block of an i-sharded field (seg.cuh),
//     planes read through the segments at GLOBAL plane q = g0 + t (a
//     plane's pointer looked up once where a plane or a row starts, never
//     a point), so q, the colours, the masks and the pins are the whole
//     field's. The blocks tile the planes [c0, c1) (seg_geometry): the
//     rank's rows, clipped to q <= n - 1, and plane n - 2 too where plane
//     n - 1 is the rank's row 0; the loaded box is clipped to the field
//     only, so a block at a rank's edge reads the halo rows, and its
//     regions shrink from them as from any tile edge. The store writes
//     only the rank's own nodes, planes [g0, o1), into its fresh (L, n,
//     n) body: plane n - 1 at row 0 from the final value of plane n - 2
//     in the tile (a halo row: the reason for its extra plane). The rows
//     past n - 1 are pad, never loaded or swept: every block of the launch
//     writes its share of them (seg_pad_fill), 0 or u's (e's) rows.
// kSegRect (K31, K40; prolong_smooth_seg.cu; and K28, K37 with no Prep,
// K1's stage, and K29, K38, K2's from a zero tile, rb_smooth_seg_stage.cu)
// is kRect's Dirichlet stage on
// one rank's segmented block: planes at GLOBAL q as kSeg's, on an
// i-sharded field (SegStageArgs, seg.cuh) or on an (i, j)-sharded one
// (Seg2StageArgs, seg2d.cuh), whose blocks also tile the rank's columns
// [gj0, cj1) (clipped to n - 1; the loaded box is clipped to the field
// only, so a block at the rank's j edge reads the j halos and the corner
// blocks). A tile row's pointer is looked up once, where the loader, a
// sweep or the store starts the row (in_row, f_row_at, store_row), never
// a point. No selects and no BC pass: the boundary nodes keep the values
// they were loaded with (K4's e + P ec); the store writes the rank's owned
// nodes, planes [g0, o1) and columns [gj0, cj1), into its fresh body; the
// pad points past n - 1 are never loaded or swept: every block writes its
// share of them as the plain versions leave them (seg_pad_prolong, e + P
// ec; K28, K37: seg_pad_copy, u's own values; K29, K38: 0).
// The two changes. (1) The selects: a neighbour across a face (i or j at 1
// or n - 2, k at 1 or n - 2) is read as the reader's own value, 0 at a
// pinned x-face node (mixed_nbr_sum's rule), as a select in the sweep, in
// the same order of the six adds: never from a tile slot of the face, which
// holds a value of the first half-sweep's input (or none), so no sweep uses
// the k-face slots. The pins are read through the read-only path (__ldg),
// not staged: only the rows of planes 1 and n - 2 read them, 4 values a
// lane's group, 0.5 MB at 257^3 that stays in L2. (2) The BC pass runs at
// store time (mixed_store): the block that owns an interior point (i, j, k)
// writes it and the boundary nodes whose copy source it is, (c(i), c(j),
// c(k)) = (i, j, k) with c mapping 0 -> 1, n - 1 -> n - 2 (0 at a pinned
// x-face node, the pin tested at the node's own (j, k)), from its final
// value: the x faces whole, the y faces, and (kMixed) the z faces, each
// node exactly once whatever the plan, and never before its source's last
// half-sweep. The fold stores no z face.
//
// RESID (K26, rb_smooth_residual.cu): kRect's stage with u loaded (K1's)
// that also writes the residual of its result, f - (1/h^2)(sum6(u') -
// 6 u'), 0 on the boundary, into a second fresh field (resid_store). Two
// changes. (1) Halos of H + 1 planes, rows and (k_halo >= H + 1) slots: the
// regions shrink from the loaded box as before, so after H half-sweeps
// both colours are final one point past the owned box, where the residual
// of its edge reads. (2) Plane q's residual is taken, and u' and r of
// plane q stored, a step after plane q + 1's last half-sweep (the
// wavefront's step q + 2 H + 2, when planes q - 1 .. q + 1 are final), so
// each colour's ring holds 2 H + 5 planes, two more than K1's; the box
// stores after its last half-sweep as before. The residual sums the six
// neighbours of a point, all of the other colour, in ops3.neighbor_sum's
// order (i - 1, i + 1, j - 1, j + 1, k - 1, k + 1), as R's plain version.
#pragma once

#include "seg.cuh"
#include "seg2d.cuh"
#include "split.cuh"

namespace mg {
namespace rect {

using split::comp;
using split::cp_async4;
using split::cp_async_commit;
using split::cp_async_wait_all_but_one;
using split::cp_async_zero;
using split::ld4;
using split::st4;
using split::stage_depth;

constexpr int kRowPad = 4;  // tile columns before slot 0 of a whole-row tile row

// The most threads a rect stage block runs (its kernels' launch bound):
// 18 warps, which lets ptxas give a thread up to 112 registers where
// split.cuh's 640 allow 96 (the stage kernels take 73-94; PERF.md).
constexpr int kStageMaxThreads = 576;

// The segment stages' (K34, K35, K36) launch bound: 16 warps, so up to 128
// registers a thread; K36's wavefront at n_iter 2 spilled under 576
// threads' 96 (the 18 warps' 5 a scheduler), and both ran no slower on
// 512 (PERF.md, stage_plans --seg).
constexpr int kSegStageMaxThreads = 512;

__host__ __device__ inline int slots(int n) { return n >> 1; }

// p of `color` in row (i, j): its slot kk holds k = 2 kk + 1 + p.
__device__ inline int parity(int i, int j, int color) { return ((i + j) & 1) ^ color ^ 1; }

enum class Layout { kRect, kFold, kMixed, kSeg, kSegRect };

// The mixed-BC selects and the BC pass at store time (the header).
__host__ __device__ constexpr bool mixed_bc(Layout L) {
  return L != Layout::kRect && L != Layout::kSegRect;
}

// Offset of grid point (q, j, k) in an (n, n, n) field, or in an (n, n,
// n - 2) one of the fold layout (kFold; 1 <= k <= n - 2).
template <Layout L>
__device__ inline int field_at(int n, int q, int j, int k) {
  return L == Layout::kFold ? (q * n + j) * (n - 2) + k - 1 : (q * n + j) * n + k;
}

// The pin planes' columns, and the grid plane k of column 0.
__host__ __device__ constexpr int pin_cols(Layout L, int n) {
  return L == Layout::kFold ? n - 2 : n;
}
__host__ __device__ constexpr int pin_k0(Layout L) { return L == Layout::kFold ? 1 : 0; }

struct StageArgs {
  float* out;
  const float* in;  // the initial guess; nullptr for a zero one (K2)
  const float* f;
  const float* pin;  // kFold, kMixed: the x-face pin planes (pin_cols columns)
  int color0;  // kRed or kBlack: the colour of the first half-sweep
  int n;
  float h2;
  int bi, bj, bk, k_halo;  // the plan (pallas_split._stage_plan, rect)
};

// RESID (K26): the residual's fresh field and 1 / h^2 beside K1's arguments.
struct ResidStageArgs : StageArgs {
  float* r;
  float inv_h2;
};

// kSeg: the launch's segments (in, f: rows at GLOBAL plane g0 + t; out the
// rank's L body rows), and the planes [c0, c1) its blocks tile and [g0,
// o1) whose nodes they store (seg_geometry). The stage reads them through
// the overloads below, which give the plain fields for StageArgs.
struct SegStageArgs : StageArgs {
  Seg in_s, f_s;
  int g0, L, c0, c1, o1;
};

// The pointer the loader adds field_at(n, q, j, k) to for plane q of the
// initial guess, and f's: the field, or (kSeg) the segment's row q - g0
// less q planes, looked up once a plane or a tile row; the stores' base:
// out, or the body less g0 planes.
__device__ inline const float* in_base(const StageArgs& a, int) { return a.in; }
__device__ inline const float* f_base(const StageArgs& a, int) { return a.f; }
__device__ inline float* store_base(const StageArgs& a) { return a.out; }
__device__ inline const float* in_base(const SegStageArgs& a, int q) {
  return a.in_s.row(q - a.g0) - (long long)q * a.n * a.n;
}
__device__ inline const float* f_base(const SegStageArgs& a, int q) {
  return a.f_s.row(q - a.g0) - (long long)q * a.n * a.n;
}
__device__ inline float* store_base(const SegStageArgs& a) {
  return a.out - (long long)a.g0 * a.n * a.n;
}

// kSegRect on an (i, j)-sharded field: the launch's segments (seg2d.cuh;
// in, f: point (t, j) at GLOBAL plane g0 + t and column gj0 + j; out the
// rank's (L, Lj, n) body), and the planes [g0, o1) and columns [gj0, cj1)
// its blocks tile and store (seg_rect_geometry).
struct Seg2StageArgs : StageArgs {
  Seg2 in_s, f_s;
  int g0, L, o1;
  int gj0, Lj, cj1;
};

// kSegRect: the k row of GLOBAL point (q, j) of the initial guess, of f,
// and of the output body, looked up once a row.
__device__ inline const float* in_row(const SegStageArgs& a, int q, int j) {
  return a.in_s.row(q - a.g0) + j * a.n;
}
__device__ inline const float* in_row(const Seg2StageArgs& a, int q, int j) {
  return a.in_s.at(q - a.g0, j - a.gj0, a.n);
}
__device__ inline const float* f_row_at(const SegStageArgs& a, int q, int j) {
  return a.f_s.row(q - a.g0) + j * a.n;
}
__device__ inline const float* f_row_at(const Seg2StageArgs& a, int q, int j) {
  return a.f_s.at(q - a.g0, j - a.gj0, a.n);
}
__device__ inline float* store_row(const SegStageArgs& a, int q, int j) {
  return a.out + ((long long)(q - a.g0) * a.n + j) * a.n;
}
__device__ inline float* store_row(const Seg2StageArgs& a, int q, int j) {
  return a.out + ((long long)(q - a.g0) * a.Lj + j - a.gj0) * a.n;
}

// The planes a launch's blocks tile, and those whose nodes it stores.
__host__ __device__ inline int planes_lo(const StageArgs&) { return 0; }
__host__ __device__ inline int planes_hi(const StageArgs& a) { return a.n; }
__host__ __device__ inline int planes_lo(const SegStageArgs& a) { return a.c0; }
__host__ __device__ inline int planes_hi(const SegStageArgs& a) { return a.c1; }
__host__ __device__ inline int planes_lo(const Seg2StageArgs& a) { return a.g0; }
__host__ __device__ inline int planes_hi(const Seg2StageArgs& a) { return a.o1; }
// The rows (j) a launch's blocks tile, and their count of row tiles (at
// least one: a rank of pad columns only tiles none); on Seg2 the rank's
// columns. The owned columns of a body row, and the global column of its
// column 0.
__host__ __device__ inline int cols_lo(const StageArgs&) { return 0; }
__host__ __device__ inline int cols_hi(const StageArgs& a) { return a.n; }
__host__ __device__ inline int row_tiles(const StageArgs& a) { return (a.n + a.bj - 1) / a.bj; }
__host__ __device__ inline int body_cols(const StageArgs& a) { return a.n; }
__host__ __device__ inline int body_col0(const StageArgs&) { return 0; }
__host__ __device__ inline int cols_lo(const Seg2StageArgs& a) { return a.gj0; }
__host__ __device__ inline int cols_hi(const Seg2StageArgs& a) { return a.cj1; }
__host__ __device__ inline int row_tiles(const Seg2StageArgs& a) {
  const int tiles = (a.cj1 - a.gj0 + a.bj - 1) / a.bj;
  return tiles > 1 ? tiles : 1;
}
__host__ __device__ inline int body_cols(const Seg2StageArgs& a) { return a.Lj; }
__host__ __device__ inline int body_col0(const Seg2StageArgs& a) { return a.gj0; }
__device__ inline int stored_lo(const StageArgs&) { return 0; }
__device__ inline int stored_hi(const StageArgs& a) { return a.n; }
__device__ inline int stored_lo(const SegStageArgs& a) { return a.g0; }
__device__ inline int stored_hi(const SegStageArgs& a) { return a.o1; }

// kSeg: the planes of a rank's launch from its g0 (the global plane of
// body row 0), its L rows and its segments' halos kl, kr (at least H = 2
// n_iter a side, and H + 1 on the left where plane n - 1 is row 0); 0, or
// cudaErrorInvalidValue for halos too short. A rank of pad rows only (g0 >
// n - 1) tiles no plane.
inline int seg_geometry(SegStageArgs& a, int g0, int L, int kl, int kr, int H) {
  const int n = a.n, last = g0 == n - 1;
  if (g0 < 0 || L < 1 || kl < H + last || kr < H) return (int)cudaErrorInvalidValue;
  a.g0 = g0;
  a.L = L;
  a.c0 = g0 - last;
  a.o1 = g0 + L < n ? g0 + L : (g0 < n ? n : g0);
  a.c1 = g0 < n ? a.o1 : a.c0;
  return 0;
}

// kSegRect: the end of a rank's rows (or columns) [g0, g0 + L) clipped to
// n - 1; g0 for a rank of pad rows only, which tiles none. The Dirichlet
// stage tiles and stores the same planes (it stores no node of another
// plane, and plane n - 1 at row 0 is a boundary plane that keeps its
// loaded value).
inline int clipped_end(int g0, int L, int n) { return g0 < n ? std::min(g0 + L, n) : g0; }

// kSegRect's geometry from a rank's g0 and L rows (on Seg2 also gj0 and Lj
// columns): 0, or cudaErrorInvalidValue for halos kl, kr (on Seg2 also
// hjl, hjr) shorter than H.
inline int seg_rect_geometry(SegStageArgs& a, int g0, int L, int kl, int kr, int H) {
  if (g0 < 0 || L < 1 || kl < H || kr < H) return (int)cudaErrorInvalidValue;
  a.g0 = a.c0 = g0;
  a.L = L;
  a.o1 = a.c1 = clipped_end(g0, L, a.n);
  return 0;
}

inline int seg_rect_geometry(Seg2StageArgs& a, int g0, int L, int gj0, int Lj, int kl, int kr,
                             int hjl, int hjr, int H) {
  if (g0 < 0 || L < 1 || gj0 < 0 || Lj < 1 || kl < H || kr < H || hjl < H || hjr < H)
    return (int)cudaErrorInvalidValue;
  a.g0 = g0;
  a.L = L;
  a.o1 = clipped_end(g0, L, a.n);
  a.gj0 = gj0;
  a.Lj = Lj;
  a.cj1 = clipped_end(gj0, Lj, a.n);
  return 0;
}

// Floats in a tile row (one colour).
__host__ __device__ inline int tile_width(int n, int bk, int k_halo) {
  return k_halo ? bk + 2 * k_halo : (slots(n) + 3) / 4 * 4 + kRowPad;
}

// Tile planes a colour holds: a ring of stage_depth(H) (the wavefront), or
// the loaded box's bi + 2 H (the box).
__host__ __device__ inline int tile_planes(int bi, int H, bool box) {
  return box ? bi + 2 * H : stage_depth(H);
}

// Shared-memory bytes of the two colours' tile planes: the same formula as
// pallas_split._stage_smem (rect); the launchers reject a plan that differs.
// ``resid`` (K26): halos of H + 1, and a wavefront ring 2 planes deeper.
__host__ __device__ inline long long stage_smem_bytes(int n, int n_iter, int bi, int bj, int bk,
                                                      int k_halo, bool box, bool resid = false) {
  const int H = 2 * n_iter, HH = H + resid;
  const int planes = box ? tile_planes(bi, HH, true) : stage_depth(H) + 2 * resid;
  return 2LL * planes * (bj + 2 * HH) * tile_width(n, bk, k_halo) * 4;
}

// The coarse tile of a prolongation stage (K4, K19), beside the fine one:
// its rows and row width for a plan, the coarse rows ja >> 1 .. jb >> 1
// and coarse k max(ka, 0) .. kb that the loaded fine box interpolates
// from, with room for the last 4-slot group's reads; its planes, a ring of
// 3 (the wavefront), or every coarse plane the loaded box's bi + 2 H fine
// planes interpolate from (the box). pallas_split._stage_smem plans with
// the same sizes.
__host__ __device__ inline int coarse_rows(int bj, int H) { return (bj + 2 * H) / 2 + 2; }
__host__ __device__ inline int coarse_width(int W) { return W + 4; }
__host__ __device__ inline int coarse_planes(int bi, int H, bool box) {
  return box ? (bi + 2 * H) / 2 + 2 : 3;
}

// The launch's blocks: the plan's tiles of the planes it tiles, at least
// one along i (a pad rank's blocks write its pad rows only).
template <class Args>
inline int stage_blocks(const Args& a) {
  const int S = slots(a.n), planes = planes_hi(a) - planes_lo(a);
  return std::max(1, (planes + a.bi - 1) / a.bi) * row_tiles(a) * ((S + a.bk - 1) / a.bk);
}

// 0 when the plan is one the stage kernels take: n_iter 1 or 2, whole rows
// or k tiles of a multiple of 4 slots with a halo of a multiple of 4 at
// least H (``resid``, K26: H + 1, and no wider than a tile), the shared
// memory it names (`smem` less any extra the caller adds), at most
// ``max_threads`` threads (the kernel's launch bound).
inline int stage_plan_error(const StageArgs& a, int n_iter, int threads, long long smem,
                            bool box, int max_threads = kStageMaxThreads, bool resid = false) {
  const int S = slots(a.n), H = 2 * n_iter + resid;
  const bool whole_rows = a.k_halo == 0 && a.bk == S;
  const bool k_tiles = a.k_halo >= H && a.k_halo % 4 == 0 && a.bk % 4 == 0 && a.bk >= 4 &&
                       a.bk < S && (!resid || a.bk >= a.k_halo);
  if (a.n < 3 || (n_iter != 1 && n_iter != 2) || a.bi < 1 || a.bj < 1 ||
      !(whole_rows || k_tiles) || threads < 32 || threads > max_threads || threads % 32 ||
      smem != stage_smem_bytes(a.n, n_iter, a.bi, a.bj, a.bk, a.k_halo, box, resid))
    return (int)cudaErrorInvalidValue;
  return 0;
}

// One block's box and tile (global indices; clipped to the field).
struct Geom {
  int n, S;
  int i0, i1, j0, j1, k0, k1;  // the owned planes, rows and slots
  int jb0, kb0;                // global row / slot of tile row 0 / column 0
  int ia, ib, ja, jb, ka, kb;  // the loaded planes, rows and slots (ka -1: k = 0)
  int kra, krb, kr0, kr1;      // the loaded and the owned k of the field
  int R, W, P;                 // tile rows, floats per tile row, per tile plane
};

template <class Args>
__device__ inline Geom geometry(const Args& a, int H) {
  Geom t;
  const int n = a.n, S = slots(n);
  t.n = n;
  t.S = S;
  const int nj = row_tiles(a), nk = (S + a.bk - 1) / a.bk;
  const int tk = blockIdx.x % nk, tj = (blockIdx.x / nk) % nj, ti = blockIdx.x / (nk * nj);
  t.i0 = planes_lo(a) + ti * a.bi;
  t.i1 = min(t.i0 + a.bi, planes_hi(a));
  t.j0 = cols_lo(a) + tj * a.bj;
  t.j1 = min(t.j0 + a.bj, cols_hi(a));
  t.k0 = tk * a.bk;
  t.k1 = min(t.k0 + a.bk, S);
  t.jb0 = t.j0 - H;
  t.kb0 = a.k_halo ? t.k0 - a.k_halo : -kRowPad;
  t.ia = max(t.i0 - H, 0);
  t.ib = min(t.i1 + H, n);
  t.ja = max(t.jb0, 0);
  t.jb = min(t.j1 + H, n);
  t.ka = max(t.kb0, -1);
  t.kb = min(t.k1 + a.k_halo, S);
  // slots [ka, kb) of both colours hold k = 2 ka + 1 .. 2 kb; a block owns
  // k = 0 with slot 0
  t.kra = max(2 * t.ka + 1, 0);
  t.krb = min(2 * t.kb + 1, n);
  t.kr0 = t.k0 == 0 ? 0 : 2 * t.k0 + 1;
  t.kr1 = min(2 * t.k1 + 1, n);
  t.W = tile_width(n, a.bk, a.k_halo);
  t.R = a.bj + 2 * H;
  t.P = t.R * t.W;
  return t;
}

// How a warp spreads over tile rows in a sweep: ``lanes`` lanes a row (the
// fewest, a power of 2 up to 32, that cover a tile row's 4-slot groups in
// one pass), ``rows`` = 32 / lanes rows a warp at once; this thread's row
// of those (sub) and its lane in that row (sl). On a level of 64 slots a
// row, two rows a warp: no lane idles where it could sweep.
struct RowLanes {
  int lanes, rows, sub, sl;
};

__device__ inline RowLanes row_lanes(const StageArgs& a, const Geom& t) {
  const int span = a.k_halo ? t.W : t.W - kRowPad;  // the slots a sweep can reach
  int lanes = 1;
  while (lanes < 32 && 4 * lanes < span) lanes *= 2;
  const int lane = threadIdx.x & 31;
  return {lanes, 32 / lanes, lane / lanes, lane % lanes};
}

// Tile row of field row j of colour `color` in the rings t0 (stage
// colour 0, color0) and t1, at its slot 0.
__device__ inline float* colour_row(float* t0, float* t1, const Geom& t, int j, int color,
                                    int color0) {
  return ((color ^ color0) ? t1 : t0) + (j - t.jb0) * t.W - t.kb0;
}

// Start copying the loaded box of plane q of the field g into the two
// rings' tile planes, a warp a row: k goes to slot (k - 1 - p) / 2 of the
// colour whose slots hold parity p = 1 - (k mod 2) in that row. A lane's k
// keeps its parity from pass to pass (32 apart), so its colour row too.
// kFold: the stored k only, from fold rows.
template <Layout L = Layout::kRect>
__device__ inline void tile_load(float* t0, float* t1, const float* __restrict__ g, const Geom& t,
                                 int q, int color0, int warp, int lane, int nwarps) {
  constexpr bool fold = L == Layout::kFold;
  const int ka = fold ? max(t.kra, 1) : t.kra, kb = fold ? min(t.krb, t.n - 1) : t.krb;
  const int k = ka + lane, p = 1 - (k & 1);
  for (int j = t.ja + warp; j < t.jb; j += nwarps) {
    const int color = ((q + j) & 1) ^ p ^ 1;
    float* d = colour_row(t0, t1, t, j, color, color0) + ((k - 1 - p) >> 1);
    const float* s = g + field_at<L>(t.n, q, j, k);
    for (int m = 0; k + 32 * m < kb; ++m) cp_async4(d + 16 * m, s + 32 * m);
  }
}

// tile_load on a segment (kSegRect): each row's pointer looked up once.
template <class Args>
__device__ inline void seg_tile_load(float* t0, float* t1, const Args& a, const Geom& t, int q,
                                     int color0, int warp, int lane, int nwarps) {
  const int k = t.kra + lane, p = 1 - (k & 1);
  for (int j = t.ja + warp; j < t.jb; j += nwarps) {
    const int color = ((q + j) & 1) ^ p ^ 1;
    float* d = colour_row(t0, t1, t, j, color, color0) + ((k - 1 - p) >> 1);
    const float* s = in_row(a, q, j) + k;
    for (int m = 0; k + 32 * m < t.krb; ++m) cp_async4(d + 16 * m, s + 32 * m);
  }
}

// Start zeroing both rings' tile planes of a plane (a zero initial
// guess, K2): 16-byte zero-filling cp.async copies (split::cp_async_zero),
// issued and waited for as a load's are.
__device__ inline void tile_zero(float* t0, float* t1, const Geom& t, const float* any) {
  for (int v = 4 * threadIdx.x; v < t.P; v += 4 * blockDim.x) {
    cp_async_zero<4>(t0 + v, any);
    cp_async_zero<4>(t1 + v, any);
  }
}

// Write the owned box of plane q, both colours, to the field g, a warp a
// row, consecutive k across a warp.
__device__ inline void tile_store(float* __restrict__ g, float* t0, float* t1, const Geom& t,
                                  int q, int color0, int warp, int lane, int nwarps) {
  const int k = t.kr0 + lane, p = 1 - (k & 1);
  for (int j = t.j0 + warp; j < t.j1; j += nwarps) {
    const int color = ((q + j) & 1) ^ p ^ 1;
    const float* s = colour_row(t0, t1, t, j, color, color0) + ((k - 1 - p) >> 1);
    float* d = g + (q * t.n + j) * t.n + k;
    for (int m = 0; k + 32 * m < t.kr1; ++m) d[32 * m] = s[16 * m];
  }
}

// tile_store into a rank's body (kSegRect): each row's pointer looked up
// once.
template <class Args>
__device__ inline void seg_tile_store(const Args& a, float* t0, float* t1, const Geom& t, int q,
                                      int color0, int warp, int lane, int nwarps) {
  const int k = t.kr0 + lane, p = 1 - (k & 1);
  for (int j = t.j0 + warp; j < t.j1; j += nwarps) {
    const int color = ((q + j) & 1) ^ p ^ 1;
    const float* s = colour_row(t0, t1, t, j, color, color0) + ((k - 1 - p) >> 1);
    float* d = store_row(a, q, j) + k;
    for (int m = 0; k + 32 * m < t.kr1; ++m) d[32 * m] = s[16 * m];
  }
}

// K26's store (RESID): tile_store's points of plane q to a.out and the
// residual of each to a.r, f - inv_h2 (sum6 - 6 u'), 0 at a boundary point;
// the six neighbours of a point are the other colour's, read from the tile
// planes q - 1 (lo), q (mid) and q + 1 (hi) of the rings (stage colour 0's,
// then 1's): the same slot in planes q -+ 1 and rows j -+ 1 (W floats
// apart), and in row j the slots of k - 1 and k + 1, slot - 1 + p and
// slot + p. Summed in ops3.neighbor_sum's order. Run once planes q - 1 ..
// q + 1 are final.
__device__ inline void resid_store(const ResidStageArgs& a, const float* lo0, const float* lo1,
                                   const float* m0, const float* m1, const float* hi0,
                                   const float* hi1, const Geom& t, int q, int warp, int lane,
                                   int nwarps) {
  const int n = t.n, W = t.W, k = t.kr0 + lane, p = 1 - (k & 1), slot = (k - 1 - p) >> 1;
  const bool plane = q >= 1 && q <= n - 2;
  // the lane's slot in the tile row of field row j and colour `color`, in
  // the rings' planes r0 (stage colour 0) and r1
  auto at_slot = [&](const float* r0, const float* r1, int j, int color) {
    return ((color ^ a.color0) ? r1 : r0) + (j - t.jb0) * W - t.kb0 + slot;
  };
  for (int j = t.j0 + warp; j < t.j1; j += nwarps) {
    const int color = ((q + j) & 1) ^ p ^ 1;
    const float* s = at_slot(m0, m1, j, color);
    const float* xl = at_slot(lo0, lo1, j, 1 - color);
    const float* xh = at_slot(hi0, hi1, j, 1 - color);
    const float* xm = at_slot(m0, m1, j, 1 - color);
    const bool row = plane && j >= 1 && j <= n - 2;
    const int at = (q * n + j) * n + k;
    for (int m = 0; k + 32 * m < t.kr1; ++m) {
      const int o = 16 * m, kt = k + 32 * m;
      const float u = s[o];
      float r = 0.0f;
      if (row && kt >= 1 && kt <= n - 2) {
        float sum = xl[o];
        sum = sum + xh[o];
        sum = sum + xm[o - W];
        sum = sum + xm[o + W];
        sum = sum + xm[o - 1 + p];
        sum = sum + xm[o + p];
        r = __ldg(a.f + at + 32 * m) - a.inv_h2 * (sum - 6.0f * u);
      }
      a.out[at + 32 * m] = u;
      a.r[at + 32 * m] = r;
    }
  }
}

// The mixed-BC store with the BC pass (kFold, kMixed, kSeg; the header): the
// nodes of plane q's owned rows and k whose copy source lies in plane q, q
// interior: its interior rows, each with the y-face row it is the source
// of (row 0 with row 1, row n - 1 with row n - 2), in plane q and, where q
// is 1 or n - 2, in the x-face plane 0 or n - 1 too, 0 at a pinned node of
// it. kMixed, kSeg: each row's k faces too, k = 0 from k = 1 and n - 1 from
// n - 2; the block owning slot 0 owns k = 0 and 1 (kr0 = 0), that owning
// slot S - 1 k = n - 2 and n - 1 (kr1 = n), so a k face's source is the
// block's own. A warp a target row, consecutive k across a warp; read once
// plane q's last half-sweep is done, so every boundary node gets its
// source's final value. Only target planes [o0, o1) are written (kSeg: the
// rank's; ``g`` then its store_base).
template <Layout L>
__device__ inline void mixed_store(float* __restrict__ g, float* t0, float* t1, const Geom& t,
                                   int q, int color0, const float* __restrict__ pin, int warp,
                                   int lane, int nwarps, int o0, int o1) {
  constexpr bool faces = L == Layout::kMixed || L == Layout::kSeg;  // the k faces are stored
  const int n = t.n, nk = pin_cols(L, n);
  int jl = max(t.j0, 1), jh = min(t.j1, n - 1);
  if (q < 1 || q > n - 2 || jl >= jh) return;  // an x-face plane: written with its source
  if (jl == 1) jl = 0;
  if (jh == n - 1) jh = n;
  const int rows = jh - jl, planes = 1 + (q == 1) + (q == n - 2);
  const int k = (faces ? t.kr0 : max(t.kr0, 1)) + lane;
  const int k_end = faces ? t.kr1 : min(t.kr1, n - 1), p = 1 - (k & 1);
  for (int v = warp; v < planes * rows; v += nwarps) {
    const int m = v / rows, jt = jl + v % rows;
    const int qt = m == 0 ? q : (m == 1 && q == 1 ? 0 : n - 1);
    if (L == Layout::kSeg && (qt < o0 || qt >= o1)) continue;  // another rank's node
    const int js = jt == 0 ? 1 : (jt == n - 1 ? n - 2 : jt);
    const int color = ((q + js) & 1) ^ p ^ 1;
    const float* s = colour_row(t0, t1, t, js, color, color0) + ((k - 1 - p) >> 1);
    // the odd-k colour's row: k = 1 at slot 0, n - 2 at (n - 3) / 2
    const float* odd = colour_row(t0, t1, t, js, ((q + js) & 1) ^ 1, color0);
    auto value = [&](int i) {  // the source's value of target k + 32 i
      const int kt = k + 32 * i;
      return faces && (kt == 0 || kt == n - 1) ? odd[kt == 0 ? 0 : (n - 3) >> 1] : s[16 * i];
    };
    float* d = g + field_at<L>(n, qt, jt, k);
    if (qt == q) {
      for (int i = 0; k + 32 * i < k_end; ++i) d[32 * i] = value(i);
    } else {
      const float* pr = pin + ((qt == 0 ? 0 : n) + jt) * nk + k - pin_k0(L);
      for (int i = 0; k + 32 * i < k_end; ++i)
        d[32 * i] = __ldg(pr + 32 * i) > 0.5f ? 0.0f : value(i);
    }
  }
}

// f of slots g .. g + 3 of a colour row (f_row[2 kk] is slot kk's; 0 past
// the live slots, whose values are not used).
__device__ inline float4 load_f4(const float* __restrict__ f_row, int g, int k_end) {
  float v[4];
#pragma unroll
  for (int c = 0; c < 4; ++c) v[c] = g + c < k_end ? __ldg(f_row + 2 * (g + c)) : 0.0f;
  return make_float4(v[0], v[1], v[2], v[3]);
}

// The mixed BC: which neighbours of a tile row (q, j) of parity p lie
// across a face, and read the reader's own value (0 at a pinned x-face
// node).
struct MixedFaces {
  const float* pin_lo;  // where q = 1: the x = 0 pins of the row, slot kk's at [2 kk]
  const float* pin_hi;  // where q = n - 2: the x = n - 1 ones
  bool jm, jp;          // j = 1, j = n - 2
  int km, kp;           // the slot at k = 1, at k = n - 2 (-1: none of this parity)
};

template <Layout L>
__device__ inline MixedFaces mixed_faces(const StageArgs& a, int q, int j, int p) {
  const int n = a.n, nk = pin_cols(L, n), c0 = 1 + p - pin_k0(L);  // slot 0's pin column
  MixedFaces fc;
  fc.pin_lo = q == 1 ? a.pin + j * nk + c0 : nullptr;
  fc.pin_hi = q == n - 2 ? a.pin + (n + j) * nk + c0 : nullptr;
  fc.jm = j == 1;
  fc.jp = j == n - 2;
  fc.km = p == 0 ? 0 : -1;                            // k = 2 kk + 1 + p
  fc.kp = ((n - 3 - p) & 1) ? -1 : (n - 3 - p) >> 1;
  return fc;
}

// One half-sweep of the live slots [kl, k_end) of one tile row of parity p
// (tile offset of slot kk: row + kk; f of slot kk: f_row[2 kk] in device
// memory, the lane's first group's prefetched in ``pre`` where ``use_pre``),
// a 4-slot group a lane (rl.sl of the row's rl.lanes), the other slots of
// a group keeping their values. Slot kk's k - 1 and k + 1 neighbours are the other colour's
// slots kk - 1 and kk where p = 0 (k odd), kk and kk + 1 where p = 1.
// MIXED (kFold, kMixed): the neighbours across the faces ``fc`` are
// selects of the slot's own value, in the same order of the adds.
template <bool MIXED = false>
__device__ inline void sweep_row(float* dst, const float* lo, const float* mid, const float* hi,
                                 const float* __restrict__ f_row, int row, int W, int kl,
                                 int k_end, int p, float h2, const RowLanes& rl, bool use_pre,
                                 float4 pre, const MixedFaces& fc = MixedFaces{}) {
  const int g0 = (kl & ~3) + 4 * rl.sl;
  for (int g = g0; g < k_end; g += 4 * rl.lanes) {
    const int o = row + g;
    const float4 vf = use_pre && g == g0 ? pre : load_f4(f_row, g, k_end);
    const float4 vl = ld4(lo + o), vh = ld4(hi + o), vjm = ld4(mid + o - W),
                 vjp = ld4(mid + o + W), vm = ld4(mid + o);
    const bool whole = MIXED || (g >= kl && g + 4 <= k_end);
    const float4 old = whole ? vm : ld4(dst + o);  // kept where a slot is outside
    float km[4], kp[4];
    if (p == 0) {
      km[0] = g >= kl ? mid[o - 1] : 0.0f;  // slot -1 (k = 0) where g = 0
      km[1] = vm.x;
      km[2] = vm.y;
      km[3] = vm.z;
      kp[0] = vm.x;
      kp[1] = vm.y;
      kp[2] = vm.z;
      kp[3] = vm.w;
    } else {
      km[0] = vm.x;
      km[1] = vm.y;
      km[2] = vm.z;
      km[3] = vm.w;
      kp[0] = vm.y;
      kp[1] = vm.z;
      kp[2] = vm.w;
      kp[3] = g + 3 < k_end ? mid[o + 4] : 0.0f;
    }
    float r[4];
    if constexpr (MIXED) {
      const float4 vc = ld4(dst + o);  // the slots' own values, what a folded read returns
      const float4 pl = fc.pin_lo ? load_f4(fc.pin_lo, g, k_end) : float4{};
      const float4 ph = fc.pin_hi ? load_f4(fc.pin_hi, g, k_end) : float4{};
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const float cen = comp(vc, c);
        const int kk = g + c;
        float s = fc.pin_lo ? (comp(pl, c) > 0.5f ? 0.0f : cen) : comp(vl, c);
        s = s + (fc.pin_hi ? (comp(ph, c) > 0.5f ? 0.0f : cen) : comp(vh, c));
        s = s + (fc.jm ? cen : comp(vjm, c));
        s = s + (fc.jp ? cen : comp(vjp, c));
        s = s + (kk == fc.km ? cen : km[c]);
        s = s + (kk == fc.kp ? cen : kp[c]);
        r[c] = kk >= kl && kk < k_end ? (s - h2 * comp(vf, c)) * (1.0f / 6.0f) : cen;
      }
    } else {
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        float s = comp(vl, c);
        s = s + comp(vh, c);
        s = s + comp(vjm, c);
        s = s + comp(vjp, c);
        s = s + km[c];
        s = s + kp[c];
        const int kk = g + c;
        r[c] = kk >= kl && kk < k_end ? (s - h2 * comp(vf, c)) * (1.0f / 6.0f) : comp(old, c);
      }
    }
    st4(dst + o, make_float4(r[0], r[1], r[2], r[3]));
  }
}

// kSeg: the rank's pad rows, body rows [o1 - g0, L) (global planes past n
// - 1, never loaded or swept), written as the plain versions leave them:
// 0, or (``copy``, K34, K36) the initial guess's rows. Spread over every thread
// of the launch, consecutive points across a warp; the stage writes no
// point of them.
__device__ inline void seg_pad_fill(const SegStageArgs& a, bool copy) {
  const int nn = a.n * a.n, t0 = a.o1 - a.g0;
  const int count = (a.L - t0) * nn, stride = gridDim.x * blockDim.x;
  float* out = a.out + t0 * nn;
  const float* src = copy ? a.in_s.body + t0 * nn : nullptr;
  for (int v = blockIdx.x * blockDim.x + threadIdx.x; v < count; v += stride)
    out[v] = copy ? src[v] : 0.0f;
}

// f of slot 0 of parity pp in row (q, j): f + field_at, or (kSegRect) the
// row looked up.
template <Layout L, class Args>
__device__ inline const float* f_row_of(const Args& a, int q, int j, int pp) {
  if constexpr (L == Layout::kSegRect) {
    return f_row_at(a, q, j) + 1 + pp;
  } else {
    return f_base(a, q) + field_at<L>(a.n, q, j, 1 + pp);
  }
}

// The stage. Prep (split::NoPrep, or K4's correction in prolong_smooth.cu)
// has start(extra shared memory, geometry), load(q, geometry) (copies
// issued with plane q's) and apply(stage colour 0's tile plane, 1's, q,
// geometry, row lanes, color0), run on plane q once it has arrived and
// before any half-sweep reads it (box_body: apply_row, the same a row).
// ZERO: the initial guess is zero, nothing is loaded. L: the layout (the
// header); Args: StageArgs, or SegStageArgs for kSeg. RESID (K26, kRect,
// ResidStageArgs): halos of HH = H + 1, rings of 2 H + 5 planes, and
// resid_store a step later than tile_store (the header).
template <int NITER, bool ZERO, Layout L = Layout::kRect, bool RESID = false, class Prep,
          class Args>
__device__ void stage_body(const Args& a, float* smem, Prep prep) {
  static_assert(!RESID || (L == Layout::kRect && !ZERO && !Prep::kActive), "K26 is K1's stage");
  constexpr int H = 2 * NITER, HH = H + RESID, D = stage_depth(H) + 2 * RESID;
  const Geom t = geometry(a, HH);
  if constexpr (L == Layout::kSeg) {
    if (t.i0 >= t.i1) return;  // a pad rank's block
  }
  if constexpr (L == Layout::kSegRect) {
    if (t.i0 >= t.i1 || t.j0 >= t.j1) return;  // a pad rank's block
  }
  const int n = a.n;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, nwarps = blockDim.x >> 5;
  const RowLanes rl = row_lanes(a, t);
  const int r0 = warp * rl.rows + rl.sub, rstep = nwarps * rl.rows;  // this thread's tile rows
  auto ring = [&](int c, int q) { return smem + (c * D + q % D) * t.P; };
  if constexpr (Prep::kActive) prep.start(smem + 2 * D * t.P, t);
  auto load = [&](int q) {
    if constexpr (ZERO) {
      tile_zero(ring(0, q), ring(1, q), t, a.f);
    } else if constexpr (L == Layout::kSegRect) {
      seg_tile_load(ring(0, q), ring(1, q), a, t, q, a.color0, warp, lane, nwarps);
    } else {
      tile_load<L>(ring(0, q), ring(1, q), in_base(a, q), t, q, a.color0, warp, lane, nwarps);
    }
    if constexpr (Prep::kActive) prep.load(q, t);
  };

  // as split.cuh's stage_body: a thread sweeps tile row r0 (and r0 +
  // rstep, ...) of plane p - 2 s in each half-sweep s whose region holds
  // it, the f of its first row fetched into registers a step ahead
  auto region = [&](int s, int q, int& jl, int& jh, int& kl, int& kh) {
    jl = max(t.jb0 + s, 1);
    jh = min(t.j1 + HH - s, n - 1);
    kl = t.k0 == 0 ? 0 : t.k0 - a.k_halo + s;
    kh = t.k1 == t.S ? t.S : t.k1 + a.k_halo - s;
    return q >= max(t.i0 - HH + s, 1) && q < min(t.i1 + HH - s, n - 1);
  };
  auto colour_of = [&](int s) { return (s - 1) & 1 ? 1 - a.color0 : a.color0; };
  auto f_row = [&](int q, int j, int pp) { return f_row_of<L>(a, q, j, pp); };
  float4 f_pre[H] = {};
  auto fetch = [&](int step) {
#pragma unroll
    for (int s = 1; s <= H; ++s) {
      int jl, jh, kl, kh;
      const int q = step - 2 * s, j = t.jb0 + r0;
      if (region(s, q, jl, jh, kl, kh) && j >= jl && j < jh) {
        const int pp = parity(q, j, colour_of(s));
        f_pre[s - 1] = load_f4(f_row(q, j, pp), (kl & ~3) + 4 * rl.sl,
                               min(kh, (n - 1 - pp) >> 1));
      }
    }
  };

  load(t.ia);
  cp_async_commit();
  fetch(t.ia);
  // the last step writes the last owned plane, i1 - 1, finished by
  // half-sweep H at step i1 - 1 + 2 H (RESID: its residual a step later)
  for (int p = t.ia; p <= t.i1 + 2 * H + RESID; ++p) {
    if (p + 1 < t.ib) load(p + 1);
    cp_async_commit();  // an empty group past the last plane keeps the count
    cp_async_wait_all_but_one();
    __syncthreads();
    if constexpr (Prep::kActive) {
      if (p < t.ib) prep.apply(ring(0, p), ring(1, p), p, t, rl, a.color0);
    }
#pragma unroll
    for (int s = 1; s <= H; ++s) {
      const int c = (s - 1) & 1, q = p - 2 * s;
      int jl, jh, kl, kh;
      if (region(s, q, jl, jh, kl, kh)) {
        const int color = colour_of(s);
        float* dst = ring(c, q);
        const float* lo = ring(1 - c, q - 1);
        const float* mid = ring(1 - c, q);
        const float* hi = ring(1 - c, q + 1);
        // rl.lanes lanes a row along k; a row's live slots are kk <
        // (n - 1 - p) / 2 (2 kk + 1 + p <= n - 2)
        for (int r = r0; r < t.R; r += rstep) {
          const int j = t.jb0 + r;
          if (j < jl || j >= jh) continue;
          const int pp = parity(q, j, color);
          sweep_row<mixed_bc(L)>(dst, lo, mid, hi, f_row(q, j, pp), r * t.W - t.kb0, t.W, kl,
                                 min(kh, (n - 1 - pp) >> 1), pp, a.h2, rl, r == r0, f_pre[s - 1],
                                 mixed_bc(L) ? mixed_faces<L>(a, q, j, pp) : MixedFaces{});
        }
      }
    }
    fetch(p + 1);
    // both colours' last half-sweeps (H - 1 and H) are done with plane
    // p - 1 - 2 H: half-sweep H finished it a step ago
    const int qb = p - 1 - 2 * H;
    if constexpr (RESID) {  // plane qb + 1 was finished a step ago too
      const int q = qb - 1, ql = max(q - 1, 0);
      if (q >= t.i0 && q < t.i1)
        resid_store(a, ring(0, ql), ring(1, ql), ring(0, q), ring(1, q), ring(0, q + 1),
                    ring(1, q + 1), t, q, warp, lane, nwarps);
    } else if (qb >= t.i0 && qb < t.i1) {
      if constexpr (mixed_bc(L)) {
        mixed_store<L>(store_base(a), ring(0, qb), ring(1, qb), t, qb, a.color0, a.pin, warp,
                       lane, nwarps, stored_lo(a), stored_hi(a));
      } else if constexpr (L == Layout::kSegRect) {
        seg_tile_store(a, ring(0, qb), ring(1, qb), t, qb, a.color0, warp, lane, nwarps);
      } else {
        tile_store(a.out, ring(0, qb), ring(1, qb), t, qb, a.color0, warp, lane, nwarps);
      }
    }
    __syncthreads();
  }
}

__device__ inline void cp_async_wait_all() { asm volatile("cp.async.wait_all;\n" ::: "memory"); }

// The box schedule: every plane of the loaded box in shared memory at once
// (plane q of colour c at tile(c, q)), then half-sweep s = 1 .. H on its
// region, rl.rows tile rows a warp, f read from device memory, a barrier
// after each, then the owned planes written. The same regions, sweeps and
// stores as stage_body, so the same values; Prep's coarse planes all
// resident too (its depth). (f held in shared memory beside the tiles
// measured no faster: PERF.md.)
template <int NITER, bool ZERO, Layout L = Layout::kRect, bool RESID = false, class Prep,
          class Args>
__device__ void box_body(const Args& a, float* smem, Prep prep) {
  static_assert(!RESID || (L == Layout::kRect && !ZERO && !Prep::kActive), "K26 is K1's stage");
  constexpr int H = 2 * NITER, HH = H + RESID;
  const Geom t = geometry(a, HH);
  if constexpr (L == Layout::kSeg) {
    if (t.i0 >= t.i1) return;  // a pad rank's block
  }
  if constexpr (L == Layout::kSegRect) {
    if (t.i0 >= t.i1 || t.j0 >= t.j1) return;  // a pad rank's block
  }
  const int n = a.n, planes = tile_planes(a.bi, HH, true), q0 = t.i0 - HH;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, nwarps = blockDim.x >> 5;
  const RowLanes rl = row_lanes(a, t);
  auto tile = [&](int c, int q) { return smem + (c * planes + q - q0) * t.P; };
  if constexpr (Prep::kActive) prep.start(smem + 2 * planes * t.P, t);
  for (int q = t.ia; q < t.ib; ++q) {
    if constexpr (ZERO) {
      tile_zero(tile(0, q), tile(1, q), t, a.f);
    } else if constexpr (L == Layout::kSegRect) {
      seg_tile_load(tile(0, q), tile(1, q), a, t, q, a.color0, warp, lane, nwarps);
    } else {
      tile_load<L>(tile(0, q), tile(1, q), in_base(a, q), t, q, a.color0, warp, lane, nwarps);
    }
    if constexpr (Prep::kActive) prep.load(q, t);
  }
  cp_async_commit();
  cp_async_wait_all();
  __syncthreads();
  if constexpr (Prep::kActive) {  // every row of every plane, spread over the warps
    const int rows = t.jb - t.ja;
    for (int v = warp * rl.rows + rl.sub; v < (t.ib - t.ia) * rows; v += nwarps * rl.rows) {
      const int q = t.ia + v / rows;
      prep.apply_row(tile(0, q), tile(1, q), q, t.ja + v % rows, t, rl, a.color0);
    }
    __syncthreads();
  }
  for (int s = 1; s <= H; ++s) {
    const int c = (s - 1) & 1, color = c ? 1 - a.color0 : a.color0;
    const int qa = max(t.i0 - HH + s, 1), qb = min(t.i1 + HH - s, n - 1);
    const int jl = max(t.jb0 + s, 1), jh = min(t.j1 + HH - s, n - 1);
    const int kl = t.k0 == 0 ? 0 : t.k0 - a.k_halo + s;
    const int kh = t.k1 == t.S ? t.S : t.k1 + a.k_halo - s;
    const int rows = jh - jl, count = rows > 0 && qb > qa ? (qb - qa) * rows : 0;
    for (int v = warp * rl.rows + rl.sub; v < count; v += nwarps * rl.rows) {
      const int q = qa + v / rows, j = jl + v % rows;
      const int pp = parity(q, j, color);
      sweep_row<mixed_bc(L)>(tile(c, q), tile(1 - c, q - 1), tile(1 - c, q),
                             tile(1 - c, q + 1), f_row_of<L>(a, q, j, pp),
                             (j - t.jb0) * t.W - t.kb0, t.W, kl, min(kh, (n - 1 - pp) >> 1), pp,
                             a.h2, rl, false, float4{},
                             mixed_bc(L) ? mixed_faces<L>(a, q, j, pp) : MixedFaces{});
    }
    __syncthreads();
  }
  for (int q = t.i0; q < t.i1; ++q) {
    if constexpr (RESID) {  // planes q - 1 .. q + 1 are all held
      resid_store(a, tile(0, q - 1), tile(1, q - 1), tile(0, q), tile(1, q), tile(0, q + 1),
                  tile(1, q + 1), t, q, warp, lane, nwarps);
    } else if constexpr (mixed_bc(L)) {
      mixed_store<L>(store_base(a), tile(0, q), tile(1, q), t, q, a.color0, a.pin, warp, lane,
                     nwarps, stored_lo(a), stored_hi(a));
    } else if constexpr (L == Layout::kSegRect) {
      seg_tile_store(a, tile(0, q), tile(1, q), t, q, a.color0, warp, lane, nwarps);
    } else {
      tile_store(a.out, tile(0, q), tile(1, q), t, q, a.color0, warp, lane, nwarps);
    }
  }
}

// The prolongation step of K4 and K15 (prolong_smooth.cu,
// mixed_prolong_smooth.cu), a stage's Prep: every point of the loaded box,
// of both colours and on the boundary too, becomes e + P ec as its plane of
// e arrives in shared memory, computed once; the coarse field's every
// point, its boundary too, takes part (K15's Neumann coarse faces are
// live). Interpolation in the order of mg::interp_at (stencil.cuh): j,
// then k, then i; an even fine index copies the coincident coarse value,
// an odd one is 0.5 a + 0.5 b of its two coarse neighbours, each step
// rounding once, so it agrees bit for bit with the plain versions'
// separable products. A lane corrects 4 slots of each colour of a tile
// row, the fine k 2 g + 1 .. 2 g + 8, from the j-interpolated values y at
// the 5 coarse k g .. g + 4 (an odd k takes 0.5 y[m] + 0.5 y[m + 1], an
// even one y[m + 1]); the k = 0 point (slot -1) is one lane's extra; a
// warp covers rows as its sweeps do. The coarse planes stream through a
// ring of 3 in shared memory beside the fine rings (the box holds all it
// needs), each copied with the first fine plane that needs it (4-byte
// cp.async: a coarse row of nc floats is not 16-byte aligned): coarse c
// serves fine planes 2 c - 1 .. 2 c + 1.
struct ProlongPrep {
  static constexpr bool kActive = true;
  const float* ec;
  int nc, rows, width, depth;  // coarse field size; the tile's rows, row width, planes
  float* tile;
  int cja, cka;  // coarse row and k of tile row 0 and column 0

  __device__ float* plane(int c) const { return tile + (c % depth) * rows * width; }

  __device__ void start(float* extra, const Geom& t) {
    tile = extra;
    cja = t.ja >> 1;
    cka = max(t.ka, 0);
  }

  __device__ void load(int q, const Geom& t) const {
    // fine plane q needs coarse q >> 1 and (q + 1) >> 1: the first plane
    // loaded copies both, an odd one the second (an even one finds both)
    if (q != t.ia && !(q & 1)) return;
    const int c_lo = q == t.ia ? q >> 1 : (q + 1) >> 1, c_hi = (q + 1) >> 1;
    const int cols = t.kb - cka + 1, rows_c = (t.jb >> 1) - cja + 1;
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, nwarps = blockDim.x >> 5;
    for (int c = c_lo; c <= c_hi; ++c) {
      for (int r = warp; r < rows_c; r += nwarps) {  // a warp a row, lanes along k
        float* d = plane(c) + r * width;
        const float* src = ec + (c * nc + cja + r) * nc + cka;
        for (int k = lane; k < cols; k += 32) cp_async4(d + k, src + k);
      }
    }
  }

  // e + P ec at every point of the loaded box of plane q, in place, the
  // rows spread over a warp's lanes as the sweeps' are.
  __device__ void apply(float* t0, float* t1, int q, const Geom& t, const RowLanes& rl,
                        int color0) const {
    const int warp = threadIdx.x >> 5, nwarps = blockDim.x >> 5;
    for (int j = t.ja + warp * rl.rows + rl.sub; j < t.jb; j += nwarps * rl.rows)
      apply_row(t0, t1, q, j, t, rl, color0);
  }

  // The same for row j of plane q.
  __device__ void apply_row(float* t0, float* t1, int q, int j, const Geom& t,
                            const RowLanes& rl, int color0) const {
    const bool oi = q & 1, oj = j & 1;
    const int par = (q + j) & 1;  // the colour with p = 1 (even k) is RED where par = 1
    float* even = ((par ^ color0) ? t1 : t0) + (j - t.jb0) * t.W - t.kb0;
    float* odd = ((par ^ 1 ^ color0) ? t1 : t0) + (j - t.jb0) * t.W - t.kb0;
    const float* c[2] = {plane(q >> 1) + ((j >> 1) - cja) * width - cka,
                         plane((q >> 1) + 1) + ((j >> 1) - cja) * width - cka};
    // the j step at coarse k: its value in coarse plane a
    auto yj = [&](int a, int k) {
      return oj ? 0.5f * c[a][k] + 0.5f * c[a][width + k] : c[a][k];
    };
    for (int g = cka + 4 * rl.sl; g < t.kb; g += 4 * rl.lanes) {
      float y[2][5];
#pragma unroll
      for (int a = 0; a < 2; ++a) {
        if (a == 1 && !oi) break;
        const float4 v = ld4(c[a] + g);
        float y5 = c[a][g + 4];
        if (oj) {
          const float4 w = ld4(c[a] + width + g);
          y[a][0] = 0.5f * v.x + 0.5f * w.x;
          y[a][1] = 0.5f * v.y + 0.5f * w.y;
          y[a][2] = 0.5f * v.z + 0.5f * w.z;
          y[a][3] = 0.5f * v.w + 0.5f * w.w;
          y5 = 0.5f * y5 + 0.5f * c[a][width + g + 4];
        } else {
          y[a][0] = v.x;
          y[a][1] = v.y;
          y[a][2] = v.z;
          y[a][3] = v.w;
        }
        y[a][4] = y5;
      }
      float vo[4], ve[4];  // P ec at k = 2 (g + m) + 1 and 2 (g + m) + 2
#pragma unroll
      for (int m = 0; m < 4; ++m) {
        float yo[2], ye[2];
#pragma unroll
        for (int a = 0; a < 2; ++a) {
          if (a == 1 && !oi) break;
          yo[a] = 0.5f * y[a][m] + 0.5f * y[a][m + 1];
          ye[a] = y[a][m + 1];
        }
        vo[m] = oi ? 0.5f * yo[0] + 0.5f * yo[1] : yo[0];
        ve[m] = oi ? 0.5f * ye[0] + 0.5f * ye[1] : ye[0];
      }
      const float4 eo = ld4(odd + g), ee = ld4(even + g);
      st4(odd + g, make_float4(eo.x + vo[0], eo.y + vo[1], eo.z + vo[2], eo.w + vo[3]));
      st4(even + g, make_float4(ee.x + ve[0], ee.y + ve[1], ee.z + ve[2], ee.w + ve[3]));
    }
    if (t.ka < 0 && rl.sl == rl.lanes - 1) {  // k = 0: the even colour's slot -1, coarse k = 0
      const float v = oi ? 0.5f * yj(0, 0) + 0.5f * yj(1, 0) : yj(0, 0);
      even[-1] = even[-1] + v;
    }
  }
};

// K36's and K31's ProlongPrep (kSeg, kSegRect): ProlongPrep::load's copies
// from a coarse field read through a segment, ``cs``, whose body row 0 is
// global coarse plane cg0, its row looked up once a coarse row
// (coarse_row: the k row of GLOBAL coarse (ci, cj), seg_pad_prolong's).
struct SegProlongPrep : ProlongPrep {
  Seg cs;
  int cg0;

  __device__ const float* coarse_row(int ci, int cj) const { return cs.row(ci - cg0) + cj * nc; }

  __device__ void load(int q, const Geom& t) const {
    if (q != t.ia && !(q & 1)) return;
    const int c_lo = q == t.ia ? q >> 1 : (q + 1) >> 1, c_hi = (q + 1) >> 1;
    const int cols = t.kb - cka + 1, rows_c = (t.jb >> 1) - cja + 1;
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, nwarps = blockDim.x >> 5;
    for (int c = c_lo; c <= c_hi; ++c) {
      for (int r = warp; r < rows_c; r += nwarps) {
        float* d = plane(c) + r * width;
        const float* src = cs.row(c - cg0) + (cja + r) * nc + cka;
        for (int k = lane; k < cols; k += 32) cp_async4(d + k, src + k);
      }
    }
  }
};

// K40's ProlongPrep (kSegRect on Seg2): the same from an (i, j)-sharded
// coarse block, ``cs``, whose body row and column 0 are global coarse
// (cg0, cgj0), a coarse row looked up once (Seg2::at).
struct Seg2ProlongPrep : ProlongPrep {
  Seg2 cs;
  int cg0, cgj0;

  __device__ const float* coarse_row(int ci, int cj) const {
    return cs.at(ci - cg0, cj - cgj0, nc);
  }

  __device__ void load(int q, const Geom& t) const {
    if (q != t.ia && !(q & 1)) return;
    const int c_lo = q == t.ia ? q >> 1 : (q + 1) >> 1, c_hi = (q + 1) >> 1;
    const int cols = t.kb - cka + 1, rows_c = (t.jb >> 1) - cja + 1;
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, nwarps = blockDim.x >> 5;
    for (int c = c_lo; c <= c_hi; ++c) {
      for (int r = warp; r < rows_c; r += nwarps) {
        float* d = plane(c) + r * width;
        const float* src = coarse_row(c, cja + r) + cka;
        for (int k = lane; k < cols; k += 32) cp_async4(d + k, src + k);
      }
    }
  }
};

// kSegRect: the rank's owned points past n - 1, which no block loads,
// sweeps or stores: the body rows [o1 - g0, L) whole and, on Seg2, the
// columns [cj1 - gj0, Lj) of the rows before them. Each is written as the
// plain versions leave it: e + P ec, P ec from the coarse block's own pad
// rows, in mg::interp_at's order (j, then k, then i, one rounding a step).
// A warp a body row (t, j), the k across its lanes, the e, output and
// coarse rows looked up once; spread over every warp of the launch.
template <class Args, class Prep>
__device__ inline void seg_pad_prolong(const Args& a, const Prep& prep) {
  const int n = a.n, W = body_cols(a), ro = a.o1 - a.g0, co = cols_hi(a) - body_col0(a);
  const int tail = (a.L - ro) * W, count = tail + ro * (W - co);
  const int lane = threadIdx.x & 31, nw = (gridDim.x * blockDim.x) >> 5;
  for (int v = (blockIdx.x * blockDim.x + threadIdx.x) >> 5; v < count; v += nw) {
    const int t = v < tail ? ro + v / W : (v - tail) / (W - co);
    const int j = v < tail ? v % W : co + (v - tail) % (W - co);
    const int g = a.g0 + t, gj = body_col0(a) + j;
    const bool oi = g & 1, oj = gj & 1;
    const float* e = in_row(a, g, gj);
    float* o = store_row(a, g, gj);
    const float* c[2][2];
#pragma unroll
    for (int p = 0; p < 2; ++p) {
#pragma unroll
      for (int b = 0; b < 2; ++b)
        c[p][b] = prep.coarse_row((g >> 1) + (p & oi), (gj >> 1) + (b & oj));
    }
    for (int k = lane; k < n; k += 32) {
      const int ck = k >> 1;
      const bool ok = k & 1;
      float y2[2];
#pragma unroll
      for (int p = 0; p < 2; ++p) {
        if (p == 1 && !oi) break;
        float y1[2];
#pragma unroll
        for (int b = 0; b < 2; ++b) {
          if (b == 1 && !ok) break;
          y1[b] = oj ? 0.5f * c[p][0][ck + b] + 0.5f * c[p][1][ck + b] : c[p][0][ck + b];
        }
        y2[p] = ok ? 0.5f * y1[0] + 0.5f * y1[1] : y1[0];
      }
      o[k] = e[k] + (oi ? 0.5f * y2[0] + 0.5f * y2[1] : y2[0]);
    }
  }
}

// kSegRect without a Prep (K28, K37): seg_pad_prolong's points, written as
// the plain versions leave them, the initial guess's own values (no
// half-sweep updates a point past n - 1); ZERO (K29, K38, from a zero
// guess, no u to read): 0. A warp a body row, the k across its lanes, the
// rows looked up once; spread over every warp of the launch.
template <bool ZERO = false, class Args>
__device__ inline void seg_pad_copy(const Args& a) {
  const int n = a.n, W = body_cols(a), ro = a.o1 - a.g0, co = cols_hi(a) - body_col0(a);
  const int tail = (a.L - ro) * W, count = tail + ro * (W - co);
  const int lane = threadIdx.x & 31, nw = (gridDim.x * blockDim.x) >> 5;
  for (int v = (blockIdx.x * blockDim.x + threadIdx.x) >> 5; v < count; v += nw) {
    const int t = v < tail ? ro + v / W : (v - tail) / (W - co);
    const int j = v < tail ? v % W : co + (v - tail) % (W - co);
    if constexpr (ZERO) {
      float* o = store_row(a, a.g0 + t, body_col0(a) + j);
      for (int k = lane; k < n; k += 32) o[k] = 0.0f;
    } else {
      const float* u = in_row(a, a.g0 + t, body_col0(a) + j);
      float* o = store_row(a, a.g0 + t, body_col0(a) + j);
      for (int k = lane; k < n; k += 32) o[k] = u[k];
    }
  }
}

// Launch one stage kernel instantiation on the plan's grid (stage_blocks);
// a cudaError_t.
template <class Kernel, class Args, class... Extra>
inline int launch_stage(Kernel kernel, const Args& a, int threads, int smem, cudaStream_t stream,
                        Extra... extra) {
  if (const int err = split::raise_smem_limit((const void*)kernel)) return err;
  kernel<<<stage_blocks(a), threads, smem, stream>>>(a, extra...);
  return (int)cudaGetLastError();
}

}  // namespace rect
}  // namespace mg
