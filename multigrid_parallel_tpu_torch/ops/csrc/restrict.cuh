// The streaming restriction stage of K3 (residual_restrict.cu, a plain
// (n, n, n) correction), K9 (residual_restrict_split.cu, a split pair),
// K18 (residual_restrict_fold.cu, the electrospray's (n, n, n - 2) fold
// layout), K23 (residual_restrict_msplit.cu, the electrospray's split
// pair), and K30 and K39 (residual_restrict_seg.cu, one rank's
// segmented block of an i-sharded or an (i, j)-sharded field): the
// interior residual of e against r, restricted by full weighting to the
// coarse (nc, nc, nc) RHS (K18, K23: the (nc, nc, nc - 2) fold; K30, K39:
// the rank's coarse block), nc = (n + 1) / 2, in one launch, each fine
// residual computed once, from tiles of e and r in shared memory, and
// only the coarse RHS written to device memory.
//
// A block owns a box of interior coarse points: bci coarse planes x bcj
// coarse rows x bck coarse k (the plan, pallas_split._restrict_plan; the
// tiles are numbered k fastest, then j, then i, and start at coarse
// point 1), and the coarse boundary points in the box widened by one on
// a side that reaches the field's edge, which it writes as 0: the output
// needs no initialisation. Its cone is fine planes 2 ci0 - 1 .. 2 ci1 - 1,
// fine rows 2 cj0 - 1 .. 2 cj1 - 1 and fine k 2 ck0 - 1 .. 2 ck1 - 1 (the
// slots ck0 - 1 .. ck1 - 1 of a split row), all on the fine interior.
// It streams the fine planes of e from 2 ci0 - 2 to 2 ci1, one e plane
// of halo on each side, and the planes of r over its cone: each plane's
// footprint (e with one row and one k of halo on each side, r without)
// goes by cp.async into a ring in shared memory, 3 planes of e and 2 of
// r, plane p + 2 of e and p + 1 of r in flight while plane p is computed.
// A step costs one barrier: the plane arrived, the ring slot it reuses
// read, and the coarse plane that the step before closed in shared memory.
//
// A warp owns a fine row of the cone, and each lane groups of 4
// consecutive points of it (k, or slots), C x 32 groups (C chunks, a
// template argument), for the whole launch: so the e of plane p - 1 at a
// lane's points stays in its registers (the i - 1 neighbour at plane p),
// and so does the i taps' partial sum. A tile row keeps 4 floats before
// the row's first point, so that every group sits on 16 bytes and a lane
// reads a neighbour row as one float4. At plane p the lane computes the
// residual at its points, once, in stencil.cuh's (or split.cuh's)
// neighbour order, then the taps in the plain version's order:
// - K3 (residual_restrict_plain): i, then j, then k, each 3-tap as
//   (0.25 a + 0.5 b) + 0.25 c. Plane 2 ci - 1 closes coarse plane ci - 1
//   (+ 0.25 R) and opens ci (0.25 R), plane 2 ci adds 0.5 R: the same
//   roundings as the 3-tap. A closed plane goes to shared memory (A), and
//   after the next step's barrier the warps apply the j taps and then the
//   k taps and store its rows, consecutive ck across a warp.
// - K18 (residual_restrict_fold_plain): K3's taps on the fold layout
//   (Fold): fine k at slot k - 1 of a row of n - 2 floats, the k faces not
//   stored, so the loaded e window stops at the stored slots and the k - 1
//   neighbour at k = 1 and the k + 1 one at k = n - 2 are selects of the
//   point's own value (the BC copy), never reads of the tile column there,
//   which is not loaded; coarse k at slot ck - 1 of a row of nc - 2.
// - K30, K39 (residual_restrict_halo_plain, residual_restrict_halo2d_plain
//   of ops/pallas_sharded.py and pallas_sharded2d.py): K3's tile, taps and
//   arithmetic on a rank's segments (SegLayout): a tile row (plane q, row
//   j, local indices) is copied from the row that Seg::row or Seg2::at
//   gives, looked up once a row, so the halo rows and columns and, on
//   Seg2, the corner blocks come from the halo buffers; the blocks tile the
//   rank's local coarse rows (and, on Seg2, columns) whose global index
//   lies in [1, nc - 2]; every other point of the rank's coarse block is
//   written 0 by the same launch.
// - K9 (residual_restrict_split_plain): the k taps first, within the
//   fine row, 0.5 E[ck - 1] + 0.25 (O[ck - 1] + O[ck]) with E / O the
//   colour holding the row's even / odd k: a lane holds both colours'
//   residuals at its slots and takes the next group's first O from the
//   next lane by a warp shuffle. Then the i taps as K3's, then the j taps
//   from A.
// - K23 (residual_restrict_msplit_plain of ops/pallas_mixed_split.py):
//   K9's tile, schedule and taps on the electrospray's pair (MSplit), two
//   changes. (1) The residual sums its neighbours in mixed.cuh's order,
//   k - 1 before k + 1 (K9's O adds E[kk] before E[kk - 1]), and the k
//   faces are not fields but BC copies: the k - 1 neighbour of O's slot 0
//   (k = 1) and the k + 1 one of its slot S - 1 (k = n - 2) are selects
//   of the point's own value, never the guard's or the dead slot's 0 that
//   K9 reads there. (2) The output is K18's coarse fold: coarse k at slot
//   ck - 1 of rows of nc - 2, only its x and y faces zeroed.
// The 0.25 and 0.5 scalings are single IEEE roundings like the rest
// (built with --fmad=false), so the result equals the plain version's
// bit for bit.
//
// Bound: device memory. The function needs e and r read once (8 B a
// fine point, 8 B a grid point for a split pair) and the coarse RHS
// written (4 B a coarse point); the blocks re-read their halo rows and
// planes, (2 bci + 3) / (2 bci) in i and (2 bcj + 3) / (2 bcj) in j for
// e, about a quarter more bytes at the main path's plan, much of it from
// L2. The first forms (one thread a coarse point, 216 loads each, every
// fine residual computed 27 / 8 times) were bound by load instructions
// and cache traffic instead.
#pragma once

#include "seg2d.cuh"
#include "split.cuh"

namespace mg {
namespace restriction {

using split::comp;
using split::cp_async16;
using split::cp_async4;
using split::cp_async_commit;
using split::ld4;
using split::st4;

// Coarse rows a block owns at most; a warp a fine row of its cone.
constexpr int kMaxRows = 8;
constexpr int kMaxThreads = 32 * (2 * kMaxRows + 1);
// Chunks of 32 groups of 4 points a fine row at most (registers: each
// chunk holds a lane's e of the plane before and the i taps' partial sum,
// both colours' e for K9).
constexpr int kMaxChunks = 2;
// Tile columns of e before a row's first point.
constexpr int kPad = 4;

__device__ inline void cp_async_wait_all() { asm volatile("cp.async.wait_all;\n" ::: "memory"); }

__host__ __device__ inline int imin(int a, int b) { return a < b ? a : b; }

__host__ __device__ inline int imax(int a, int b) { return a > b ? a : b; }

__host__ __device__ inline int round4(int x) { return (x + 3) & ~3; }

// The full-weighting 3-tap, as the plain versions compute it.
__device__ inline float tap3(float a, float b, float c) {
  return (0.25f * a + 0.5f * b) + 0.25f * c;
}

struct Args {
  float* out;
  const float* e[2];  // K3, K18: e[0]; K9, K23: (red, black)
  const float* r[2];
  int n;
  float inv_h2;
  int bci, bcj, bck;  // the plan (pallas_split._restrict_plan)
  int vec;            // K9, K23: 16-byte copies (every loaded row starts and ends on 4 slots)
};

// Interior coarse points along an axis.
__host__ __device__ inline int interior(int n) { return (n + 1) / 2 - 2; }

// Fine residual points of a tile row of a box of bck coarse k: K3 fine k,
// K9 slots.
__host__ __device__ inline int row_points(int bck, bool split) {
  return split ? bck + 1 : 2 * bck + 1;
}

// Floats a tile row holds: e (kPad before the first point, one k of halo
// past the last, and the last group's reads past that), r, and A (a
// closed plane of i-tapped values); the same formula as
// pallas_split._restrict_widths.
struct Widths {
  int we, wr, wa;
};

__host__ __device__ inline Widths widths(int bck, bool split) {
  const int pts = row_points(bck, split);
  return {round4(pts + 2 * kPad), round4(pts), round4(pts)};
}

// Tile planes of e and of r in a block's rings.
constexpr int kERing = 3;
constexpr int kRRing = 2;

// Shared-memory bytes of a block: the e ring (planes of 2 bcj + 3 rows),
// the r ring (2 bcj + 1 rows), both colours of each for K9, and A (2 bcj +
// 1 rows). pallas_split._restrict_smem computes the same; the launchers
// reject a plan that differs.
__host__ __device__ inline long long smem_bytes(int bcj, int bck, bool split) {
  const Widths w = widths(bck, split);
  const long long colours = split ? 2 : 1, re = 2 * bcj + 3, rr = 2 * bcj + 1;
  return 4 * (colours * (kERing * re * w.we + kRRing * rr * w.wr) + rr * w.wa);
}

inline int blocks(const Args& a) {
  const int m = interior(a.n);
  return ((m + a.bci - 1) / a.bci) * ((m + a.bcj - 1) / a.bcj) * ((m + a.bck - 1) / a.bck);
}

// 0 when the kernels take the plan: a box inside the interior (of mi
// coarse planes and mj rows, the level's m where 0), at most kMaxRows
// coarse rows, a warp a fine row, C chunks a power of 2 up to kMaxChunks
// that cover a row, the shared memory the formula gives.
inline int plan_error(const Args& a, bool split, int chunks, int threads, long long smem,
                      int mi = 0, int mj = 0) {
  const int m = interior(a.n);
  mi = mi ? mi : m;
  mj = mj ? mj : m;
  const bool chunks_ok = (chunks == 1 || chunks == kMaxChunks) &&
                         128 * chunks >= row_points(a.bck, split);
  if (m < 1 || a.bci < 1 || a.bci > mi || a.bcj < 1 || a.bcj > imin(mj, kMaxRows) || a.bck < 1 ||
      a.bck > m || !chunks_ok || threads != 32 * (2 * a.bcj + 1) ||
      smem != smem_bytes(a.bcj, a.bck, split))
    return (int)cudaErrorInvalidValue;
  return 0;
}

// One block's box and footprint.
struct Geom {
  int n, nc, S;
  int ci0, ci1, cj0, cj1, ck0, ck1;  // the owned interior coarse box
  int rows;                          // fine rows of the cone, from 2 cj0 - 1
  int pts;                           // residual points a row, from k0
  int k0;                            // the row's first point (K3, K18 fine k 2 ck0 - 1, K9 slot ck0 - 1)
  int ka, kb;                        // the loaded e columns (K3 fine k, K9 and K18 slots)
  int ra, rb;                        // the loaded r columns
  int pa;                            // the first e plane, 2 ci0 - 2
  Widths w;
};

__device__ inline Geom geometry(const Args& a, bool split, bool fold) {
  Geom g;
  g.n = a.n;
  g.nc = (a.n + 1) / 2;
  g.S = split::slots(a.n);
  const int m = g.nc - 2;
  const int nj = (m + a.bcj - 1) / a.bcj, nk = (m + a.bck - 1) / a.bck;
  const int tk = blockIdx.x % nk, tj = (blockIdx.x / nk) % nj, ti = blockIdx.x / (nk * nj);
  g.ci0 = 1 + ti * a.bci;
  g.ci1 = imin(g.ci0 + a.bci, g.nc - 1);
  g.cj0 = 1 + tj * a.bcj;
  g.cj1 = imin(g.cj0 + a.bcj, g.nc - 1);
  g.ck0 = 1 + tk * a.bck;
  g.ck1 = imin(g.ck0 + a.bck, g.nc - 1);
  g.rows = 2 * (g.cj1 - g.cj0) + 1;
  g.pa = 2 * g.ci0 - 2;
  g.w = widths(a.bck, split);
  if (fold) {
    // fine k k0 - 1 .. 2 ck1 at slots k0 - 2 .. 2 ck1 - 1, clipped to the
    // stored n - 2: the k faces (k = 0, n - 1) are not loaded
    g.pts = 2 * (g.ck1 - g.ck0) + 1;
    g.k0 = 2 * g.ck0 - 1;
    g.ka = imax(g.k0 - 2, 0);
    g.kb = imin(2 * g.ck1, a.n - 2);
    g.ra = g.k0 - 1;
    g.rb = 2 * g.ck1 - 1;
  } else if (!split) {
    g.pts = 2 * (g.ck1 - g.ck0) + 1;
    g.k0 = 2 * g.ck0 - 1;
    g.ka = g.k0 - 1;
    g.kb = 2 * g.ck1 + 1;
    g.ra = g.k0;
    g.rb = 2 * g.ck1;
  } else {
    // residual slots ck0 - 1 .. ck1 - 1, their k neighbours one slot out;
    // with 16-byte copies the windows open and close on 4 slots (ck0 - 1
    // is a multiple of 4 there, bck being one)
    g.pts = g.ck1 - g.ck0 + 1;
    g.k0 = g.ck0 - 1;
    g.ra = g.k0;
    if (a.vec) {
      g.ka = imax(g.k0 - 4, 0);
      g.kb = imin((g.ck1 + 4) & ~3, g.S);
      g.rb = imin((g.ck1 + 3) & ~3, g.S);
    } else {
      g.ka = imax(g.k0 - 1, 0);
      g.kb = imin(g.ck1 + 1, g.S);
      g.rb = g.ck1;
    }
  }
  return g;
}

// Start copying rows [j0, j1) x columns [c0, c1) of plane q of a field of
// rows of `len` floats into a tile whose row 0 is field row jt and whose
// column col0 holds field column c0, W floats a row: a warp a row,
// consecutive columns across it, 16 bytes (V = 4) or 4 a lane.
template <int V>
__device__ inline void load_box(float* tile, const float* __restrict__ g, int q, int n, int len,
                                int j0, int j1, int c0, int c1, int col0, int jt, int W,
                                int warp, int lane, int nwarps) {
  for (int j = j0 + warp; j < j1; j += nwarps) {
    float* d = tile + (j - jt) * W + col0 - c0;
    const float* s = g + (q * n + j) * len;
    for (int c = c0 + V * lane; c < c1; c += 32 * V) {
      if constexpr (V == 4) {
        cp_async16(d + c, s + c);
      } else {
        cp_async4(d + c, s + c);
      }
    }
  }
}

// Coarse row (ci, cj) of the output at its point ck = 0: rows of nc
// floats, or the fold's nc - 2 (ck at slot ck - 1; FOLD).
template <bool FOLD>
__device__ inline float* coarse_row(float* out, const Geom& g, int ci, int cj) {
  return FOLD ? out + (ci * g.nc + cj) * (g.nc - 2) - 1 : out + (ci * g.nc + cj) * g.nc;
}

// Write 0 at the coarse boundary points of the block's box widened by one
// on each side at the field's edge: whole rows where the plane or the row
// is a boundary one, else the row's ends (FOLD: every stored coarse k is
// interior, so the x and y faces' rows only, over the box's k); a warp a
// row.
template <bool FOLD>
__device__ inline void zero_boundary(float* __restrict__ out, const Geom& g, int warp, int lane,
                                     int nwarps) {
  const int last = g.nc - 1;
  const int ia = g.ci0 == 1 ? 0 : g.ci0, ib = g.ci1 == last ? g.nc : g.ci1;
  const int ja = g.cj0 == 1 ? 0 : g.cj0, jb = g.cj1 == last ? g.nc : g.cj1;
  const int ka = g.ck0 == 1 && !FOLD ? 0 : g.ck0, kb = g.ck1 == last && !FOLD ? g.nc : g.ck1;
  const int nj = jb - ja;
  for (int row = warp; row < (ib - ia) * nj; row += nwarps) {
    const int ci = ia + row / nj, cj = ja + row % nj;
    float* o = coarse_row<FOLD>(out, g, ci, cj);
    if (ci == 0 || ci == last || cj == 0 || cj == last) {
      for (int ck = ka + lane; ck < kb; ck += 32) o[ck] = 0.0f;
    } else if (!FOLD && lane == 0) {
      if (ka == 0) o[0] = 0.0f;
      if (kb == g.nc) o[last] = 0.0f;
    }
  }
}

// The coarse rows of plane ci from A, spread over the block's warps: each
// item a coarse row's 32 consecutive ck; `tap(a0, W, t)` the value of
// coarse point t of the row whose A rows start at a0.
template <bool FOLD, class Tap>
__device__ inline void store_coarse(float* __restrict__ out, const float* A, const Geom& g,
                                    int ci, int W, int warp, int lane, int nwarps, Tap tap) {
  const int ncr = g.cj1 - g.cj0, nck = g.ck1 - g.ck0, groups = (nck + 31) >> 5;
  for (int it = warp; it < ncr * groups; it += nwarps) {
    const int cr = it / groups, t = 32 * (it - cr * groups) + lane;
    if (t < nck) coarse_row<FOLD>(out, g, ci, g.cj0 + cr)[g.ck0 + t] = tap(A + 2 * cr * W, W, t);
  }
}

// K3's layout: one field, tile rows of fine k, point b (fine k k0 + b) of
// e at column kPad + b, of r and A at column b. FOLD: K18's, the same tile
// from fold rows (fine k at slot k - 1 of n - 2), the k-face columns not
// loaded and read through selects.
template <bool FOLD>
struct RectLayout {
  static constexpr bool kSplit = false;
  static constexpr bool kFold = FOLD;
  static constexpr bool kFoldOut = FOLD;  // the coarse fold out (zero_boundary, coarse_row)
  static constexpr bool kSeg = false;
  float* ering;  // kERing planes of 2 bcj + 3 rows x we
  float* rring;  // kRRing planes of 2 bcj + 1 rows x wr
  float* A;      // 2 bcj + 1 rows x wa
  int pe, pr;    // floats a plane

  __device__ RectLayout(const Args& a, const Geom& g, float* smem) {
    pe = (2 * a.bcj + 3) * g.w.we;
    pr = (2 * a.bcj + 1) * g.w.wr;
    ering = smem;
    rring = ering + kERing * pe;
    A = rring + kRRing * pr;
  }

  __device__ float* e_plane(const Geom& g, int q) const {
    return ering + ((q - g.pa) % kERing) * pe;
  }
  __device__ float* r_plane(const Geom& g, int q) const {
    return rring + ((q - g.pa) % kRRing) * pr;
  }

  // Floats a field row; the tile column of e's first loaded column (fine
  // k ka, or slot ka: fine k ka + 1).
  __device__ static int row_len(const Geom& g) { return FOLD ? g.n - 2 : g.n; }
  __device__ static int e_col0(const Geom& g) { return FOLD ? kPad + g.ka + 1 - g.k0 : kPad - 1; }

  __device__ void load_e(const Args& a, const Geom& g, int q, int warp, int lane,
                         int nwarps) const {
    load_box<1>(e_plane(g, q), a.e[0], q, g.n, row_len(g), 2 * g.cj0 - 2, 2 * g.cj1 + 1, g.ka,
                g.kb, e_col0(g), 2 * g.cj0 - 2, g.w.we, warp, lane, nwarps);
  }

  __device__ void load_r(const Args& a, const Geom& g, int q, int warp, int lane,
                         int nwarps) const {
    load_box<1>(r_plane(g, q), a.r[0], q, g.n, row_len(g), 2 * g.cj0 - 1, 2 * g.cj1, g.ra, g.rb,
                0, 2 * g.cj0 - 1, g.w.wr, warp, lane, nwarps);
  }

  // Its e at plane q at each of the lane's points (fine row `row`).
  template <int C>
  __device__ void init_prev(float4 (&prev)[2][C], const Geom& g, int q, int row, int lane) const {
    const float* mid = e_plane(g, q) + (row + 1) * g.w.we + kPad;
#pragma unroll
    for (int m = 0; m < C; ++m) {
      const int b = 4 * (32 * m + lane);
      if (b < g.pts) prev[0][m] = ld4(mid + b);
    }
  }

  // The residual at the lane's points of fine row `row` of plane p, each
  // group handed to sink(m, values): r - inv_h2 (nbr_sum - 6 e), the
  // neighbours i - 1 (prev), i + 1, j - 1, j + 1, k - 1, k + 1 (stencil.cuh,
  // nbr_sum; FOLD: the k - 1 one at k = 1 and the k + 1 one at k = n - 2
  // the point's own value); prev becomes plane p's e. A group past the
  // row's last point computes values that nothing reads.
  template <int C, class Sink>
  __device__ void row_values(float4 (&prev)[2][C], const Args& a, const Geom& g, int p, int row,
                             int lane, Sink sink) const {
    const int W = g.w.we;
    const float* mid = e_plane(g, p) + (row + 1) * W + kPad;
    const float* hi = e_plane(g, p + 1) + (row + 1) * W + kPad;
    const float* rr = r_plane(g, p) + row * g.w.wr;
#pragma unroll
    for (int m = 0; m < C; ++m) {
      const int b = 4 * (32 * m + lane);
      if (b < g.pts) {
        const float4 c = ld4(mid + b), h = ld4(hi + b), jm = ld4(mid + b - W),
                     jp = ld4(mid + b + W), r = ld4(rr + b), lo = prev[0][m];
        const float left = mid[b - 1], right = mid[b + 4];
        float x[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int k = g.k0 + b + i;
          float s = comp(lo, i);
          s = s + comp(h, i);
          s = s + comp(jm, i);
          s = s + comp(jp, i);
          s = s + (FOLD && k == 1 ? comp(c, i) : (i == 0 ? left : comp(c, i - 1)));
          s = s + (FOLD && k == g.n - 2 ? comp(c, i) : (i == 3 ? right : comp(c, i + 1)));
          x[i] = comp(r, i) - a.inv_h2 * (s - 6.0f * comp(c, i));
        }
        prev[0][m] = c;
        sink(m, make_float4(x[0], x[1], x[2], x[3]));
      }
    }
  }

  // Coarse plane ci from A: the j taps, then the k taps.
  __device__ void coarse_rows(float* __restrict__ out, const Geom& g, int ci, int warp, int lane,
                              int nwarps) const {
    store_coarse<FOLD>(out, A, g, ci, g.w.wa, warp, lane, nwarps,
                       [](const float* a0, int W, int t) {
      float y[3];
#pragma unroll
      for (int dk = 0; dk < 3; ++dk) {
        const int b = 2 * t + dk;
        y[dk] = tap3(a0[b], a0[W + b], a0[2 * W + b]);
      }
      return tap3(y[0], y[1], y[2]);
    });
  }
};

using Rect = RectLayout<false>;
using Fold = RectLayout<true>;

// K9's layout: a split pair, tile rows of slots, both colours; slot
// k0 + s of e at column kPad + s, of r and A at column s. MIXED: K23's,
// the same tile, the residual's k terms in mixed.cuh's order with the k
// faces' BC copies selected, the coarse fold out.
template <bool MIXED>
struct SplitLayout {
  static constexpr bool kSplit = true;
  static constexpr bool kFold = false;
  static constexpr bool kFoldOut = MIXED;
  static constexpr bool kSeg = false;
  float* ering;  // kERing planes x 2 colours of 2 bcj + 3 rows x we
  float* rring;  // kRRing planes x 2 colours of 2 bcj + 1 rows x wr
  float* A;      // 2 bcj + 1 rows x wa
  int pe, pr;

  __device__ SplitLayout(const Args& a, const Geom& g, float* smem) {
    pe = (2 * a.bcj + 3) * g.w.we;
    pr = (2 * a.bcj + 1) * g.w.wr;
    ering = smem;
    rring = ering + 2 * kERing * pe;
    A = rring + 2 * kRRing * pr;
  }

  __device__ float* e_plane(const Geom& g, int c, int q) const {
    return ering + (2 * ((q - g.pa) % kERing) + c) * pe;
  }
  __device__ float* r_plane(const Geom& g, int c, int q) const {
    return rring + (2 * ((q - g.pa) % kRRing) + c) * pr;
  }

  template <int V>
  __device__ void load_pair(float* t0, float* t1, const float* const* f, const Geom& g, int q,
                            int j0, int j1, int c0, int c1, int col0, int W, int warp, int lane,
                            int nwarps) const {
    load_box<V>(t0, f[0], q, g.n, g.S, j0, j1, c0, c1, col0, j0, W, warp, lane, nwarps);
    load_box<V>(t1, f[1], q, g.n, g.S, j0, j1, c0, c1, col0, j0, W, warp, lane, nwarps);
  }

  __device__ void load_e(const Args& a, const Geom& g, int q, int warp, int lane,
                         int nwarps) const {
    const int col0 = kPad + g.ka - g.k0;
    if (a.vec) {
      load_pair<4>(e_plane(g, 0, q), e_plane(g, 1, q), a.e, g, q, 2 * g.cj0 - 2, 2 * g.cj1 + 1,
                   g.ka, g.kb, col0, g.w.we, warp, lane, nwarps);
    } else {
      load_pair<1>(e_plane(g, 0, q), e_plane(g, 1, q), a.e, g, q, 2 * g.cj0 - 2, 2 * g.cj1 + 1,
                   g.ka, g.kb, col0, g.w.we, warp, lane, nwarps);
    }
  }

  __device__ void load_r(const Args& a, const Geom& g, int q, int warp, int lane,
                         int nwarps) const {
    if (a.vec) {
      load_pair<4>(r_plane(g, 0, q), r_plane(g, 1, q), a.r, g, q, 2 * g.cj0 - 1, 2 * g.cj1, g.ra,
                   g.rb, 0, g.w.wr, warp, lane, nwarps);
    } else {
      load_pair<1>(r_plane(g, 0, q), r_plane(g, 1, q), a.r, g, q, 2 * g.cj0 - 1, 2 * g.cj1, g.ra,
                   g.rb, 0, g.w.wr, warp, lane, nwarps);
    }
  }

  // The colour holding the even k of fine row j of plane q (slot parity
  // 1): red where i + j is odd.
  __device__ static int even_colour(int q, int j) { return ((q + j) & 1) ? 0 : 1; }

  // The e at plane q at each of the lane's slots by role: prev[0] the
  // colour holding the row's even k there, prev[1] the other. A colour's
  // role flips from plane to plane, so at plane q + 1 prev[0] is the e of
  // the colour that then holds the odd k: the i - 1 neighbour of the
  // even-k colour's residual, and prev[1] that of the odd-k one's.
  template <int C>
  __device__ void init_prev(float4 (&prev)[2][C], const Geom& g, int q, int row, int lane) const {
    const int ce = even_colour(q, 2 * g.cj0 - 1 + row);
    const int o = (row + 1) * g.w.we + kPad;
    const float* te = e_plane(g, ce, q) + o;
    const float* to = e_plane(g, 1 - ce, q) + o;
#pragma unroll
    for (int m = 0; m < C; ++m) {
      const int s = 4 * (32 * m + lane);
      if (s < g.pts) {
        prev[0][m] = ld4(te + s);
        prev[1][m] = ld4(to + s);
      }
    }
  }

  // The k-tapped values of fine row `row` of plane p at the lane's coarse
  // k, each group handed to sink(m, values): both colours' residuals at
  // slots kk = k0 + s (split.cuh's nbr_sum order: the other colour at
  // i - 1 (prev), i + 1, j - 1, j + 1, kk, then kk - 1 where the colour's
  // k is odd, kk + 1 where even, 0 past the row; MIXED: O's k terms k - 1
  // (kk - 1) before k + 1 (kk), each the point's own value past its end
  // of the row), then
  // 0.5 E[kk] + 0.25 (O[kk] + O[kk + 1]), E / O the colour holding the
  // row's even / odd k, the group's last O[kk + 1] from the next lane (or
  // the next chunk's first); prev becomes plane p's e. Slots past the
  // row's last point compute values that nothing reads (E's dead slot
  // S - 1 among them).
  template <int C, class Sink>
  __device__ void row_values(float4 (&prev)[2][C], const Args& a, const Geom& g, int p, int row,
                             int lane, Sink sink) const {
    const int ce = even_colour(p, 2 * g.cj0 - 1 + row);
    const int W = g.w.we, oe = (row + 1) * W + kPad, orr = row * g.w.wr;
    const float* me = e_plane(g, ce, p) + oe;  // even-k colour, plane p
    const float* mo = e_plane(g, 1 - ce, p) + oe;
    const float* he = e_plane(g, ce, p + 1) + oe;
    const float* ho = e_plane(g, 1 - ce, p + 1) + oe;
    const float* re = r_plane(g, ce, p) + orr;
    const float* ro = r_plane(g, 1 - ce, p) + orr;
    // group m's (E, O) residuals at slots k0 + s .. + 3
    auto group = [&](int m, float (&se)[4], float (&so)[4]) {
      const int s = 4 * (32 * m + lane);
      if (s >= g.pts) return;
      const float4 ve = ld4(me + s), vo = ld4(mo + s), vhe = ld4(he + s), vho = ld4(ho + s);
      const float4 oem = ld4(mo + s - W), oep = ld4(mo + s + W);  // O's j -+ 1, for E
      const float4 eom = ld4(me + s - W), eop = ld4(me + s + W);  // E's j -+ 1, for O
      const float4 vre = ld4(re + s), vro = ld4(ro + s);
      const float o_right = mo[s + 4], e_left = me[s - 1];
      const float4 le = prev[0][m], lo = prev[1][m];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int kk = g.k0 + s + i;
        // E (k parity 1): the other colour O, its kk + 1 last
        float t = comp(le, i);
        t = t + comp(vho, i);
        t = t + comp(oem, i);
        t = t + comp(oep, i);
        t = t + comp(vo, i);
        t = t + (kk + 1 < g.S ? (i == 3 ? o_right : comp(vo, i + 1)) : 0.0f);
        se[i] = comp(vre, i) - a.inv_h2 * (t - 6.0f * comp(ve, i));
        // O (k parity 0): the other colour E; K9 its kk - 1 last, MIXED
        // first, the k = 1 and k = n - 2 neighbours the centre
        float u = comp(lo, i);
        u = u + comp(vhe, i);
        u = u + comp(eom, i);
        u = u + comp(eop, i);
        if constexpr (MIXED) {
          u = u + (kk > 0 ? (i == 0 ? e_left : comp(ve, i - 1)) : comp(vo, i));
          u = u + (kk + 1 < g.S ? comp(ve, i) : comp(vo, i));
        } else {
          u = u + comp(ve, i);
          u = u + (kk > 0 ? (i == 0 ? e_left : comp(ve, i - 1)) : 0.0f);
        }
        so[i] = comp(vro, i) - a.inv_h2 * (u - 6.0f * comp(vo, i));
      }
      prev[0][m] = ve;
      prev[1][m] = vo;
    };
    float se[4] = {}, so[4] = {};
    group(0, se, so);
#pragma unroll
    for (int m = 0; m < C; ++m) {
      float se_next[4] = {}, so_next[4] = {};
      if (m + 1 < C) group(m + 1, se_next, so_next);
      float up = __shfl_down_sync(0xffffffffu, so[0], 1);
      const float wrap = __shfl_sync(0xffffffffu, so_next[0], 0);
      if (lane == 31) up = wrap;
      if (4 * (32 * m + lane) < g.pts) {
        float x[4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
          x[i] = 0.5f * se[i] + 0.25f * (so[i] + (i == 3 ? up : so[i + 1]));
        sink(m, make_float4(x[0], x[1], x[2], x[3]));
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        se[i] = se_next[i];
        so[i] = so_next[i];
      }
    }
  }

  // Coarse plane ci from A: the j taps (MIXED: into the coarse fold).
  __device__ void coarse_rows(float* __restrict__ out, const Geom& g, int ci, int warp, int lane,
                              int nwarps) const {
    store_coarse<MIXED>(out, A, g, ci, g.w.wa, warp, lane, nwarps,
                        [](const float* a0, int W, int t) {
      return tap3(a0[t], a0[W + t], a0[2 * W + t]);
    });
  }
};

using Split = SplitLayout<false>;
using MSplit = SplitLayout<true>;

// ------------------------------------------------ K30's and K39's segments

// A launch on one rank's segmented block: K3's arguments (e and r unused),
// the rank's segments of e and r (seg2d.cuh: row t, column j local, the
// halos at negative and past-the-end indices), its coarse block's lc rows
// of ljc columns of nc (on Seg the j axis whole, ljc = nc), and its local
// interior coarse rows [c0, c1) and columns [cj0, cj1), those whose
// GLOBAL index lies in [1, nc - 2]; all four 0 for a rank without
// interior coarse points (seg_setup).
template <class S>
struct SegArgs : Args {
  S e_s, r_s;
  int lc, ljc;
  int c0, c1, cj0, cj1;
};

// The local interior coarse points [lo, hi) of len coarse points whose
// first is global coarse index cg0.
inline void interior_span(int cg0, int len, int nc, int& lo, int& hi) {
  lo = imax(0, 1 - cg0);
  hi = imin(len, nc - 1 - cg0);
}

// SegArgs' block and interior from the rank's global fine row g0 of body
// row 0 and its L rows, and (Seg2) gj0 and Lj columns; on Seg (whole) the
// columns are the field's, gj0 and Lj unused. 0, or cudaErrorInvalidValue
// for an odd offset or extent (a coarse point is two fine ones from global
// 0) or a level without interior coarse points.
template <class S>
inline int seg_setup(SegArgs<S>& a, int g0, int L, int gj0, int Lj, bool whole) {
  const int nc = (a.n + 1) / 2;
  if (a.n % 2 == 0 || interior(a.n) < 1 || g0 < 0 || g0 % 2 || L < 2 || L % 2 ||
      (!whole && (gj0 < 0 || gj0 % 2 || Lj < 2 || Lj % 2)) ||
      (long long)(L / 2) * (whole ? nc : Lj / 2) * nc >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
  a.lc = L / 2;
  a.ljc = whole ? nc : Lj / 2;
  interior_span(g0 / 2, a.lc, nc, a.c0, a.c1);
  interior_span(whole ? 0 : gj0 / 2, a.ljc, nc, a.cj0, a.cj1);
  if (a.c1 <= a.c0 || a.cj1 <= a.cj0) a.c0 = a.c1 = a.cj0 = a.cj1 = 0;
  return 0;
}

// 0 when the kernels take the plan: plan_error's rules with the rank's
// interior rows and columns for the level's (any box for a rank without
// interior coarse points, whose one block writes zeros only).
template <class S>
inline int seg_plan_error(const SegArgs<S>& a, int chunks, int threads, long long smem) {
  const bool empty = a.c1 <= a.c0;
  return plan_error(a, false, chunks, threads, smem, empty ? 0x7fffffff : a.c1 - a.c0,
                    empty ? kMaxRows : a.cj1 - a.cj0);
}

// A segment launch's blocks: the boxes over the rank's interior, or one
// (chosen over blocks(const Args&) by launch for SegArgs).
template <class S>
inline int blocks(const SegArgs<S>& a) {
  if (a.c1 <= a.c0) return 1;
  const int m = interior(a.n);
  return ((a.c1 - a.c0 + a.bci - 1) / a.bci) * ((a.cj1 - a.cj0 + a.bcj - 1) / a.bcj) *
         ((m + a.bck - 1) / a.bck);
}

// One block's box, in local coarse indices, and K3's footprint of it: the
// cone's fine planes 2 ci0 - 2 .. 2 ci1 of e reach local plane -2 and L,
// its rows (Seg2) local column -2 and Lj, through the halos.
template <class S>
__device__ inline Geom geometry(const SegArgs<S>& a, bool, bool) {
  Geom g;
  g.n = a.n;
  g.nc = (a.n + 1) / 2;
  g.S = split::slots(a.n);
  const int nj = (a.cj1 - a.cj0 + a.bcj - 1) / a.bcj, nk = (g.nc - 2 + a.bck - 1) / a.bck;
  const int tk = blockIdx.x % nk, tj = (blockIdx.x / nk) % nj, ti = blockIdx.x / (nk * nj);
  g.ci0 = a.c0 + ti * a.bci;
  g.ci1 = imin(g.ci0 + a.bci, a.c1);
  g.cj0 = a.cj0 + tj * a.bcj;
  g.cj1 = imin(g.cj0 + a.bcj, a.cj1);
  g.ck0 = 1 + tk * a.bck;
  g.ck1 = imin(g.ck0 + a.bck, g.nc - 1);
  g.rows = 2 * (g.cj1 - g.cj0) + 1;
  g.pa = 2 * g.ci0 - 2;
  g.w = widths(a.bck, false);
  g.pts = 2 * (g.ck1 - g.ck0) + 1;
  g.k0 = 2 * g.ck0 - 1;
  g.ka = g.k0 - 1;
  g.kb = 2 * g.ck1 + 1;
  g.ra = g.k0;
  g.rb = 2 * g.ck1;
  return g;
}

// The coarse planes [0, c0) and [c1, lc) of the rank's block, written 0
// (the whole block where it has no interior), spread over every thread of
// the launch, consecutive points across a warp.
template <class S>
__device__ inline void seg_zero_planes(const SegArgs<S>& a) {
  const int P = a.ljc * ((a.n + 1) / 2), head = a.c0 * P, skip = (a.c1 - a.c0) * P;
  const int count = head + (a.lc - a.c1) * P, stride = gridDim.x * blockDim.x;
  for (int v = blockIdx.x * blockDim.x + threadIdx.x; v < count; v += stride)
    a.out[v < head ? v : v + skip] = 0.0f;
}

// K30's and K39's layout: K3's tile (Rect), its rows copied from the
// segments, a row looked up once (seg_at: Seg::row, Seg2::at), 4-byte
// copies (rows of an odd n floats do not start on 16 bytes); K3's
// residuals and i taps; the coarse rows stored into the rank's (lc, ljc,
// nc) block; the zeros of the rank's coarse points off the interior.
template <class S>
struct SegLayout : Rect {
  static constexpr bool kSeg = true;
  int ljc;  // the coarse block's columns

  __device__ SegLayout(const SegArgs<S>& a, const Geom& g, float* smem)
      : Rect(a, g, smem), ljc(a.ljc) {}

  // Rows [j0, j1) x columns [c0, c1) of plane q of segment s into a tile
  // whose row 0 is row j0 and whose column col0 holds column c0.
  __device__ static void load_rows(float* tile, const S& s, int q, int n, int j0, int j1, int c0,
                                   int c1, int col0, int W, int warp, int lane, int nwarps) {
    for (int j = j0 + warp; j < j1; j += nwarps) {
      float* d = tile + (j - j0) * W + col0 - c0;
      const float* src = seg_at(s, q, j, n);
      for (int c = c0 + lane; c < c1; c += 32) cp_async4(d + c, src + c);
    }
  }

  __device__ void load_e(const SegArgs<S>& a, const Geom& g, int q, int warp, int lane,
                         int nwarps) const {
    load_rows(e_plane(g, q), a.e_s, q, g.n, 2 * g.cj0 - 2, 2 * g.cj1 + 1, g.ka, g.kb, kPad - 1,
              g.w.we, warp, lane, nwarps);
  }

  __device__ void load_r(const SegArgs<S>& a, const Geom& g, int q, int warp, int lane,
                         int nwarps) const {
    load_rows(r_plane(g, q), a.r_s, q, g.n, 2 * g.cj0 - 1, 2 * g.cj1, g.ra, g.rb, 0, g.w.wr,
              warp, lane, nwarps);
  }

  // Coarse plane ci from A: K3's j taps, then its k taps, into the block.
  __device__ void coarse_rows(float* __restrict__ out, const Geom& g, int ci, int warp, int lane,
                              int nwarps) const {
    const int W = g.w.wa, ncr = g.cj1 - g.cj0, nck = g.ck1 - g.ck0, groups = (nck + 31) >> 5;
    for (int it = warp; it < ncr * groups; it += nwarps) {
      const int cr = it / groups, t = 32 * (it - cr * groups) + lane;
      if (t >= nck) continue;
      const float* a0 = A + 2 * cr * W;
      float y[3];
#pragma unroll
      for (int dk = 0; dk < 3; ++dk) {
        const int b = 2 * t + dk;
        y[dk] = tap3(a0[b], a0[W + b], a0[2 * W + b]);
      }
      out[(ci * ljc + g.cj0 + cr) * g.nc + g.ck0 + t] = tap3(y[0], y[1], y[2]);
    }
  }

  // The rank's coarse points off the global interior, written 0: the
  // planes outside [c0, c1) (seg_zero_planes); in the box's planes, the
  // points of the box widened by one to the block's edge on each side that
  // reaches the end of the interior (rows to 0 and ljc, k to 0 and nc) that
  // lie off it, as zero_boundary's: whole rows off [cj0, cj1) (boundary,
  // pad), else the k ends; a warp a row. Each such point is written once.
  __device__ void zero(const SegArgs<S>& a, const Geom& g, int warp, int lane, int nwarps) const {
    seg_zero_planes(a);
    const int last = g.nc - 1;
    const int ja = g.cj0 == a.cj0 ? 0 : g.cj0, jb = g.cj1 == a.cj1 ? a.ljc : g.cj1;
    const bool k_lo = g.ck0 == 1, k_hi = g.ck1 == last;
    const int ka = k_lo ? 0 : g.ck0, kb = k_hi ? g.nc : g.ck1, nj = jb - ja;
    for (int row = warp; row < (g.ci1 - g.ci0) * nj; row += nwarps) {
      const int ci = g.ci0 + row / nj, cj = ja + row % nj;
      float* o = a.out + (ci * a.ljc + cj) * g.nc;
      if (cj < a.cj0 || cj >= a.cj1) {
        for (int ck = ka + lane; ck < kb; ck += 32) o[ck] = 0.0f;
      } else if (lane == 0) {
        if (k_lo) o[0] = 0.0f;
        if (k_hi) o[last] = 0.0f;
      }
    }
  }
};

// The stage: the prologue (e planes 2 ci0 - 2 .. 2 ci0, r planes 2 ci0 - 1
// and 2 ci0; the block's boundary zeros stored while they fly), then a
// step a fine plane p of the cone: wait for plane p + 1 of e and p of r, a
// barrier, the rows of the coarse plane the step before closed, start e
// plane p + 2 and r plane p + 1 (into the ring slots of plane p - 1), the
// row values and the i taps, and where p = 2 ci - 1 closes coarse plane
// ci - 1, its i-tapped plane into A. On a segment (L::kSeg, Arg SegArgs)
// the layout's own zeros; a rank without interior coarse points (one
// block) writes its zeros only.
template <class L, int C, class Arg>
__device__ void restrict_body(const Arg& a, float* smem) {
  if constexpr (L::kSeg) {
    if (a.c1 <= a.c0) {
      seg_zero_planes(a);
      return;
    }
  }
  const Geom g = geometry(a, L::kSplit, L::kFold);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, nwarps = blockDim.x >> 5;
  const L lay(a, g, smem);
  const int pa = g.pa, pe = 2 * g.ci1, p1 = 2 * g.ci1 - 1;
  for (int q = pa; q < pa + kERing; ++q) lay.load_e(a, g, q, warp, lane, nwarps);
  for (int q = pa + 1; q <= pa + kRRing; ++q) lay.load_r(a, g, q, warp, lane, nwarps);
  cp_async_commit();
  if constexpr (L::kSeg) {
    lay.zero(a, g, warp, lane, nwarps);  // while the copies fly
  } else {
    zero_boundary<L::kFoldOut>(a.out, g, warp, lane, nwarps);  // while the copies fly
  }
  cp_async_wait_all();
  __syncthreads();
  const bool mine = warp < g.rows;  // a warp a fine row of the cone
  float4 prev[2][C], acc[C];
  if (mine) lay.template init_prev<C>(prev, g, pa, warp, lane);
  float* arow = lay.A + warp * g.w.wa;
  for (int p = pa + 1; p <= p1; ++p) {
    cp_async_wait_all();
    __syncthreads();  // plane p + 1 of e and p of r in; ring slots of p - 1 and A read
    // the coarse plane the step before closed (p - 1 = 2 ci - 1)
    if (!(p & 1) && p > pa + 2) lay.coarse_rows(a.out, g, p / 2 - 1, warp, lane, nwarps);
    if (p + 2 <= pe) lay.load_e(a, g, p + 2, warp, lane, nwarps);
    if (p > pa + 1 && p + 1 <= p1) lay.load_r(a, g, p + 1, warp, lane, nwarps);
    cp_async_commit();
    const bool opens = p & 1;                 // p = 2 ci - 1
    const bool closes = opens && p > pa + 1;  // and the last plane of ci - 1's cone
    if (mine) {
      // the i taps of the lane's group m: 0.25 R opens coarse plane ci,
      // closing ci - 1 with it; 0.5 R adds the middle plane
      lay.template row_values<C>(prev, a, g, p, warp, lane, [&](int m, float4 x) {
        float4& s = acc[m];
        if (opens) {
          const float4 q = make_float4(0.25f * x.x, 0.25f * x.y, 0.25f * x.z, 0.25f * x.w);
          if (closes)
            st4(arow + 4 * (32 * m + lane),
                make_float4(s.x + q.x, s.y + q.y, s.z + q.z, s.w + q.w));
          s = q;
        } else {
          s = make_float4(s.x + 0.5f * x.x, s.y + 0.5f * x.y, s.z + 0.5f * x.z, s.w + 0.5f * x.w);
        }
      });
    }
  }
  __syncthreads();  // the last coarse plane, ci1 - 1, in A
  lay.coarse_rows(a.out, g, g.ci1 - 1, warp, lane, nwarps);
}

// Launch one instantiation on the plan's grid (Arg: Args or SegArgs); a
// cudaError_t.
template <class Kernel, class Arg>
inline int launch(Kernel kernel, const Arg& a, int threads, int smem, cudaStream_t stream) {
  if (const int err = split::raise_smem_limit((const void*)kernel)) return err;
  kernel<<<blocks(a), threads, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace restriction
}  // namespace mg
