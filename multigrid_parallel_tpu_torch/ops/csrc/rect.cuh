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
#pragma once

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

__host__ __device__ inline int slots(int n) { return n >> 1; }

// p of `color` in row (i, j): its slot kk holds k = 2 kk + 1 + p.
__device__ inline int parity(int i, int j, int color) { return ((i + j) & 1) ^ color ^ 1; }

struct StageArgs {
  float* out;
  const float* in;  // the initial guess; nullptr for a zero one (K2)
  const float* f;
  int color0;  // kRed or kBlack: the colour of the first half-sweep
  int n;
  float h2;
  int bi, bj, bk, k_halo;  // the plan (pallas_split._stage_plan, rect)
};

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
__host__ __device__ inline long long stage_smem_bytes(int n, int n_iter, int bi, int bj, int bk,
                                                      int k_halo, bool box) {
  const int H = 2 * n_iter;
  return 2LL * tile_planes(bi, H, box) * (bj + 2 * H) * tile_width(n, bk, k_halo) * 4;
}

inline int stage_blocks(const StageArgs& a) {
  const int S = slots(a.n);
  return ((a.n + a.bi - 1) / a.bi) * ((a.n + a.bj - 1) / a.bj) * ((S + a.bk - 1) / a.bk);
}

// 0 when the plan is one the stage kernels take: n_iter 1 or 2, whole rows
// or k tiles of a multiple of 4 slots with a halo of a multiple of 4 at
// least H, the shared memory it names (`smem` less any extra the caller
// adds).
inline int stage_plan_error(const StageArgs& a, int n_iter, int threads, long long smem,
                            bool box) {
  const int S = slots(a.n), H = 2 * n_iter;
  const bool whole_rows = a.k_halo == 0 && a.bk == S;
  const bool k_tiles = a.k_halo >= H && a.k_halo % 4 == 0 && a.bk % 4 == 0 && a.bk >= 4 &&
                       a.bk < S;
  if (a.n < 3 || (n_iter != 1 && n_iter != 2) || a.bi < 1 || a.bj < 1 ||
      !(whole_rows || k_tiles) || threads < 32 || threads > kStageMaxThreads || threads % 32 ||
      smem != stage_smem_bytes(a.n, n_iter, a.bi, a.bj, a.bk, a.k_halo, box))
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

__device__ inline Geom geometry(const StageArgs& a, int H) {
  Geom t;
  const int n = a.n, S = slots(n);
  t.n = n;
  t.S = S;
  const int nj = (n + a.bj - 1) / a.bj, nk = (S + a.bk - 1) / a.bk;
  const int tk = blockIdx.x % nk, tj = (blockIdx.x / nk) % nj, ti = blockIdx.x / (nk * nj);
  t.i0 = ti * a.bi;
  t.i1 = min(t.i0 + a.bi, n);
  t.j0 = tj * a.bj;
  t.j1 = min(t.j0 + a.bj, n);
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
__device__ inline void tile_load(float* t0, float* t1, const float* __restrict__ g, const Geom& t,
                                 int q, int color0, int warp, int lane, int nwarps) {
  const int k = t.kra + lane, p = 1 - (k & 1);
  for (int j = t.ja + warp; j < t.jb; j += nwarps) {
    const int color = ((q + j) & 1) ^ p ^ 1;
    float* d = colour_row(t0, t1, t, j, color, color0) + ((k - 1 - p) >> 1);
    const float* s = g + (q * t.n + j) * t.n + k;
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

// f of slots g .. g + 3 of a colour row (f_row[2 kk] is slot kk's; 0 past
// the live slots, whose values are not used).
__device__ inline float4 load_f4(const float* __restrict__ f_row, int g, int k_end) {
  float v[4];
#pragma unroll
  for (int c = 0; c < 4; ++c) v[c] = g + c < k_end ? __ldg(f_row + 2 * (g + c)) : 0.0f;
  return make_float4(v[0], v[1], v[2], v[3]);
}

// One half-sweep of the live slots [kl, k_end) of one tile row of parity p
// (tile offset of slot kk: row + kk; f of slot kk: f_row[2 kk] in device
// memory, the lane's first group's prefetched in ``pre`` where ``use_pre``),
// a 4-slot group a lane (rl.sl of the row's rl.lanes), the other slots of
// a group keeping their values. Slot kk's k - 1 and k + 1 neighbours are the other colour's
// slots kk - 1 and kk where p = 0 (k odd), kk and kk + 1 where p = 1.
__device__ inline void sweep_row(float* dst, const float* lo, const float* mid, const float* hi,
                                 const float* __restrict__ f_row, int row, int W, int kl,
                                 int k_end, int p, float h2, const RowLanes& rl, bool use_pre,
                                 float4 pre) {
  const int g0 = (kl & ~3) + 4 * rl.sl;
  for (int g = g0; g < k_end; g += 4 * rl.lanes) {
    const int o = row + g;
    const float4 vf = use_pre && g == g0 ? pre : load_f4(f_row, g, k_end);
    const float4 vl = ld4(lo + o), vh = ld4(hi + o), vjm = ld4(mid + o - W),
                 vjp = ld4(mid + o + W), vm = ld4(mid + o);
    const bool whole = g >= kl && g + 4 <= k_end;
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
    st4(dst + o, make_float4(r[0], r[1], r[2], r[3]));
  }
}

// The stage. Prep (split::NoPrep, or K4's correction in prolong_smooth.cu)
// has start(extra shared memory, geometry), load(q, geometry) (copies
// issued with plane q's) and apply(stage colour 0's tile plane, 1's, q,
// geometry, row lanes, color0), run on plane q once it has arrived and
// before any half-sweep reads it (box_body: apply_row, the same a row).
// ZERO: the initial guess is zero, nothing is loaded.
template <int NITER, bool ZERO, class Prep>
__device__ void stage_body(const StageArgs& a, float* smem, Prep prep) {
  constexpr int H = 2 * NITER, D = stage_depth(H);
  const Geom t = geometry(a, H);
  const int n = a.n;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, nwarps = blockDim.x >> 5;
  const RowLanes rl = row_lanes(a, t);
  const int r0 = warp * rl.rows + rl.sub, rstep = nwarps * rl.rows;  // this thread's tile rows
  auto ring = [&](int c, int q) { return smem + (c * D + q % D) * t.P; };
  if constexpr (Prep::kActive) prep.start(smem + 2 * D * t.P, t);
  auto load = [&](int q) {
    if constexpr (ZERO) {
      tile_zero(ring(0, q), ring(1, q), t, a.f);
    } else {
      tile_load(ring(0, q), ring(1, q), a.in, t, q, a.color0, warp, lane, nwarps);
    }
    if constexpr (Prep::kActive) prep.load(q, t);
  };

  // as split.cuh's stage_body: a thread sweeps tile row r0 (and r0 +
  // rstep, ...) of plane p - 2 s in each half-sweep s whose region holds
  // it, the f of its first row fetched into registers a step ahead
  auto region = [&](int s, int q, int& jl, int& jh, int& kl, int& kh) {
    jl = max(t.jb0 + s, 1);
    jh = min(t.j1 + H - s, n - 1);
    kl = t.k0 == 0 ? 0 : t.k0 - a.k_halo + s;
    kh = t.k1 == t.S ? t.S : t.k1 + a.k_halo - s;
    return q >= max(t.i0 - H + s, 1) && q < min(t.i1 + H - s, n - 1);
  };
  auto colour_of = [&](int s) { return (s - 1) & 1 ? 1 - a.color0 : a.color0; };
  auto f_row = [&](int q, int j, int pp) {
    return a.f + (q * n + j) * n + 1 + pp;
  };
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
  // half-sweep H at step i1 - 1 + 2 H
  for (int p = t.ia; p <= t.i1 + 2 * H; ++p) {
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
          sweep_row(dst, lo, mid, hi, f_row(q, j, pp), r * t.W - t.kb0, t.W, kl,
                    min(kh, (n - 1 - pp) >> 1), pp, a.h2, rl, r == r0, f_pre[s - 1]);
        }
      }
    }
    fetch(p + 1);
    // both colours' last half-sweeps (H - 1 and H) are done with plane
    // p - 1 - 2 H: half-sweep H finished it a step ago
    const int qb = p - 1 - 2 * H;
    if (qb >= t.i0 && qb < t.i1)
      tile_store(a.out, ring(0, qb), ring(1, qb), t, qb, a.color0, warp, lane, nwarps);
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
template <int NITER, bool ZERO, class Prep>
__device__ void box_body(const StageArgs& a, float* smem, Prep prep) {
  constexpr int H = 2 * NITER;
  const Geom t = geometry(a, H);
  const int n = a.n, planes = tile_planes(a.bi, H, true), q0 = t.i0 - H;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, nwarps = blockDim.x >> 5;
  const RowLanes rl = row_lanes(a, t);
  auto tile = [&](int c, int q) { return smem + (c * planes + q - q0) * t.P; };
  if constexpr (Prep::kActive) prep.start(smem + 2 * planes * t.P, t);
  for (int q = t.ia; q < t.ib; ++q) {
    if constexpr (ZERO) {
      tile_zero(tile(0, q), tile(1, q), t, a.f);
    } else {
      tile_load(tile(0, q), tile(1, q), a.in, t, q, a.color0, warp, lane, nwarps);
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
    const int qa = max(t.i0 - H + s, 1), qb = min(t.i1 + H - s, n - 1);
    const int jl = max(t.jb0 + s, 1), jh = min(t.j1 + H - s, n - 1);
    const int kl = t.k0 == 0 ? 0 : t.k0 - a.k_halo + s;
    const int kh = t.k1 == t.S ? t.S : t.k1 + a.k_halo - s;
    const int rows = jh - jl, count = rows > 0 && qb > qa ? (qb - qa) * rows : 0;
    for (int v = warp * rl.rows + rl.sub; v < count; v += nwarps * rl.rows) {
      const int q = qa + v / rows, j = jl + v % rows;
      const int pp = parity(q, j, color);
      sweep_row(tile(c, q), tile(1 - c, q - 1), tile(1 - c, q), tile(1 - c, q + 1),
                a.f + (q * n + j) * n + 1 + pp, (j - t.jb0) * t.W - t.kb0, t.W, kl,
                min(kh, (n - 1 - pp) >> 1), pp, a.h2, rl, false, float4{});
    }
    __syncthreads();
  }
  for (int q = t.i0; q < t.i1; ++q)
    tile_store(a.out, tile(0, q), tile(1, q), t, q, a.color0, warp, lane, nwarps);
}

// Launch one stage kernel instantiation on the plan's grid; a cudaError_t.
template <class Kernel, class... Extra>
inline int launch_stage(Kernel kernel, const StageArgs& a, int threads, int smem,
                        cudaStream_t stream, Extra... extra) {
  if (const int err = split::raise_smem_limit((const void*)kernel)) return err;
  kernel<<<stage_blocks(a), threads, smem, stream>>>(a, extra...);
  return (int)cudaGetLastError();
}

}  // namespace rect
}  // namespace mg
