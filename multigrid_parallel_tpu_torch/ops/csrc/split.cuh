// Shared pieces of the split-colour kernels K7-K12 (rb_smooth_split.cu,
// residual_restrict_split.cu, prolong_smooth_split.cu, df_split.cu).
//
// A field of the finest level is a (red, black) PAIR of contiguous f32
// tensors, each of shape (n, n, S) with S = (n - 1) / 2 slots, flat index
// idx = (i * n + j) * S + kk. Slot kk of colour c in row (i, j) holds the
// fine point k = 2 kk + 1 + p, with p = (i + j) mod 2 for RED and
// 1 - that for BLACK (RED = (i + j + k) odd, mg_3d.h:669). The layout of
// multigrid_parallel_tpu/ops/pallas_split.py without the TPU's lane and
// sublane padding.
//
// Invariant: slots that hold no interior point (2 kk + 1 + p > n - 2: the
// last slot of the colour holding the even k's on every row) are exactly
// 0, and so are the i / j boundary rows of correction fields. The k-face
// neighbours of the first and last interior k read those zeros (or the
// guard below), as the Pallas kernels read their rolled-in zero lanes.
#pragma once

#include <mutex>
#include <utility>
#include <vector>

#include "stencil.cuh"

namespace mg {
namespace split {

constexpr int kRed = 1;
constexpr int kBlack = 0;

__host__ __device__ inline int slots(int n) { return (n - 1) / 2; }

inline int slot_blocks(int n) {
  const long long total = (long long)n * n * slots(n);
  return (int)((total + kThreads - 1) / kThreads);
}

// Decode a flat slot index; false when idx is past the field.
__device__ inline bool decode(int idx, int n, int S, int& i, int& j, int& kk) {
  if (idx >= n * n * S) return false;
  const int row = idx / S;
  kk = idx - row * S;
  i = row / n;
  j = row - i * n;
  return true;
}

// p of `color` in row (i, j): its slot kk holds fine k = 2 kk + 1 + p.
__device__ inline int parity(int i, int j, int color) {
  return ((i + j) & 1) ^ color ^ 1;
}

// The points a half-sweep updates and a residual covers: interior rows,
// interior k.
__device__ inline bool live_interior(int i, int j, int kk, int p, int n) {
  return i >= 1 && i <= n - 2 && j >= 1 && j <= n - 2 && 2 * kk + 1 + p <= n - 2;
}

// The six face neighbours of slot idx of a colour with parity p, all in
// the OTHER colour `src`, in the Pallas split order
// (pallas_split.py:174-186): i-1, i+1, j-1, j+1 (same slot), then the
// shared k-neighbour src[kk], then src[kk-1] where p = 0 (the colour's k
// is odd, its neighbours k-1, k+1 sit at kk-1, kk) or src[kk+1] where
// p = 1 (at kk, kk+1). Past either end of the row that last one is the
// zero k face. Interior rows only.
__device__ inline void load_nbrs(const float* src, int idx, int n, int S, int kk,
                                 int p, float (&v)[6]) {
  const int nS = n * S;
  v[0] = src[idx - nS];
  v[1] = src[idx + nS];
  v[2] = src[idx - S];
  v[3] = src[idx + S];
  v[4] = src[idx];
  if (p == 0) {
    v[5] = kk > 0 ? src[idx - 1] : 0.0f;
  } else {
    v[5] = kk + 1 < S ? src[idx + 1] : 0.0f;
  }
}

// Their sum, left to right in that order.
__device__ inline float nbr_sum(const float* src, int idx, int n, int S, int kk,
                                int p) {
  float v[6];
  load_nbrs(src, idx, n, S, kk, p, v);
  float s = v[0];
#pragma unroll
  for (int m = 1; m < 6; ++m) s = s + v[m];
  return s;
}

// One RB-GS update of slot idx from the other colour `src`:
//   (nbr_sum - h^2 f) * (1/6)   (mg_3d.h:438-443)
__device__ inline float sweep_value(const float* src, const float* f, int idx,
                                    int n, int S, int kk, int p, float h2) {
  return (nbr_sum(src, idx, n, S, kk, p) - h2 * f[idx]) * (1.0f / 6.0f);
}

// ------------------------------------------------------------------
// The one-pass smoothing stage (K7, and K10 after its prolongation): all
// 2 n_iter half-sweeps of a stage on a tile held in shared memory.
//
// A block owns a box of planes [i0, i1), rows [j0, j1) and slots [k0, k1)
// of both colours, and holds in shared memory its rows widened by H =
// 2 n_iter on each side (whole k rows, or a k tile widened by k_halo >= H
// slots where a row does not fit). It streams i as a skewed wavefront:
// at step p, half-sweep s (s = 1 .. H) runs at plane p - 2 s. Half-sweep s
// needs the planes p - 2 s - 1 .. p - 2 s + 1 of the other colour at the
// level before it, which half-sweep s - 1 finished at steps p - 3 and p - 1,
// and which half-sweep s + 1 of that colour overwrites only at steps p + 1
// and p + 3: so the H half-sweeps of a step are independent of each other,
// and a step needs two barriers (plane p arrived; step done), however deep
// the stage. A colour's tile is a ring of 2 H + 3 planes (p + 1 in flight
// by cp.async, p .. p - 2 H - 1 in use), updated in place: a half-sweep
// writes only the live interior slots of its colour inside its region, so
// every other slot keeps its input value, the plain version's where(live,
// upd, dst). f is read from device memory at each half-sweep of its colour
// (from L2 after the first), its latency covered by the step's other
// half-sweeps. The region of half-sweep s is the loaded box shrunk by s on
// every side that is not the field's edge. After H half-sweeps the owned
// box is exact: each colour's is written at the step after its last
// half-sweep. The first half-sweep's colour is needed only at the slots
// that no half-sweep updates (the boundary planes and rows, and the dead
// last slot of the rows of parity 1): half-sweep 1 rewrites every live
// slot of its region, and no later half-sweep reads that colour outside it
// (half-sweep s + 1 reads one slot, row or plane past its region, which is
// half-sweep s's). A Prep with kFixedFirst loads only those (K10); K7
// loads the colour whole, because the narrower loader costs its
// two-iteration 16-byte instantiation a register spill at 640 threads and
// made it slower (PERF.md).

struct StageArgs {
  float* out[2];  // by stage colour: [0] the first half-sweep's colour
  const float* in[2];
  const float* f[2];
  int color0;  // kRed or kBlack: the colour of the first half-sweep
  int n;
  float h2;
  int bi, bj, bk, k_halo;  // the plan (pallas_split._stage_plan)
};

// One block's box and tile (global indices; clipped to the field).
struct StageGeom {
  int n, S;
  int i0, i1, j0, j1, k0, k1;  // the owned box
  int jb0, kb0;                // global row / slot of tile row 0 / column 0
  int ia, ib, ja, jb, ka, kb;  // the loaded planes, rows and slots
  int R, W, P;                 // tile rows, floats per tile row, per tile plane
};

// The most threads a stage block runs (its kernels' launch bound).
constexpr int kStageMaxThreads = 640;

// Tile planes in each colour's ring: p + 1 .. p - 2 H - 1 at step p.
__host__ __device__ constexpr int stage_depth(int H) { return 2 * H + 3; }

// Shared-memory bytes of one block: the two colours' rings. The same
// formula as pallas_split._stage_smem, which plans in Python; the launchers
// reject a plan whose smem differs from it.
__host__ __device__ inline long long stage_smem_bytes(int n, int n_iter, int bj, int bk,
                                                      int k_halo) {
  const int H = 2 * n_iter;
  const long long W = k_halo ? bk + 2 * k_halo : slots(n);
  return 2LL * stage_depth(H) * (bj + 2 * H) * W * 4;
}

inline int stage_blocks(int n, const StageArgs& a) {
  const int S = slots(n);
  return ((n + a.bi - 1) / a.bi) * ((n + a.bj - 1) / a.bj) * ((S + a.bk - 1) / a.bk);
}

// 0 when the plan is one the stage kernels take: n_iter 1 or 2, halos
// deep enough, the shared memory it names.
inline int stage_plan_error(const StageArgs& a, int n_iter, int threads, int smem) {
  const int S = slots(a.n), H = 2 * n_iter;
  const bool whole_rows = a.k_halo == 0 && a.bk == S;
  const bool k_tiles = a.k_halo >= H && a.bk >= 1 && a.bk < S;
  if ((n_iter != 1 && n_iter != 2) || a.bi < 1 || a.bj < 1 || !(whole_rows || k_tiles) ||
      threads < 32 || threads > kStageMaxThreads || threads % 32 ||
      smem != stage_smem_bytes(a.n, n_iter, a.bj, a.bk, a.k_halo))
    return (int)cudaErrorInvalidValue;
  return 0;
}

// 16-byte copies and sweeps where every row of the box starts and ends on
// 4 floats.
inline bool stage_vec(const StageArgs& a) {
  const int S = slots(a.n);
  return S % 4 == 0 && (a.k_halo == 0 || (a.bk % 4 == 0 && a.k_halo % 4 == 0));
}

__device__ inline void cp_async4(float* dst, const float* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src) : "memory");
}

__device__ inline void cp_async16(float* dst, const float* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src) : "memory");
}

// Start zero-filling 16 bytes (V = 4) or 4 (V = 1) of shared memory: a
// cp.async of no source bytes, which fills with zeros (``any`` is a
// device address aligned to the copy, not read), issued and waited for as
// a load's are. (Plain stores of a zero tile cost the two-iteration rect
// wavefront a register spill.)
template <int V>
__device__ inline void cp_async_zero(float* dst, const float* any) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  if constexpr (V == 4) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(any), "r"(0)
                 : "memory");
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d), "l"(any), "r"(0)
                 : "memory");
  }
}

__device__ inline void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }

// Wait for every group but the newest.
__device__ inline void cp_async_wait_all_but_one() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// Start copying rows [ja, jb) of the loaded box of plane q of field g into
// its tile plane.
template <bool VEC>
__device__ inline void tile_load_rows(float* tile, const float* __restrict__ g,
                                      const StageGeom& t, int q, int ja, int jb) {
  constexpr int V = VEC ? 4 : 1;
  const int w = (t.kb - t.ka) / V, count = (jb - ja) * w;
  for (int v = threadIdx.x; v < count; v += blockDim.x) {
    const int r = v / w, j = ja + r, k = t.ka + (v - r * w) * V;
    float* d = tile + (j - t.jb0) * t.W + (k - t.kb0);
    const float* s = g + (q * t.n + j) * t.S + k;
    if (VEC) {
      cp_async16(d, s);
    } else {
      cp_async4(d, s);
    }
  }
}

// Start copying the loaded box of plane q of field g into its tile plane.
template <bool VEC>
__device__ inline void tile_load(float* tile, const float* __restrict__ g, const StageGeom& t,
                                 int q) {
  tile_load_rows<VEC>(tile, g, t, q, t.ja, t.jb);
}

// The same for the first half-sweep's colour `color`, whose live slots no
// half-sweep reads before it rewrites them: only the boundary planes and
// rows and, on interior rows of parity 1, the dead last slot S - 1 (slot kk
// is live where 2 kk + 1 + p <= n - 2).
template <bool VEC>
__device__ inline void tile_load_fixed(float* tile, const float* __restrict__ g,
                                       const StageGeom& t, int q, int color) {
  if (q == 0 || q == t.n - 1) {
    tile_load<VEC>(tile, g, t, q);
    return;
  }
  if (t.ja == 0) tile_load_rows<VEC>(tile, g, t, q, 0, 1);
  if (t.jb == t.n) tile_load_rows<VEC>(tile, g, t, q, t.n - 1, t.n);
  const int kd = t.S - 1;
  if (kd < t.ka || kd >= t.kb) return;
  for (int j = max(t.ja, 1) + threadIdx.x; j < min(t.jb, t.n - 1); j += blockDim.x) {
    if (parity(q, j, color))
      cp_async4(tile + (j - t.jb0) * t.W + (kd - t.kb0), g + (q * t.n + j) * t.S + kd);
  }
}

// Start zeroing both colours' tile planes of a plane (a zero initial
// pair, K8): every slot of each, dead slots and boundary rows too, which
// the stores write out as they are.
template <bool VEC>
__device__ inline void tile_zero(float* t0, float* t1, const StageGeom& t, const float* any) {
  constexpr int V = VEC ? 4 : 1;
  for (int v = V * threadIdx.x; v < t.P; v += V * blockDim.x) {
    cp_async_zero<V>(t0 + v, any);
    cp_async_zero<V>(t1 + v, any);
  }
}

// Write the owned box of tile plane q to plane q of field g, a warp a row.
template <bool VEC>
__device__ inline void tile_store(float* __restrict__ g, const float* tile, const StageGeom& t,
                                  int q, int warp, int lane, int nwarps) {
  constexpr int V = VEC ? 4 : 1;
  for (int j = t.j0 + warp; j < t.j1; j += nwarps) {
    const float* s = tile + (j - t.jb0) * t.W - t.kb0;
    float* d = g + (q * t.n + j) * t.S;
    for (int k = t.k0 + V * lane; k < t.k1; k += 32 * V) {
      if (VEC) {
        *reinterpret_cast<float4*>(d + k) = *reinterpret_cast<const float4*>(s + k);
      } else {
        d[k] = s[k];
      }
    }
  }
}

// nbr_sum on tile planes: the other colour at planes q - 1 (lo), q (mid)
// and q + 1 (hi), tile offset o of global slot kk, rows W floats apart;
// the same terms in the same order.
__device__ inline float tile_nbr_sum(const float* lo, const float* mid, const float* hi, int o,
                                     int W, int S, int kk, int p) {
  float s = lo[o];
  s = s + hi[o];
  s = s + mid[o - W];
  s = s + mid[o + W];
  s = s + mid[o];
  if (p == 0) {
    s = s + (kk > 0 ? mid[o - 1] : 0.0f);
  } else {
    s = s + (kk + 1 < S ? mid[o + 1] : 0.0f);
  }
  return s;
}

__device__ inline float4 ld4(const float* p) { return *reinterpret_cast<const float4*>(p); }

__device__ inline void st4(float* p, float4 v) { *reinterpret_cast<float4*>(p) = v; }

// Component c (a constant after unrolling) of v.
__device__ inline float comp(const float4& v, int c) {
  return c == 0 ? v.x : c == 1 ? v.y : c == 2 ? v.z : v.w;
}

// One half-sweep of the live slots [kl, k_end) of one tile row of parity p
// (tile offset of slot kk: row + kk; f of slot kk: f_row[kk] in device
// memory; its lane's first group prefetched in ``pre`` where ``use_pre``).
// VEC: a 4-slot group a lane, 16-byte loads and stores, the other slots
// of a group keeping their values; else a slot a lane. Each slot takes
// tile_nbr_sum's terms in its order, then (sum - h2 f) (1/6).
template <bool VEC>
__device__ inline void sweep_row(float* dst, const float* lo, const float* mid, const float* hi,
                                 const float* __restrict__ f_row, int row, int W, int S, int kl,
                                 int k_end, int p, float h2, int lane, bool use_pre,
                                 float4 pre) {
  if constexpr (!VEC) {
    for (int kk = kl + lane; kk < k_end; kk += 32) {
      const int o = row + kk;
      dst[o] = (tile_nbr_sum(lo, mid, hi, o, W, S, kk, p) - h2 * __ldg(f_row + kk)) *
               (1.0f / 6.0f);
    }
  } else {
    const int g0 = (kl & ~3) + 4 * lane;
    for (int g = g0; g < k_end; g += 128) {
      const int o = row + g;
      const float4 vf = use_pre && g == g0 ? pre : __ldg(reinterpret_cast<const float4*>(f_row + g));
      const float4 vl = ld4(lo + o), vh = ld4(hi + o), vjm = ld4(mid + o - W),
                   vjp = ld4(mid + o + W), vm = ld4(mid + o);
      const bool whole = g >= kl && g + 4 <= k_end;
      const float4 old = whole ? vm : ld4(dst + o);  // kept where a slot is outside
      float kn[4];  // each slot's second k neighbour: kk - 1 (p = 0) or kk + 1 (p = 1)
      if (p == 0) {
        kn[0] = g > 0 && g >= kl ? mid[o - 1] : 0.0f;
        kn[1] = vm.x;
        kn[2] = vm.y;
        kn[3] = vm.z;
      } else {
        kn[0] = vm.y;
        kn[1] = vm.z;
        kn[2] = vm.w;
        kn[3] = g + 3 < k_end && g + 4 < S ? mid[o + 4] : 0.0f;
      }
      float r[4];
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        float s = comp(vl, c);
        s = s + comp(vh, c);
        s = s + comp(vjm, c);
        s = s + comp(vjp, c);
        s = s + comp(vm, c);
        s = s + kn[c];
        const int kk = g + c;
        r[c] = kk >= kl && kk < k_end ? (s - h2 * comp(vf, c)) * (1.0f / 6.0f) : comp(old, c);
      }
      st4(dst + o, make_float4(r[0], r[1], r[2], r[3]));
    }
  }
}

// What a stage does to a plane of both colours as it arrives, before any
// half-sweep reads it, and whether it loads only the first colour's fixed
// slots (kFixedFirst): nothing and no for K7. K10's (prolong_smooth_split.cu)
// has start(extra shared memory, geometry), load(q, geometry) (copies
// issued with fine plane q's) and apply<VEC>(first colour's tile plane,
// second's, q, geometry).
struct NoPrep {
  static constexpr bool kActive = false;
  static constexpr bool kFixedFirst = false;
};

// ZERO: the initial pair is zero (K8): nothing is read from a.in, the
// tile planes start as zeros, so half-sweep 1 computes (+0 - h^2 f) (1/6)
// at every live slot of its region, as the plain version does from a zero
// pair, and every other slot is written out as 0.
template <int NITER, bool VEC, bool ZERO = false, class Prep>
__device__ void stage_body(const StageArgs& a, float* smem, Prep prep) {
  static_assert(!(ZERO && Prep::kActive), "a zero initial pair has nothing to prepare");
  constexpr int H = 2 * NITER, D = stage_depth(H);
  StageGeom t;
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
  t.kb0 = t.k0 - a.k_halo;
  t.ia = max(t.i0 - H, 0);
  t.ib = min(t.i1 + H, n);
  t.ja = max(t.jb0, 0);
  t.jb = min(t.j1 + H, n);
  t.ka = max(t.kb0, 0);
  t.kb = min(t.k1 + a.k_halo, S);
  t.W = a.k_halo ? a.bk + 2 * a.k_halo : S;
  t.R = a.bj + 2 * H;
  t.P = t.R * t.W;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, nwarps = blockDim.x >> 5;
  auto ring = [&](int c, int q) { return smem + (c * D + q % D) * t.P; };
  if constexpr (Prep::kActive) prep.start(smem + 2 * D * t.P, t);
  auto load = [&](int q) {
    if constexpr (ZERO) {
      tile_zero<VEC>(ring(0, q), ring(1, q), t, a.f[0]);
    } else {
      if constexpr (Prep::kFixedFirst) {
        tile_load_fixed<VEC>(ring(0, q), a.in[0], t, q, a.color0);
      } else {
        tile_load<VEC>(ring(0, q), a.in[0], t, q);
      }
      tile_load<VEC>(ring(1, q), a.in[1], t, q);
    }
    if constexpr (Prep::kActive) prep.load(q, t);
  };

  // Warp w sweeps tile row w (and w + nwarps, ...) of plane p - 2 s in
  // each half-sweep s whose region holds it; the f of its first row is
  // fetched into registers a step ahead, so its latency hides behind a
  // step's work.
  auto region = [&](int s, int q, int& jl, int& jh, int& kl, int& kh) {
    jl = max(t.jb0 + s, 1);
    jh = min(t.j1 + H - s, n - 1);
    kl = t.k0 == 0 ? 0 : t.k0 - a.k_halo + s;
    kh = t.k1 == S ? S : t.k1 + a.k_halo - s;
    return q >= max(t.i0 - H + s, 1) && q < min(t.i1 + H - s, n - 1);
  };
  float4 f_pre[H] = {};
  auto fetch = [&](int step) {
    if constexpr (VEC) {
#pragma unroll
      for (int s = 1; s <= H; ++s) {
        int jl, jh, kl, kh;
        const int q = step - 2 * s, j = t.jb0 + warp;
        const bool rows = region(s, q, jl, jh, kl, kh) && j >= jl && j < jh;
        const int g = (kl & ~3) + 4 * lane;  // the lane's first group
        if (rows && g < kh)
          f_pre[s - 1] = __ldg(reinterpret_cast<const float4*>(a.f[(s - 1) & 1] +
                                                               (q * n + j) * S + g));
      }
    }
  };

  load(t.ia);
  cp_async_commit();
  fetch(t.ia);
  // the last step writes the second colour's last owned plane, i1 - 1,
  // finished by half-sweep H at step i1 - 1 + 2 H
  for (int p = t.ia; p <= t.i1 + 2 * H; ++p) {
    if (p + 1 < t.ib) load(p + 1);
    cp_async_commit();  // an empty group past the last plane keeps the count
    cp_async_wait_all_but_one();
    __syncthreads();
    if constexpr (Prep::kActive) {
      if (p < t.ib) prep.template apply<VEC>(ring(0, p), ring(1, p), p, t);
    }
#pragma unroll
    for (int s = 1; s <= H; ++s) {
      const int c = (s - 1) & 1, q = p - 2 * s;
      int jl, jh, kl, kh;
      if (region(s, q, jl, jh, kl, kh)) {
        const int color = c ? 1 - a.color0 : a.color0;
        float* dst = ring(c, q);
        const float* lo = ring(1 - c, q - 1);
        const float* mid = ring(1 - c, q);
        const float* hi = ring(1 - c, q + 1);
        // a warp a row, its lanes along k; a row's live slots are kk <
        // (n - 1 - p) / 2 (2 kk + 1 + p <= n - 2)
        for (int r = warp; r < t.R; r += nwarps) {
          const int j = t.jb0 + r;
          if (j < jl || j >= jh) continue;
          const int pp = parity(q, j, color);
          sweep_row<VEC>(dst, lo, mid, hi, a.f[c] + (q * n + j) * S, r * t.W - t.kb0, t.W, S,
                         kl, min(kh, (n - 1 - pp) >> 1), pp, a.h2, lane, VEC && r == warp,
                         f_pre[s - 1]);
        }
      }
    }
    fetch(p + 1);
    // each colour's last half-sweep (H - 1 and H) finished a step ago
    const int qa = p - 1 - 2 * (H - 1), qb = p - 1 - 2 * H;
    if (qa >= t.i0 && qa < t.i1) tile_store<VEC>(a.out[0], ring(0, qa), t, qa, warp, lane, nwarps);
    if (qb >= t.i0 && qb < t.i1) tile_store<VEC>(a.out[1], ring(1, qb), t, qb, warp, lane, nwarps);
    __syncthreads();
  }
}

// Raise a kernel's dynamic shared-memory limit on the current device to the
// most a block may opt in to, once a kernel and device; a cudaError_t.
inline int raise_smem_limit(const void* kernel) {
  static std::mutex lock;
  static std::vector<std::pair<const void*, int>> raised;
  int dev = 0;
  if (const int err = (int)cudaGetDevice(&dev)) return err;
  const std::lock_guard<std::mutex> guard(lock);
  for (const auto& r : raised)
    if (r.first == kernel && r.second == dev) return 0;
  int limit = 0;
  if (const int err = (int)cudaDeviceGetAttribute(
          &limit, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev))
    return err;
  if (const int err = (int)cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, limit))
    return err;
  raised.emplace_back(kernel, dev);
  return 0;
}

// Launch one stage kernel instantiation on the plan's grid; a cudaError_t.
template <class Kernel, class... Extra>
inline int launch_stage(Kernel kernel, const StageArgs& a, int threads, int smem,
                        cudaStream_t stream, Extra... extra) {
  if (const int err = raise_smem_limit((const void*)kernel)) return err;
  kernel<<<stage_blocks(a.n, a), threads, smem, stream>>>(a, extra...);
  return (int)cudaGetLastError();
}

}  // namespace split
}  // namespace mg
