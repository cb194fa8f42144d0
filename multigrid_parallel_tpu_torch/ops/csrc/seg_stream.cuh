// The streaming stage's geometry on one rank's segmented block, shared by
// the double-float residual-and-norm stage (K32, K41; residual_df_norm_seg
// .cu, df_stage_kernel) and the residual stage (K33; residual.cu,
// resid_stage_kernel).
//
// A block owns a box of the rank's interior points, bj rows (a warp each)
// of bk k (a tile of the row, from k = 1), and marches in i over a chunk of
// bi planes; the planes of u go by cp.async into a ring of kRing tile
// planes, each of the box's rows and k with one row and one k of halo on
// each side. The blocks are numbered k fastest, then j, then i. Every point
// of the block off the interior is written 0 by the same launch with no
// load: the planes outside the interior rows (zero_planes, grid-stride over
// every thread) and around each box its boundary rows, pad columns and k
// ends (zero_box). A rank without interior points launches blocks that
// write only zeros, kZeroPerThread a thread.
//
// The helpers take the launch's arguments as any struct A with the fields
// out, n, L, Lj, t0, t1, j0, j1, bi, bj, bk: each stage keeps its own
// struct (fields, partials), so that one stage's code is not another's.
#pragma once

#include "restrict.cuh"

namespace mg {
namespace stream {

using mg::restriction::imin;
using mg::restriction::round4;

constexpr int kMaxRows = 8;                 // rows a block owns at most, a warp each
constexpr int kMaxThreads = 32 * kMaxRows;  // the launch bound
constexpr int kMaxChunks = 8;               // 32-point chunks of a lane's row at most
constexpr int kRing = 3;                    // planes of each streamed field in a block's ring
constexpr int kZeroPerThread = 32;          // zeros a thread of a zeros-only launch writes

// Floats a tile row: the box's bk points and one k of halo on each side.
__host__ __device__ inline int tile_width(int bk) { return round4(bk + 2); }

// Shared-memory bytes of a block: a ring of kRing planes of bj + 2 rows for
// each of ``fields`` streamed fields (pallas_split._df_smem computes the
// same; the launchers reject a plan that differs).
inline long long smem_bytes(int bj, int bk, int fields) {
  return 4LL * fields * kRing * (bj + 2) * tile_width(bk);
}

// The interior rows [t0, t1) and columns [j0, j1) of the rank's block from
// the global row g0 and column gj0 of its body point (0, 0): those whose
// global index lies in [1, n - 2] (on Seg the j axis whole, [1, n - 1)).
template <class A>
inline void setup(A& a, int g0, int gj0, bool whole) {
  a.t0 = g0 < 1 ? 1 - g0 : 0;
  a.t1 = imin(a.L, a.n - 1 - g0);
  a.j0 = whole ? 1 : (gj0 < 1 ? 1 - gj0 : 0);
  a.j1 = whole ? a.n - 1 : imin(a.Lj, a.n - 1 - gj0);
  if (a.t1 <= a.t0 || a.j1 <= a.j0) a.t0 = a.t1 = a.j0 = a.j1 = 0;
}

// The blocks of a launch: the boxes over the interior, or for a rank
// without interior points kZeroPerThread zeros a thread
// (pallas_sharded.seg_df_parts computes the same).
template <class A>
inline int launch_blocks(const A& a, int threads) {
  if (a.t1 <= a.t0) {
    const long long points = (long long)a.L * a.Lj * a.n;
    const long long per = (long long)kZeroPerThread * threads;
    return (int)((points + per - 1) / per);
  }
  const int m = a.n - 2;
  return ((a.t1 - a.t0 + a.bi - 1) / a.bi) * ((a.j1 - a.j0 + a.bj - 1) / a.bj) *
         ((m + a.bk - 1) / a.bk);
}

// 0 when the kernels take the plan: a box inside the interior (any box
// for a rank without it) of at most kMaxRows rows, C the least power of 2
// chunks that cover bk, a warp a row, the shared memory the formula gives
// for ``fields`` rings.
template <class A>
inline int plan_error(const A& a, int chunks, int threads, int smem, int fields) {
  const int m = a.n - 2;
  const bool empty = a.t1 <= a.t0;
  int c = 1;
  while (32 * c < a.bk) c *= 2;
  if (a.bi < 1 || a.bj < 1 || a.bj > kMaxRows || a.bk < 1 || a.bk > m || c > kMaxChunks ||
      chunks != c || threads != 32 * a.bj || smem != smem_bytes(a.bj, a.bk, fields) ||
      (!empty && (a.bi > a.t1 - a.t0 || a.bj > a.j1 - a.j0)))
    return (int)cudaErrorInvalidValue;
  return 0;
}

// The rank's planes outside [t0, t1) (all where it has no interior),
// written 0, spread over every thread of the launch, consecutive points
// across a warp.
template <class A>
__device__ inline void zero_planes(const A& a) {
  const int P = a.Lj * a.n, head = a.t0 * P, skip = (a.t1 - a.t0) * P;
  const int count = head + (a.L - a.t1) * P, stride = gridDim.x * blockDim.x;
  for (int v = blockIdx.x * blockDim.x + threadIdx.x; v < count; v += stride)
    a.out[v < head ? v : v + skip] = 0.0f;
}

// The block's share of the zeros in its planes [ta, tb): the points of its
// box widened to the block's edge on each side that reaches the end of the
// interior (rows to 0 and Lj, k to 0 and n) that lie off the interior:
// whole rows off [j0, j1) (the boundary rows, the pad columns), else the k
// ends; a warp a row. Each such point is written once.
template <class A>
__device__ inline void zero_box(const A& a, int ta, int tb, int ja, int jb, int ka, int kb,
                                int warp, int lane, int nwarps) {
  const int n = a.n;
  const int jlo = ja == a.j0 ? 0 : ja, jhi = jb == a.j1 ? a.Lj : jb;
  const bool k_lo = ka == 1, k_hi = kb == n - 1;
  const int klo = k_lo ? 0 : ka, khi = k_hi ? n : kb, rows = jhi - jlo;
  for (int it = warp; it < (tb - ta) * rows; it += nwarps) {
    const int t = ta + it / rows, j = jlo + it % rows;
    float* o = a.out + (t * a.Lj + j) * n;
    if (j < a.j0 || j >= a.j1) {
      for (int k = klo + lane; k < khi; k += 32) o[k] = 0.0f;
    } else if (lane == 0) {
      if (k_lo) o[0] = 0.0f;
      if (k_hi) o[n - 1] = 0.0f;
    }
  }
}

}  // namespace stream
}  // namespace mg
