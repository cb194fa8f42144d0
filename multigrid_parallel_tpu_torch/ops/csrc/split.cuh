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

}  // namespace split
}  // namespace mg
