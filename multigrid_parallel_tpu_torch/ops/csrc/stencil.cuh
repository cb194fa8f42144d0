// Shared pieces of the 7-point stencil kernels on (n, n, n) contiguous
// f32 fields, index p = (i * n + j) * n + k, and of the trilinear
// prolongation.
//
// Built with --fmad=false and without --use_fast_math: every expression
// below must round exactly as its plain PyTorch version (and as the
// Pallas kernel it replaces) does, one IEEE f32 operation at a time, and
// the two-sum chains of the EFT residual are only exact without
// contraction or reassociation. Every literal is f-suffixed so that no
// update is silently promoted to f64.
#pragma once

#include <cuda_runtime.h>

namespace mg {

// threads per block of every point-parallel kernel
constexpr int kThreads = 256;

// Whether the floats [p, p + count) and [q, q + qcount) meet (the
// launchers' check that an output meets no input).
inline bool meet(const float* p, long long count, const float* q, long long qcount) {
  return q != nullptr && qcount > 0 && p < q + qcount && q < p + count;
}

inline int point_blocks(int n) {
  long long total = (long long)n * n * n;
  return (int)((total + kThreads - 1) / kThreads);
}

// Decode a flat point index; false when p is past the field.
__device__ inline bool decode(int p, int n, int& i, int& j, int& k) {
  const int nn = n * n;
  if (p >= nn * n) return false;
  i = p / nn;
  const int rem = p - i * nn;
  j = rem / n;
  k = rem - j * n;
  return true;
}

__device__ inline bool is_interior(int i, int j, int k, int n) {
  return i >= 1 && i <= n - 2 && j >= 1 && j <= n - 2 && k >= 1 && k <= n - 2;
}

// Sum of the six face neighbours in the reference's addition order
// (i-1)+(i+1)+(j-1)+(j+1)+(k-1)+(k+1) (mg_3d.h:439-441); interior p only.
__device__ inline float nbr_sum(const float* u, int p, int n) {
  const int nn = n * n;
  float s = u[p - nn];
  s = s + u[p + nn];
  s = s + u[p - n];
  s = s + u[p + n];
  s = s + u[p - 1];
  s = s + u[p + 1];
  return s;
}

// A plain (n, n, n) field read at grid point (i, j, k).
struct FieldAt {
  const float* u;
  int n;
  __device__ float operator()(int i, int j, int k) const {
    return u[(i * n + j) * n + k];
  }
};

// Trilinear prolongation (P ec) at fine point (fi, fj, fk) of a coarse
// field of (n + 1) / 2 points a side, read through `c(ci, cj, ck)`: j,
// then k, then i, as the Pallas kernels' MXU bands and i interleave do.
// An even fine index copies the coincident coarse value, an odd one is
// 0.5 a + 0.5 b of its two coarse neighbours; every step has at most two
// non-zero taps with exact 0.5 scalings, so it rounds once whatever the
// order of the sum. Coarse boundary values take part (zero for Dirichlet
// corrections, live for the mixed-BC ones). Used by K4, K15 and K19.
template <class CoarseAt>
__device__ inline float interp_at(const CoarseAt& c, int fi, int fj, int fk) {
  const int ci0 = fi >> 1, cj0 = fj >> 1, ck0 = fk >> 1;
  const bool oi = fi & 1, oj = fj & 1, ok = fk & 1;
  float y2[2];
#pragma unroll
  for (int a = 0; a < 2; ++a) {
    if (a == 1 && !oi) break;
    float y1[2];
#pragma unroll
    for (int b = 0; b < 2; ++b) {
      if (b == 1 && !ok) break;
      const int ci = ci0 + a, ck = ck0 + b;
      y1[b] = oj ? 0.5f * c(ci, cj0, ck) + 0.5f * c(ci, cj0 + 1, ck) : c(ci, cj0, ck);
    }
    y2[a] = ok ? 0.5f * y1[0] + 0.5f * y1[1] : y1[0];
  }
  return oi ? 0.5f * y2[0] + 0.5f * y2[1] : y2[0];
}

// interp_at of the plain coarse (nc, nc, nc) field ec.
__device__ inline float interp(const float* __restrict__ ec, int nc, int fi,
                               int fj, int fk) {
  return interp_at(FieldAt{ec, nc}, fi, fj, fk);
}

}  // namespace mg
