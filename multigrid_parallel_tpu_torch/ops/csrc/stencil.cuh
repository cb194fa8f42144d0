// Shared pieces of the 7-point stencil kernels on (n, n, n) contiguous
// f32 fields, index p = (i * n + j) * n + k.
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

}  // namespace mg
