// A segmented block: one rank's rows of an i-sharded field, its halo
// planes from the neighbours beside them, read as one field of rows
// [-kl, L + kr), shared by the sharded kernels K28-K33.
//
// The JAX package hands its sharded kernels either an extended copy
// (L + 2 halo planes, multigrid_parallel_tpu/ops/pallas_sharded.py *_ext)
// or the local block plus two small halo buffers that the kernel stitches
// with three DMAs (*_halo). Here both are one descriptor of three
// pointers: an ext tensor is passed as three contiguous views of its one
// buffer (no copy), a halo triple as its three tensors. Row t maps to
//   t <  0:      lh   + (t + kl) planes
//   0 <= t < L:  body + t planes
//   t >= L:      rh   + (t - L + r_off) planes
// where r_off skips the local tail planes of a composite right buffer
// (the JAX _halo_parts(tail_local) layout; 0 for a plain halo).
//
// Masks and colours use GLOBAL plane indices g = g0 + t (g0 = the global
// index of body row 0, negative halo rows on rank 0 included): interior
// is 1 <= g <= n - 2, RED is (g + j + k) odd. Pad planes (g >= n) and
// whole pad ranks are never updated.
#pragma once

#include "stencil.cuh"

namespace mg {

struct Seg {
  float* lh;
  float* body;
  float* rh;
  int kl, L, kr, r_off;
  int nn;  // points per plane

  __device__ float* row(int t) const {
    if (t < 0) return lh + (t + kl) * nn;
    if (t < L) return body + t * nn;
    return rh + (t - L + r_off) * nn;
  }
};

inline Seg make_seg(float* lh, float* body, float* rh, int kl, int L, int kr, int r_off,
                    int nn) {
  return Seg{lh, body, rh, kl, L, kr, r_off, nn};
}

inline int seg_blocks(int rows, int nn) {
  long long total = (long long)rows * nn;
  return (int)((total + kThreads - 1) / kThreads);
}

// Decode a flat point index over `rows` rows starting at local row t0;
// false when p is past them. jk = j * n + k.
__device__ inline bool decode_seg(int p, int rows, int t0, int n, int& t, int& j, int& k,
                                  int& jk) {
  const int nn = n * n;
  if (p >= rows * nn) return false;
  const int q = p / nn;
  t = t0 + q;
  jk = p - q * nn;
  j = jk / n;
  k = jk - j * n;
  return true;
}

// stencil.cuh's nbr_sum across segment rows, in its order:
// (t-1) + (t+1) + (j-1) + (j+1) + (k-1) + (k+1); interior points only.
__device__ inline float seg_nbr_sum(const Seg& u, int t, int jk, int n) {
  const float* ut = u.row(t);
  float s = u.row(t - 1)[jk];
  s = s + u.row(t + 1)[jk];
  s = s + ut[jk - n];
  s = s + ut[jk + n];
  s = s + ut[jk - 1];
  s = s + ut[jk + 1];
  return s;
}

// The six face neighbours in nbr_sum order (eft.cuh's load_nbrs).
__device__ inline void seg_load_nbrs(const Seg& u, int t, int jk, int n, float (&v)[6]) {
  const float* ut = u.row(t);
  v[0] = u.row(t - 1)[jk];
  v[1] = u.row(t + 1)[jk];
  v[2] = ut[jk - n];
  v[3] = ut[jk + n];
  v[4] = ut[jk - 1];
  v[5] = ut[jk + 1];
}

// A coarse segment read at GLOBAL coarse plane ci (interp_at's accessor):
// cg0 is the global index of its body row 0.
struct SegAt {
  Seg c;
  int cg0, nc;
  __device__ float operator()(int ci, int cj, int ck) const {
    return c.row(ci - cg0)[cj * nc + ck];
  }
};

}  // namespace mg
