// Shared pieces of the mixed-BC (electrospray) kernels: K13-K15
// (mixed_rb_smooth.cu, mixed_prolong_smooth.cu) on (n, n, n) contiguous
// f32 correction fields, K21-K25 on split pairs (msplit.cuh), and K18 and
// K20 (residual_restrict_fold.cu, residual_df_norm_fold.cu; K16, K17 and
// K19 run rect.cuh's fold stage) on the same fields in the FOLD layout:
// (n, n, n - 2), stored slot kk holding grid plane k = kk + 1. The fold
// stores no k face: the BC makes each k-face node a copy of its stored
// neighbour, so a folded read returns the reader's own value.
//
// The pin planes are 1.0 at the Dirichlet patch nodes of the x = 0 (plane
// 0) and x = n-1 (plane 1) faces, 0.0 elsewhere: (2, n, n), or (2, n,
// n - 2) in fold coordinates. Every other boundary node is homogeneous
// Neumann.
//
// The boundary condition of the correction equation is the copy-BC pass
// of the JAX package (ops.stencils_3d.apply_neumann_copy, then the zero
// pin): face copies in x, then y, then z order, so a boundary node ends
// up holding u[c(i), c(j), c(k)], c mapping 0 -> 1, n-1 -> n-2 and every
// interior index to itself, or 0 at a pinned x-face node.
#pragma once

#include "stencil.cuh"

namespace mg {

// The pin planes read at x face `face` (0: x = 0, 1: x = n-1), row j,
// grid plane k; column k - k0 of a plane of nk columns holds plane k.
struct PinAt {
  const float* pin;
  int n, nk, k0;
  __device__ bool operator()(int face, int j, int k) const {
    return pin[(face * n + j) * nk + k - k0] > 0.5f;
  }
};

__device__ inline PinAt full_pins(const float* pin, int n) { return {pin, n, n, 0}; }

__device__ inline bool pinned(const PinAt& pin, int i, int j, int k, int n) {
  if (i == 0) return pin(0, j, k);
  if (i == n - 1) return pin(1, j, k);
  return false;
}

// The copy-BC source index of a boundary coordinate.
__device__ inline int copy_source(int x, int n) {
  return x == 0 ? 1 : (x == n - 1 ? n - 2 : x);
}

// Sum of the six face neighbours of interior point (i, j, k) in nbr_sum's
// order, with the copy-BC folded in (the Pallas _mixed_rb_body): an
// interior stencil only reads boundary nodes with exactly one boundary
// coordinate, whose BC value is the adjacent interior value, i.e. the
// reader's own value, or 0 at a pinned x-face node. So the sweeps never
// read the stored boundary, and one BC pass per stage suffices; on
// BC-consistent input the iterates equal the copy form's (a half-sweep,
// then a BC pass) bit for bit. `at(i, j, k)` returns the field's value at
// grid point (i, j, k); k = 0 and k = n-1 are never read, so the same sum
// serves the fold layout and the split pairs (msplit.cuh). `pin(face, j,
// k)` is PinAt's test, or msplit.cuh's on the pairs' pin packs.
template <class At, class Pin>
__device__ inline float mixed_nbr_sum(const At& at, const Pin& pin, int i,
                                      int j, int k, int n) {
  const float cen = at(i, j, k);
  const float im = i == 1 ? (pin(0, j, k) ? 0.0f : cen) : at(i - 1, j, k);
  const float ip = i == n - 2 ? (pin(1, j, k) ? 0.0f : cen) : at(i + 1, j, k);
  const float jm = j == 1 ? cen : at(i, j - 1, k);
  const float jp = j == n - 2 ? cen : at(i, j + 1, k);
  const float km = k == 1 ? cen : at(i, j, k - 1);
  const float kp = k == n - 2 ? cen : at(i, j, k + 1);
  float s = im;
  s = s + ip;
  s = s + jm;
  s = s + jp;
  s = s + km;
  s = s + kp;
  return s;
}

// ------------------------------------------------------------ fold layout

// Stored points of an n-point fold field.
inline long long fold_points(int n) { return (long long)n * n * (n - 2); }

inline int fold_blocks(int n) {
  return (int)((fold_points(n) + kThreads - 1) / kThreads);
}

// Decode a flat fold index into grid coordinates (k = kk + 1); false when
// p is past the field.
__device__ inline bool decode_fold(int p, int n, int& i, int& j, int& k) {
  const int nk = n - 2, plane = n * nk;
  if (p >= n * plane) return false;
  i = p / plane;
  const int rem = p - i * plane;
  j = rem / nk;
  k = rem - j * nk + 1;
  return true;
}

// Interior in i and j (every stored k is interior).
__device__ inline bool is_interior_ij(int i, int j, int n) {
  return i >= 1 && i <= n - 2 && j >= 1 && j <= n - 2;
}

}  // namespace mg
