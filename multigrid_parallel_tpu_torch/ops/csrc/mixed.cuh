// Shared pieces of the mixed-BC (electrospray) kernels K13-K15
// (mixed_rb_smooth.cu, mixed_prolong_smooth.cu) on (n, n, n) contiguous
// f32 correction fields with a (2, n, n) f32 pin plane input: 1.0 at the
// Dirichlet patch nodes of the x = 0 (plane 0) and x = n-1 (plane 1)
// faces, 0.0 elsewhere. Every other boundary node is homogeneous Neumann.
//
// The boundary condition of the correction equation is the copy-BC pass
// of the JAX package (ops.stencils_3d.apply_neumann_copy, then the zero
// pin): face copies in x, then y, then z order, so a boundary node ends
// up holding u[c(i), c(j), c(k)], c mapping 0 -> 1, n-1 -> n-2 and every
// interior index to itself, or 0 at a pinned x-face node.
#pragma once

#include "stencil.cuh"

namespace mg {

__device__ inline bool pinned(const float* __restrict__ pin, int i, int j,
                              int k, int n) {
  if (i == 0) return pin[j * n + k] > 0.5f;
  if (i == n - 1) return pin[(n + j) * n + k] > 0.5f;
  return false;
}

// Sum of the six face neighbours of interior point (i, j, k) in nbr_sum's
// order, with the copy-BC folded in (the Pallas _mixed_rb_body): an
// interior stencil only reads boundary nodes with exactly one boundary
// coordinate, whose BC value is the adjacent interior value, i.e. the
// reader's own value, or 0 at a pinned x-face node. So the sweeps never
// read the stored boundary, and one BC pass per stage suffices; on
// BC-consistent input the iterates equal the copy form's (a half-sweep,
// then a BC pass) bit for bit. `at(i, j, k)` returns the field's value.
template <class At>
__device__ inline float mixed_nbr_sum(const At& at,
                                      const float* __restrict__ pin, int i,
                                      int j, int k, int n) {
  const float cen = at(i, j, k);
  const float im = i == 1 ? (pinned(pin, 0, j, k, n) ? 0.0f : cen) : at(i - 1, j, k);
  const float ip = i == n - 2 ? (pinned(pin, n - 1, j, k, n) ? 0.0f : cen) : at(i + 1, j, k);
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

// A plain field as an accessor of mixed_nbr_sum.
struct FieldAt {
  const float* u;
  int n;
  __device__ float operator()(int i, int j, int k) const {
    return u[(i * n + j) * n + k];
  }
};

}  // namespace mg
