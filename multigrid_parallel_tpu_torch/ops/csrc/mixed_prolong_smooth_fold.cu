// Mixed-BC prolongation + correction and the first half-sweep of the
// black-first mixed stage on the fold layout (mixed.cuh), in one kernel
// that writes a fresh fine (n, n, n - 2) field from the coarse
// (nc, nc, nc - 2) correction ec.
//
// Replaces, with K16 launches for the rest of the stage, the Pallas kernel
// multigrid_parallel_tpu/ops/pallas_mixed_fold.py: mixed_prolong_smooth_fold
// (K19), K15 on the fold layout. The trilinear interpolation (mg::interp_at,
// j then k then i, as K15) reads coarse k faces that the fold does not
// store. Pallas folds their band weights onto the stored neighbour columns
// (slot 0 / nc-3) and adds a pin-priority fix through a second band: at
// an x-face node the BC pins AFTER the z copy, so where the pin differs
// between the k-face node and its stored neighbour, the true value is
//   stored + sgn * (the adjacent interior i plane's value),
// sgn = pin(stored column) - pin(k-face column) from the coarse level's
// fold_edge_sign_planes (2, nc, nc - 2), nonzero only at columns 0 and
// nc-3. This kernel rebuilds that value inside the coarse accessor
// instead (FoldCoarseAt): one expression v + sgn * nbr, exact on a
// BC-consistent ec (v is 0 or nbr where sgn is not 0), where Pallas sums
// the two bands' products in the compiler's order.
//
// This launch: red points and boundary points get the corrected value
// e + P ec (the boundary ones are overwritten by the stage's BC pass);
// black interior points get their first smoothed value
//   (mixed_nbr_sum(e + P ec) - h^2 r) * (1/6),
// each neighbour's corrected value recomputed from e and ec, as K15 does.
// The stage's other 2 * n_iter - 1 half-sweeps and its BC pass are K16's
// launches on the output.
//
// Bound: as K15, loads through L1/L2 (a black point recomputes six
// neighbours' interpolations, up to 8 coarse loads each, ~56 coarse index
// computations): the accessor's face tests on every one of them, and the
// warps that ran both paths, made the launch up to twice K15's, so the
// threads whose reads stay off the coarse k faces skip the tests and run
// in warps of their own (the kernel's index order). The device-memory
// floor is 12 B per stored fine point (e, r read, output written) plus
// the coarse field, the pin and the sign planes.
#include "mixed.cuh"

namespace {

// The coarse fold correction at grid point (i, j, k), 0 <= k <= nc-1.
struct FoldCoarseAt {
  const float* ec;
  const float* sgn;
  int nc;
  __device__ float operator()(int i, int j, int k) const {
    const int nk = nc - 2;
    const bool kface = k == 0 || k == nc - 1;
    const int kk = k == 0 ? 0 : (k == nc - 1 ? nk - 1 : k - 1);
    const float v = ec[(i * nc + j) * nk + kk];
    if (!kface || (i != 0 && i != nc - 1)) return v;
    const int face = i == 0 ? 0 : 1;
    const int nb = i == 0 ? 1 : nc - 2;
    return v + sgn[(face * nc + j) * nk + kk] * ec[(nb * nc + j) * nk + kk];
  }
};

// FoldCoarseAt away from the coarse k faces (1 <= k <= nc-2): the stored
// slot k - 1, without the face tests.
struct FoldCoarseInnerAt {
  const float* ec;
  int nc;
  __device__ float operator()(int i, int j, int k) const {
    return ec[(i * nc + j) * (nc - 2) + k - 1];
  }
};

template <class CoarseAt>
struct FoldCorrectedAt {
  const float* e;
  CoarseAt c;
  int n;
  __device__ float operator()(int i, int j, int k) const {
    return e[(i * n + j) * (n - 2) + k - 1] + mg::interp_at(c, i, j, k);
  }
};

template <class CoarseAt>
__device__ inline void prolong_correct_black(float* __restrict__ out, const CoarseAt& c,
                                             const float* __restrict__ e,
                                             const float* __restrict__ r,
                                             const float* __restrict__ pin, int n, float h2,
                                             int p, int i, int j, int k) {
  const FoldCorrectedAt<CoarseAt> at{e, c, n};
  if (!mg::is_interior_ij(i, j, n) || ((i + j + k) & 1) != 0) {  // 0 = BLACK
    out[p] = at(i, j, k);
    return;
  }
  const float nbr = mg::mixed_nbr_sum(at, mg::fold_pins(pin, n), i, j, k, n);
  out[p] = (nbr - h2 * r[p]) * (1.0f / 6.0f);
}

// Threads [0, n * n * m) take the stored points with 3 <= k <= n-4, m =
// n - 6 a row, k fastest: fine planes k - 1 .. k + 1 interpolate coarse
// planes 1 .. nc-2 only, so they read with the plain index. The others
// take the rest of each row (k = 1, 2, n-3, n-2; every k below n = 9,
// where m = 0) through FoldCoarseAt. Grouped so, the two paths share no
// warp but one: the k-edge threads of a row-major order would put one
// in every eighth warp.
__global__ void mixed_fold_prolong_correct_black_kernel(
    float* __restrict__ out, const float* __restrict__ ec,
    const float* __restrict__ e, const float* __restrict__ r,
    const float* __restrict__ pin, const float* __restrict__ sgn, int n,
    float h2, int m) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  const int nk = n - 2, rows = n * n, inner = rows * m;
  int row, k;
  if (t < inner) {
    row = t / m;
    k = 3 + (t - row * m);
  } else {
    const int ne = nk - m, q = t - inner;
    if (q >= rows * ne) return;
    row = q / ne;
    const int s = q - row * ne;
    k = (m == 0 || s < 2) ? 1 + s : n - 5 + s;
  }
  const int i = row / n, j = row - i * n, p = row * nk + k - 1;
  const int nc = (n + 1) / 2;
  if (t < inner) {
    prolong_correct_black(out, FoldCoarseInnerAt{ec, nc}, e, r, pin, n, h2, p, i, j, k);
  } else {
    prolong_correct_black(out, FoldCoarseAt{ec, sgn, nc}, e, r, pin, n, h2, p, i, j, k);
  }
}

}  // namespace

// out <- e + P ec on red and boundary points, the first black mixed
// half-sweep of that field on black interior points, all in the fold
// layout. out must not alias e.
extern "C" int mg_mixed_fold_prolong_correct_black(float* out, const float* ec,
                                                   const float* e, const float* r,
                                                   const float* pin, const float* sgn,
                                                   int n, float h2, cudaStream_t stream) {
  mixed_fold_prolong_correct_black_kernel<<<mg::fold_blocks(n), mg::kThreads, 0,
                                            stream>>>(out, ec, e, r, pin, sgn, n, h2,
                                                      n >= 9 ? n - 6 : 0);
  return (int)cudaGetLastError();
}
