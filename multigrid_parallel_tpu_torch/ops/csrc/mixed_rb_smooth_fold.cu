// Mixed-BC red-black Gauss-Seidel half-sweep and the BC pass that ends a
// smoothing stage, on an (n, n, n - 2) f32 correction field in the fold
// layout (mixed.cuh: stored slot kk holds grid plane k = kk + 1).
//
// Replaces the Pallas kernels multigrid_parallel_tpu/ops/pallas_mixed_fold.py:
// mixed_rb_smooth_fold (K16) and mixed_rb_smooth_from_zero_fold (K17).
// Those run all 2 * n_iter half-sweeps of a stage in one pass over HBM
// with the copy-BC folded into the stencil, then one BC pass without z
// faces. This first Hopper form is K13's, one launch per half-sweep, in
// place:
//   u <- (mixed_nbr_sum(u) - h^2 r) * (1/6)   on interior points of `color`,
// with (i + j + k) & 1 the colour of grid plane k = kk + 1. The k-edge
// reads at kk = 0 and n-3 fold to the reader's own value, as K13's do at
// k = 1 and n-2, so the iterates equal K13's on every stored node. Then
// one BC-pass launch, a gather with one thread per stored boundary node:
// the two x faces whole and the two y faces without their x-face rows,
// out = u[c(i), c(j), kk], or 0 at a pinned x-face node. There are no z
// faces, the nodes K13's pass reaches one per row (a strided store each).
// K17's first half-sweep writes every stored point from an implicit zero
// field (the folded reads of zero are zero), so its output needs no
// initialisation.
//
// Bound: device-memory bytes, as K13: ~10 B per stored point per
// half-sweep (u's neighbours and r read, the active half of u written);
// the BC pass touches ~4 n (n - 2) boundary nodes and the rows next to
// them. The fold stores (n - 2) / n of K13's points: 2/n fewer bytes.
#include "mixed.cuh"

namespace {

template <bool FromZero>
__global__ void mixed_fold_half_sweep_kernel(float* __restrict__ u,
                                             const float* __restrict__ r,
                                             const float* __restrict__ pin,
                                             int n, float h2, int color) {
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  int i, j, k;
  if (!mg::decode_fold(p, n, i, j, k)) return;
  const bool active = mg::is_interior_ij(i, j, n) && ((i + j + k) & 1) == color;
  if constexpr (FromZero) {
    float v = 0.0f;
    if (active) {
      const float nbr = 0.0f;  // six zero neighbours, summed: +0
      v = (nbr - h2 * r[p]) * (1.0f / 6.0f);
    }
    u[p] = v;
    return;
  }
  if (!active) return;
  const float nbr = mg::mixed_nbr_sum(mg::FoldAt{u, n}, mg::fold_pins(pin, n), i, j, k, n);
  u[p] = (nbr - h2 * r[p]) * (1.0f / 6.0f);
}

// Stored boundary nodes of an n-point fold field, 2 n (n-2) + 2 (n-2)^2 of
// them, numbered: the two x faces whole, then the two y faces without
// their x-face rows. kk is the stored slot.
__device__ inline bool decode_fold_boundary(int q, int n, int& i, int& j, int& kk) {
  const int nk = n - 2;
  const int x_face = n * nk, y_face = (n - 2) * nk;
  if (q < 2 * x_face) {
    i = q < x_face ? 0 : n - 1;
    const int rem = q % x_face;
    j = rem / nk;
    kk = rem % nk;
    return true;
  }
  q -= 2 * x_face;
  if (q < 2 * y_face) {
    j = q < y_face ? 0 : n - 1;
    const int rem = q % y_face;
    i = 1 + rem / nk;
    kk = rem % nk;
    return true;
  }
  return false;
}

__global__ void mixed_fold_bc_pass_kernel(float* __restrict__ u,
                                          const float* __restrict__ pin, int n) {
  const int q = blockIdx.x * blockDim.x + threadIdx.x;
  int i, j, kk;
  if (!decode_fold_boundary(q, n, i, j, kk)) return;
  const int nk = n - 2;
  u[(i * n + j) * nk + kk] =
      mg::pinned(mg::fold_pins(pin, n), i, j, kk + 1, n)
          ? 0.0f
          : u[(mg::copy_source(i, n) * n + mg::copy_source(j, n)) * nk + kk];
}

}  // namespace

// One in-place mixed fold half-sweep of `color` (1 = RED = (i+j+k) odd).
extern "C" int mg_mixed_fold_half_sweep(float* u, const float* r, const float* pin,
                                        int n, float h2, int color,
                                        cudaStream_t stream) {
  mixed_fold_half_sweep_kernel<false><<<mg::fold_blocks(n), mg::kThreads, 0, stream>>>(
      u, r, pin, n, h2, color);
  return (int)cudaGetLastError();
}

// First half-sweep from a zero initial guess: writes all of `out`.
extern "C" int mg_mixed_fold_half_sweep_from_zero(float* out, const float* r, int n,
                                                  float h2, int color,
                                                  cudaStream_t stream) {
  mixed_fold_half_sweep_kernel<true><<<mg::fold_blocks(n), mg::kThreads, 0, stream>>>(
      out, r, nullptr, n, h2, color);
  return (int)cudaGetLastError();
}

// The fold BC pass, in place: x and y Neumann copies and the zero pin.
extern "C" int mg_mixed_fold_bc_pass(float* u, const float* pin, int n,
                                     cudaStream_t stream) {
  const long long count = 2LL * n * (n - 2) + 2LL * (n - 2) * (n - 2);
  const int blocks = (int)((count + mg::kThreads - 1) / mg::kThreads);
  mixed_fold_bc_pass_kernel<<<blocks, mg::kThreads, 0, stream>>>(u, pin, n);
  return (int)cudaGetLastError();
}
