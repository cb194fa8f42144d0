// Mixed-BC red-black Gauss-Seidel half-sweep and the BC pass that ends a
// smoothing stage, on an (n, n, n) f32 correction field.
//
// Replaces the Pallas kernels multigrid_parallel_tpu/ops/pallas_mixed.py:
// mixed_rb_smooth_fused (K13) and mixed_rb_smooth_from_zero_fused (K14).
// Those run all 2 * n_iter half-sweeps of a stage in one pass over HBM
// with the copy-BC folded into the stencil (mixed.cuh), then one BC pass.
// This first Hopper form runs one launch per half-sweep, in place (a
// colour reads only the other colour and itself):
//   u <- (mixed_nbr_sum(u) - h^2 r) * (1/6)   on interior points of `color`,
// then one BC-pass launch with one thread per boundary node, each written
// once: out = u[c(i), c(j), c(k)], or 0 at a pinned x-face node. The pass
// reads only interior nodes and writes only boundary ones, so it runs in
// place too. K14's first half-sweep is K2's from-zero launch
// (mg_rb_half_sweep_from_zero): from a zero field the folded reads are
// zero as well, so the update is the same.
//
// Bound: device-memory bytes, as K1: a half-sweep reads u's neighbours and
// r and writes the active half of u, ~10 B per point; the BC pass touches
// ~6 n^2 boundary nodes and the rows next to them. A stage of n_iter = 2
// moves ~40 B per point where the fused Pallas stage moves 12 (e, r read,
// e written); temporal blocking is the follow-up, as for K1.
#include "mixed.cuh"

namespace {

__global__ void mixed_half_sweep_kernel(float* __restrict__ u,
                                        const float* __restrict__ r,
                                        const float* __restrict__ pin, int n,
                                        float h2, int color) {
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  int i, j, k;
  if (!mg::decode(p, n, i, j, k)) return;
  if (!mg::is_interior(i, j, k, n) || ((i + j + k) & 1) != color) return;
  const float nbr = mg::mixed_nbr_sum(mg::FieldAt{u, n}, mg::full_pins(pin, n), i, j, k, n);
  u[p] = (nbr - h2 * r[p]) * (1.0f / 6.0f);
}

// Boundary nodes of an n^3 cube, n^3 - (n-2)^3 of them, numbered: the
// two x faces whole, then the two y faces without x-face nodes, then the
// two z faces of the remaining interior rows.
__device__ inline bool decode_boundary(int q, int n, int& i, int& j, int& k) {
  const int m = n - 2;
  const int x_face = n * n, y_face = m * n, z_face = m * m;
  if (q < 2 * x_face) {
    i = q < x_face ? 0 : n - 1;
    const int rem = q % x_face;
    j = rem / n;
    k = rem % n;
    return true;
  }
  q -= 2 * x_face;
  if (q < 2 * y_face) {
    j = q < y_face ? 0 : n - 1;
    const int rem = q % y_face;
    i = 1 + rem / n;
    k = rem % n;
    return true;
  }
  q -= 2 * y_face;
  if (q < 2 * z_face) {
    k = q < z_face ? 0 : n - 1;
    const int rem = q % z_face;
    i = 1 + rem / m;
    j = 1 + rem % m;
    return true;
  }
  return false;
}

__global__ void mixed_bc_pass_kernel(float* __restrict__ u,
                                     const float* __restrict__ pin, int n) {
  const int q = blockIdx.x * blockDim.x + threadIdx.x;
  int i, j, k;
  if (!decode_boundary(q, n, i, j, k)) return;
  const int p = (i * n + j) * n + k;
  u[p] = mg::pinned(mg::full_pins(pin, n), i, j, k, n)
             ? 0.0f
             : u[(mg::copy_source(i, n) * n + mg::copy_source(j, n)) * n +
                 mg::copy_source(k, n)];
}

}  // namespace

// One in-place mixed half-sweep of `color` (1 = RED = (i+j+k) odd).
extern "C" int mg_mixed_half_sweep(float* u, const float* r, const float* pin,
                                   int n, float h2, int color,
                                   cudaStream_t stream) {
  mixed_half_sweep_kernel<<<mg::point_blocks(n), mg::kThreads, 0, stream>>>(
      u, r, pin, n, h2, color);
  return (int)cudaGetLastError();
}

// The BC pass, in place: Neumann copies (x, y, z order) and the zero pin.
extern "C" int mg_mixed_bc_pass(float* u, const float* pin, int n,
                                cudaStream_t stream) {
  const long long m = n - 2;
  const long long count = (long long)n * n * n - m * m * m;
  const int blocks = (int)((count + mg::kThreads - 1) / mg::kThreads);
  mixed_bc_pass_kernel<<<blocks, mg::kThreads, 0, stream>>>(u, pin, n);
  return (int)cudaGetLastError();
}
