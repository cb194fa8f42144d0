// Red-black Gauss-Seidel half-sweep on an (n, n, n) f32 field.
//
// Replaces the Pallas kernels multigrid_parallel_tpu/ops/pallas3d.py:
// rb_smooth_fused_pipelined (K1) and rb_smooth_from_zero_fused (K2).
// Those run all 2 * n_iter half-sweeps of a smoothing stage in one pass
// over HBM (trapezoidal halo in VMEM). This first Hopper form runs one
// launch per half-sweep, which is race-free in place because a colour
// reads only the other colour:
//   u <- (sum6(u) - h^2 f) * (1/6)   on interior points of `color`.
//
// Bound: device-memory bytes. One half-sweep reads u's neighbours and f
// and writes the active half of u, at least 4 + 4 + 2 = 10 bytes per
// point (every 32-byte sector of u and f is touched, though only half of
// f is used), so a stage of 2 * n_iter half-sweeps moves ~10 * 2 * n_iter
// bytes per point where the fused Pallas stage moves 12. The simple design
// takes that 3.3x (n_iter = 2) in exchange for no halo logic: one thread
// per point, k fastest, so the six neighbour loads of a warp are
// coalesced rows that the i +- 1 and j +- 1 rows of later blocks find in
// L2. Temporal blocking in shared memory is the follow-up.
//
// K2's first half-sweep reads only f (the initial guess is an implicit
// zero) and writes every point of the output, so the output tensor
// needs no initialisation.
#include "stencil.cuh"

namespace {

__global__ void rb_half_sweep_kernel(float* __restrict__ u,
                                     const float* __restrict__ f, int n,
                                     float h2, int color) {
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  int i, j, k;
  if (!mg::decode(p, n, i, j, k)) return;
  if (!mg::is_interior(i, j, k, n) || ((i + j + k) & 1) != color) return;
  const float nbr = mg::nbr_sum(u, p, n);
  u[p] = (nbr - h2 * f[p]) * (1.0f / 6.0f);
}

__global__ void rb_half_sweep_from_zero_kernel(float* __restrict__ out,
                                               const float* __restrict__ f,
                                               int n, float h2, int color) {
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  int i, j, k;
  if (!mg::decode(p, n, i, j, k)) return;
  float v = 0.0f;
  if (mg::is_interior(i, j, k, n) && ((i + j + k) & 1) == color) {
    const float nbr = 0.0f;  // six zero neighbours, summed: +0
    v = (nbr - h2 * f[p]) * (1.0f / 6.0f);
  }
  out[p] = v;
}

}  // namespace

// One in-place half-sweep of `color` (1 = RED = (i+j+k) odd, 0 = BLACK).
extern "C" int mg_rb_half_sweep(float* u, const float* f, int n, float h2,
                                int color, cudaStream_t stream) {
  rb_half_sweep_kernel<<<mg::point_blocks(n), mg::kThreads, 0, stream>>>(
      u, f, n, h2, color);
  return (int)cudaGetLastError();
}

// First half-sweep from a zero initial guess: writes all of `out`.
extern "C" int mg_rb_half_sweep_from_zero(float* out, const float* f, int n,
                                          float h2, int color,
                                          cudaStream_t stream) {
  rb_half_sweep_from_zero_kernel<<<mg::point_blocks(n), mg::kThreads, 0,
                                   stream>>>(out, f, n, h2, color);
  return (int)cudaGetLastError();
}
