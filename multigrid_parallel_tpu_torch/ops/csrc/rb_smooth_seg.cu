// Red-black Gauss-Seidel half-sweeps on one rank's segmented block (K28)
// and the from-zero first half-sweep (K29).
//
// Replace the Pallas kernels multigrid_parallel_tpu/ops/pallas_sharded.py:
// rb_smooth_ext / rb_smooth_halo (K28) and rb_smooth_from_zero_ext /
// rb_smooth_from_zero_halo (K29), which run all 2 * n_iter half-sweeps of
// a smoothing stage on a block with a 2 * n_iter plane halo in one pass
// (trapezoidal recompute in VMEM). Here, as for K1/K2, one launch per
// half-sweep over local rows [-kl + 1, L + kr - 2], in place: the halo
// rows are the rank's own receive buffers (or its own ext copy), so
// writing them is safe. A half-sweep is Jacobi within a colour, so a stale
// halo row spoils one more row per half-sweep; a halo as deep as the
// number of half-sweeps leaves every owned row exactly what the
// single-device K1 computes on the whole field, bit for bit (same
// neighbour order, global colours and masks, --fmad=false).
//
// K29's first half-sweep reads only f (the initial guess is an implicit
// zero) and writes every row [-kl, L + kr) of the output segment: the
// body and one scratch buffer per halo side.
//
// Bound: device-memory bytes, as K1: ~10 bytes per point and half-sweep
// over L + kl + kr rows; the halo rows are the recompute the TPU kernel
// also pays.
#include "seg.cuh"

namespace {

__global__ void seg_half_sweep_kernel(mg::Seg u, mg::Seg f, int n, int g0, float h2,
                                      int color, int t0, int rows) {
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  int t, j, k, jk;
  if (!mg::decode_seg(p, rows, t0, n, t, j, k, jk)) return;
  const int g = g0 + t;
  if (!mg::is_interior(g, j, k, n) || ((g + j + k) & 1) != color) return;
  const float nbr = mg::seg_nbr_sum(u, t, jk, n);
  u.row(t)[jk] = (nbr - h2 * f.row(t)[jk]) * (1.0f / 6.0f);
}

__global__ void seg_half_sweep_from_zero_kernel(mg::Seg out, mg::Seg f, int n, int g0,
                                                float h2, int color, int t0, int rows) {
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  int t, j, k, jk;
  if (!mg::decode_seg(p, rows, t0, n, t, j, k, jk)) return;
  const int g = g0 + t;
  float v = 0.0f;
  if (mg::is_interior(g, j, k, n) && ((g + j + k) & 1) == color) {
    const float nbr = 0.0f;  // six zero neighbours, summed: +0
    v = (nbr - h2 * f.row(t)[jk]) * (1.0f / 6.0f);
  }
  out.row(t)[jk] = v;
}

}  // namespace

// One in-place half-sweep of `color` (1 = RED) over local rows
// [-kl + 1, L + kr - 2] of the segment u, RHS segment f (same rows).
extern "C" int mg_seg_half_sweep(float* u_lh, float* u_body, float* u_rh, int u_roff,
                                 float* f_lh, float* f_body, float* f_rh, int f_roff,
                                 int kl, int L, int kr, int n, int g0, float h2, int color,
                                 cudaStream_t stream) {
  const int nn = n * n;
  const mg::Seg u = mg::make_seg(u_lh, u_body, u_rh, kl, L, kr, u_roff, nn);
  const mg::Seg f = mg::make_seg(f_lh, f_body, f_rh, kl, L, kr, f_roff, nn);
  const int rows = L + kl + kr - 2;
  seg_half_sweep_kernel<<<mg::seg_blocks(rows, nn), mg::kThreads, 0, stream>>>(
      u, f, n, g0, h2, color, -kl + 1, rows);
  return (int)cudaGetLastError();
}

// The from-zero first half-sweep: writes every row [-kl, L + kr) of out.
extern "C" int mg_seg_half_sweep_from_zero(float* o_lh, float* o_body, float* o_rh,
                                           float* f_lh, float* f_body, float* f_rh,
                                           int f_roff, int kl, int L, int kr, int n, int g0,
                                           float h2, int color, cudaStream_t stream) {
  const int nn = n * n;
  const mg::Seg out = mg::make_seg(o_lh, o_body, o_rh, kl, L, kr, 0, nn);
  const mg::Seg f = mg::make_seg(f_lh, f_body, f_rh, kl, L, kr, f_roff, nn);
  const int rows = L + kl + kr;
  seg_half_sweep_from_zero_kernel<<<mg::seg_blocks(rows, nn), mg::kThreads, 0, stream>>>(
      out, f, n, g0, h2, color, -kl, rows);
  return (int)cudaGetLastError();
}
