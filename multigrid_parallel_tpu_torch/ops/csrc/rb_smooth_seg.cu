// Red-black Gauss-Seidel half-sweeps on one rank's segmented block (K28,
// and K37 on an (i, j) block) and the from-zero first half-sweep (K29,
// K38).
//
// Replace the Pallas kernels multigrid_parallel_tpu/ops/pallas_sharded.py:
// rb_smooth_ext / rb_smooth_halo (K28) and rb_smooth_from_zero_ext /
// rb_smooth_from_zero_halo (K29), which run all 2 * n_iter half-sweeps of
// a smoothing stage on a block with a 2 * n_iter plane halo in one pass
// (trapezoidal recompute in VMEM), and their (i, j) twins of
// pallas_sharded2d.py: rb_smooth_ext2d / rb_smooth_halo2d (K37) and
// rb_smooth_from_zero_ext2d / rb_smooth_from_zero_halo2d (K38), the same
// stage on a block with that halo in i and in j. K28 and K37 at n_iter <=
// 2 are one launch of K1's one-pass stage, K29 and K38 of K2's
// (rb_smooth_seg_stage.cu); this is their first form, which every stage
// past n_iter 2 still runs (and K35's past n_iter 2 its from-zero head):
// one launch per half-sweep over local rows [-kl + 1, L + kr - 2] (and, on
// an (i, j) block, columns [-hjl + 1, Lj + hjr - 2]), in place on a
// segment of the wrapper's own (a copy of u's, or K29's and K38's fresh
// output), so writing its halo rows and columns is safe. A half-sweep is
// Jacobi within a colour, so a stale halo row or column spoils one more per
// half-sweep; a halo as deep as the number of half-sweeps leaves every
// owned point exactly what the single-device K1 computes on the whole
// field, bit for bit (same neighbour order, global colours and masks,
// --fmad=false). The corner points of an (i, j) stage read
// diagonal-neighbour values: they come in the j-extended i-halo rows
// (seg2d.cuh).
//
// K29's (K38's) first half-sweep reads only f (the initial guess is an
// implicit zero) and writes every point of the output segment: the body
// and one scratch buffer per halo side.
//
// Bound: device-memory bytes, as K1: ~10 bytes per point and half-sweep
// over the halo-extended block; the halo rows and columns are the
// recompute the TPU kernel also pays.
#include "seg2d.cuh"

namespace {

template <class S>
__global__ void seg_half_sweep_kernel(S u, S f, mg::Span sp, int n, int g0, int gj0, float h2,
                                      int color) {
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  int t, j, k;
  if (!mg::decode_span(p, sp, n, t, j, k)) return;
  const int g = g0 + t, gj = gj0 + j;
  if (!mg::is_interior(g, gj, k, n) || ((g + gj + k) & 1) != color) return;
  const float nbr = mg::nbr_sum_at(u, t, j, k, n);
  mg::seg_at(u, t, j, n)[k] = (nbr - h2 * mg::seg_at(f, t, j, n)[k]) * (1.0f / 6.0f);
}

template <class S>
__global__ void seg_half_sweep_from_zero_kernel(S out, S f, mg::Span sp, int n, int g0, int gj0,
                                                float h2, int color) {
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  int t, j, k;
  if (!mg::decode_span(p, sp, n, t, j, k)) return;
  const int g = g0 + t, gj = gj0 + j;
  float v = 0.0f;
  if (mg::is_interior(g, gj, k, n) && ((g + gj + k) & 1) == color) {
    const float nbr = 0.0f;  // six zero neighbours, summed: +0
    v = (nbr - h2 * mg::seg_at(f, t, j, n)[k]) * (1.0f / 6.0f);
  }
  mg::seg_at(out, t, j, n)[k] = v;
}

template <class S>
int launch_half_sweep(const S& u, const S& f, const mg::Span& sp, int n, int g0, int gj0,
                      float h2, int color, cudaStream_t stream) {
  seg_half_sweep_kernel<<<mg::span_blocks(sp, n), mg::kThreads, 0, stream>>>(u, f, sp, n, g0,
                                                                             gj0, h2, color);
  return (int)cudaGetLastError();
}

template <class S>
int launch_half_sweep_from_zero(const S& out, const S& f, const mg::Span& sp, int n, int g0,
                                int gj0, float h2, int color, cudaStream_t stream) {
  seg_half_sweep_from_zero_kernel<<<mg::span_blocks(sp, n), mg::kThreads, 0, stream>>>(
      out, f, sp, n, g0, gj0, h2, color);
  return (int)cudaGetLastError();
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
  return launch_half_sweep(u, f, mg::Span{-kl + 1, L + kl + kr - 2, 0, n}, n, g0, 0, h2, color,
                           stream);
}

// The from-zero first half-sweep: writes every row [-kl, L + kr) of out.
extern "C" int mg_seg_half_sweep_from_zero(float* o_lh, float* o_body, float* o_rh,
                                           float* f_lh, float* f_body, float* f_rh,
                                           int f_roff, int kl, int L, int kr, int n, int g0,
                                           float h2, int color, cudaStream_t stream) {
  const int nn = n * n;
  const mg::Seg out = mg::make_seg(o_lh, o_body, o_rh, kl, L, kr, 0, nn);
  const mg::Seg f = mg::make_seg(f_lh, f_body, f_rh, kl, L, kr, f_roff, nn);
  return launch_half_sweep_from_zero(out, f, mg::Span{-kl, L + kl + kr, 0, n}, n, g0, 0, h2,
                                     color, stream);
}

// K37: one in-place half-sweep over rows [-H + 1, L + H - 2] x columns
// [-H + 1, Lj + H - 2] of the (i, j) segment u (descriptor, seg2d.cuh),
// RHS f; (g0, gj0) = global indices of body row and column 0.
extern "C" int mg_seg2d_half_sweep(const long long* u_desc, const long long* f_desc, int H,
                                   int L, int Lj, int n, int g0, int gj0, float h2, int color,
                                   cudaStream_t stream) {
  return launch_half_sweep(mg::seg2_from_desc(u_desc, L, Lj), mg::seg2_from_desc(f_desc, L, Lj),
                           mg::Span{-H + 1, L + 2 * H - 2, -H + 1, Lj + 2 * H - 2}, n, g0, gj0,
                           h2, color, stream);
}

// K38's first launch: writes every point of rows [-H, L + H) x columns
// [-H, Lj + H) of out.
extern "C" int mg_seg2d_half_sweep_from_zero(const long long* o_desc, const long long* f_desc,
                                             int H, int L, int Lj, int n, int g0, int gj0,
                                             float h2, int color, cudaStream_t stream) {
  return launch_half_sweep_from_zero(mg::seg2_from_desc(o_desc, L, Lj),
                                     mg::seg2_from_desc(f_desc, L, Lj),
                                     mg::Span{-H, L + 2 * H, -H, Lj + 2 * H}, n, g0, gj0, h2,
                                     color, stream);
}
