// Mixed-BC red-black Gauss-Seidel half-sweep (K34, and K35 after its
// from-zero first launch) and the BC pass that ends a smoothing stage, on
// one rank's segmented block of an i-sharded correction field.
//
// Replace the Pallas kernels multigrid_parallel_tpu/ops/pallas_mixed.py:
// mixed_rb_smooth_ext / mixed_rb_smooth_halo (K34) and
// mixed_rb_smooth_from_zero_ext / mixed_rb_smooth_from_zero_halo (K35),
// which run all 2 * n_iter half-sweeps of a stage, copy-BC folded
// (mixed.cuh), and one BC pass on a block with a 2 * n_iter plane halo in
// one pass. Here, as for K13 and K28, one launch per half-sweep over local
// rows [-kl + 1, L + kr - 2], in place on the rank's own segment, then one
// BC-pass launch over the body rows. The segment is read at GLOBAL plane
// i = g0 + t (mg::SegFieldAt), so mixed.cuh's folded neighbour sum and pin
// selects serve it unchanged: the neighbour order, the global colour (RED =
// (i + j + k) odd), the global interior and the pins at i = 1 and n - 2.
// A stale halo row spoils one more row per half-sweep, so after the stage
// the rows from -kl + 2 n_iter on are what K13 computes on the whole field.
//
// The BC pass writes each boundary node of the body rows once:
// u[c(i), c(j), c(k)], or 0 at a pinned x-face node (mg_mixed_bc_pass's
// rule). Only its copy at global plane n - 1 reads another row, plane n - 2;
// where plane n - 1 is body row 0 that is row -1, so the caller gives that
// block a left halo of 2 n_iter + 1 rows, and row -1 is fresh at the end.
// Pad planes (i >= n) are never written.
//
// Bound: device-memory bytes, as K13: ~10 B per point and half-sweep over
// the L + kl + kr rows; the BC pass touches ~4 n boundary nodes a row.
#include "mixed.cuh"
#include "seg.cuh"

namespace {

__global__ void seg_mixed_half_sweep_kernel(mg::Seg u, mg::Seg f, const float* __restrict__ pin,
                                            int n, int g0, float h2, int color, int t0,
                                            int rows) {
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  int t, j, k, jk;
  if (!mg::decode_seg(p, rows, t0, n, t, j, k, jk)) return;
  const int g = g0 + t;
  if (!mg::is_interior(g, j, k, n) || ((g + j + k) & 1) != color) return;
  const float nbr =
      mg::mixed_nbr_sum(mg::SegFieldAt{u, g0, n}, mg::full_pins(pin, n), g, j, k, n);
  u.row(t)[jk] = (nbr - h2 * f.row(t)[jk]) * (1.0f / 6.0f);
}

// blockIdx.y == 0: the y / z face nodes of body rows with 1 <= g <= n - 2,
// 4 (n - 1) a row (the two y faces whole, then the two z faces between
// them); blockIdx.y == 1: the two x-face planes, where the body holds them.
__global__ void seg_mixed_bc_pass_kernel(mg::Seg u, const float* __restrict__ pin, int n,
                                         int g0) {
  const int q = blockIdx.x * blockDim.x + threadIdx.x;
  int t, j, k;
  if (blockIdx.y == 0) {
    const int per_row = 4 * (n - 1);
    if (q >= u.L * per_row) return;
    t = q / per_row;
    int rem = q - t * per_row;
    if (rem < 2 * n) {
      j = rem < n ? 0 : n - 1;
      k = rem % n;
    } else {
      rem -= 2 * n;
      k = rem < n - 2 ? 0 : n - 1;
      j = 1 + rem % (n - 2);
    }
    const int g = g0 + t;
    if (g < 1 || g > n - 2) return;
  } else {
    const int nn = n * n;
    if (q >= 2 * nn) return;
    const int g = q < nn ? 0 : n - 1;
    t = g - g0;
    if (t < 0 || t >= u.L) return;
    j = (q % nn) / n;
    k = q % n;
  }
  const int g = g0 + t;
  u.row(t)[j * n + k] =
      mg::pinned(mg::full_pins(pin, n), g, j, k, n)
          ? 0.0f
          : u.row(mg::copy_source(g, n) - g0)[mg::copy_source(j, n) * n + mg::copy_source(k, n)];
}

}  // namespace

// One in-place mixed half-sweep of `color` (1 = RED) over local rows
// [-kl + 1, L + kr - 2] of the segment u, RHS segment f (same rows); g0 =
// global index of body row 0.
extern "C" int mg_seg_mixed_half_sweep(float* u_lh, float* u_body, float* u_rh, int u_roff,
                                       float* f_lh, float* f_body, float* f_rh, int f_roff,
                                       const float* pin, int kl, int L, int kr, int n, int g0,
                                       float h2, int color, cudaStream_t stream) {
  const int nn = n * n;
  const mg::Seg u = mg::make_seg(u_lh, u_body, u_rh, kl, L, kr, u_roff, nn);
  const mg::Seg f = mg::make_seg(f_lh, f_body, f_rh, kl, L, kr, f_roff, nn);
  const int rows = L + kl + kr - 2;
  seg_mixed_half_sweep_kernel<<<mg::seg_blocks(rows, nn), mg::kThreads, 0, stream>>>(
      u, f, pin, n, g0, h2, color, -kl + 1, rows);
  return (int)cudaGetLastError();
}

// The BC pass of the body rows, in place: Neumann copies (x, y, z order)
// and the zero pin; reads row -1 where plane n - 1 is body row 0.
extern "C" int mg_seg_mixed_bc_pass(float* u_lh, float* u_body, float* u_rh, int u_roff,
                                    const float* pin, int kl, int L, int kr, int n, int g0,
                                    cudaStream_t stream) {
  const mg::Seg u = mg::make_seg(u_lh, u_body, u_rh, kl, L, kr, u_roff, n * n);
  const long long faces = (long long)L * 4 * (n - 1), x_planes = 2LL * n * n;
  const long long count = faces > x_planes ? faces : x_planes;
  const dim3 grid((unsigned)((count + mg::kThreads - 1) / mg::kThreads), 2);
  seg_mixed_bc_pass_kernel<<<grid, mg::kThreads, 0, stream>>>(u, pin, n, g0);
  return (int)cudaGetLastError();
}
