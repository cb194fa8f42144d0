// The last red-black half-sweep of a smoothing stage and the residual of
// its result, on an (n, n, n) f32 field.
//
// Replaces, with half-sweeps of K1's per-sweep form (rb_smooth.cu) for the
// stage's first 2 * n_iter - 1 half-sweeps, the Pallas kernel multigrid_parallel_tpu/ops/pallas3d.py:
// rb_smooth_residual_fused_padded (K26), which runs all 2 * n_iter
// half-sweeps of a pre-smoothing stage and the residual of the smoothed
// field in one pass (halo 2 * n_iter + 1 planes in VMEM) and writes
// (u', r).
//
// This launch sweeps the last colour c in place and writes r, without the
// separate residual pass (R) that would read u' back:
//   * an interior point of colour c takes (sum6(u) - h^2 f) * (1/6); its
//     neighbours are of colour !c, which this launch does not write, so
//     its residual f - (1/h^2)(sum6 - 6 u') reuses the same sum;
//   * an interior point of colour !c keeps its value; each of its six
//     neighbours of colour c is recomputed from that neighbour's own !c
//     neighbours, as K4 recomputes its neighbours' interpolations
//     (boundary neighbours are read as they are);
//   * boundary points get r = 0 and keep u.
// No thread reads an interior point of colour c, the only points that are
// written, so the in-place update is race-free. A recomputed value is the
// same expression on the same inputs as the stored one, so with
// --fmad=false it equals it bit for bit, and (u', r) equal K1's u' and R's
// residual of it.
//
// Bound: device-memory bytes. The floor of the whole stage is 16 B per
// point (read u and f, write u' and r); this form moves ~10 B per point
// for each of its 2 * n_iter - 1 half-sweeps and ~14 for this launch
// (u and f read, half of u and all of r written). Against the unfused
// pair it saves R's 12 B per point and one launch. A !c point reads 30
// neighbour values of u, from L1/L2 as K4's recomputes do.
#include "stencil.cuh"

namespace {

// u at grid point (i, j, k), a face neighbour of an interior point and of
// the swept colour, after the sweep: recomputed when interior.
__device__ inline float swept(const float* u, const float* __restrict__ f, int i, int j,
                              int k, int n, float h2) {
  const int q = (i * n + j) * n + k;
  if (!mg::is_interior(i, j, k, n)) return u[q];
  return (mg::nbr_sum(u, q, n) - h2 * f[q]) * (1.0f / 6.0f);
}

__global__ void rb_last_sweep_residual_kernel(float* u, float* __restrict__ r,
                                              const float* __restrict__ f, int n,
                                              float h2, float inv_h2, int color) {
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  int i, j, k;
  if (!mg::decode(p, n, i, j, k)) return;
  if (!mg::is_interior(i, j, k, n)) {
    r[p] = 0.0f;
    return;
  }
  if (((i + j + k) & 1) == color) {
    const float nbr = mg::nbr_sum(u, p, n);
    const float v = (nbr - h2 * f[p]) * (1.0f / 6.0f);
    u[p] = v;
    r[p] = f[p] - inv_h2 * (nbr - 6.0f * v);
    return;
  }
  // nbr_sum order: i-1, i+1, j-1, j+1, k-1, k+1
  float s = swept(u, f, i - 1, j, k, n, h2);
  s = s + swept(u, f, i + 1, j, k, n, h2);
  s = s + swept(u, f, i, j - 1, k, n, h2);
  s = s + swept(u, f, i, j + 1, k, n, h2);
  s = s + swept(u, f, i, j, k - 1, n, h2);
  s = s + swept(u, f, i, j, k + 1, n, h2);
  r[p] = f[p] - inv_h2 * (s - 6.0f * u[p]);
}

}  // namespace

// The in-place half-sweep of `color` (1 = RED = (i+j+k) odd, 0 = BLACK)
// and the interior residual of the result into r (zero boundary). r must
// not alias u or f.
extern "C" int mg_rb_last_sweep_residual(float* u, float* r, const float* f, int n,
                                         float h2, float inv_h2, int color,
                                         cudaStream_t stream) {
  rb_last_sweep_residual_kernel<<<mg::point_blocks(n), mg::kThreads, 0, stream>>>(
      u, r, f, n, h2, inv_h2, color);
  return (int)cudaGetLastError();
}
