// Trilinear prolongation of the coarse correction, added to the fine
// correction, and the first half-sweep of the black-first RB stage, in
// one kernel that writes a fresh fine field.
//
// Replaces, with K1 launches for the rest of the stage, the Pallas kernel
// multigrid_parallel_tpu/ops/pallas3d.py: prolong_smooth_fused_padded
// (K4), which computes rb_smooth(e + P ec, r, h, n_iter, black first) in
// one pass. Interpolation in its order, j, then k, then i (mg::interp in
// stencil.cuh, shared with K15): each step rounds once whatever the
// order of its sum, so the plain version (separable matrix products,
// then the plain RB stage) agrees bit for bit.
//
// This launch: red points and boundary points get the corrected value
// e + P ec; black interior points get their first smoothed value
//   (nbr_sum(e + P ec) - h^2 r) * (1/6),
// each neighbour's corrected value recomputed from e and ec. The output
// is a fresh field: in place, a black point could read a red neighbour
// that its own thread had already corrected and add P ec twice. The
// stage's other 2 * n_iter - 1 half-sweeps are K1 launches on the output.
//
// Bound: one thread per fine point, loads through L1/L2: a black point
// reads 7 points of e and up to 8 coarse points for each of its 6
// neighbours. The device-memory floor is 12 B per fine point (e, r read,
// output written) plus the small coarse field. The unfused path moves 12 B
// per fine point for the add, about 10 for its first K1 half-sweep, and
// the three matrix products of the prolongation on top.
#include "stencil.cuh"

namespace {

__device__ inline float corrected(const float* __restrict__ e,
                                  const float* __restrict__ ec, int n, int nc,
                                  int i, int j, int k) {
  return e[(i * n + j) * n + k] + mg::interp(ec, nc, i, j, k);
}

__global__ void prolong_correct_black_kernel(float* __restrict__ out,
                                             const float* __restrict__ ec,
                                             const float* __restrict__ e,
                                             const float* __restrict__ r,
                                             int n, float h2) {
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  int i, j, k;
  if (!mg::decode(p, n, i, j, k)) return;
  const int nc = (n + 1) / 2;
  if (!mg::is_interior(i, j, k, n) || ((i + j + k) & 1) != 0) {  // 0 = BLACK
    out[p] = corrected(e, ec, n, nc, i, j, k);
    return;
  }
  // nbr_sum order: i-1, i+1, j-1, j+1, k-1, k+1
  float s = corrected(e, ec, n, nc, i - 1, j, k);
  s = s + corrected(e, ec, n, nc, i + 1, j, k);
  s = s + corrected(e, ec, n, nc, i, j - 1, k);
  s = s + corrected(e, ec, n, nc, i, j + 1, k);
  s = s + corrected(e, ec, n, nc, i, j, k - 1);
  s = s + corrected(e, ec, n, nc, i, j, k + 1);
  out[p] = (s - h2 * r[p]) * (1.0f / 6.0f);
}

}  // namespace

// out <- e + P ec on red and boundary points, the first black half-sweep
// of that field on black interior points. out must not alias e.
extern "C" int mg_prolong_correct_black(float* out, const float* ec,
                                        const float* e, const float* r, int n,
                                        float h2, cudaStream_t stream) {
  prolong_correct_black_kernel<<<mg::point_blocks(n), mg::kThreads, 0,
                                 stream>>>(out, ec, e, r, n, h2);
  return (int)cudaGetLastError();
}
