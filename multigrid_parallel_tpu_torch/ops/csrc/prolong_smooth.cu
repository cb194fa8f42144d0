// Trilinear prolongation of the coarse correction, added to the fine
// correction, and the first half-sweep of the black-first RB stage, in
// one kernel that writes a fresh fine field.
//
// Replaces, with K1 launches for the rest of the stage, the Pallas kernel
// multigrid_parallel_tpu/ops/pallas3d.py: prolong_smooth_fused_padded
// (K4), which computes rb_smooth(e + P ec, r, h, n_iter, black first) in
// one pass. Interpolation in its order: j, then k, then i; an even fine
// index copies the coincident coarse value, an odd one is
// 0.5 a + 0.5 b of its two coarse neighbours. Every step has at most two
// non-zero taps with exact 0.5 scalings, so it rounds once whatever the
// order of the sum, and the plain version (separable matrix products,
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

// (P ec) at fine point (fi, fj, fk): j, then k, then i.
__device__ inline float interp(const float* __restrict__ ec, int nc, int fi,
                               int fj, int fk) {
  const int ci0 = fi >> 1, cj0 = fj >> 1, ck0 = fk >> 1;
  const bool oi = fi & 1, oj = fj & 1, ok = fk & 1;
  float y2[2];
#pragma unroll
  for (int a = 0; a < 2; ++a) {
    if (a == 1 && !oi) break;
    float y1[2];
#pragma unroll
    for (int b = 0; b < 2; ++b) {
      if (b == 1 && !ok) break;
      const float* col = ec + (ci0 + a) * nc * nc + (ck0 + b);  // stride nc in j
      y1[b] = oj ? 0.5f * col[cj0 * nc] + 0.5f * col[(cj0 + 1) * nc] : col[cj0 * nc];
    }
    y2[a] = ok ? 0.5f * y1[0] + 0.5f * y1[1] : y1[0];
  }
  return oi ? 0.5f * y2[0] + 0.5f * y2[1] : y2[0];
}

__device__ inline float corrected(const float* __restrict__ e,
                                  const float* __restrict__ ec, int n, int nc,
                                  int i, int j, int k) {
  return e[(i * n + j) * n + k] + interp(ec, nc, i, j, k);
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
