// Interior residual and full-weighting restriction on one rank's
// segmented block (K30, and K39 on an (i, j) block): fine segment points
// of e and r -> the rank's coarse block, without the fine residual
// reaching device memory.
//
// Replaces the Pallas kernels multigrid_parallel_tpu/ops/pallas_sharded.py:
// residual_restrict_ext (fine halo 2 on both sides) and
// residual_restrict_halo (2 planes left, 1 right), and their (i, j) twins
// of pallas_sharded2d.py, residual_restrict_ext2d and
// residual_restrict_halo2d (the same halos in j), in K3's arithmetic and
// order (residual_restrict.cu): the residual of each fine point of the
// (2c-1 .. 2c+1)^3 cone, then the 3-tap weights along i, then j, then k,
// each (0.25 a + 0.5 b) + 0.25 c. Coarse local row c is global coarse
// plane cg0 + c, cg0 = g0 / 2 (rank offsets are even), and coarse local
// column cj global cgj0 + cj, cgj0 = gj0 / 2; its fine rows and columns
// are local 2c - 1 .. 2c + 1 and 2cj - 1 .. 2cj + 1, so the residuals read
// e on rows and columns [-2, L] and r on [-1, L - 1]. Coarse points off
// the global coarse interior (the boundary, pad planes and columns, whole
// pad ranks) are 0. Every owned coarse point equals K3's on the whole
// field bit for bit.
//
// One thread per coarse point, 216 loads through L1/L2, as K3. Bound: as
// K3, the loads; the device-memory floor is 8 B per fine point plus 4 B
// per coarse point.
#include "seg2d.cuh"

namespace {

__device__ inline float tap3(float a, float b, float c) {
  return (0.25f * a + 0.5f * b) + 0.25f * c;
}

template <class S>
__global__ void seg_residual_restrict_kernel(float* __restrict__ out, S e, S r, int n, int cg0,
                                             int cgj0, mg::Span sp, float inv_h2) {
  const int nc = (n + 1) / 2;
  const int q = blockIdx.x * blockDim.x + threadIdx.x;
  int c, cj, ck;
  if (!mg::decode_span(q, sp, nc, c, cj, ck)) return;
  if (!mg::is_interior(cg0 + c, cgj0 + cj, ck, nc)) {
    out[q] = 0.0f;
    return;
  }
  // i taps first: plane[dj][dk] combines fine rows 2c-1, 2c, 2c+1
  float plane[3][3];
#pragma unroll
  for (int dj = 0; dj < 3; ++dj) {
#pragma unroll
    for (int dk = 0; dk < 3; ++dk) {
      const int j = 2 * cj - 1 + dj, k = 2 * ck - 1 + dk;
      float rr[3];
#pragma unroll
      for (int di = 0; di < 3; ++di) {
        const int t = 2 * c - 1 + di;
        rr[di] = mg::seg_at(r, t, j, n)[k] -
                 inv_h2 * (mg::nbr_sum_at(e, t, j, k, n) - 6.0f * mg::seg_at(e, t, j, n)[k]);
      }
      plane[dj][dk] = tap3(rr[0], rr[1], rr[2]);
    }
  }
  // then j, then k
  float y[3];
#pragma unroll
  for (int dk = 0; dk < 3; ++dk) y[dk] = tap3(plane[0][dk], plane[1][dk], plane[2][dk]);
  out[q] = tap3(y[0], y[1], y[2]);
}

template <class S>
int launch_residual_restrict(float* out, const S& e, const S& r, int n, int g0, int gj0,
                             const mg::Span& sp, float inv_h2, cudaStream_t stream) {
  const int nc = (n + 1) / 2;
  seg_residual_restrict_kernel<<<mg::span_blocks(sp, nc), mg::kThreads, 0, stream>>>(
      out, e, r, n, g0 / 2, gj0 / 2, sp, inv_h2);
  return (int)cudaGetLastError();
}

}  // namespace

// out (Lc, nc, nc) <- restriction of the residual of the fine segments
// e and r (left halo kl >= 2, right halo kr >= 1), g0 = global fine index
// of body row 0 (even).
extern "C" int mg_seg_residual_restrict(float* out, float* e_lh, float* e_body, float* e_rh,
                                        int e_roff, float* r_lh, float* r_body, float* r_rh,
                                        int r_roff, int kl, int L, int kr, int n, int g0,
                                        float inv_h2, cudaStream_t stream) {
  const int nn = n * n;
  const int nc = (n + 1) / 2;
  const mg::Seg e = mg::make_seg(e_lh, e_body, e_rh, kl, L, kr, e_roff, nn);
  const mg::Seg r = mg::make_seg(r_lh, r_body, r_rh, kl, L, kr, r_roff, nn);
  return launch_residual_restrict(out, e, r, n, g0, 0, mg::Span{0, L / 2, 0, nc}, inv_h2,
                                  stream);
}

// K39: out (L / 2, Lj / 2, nc) <- the same on (i, j) segments e and r
// (descriptors; halo 2 left and 1 right in i and j), (g0, gj0) = global
// fine indices of body row and column 0 (both even).
extern "C" int mg_seg2d_residual_restrict(float* out, const long long* e_desc,
                                          const long long* r_desc, int L, int Lj, int n, int g0,
                                          int gj0, float inv_h2, cudaStream_t stream) {
  return launch_residual_restrict(out, mg::seg2_from_desc(e_desc, L, Lj),
                                  mg::seg2_from_desc(r_desc, L, Lj), n, g0, gj0,
                                  mg::Span{0, L / 2, 0, Lj / 2}, inv_h2, stream);
}
