// Interior residual and full-weighting restriction on one rank's
// segmented block (K30): fine segment rows of e and r -> the rank's Lc
// coarse planes (Lc, nc, nc), nc = (n + 1) / 2, without the fine residual
// reaching device memory.
//
// Replaces the Pallas kernels multigrid_parallel_tpu/ops/pallas_sharded.py:
// residual_restrict_ext (fine halo 2 on both sides) and
// residual_restrict_halo (2 planes left, 1 right), in K3's arithmetic and
// order (residual_restrict.cu): the residual of each fine point of the
// (2c-1 .. 2c+1)^3 cone, then the 3-tap weights along i, then j, then k,
// each (0.25 a + 0.5 b) + 0.25 c. Coarse local row c is global coarse
// plane cg0 + c, cg0 = g0 / 2 (rank offsets are even); its fine rows are
// local 2c - 1 .. 2c + 1, so the residuals read e on rows [-2, L] and r on
// [-1, L - 1]. Coarse points off the global coarse interior (the
// boundary, pad planes, whole pad ranks) are 0. Every owned coarse point
// equals K3's on the whole field bit for bit.
//
// One thread per coarse point, 216 loads through L1/L2, as K3. Bound: as
// K3, the loads; the device-memory floor is 8 B per fine point plus 4 B
// per coarse point.
#include "seg.cuh"

namespace {

__device__ inline float tap3(float a, float b, float c) {
  return (0.25f * a + 0.5f * b) + 0.25f * c;
}

__global__ void seg_residual_restrict_kernel(float* __restrict__ out, mg::Seg e, mg::Seg r,
                                             int n, int cg0, int Lc, float inv_h2) {
  const int nc = (n + 1) / 2;
  const int q = blockIdx.x * blockDim.x + threadIdx.x;
  int c, cj, ck, cjk;
  if (!mg::decode_seg(q, Lc, 0, nc, c, cj, ck, cjk)) return;
  if (!mg::is_interior(cg0 + c, cj, ck, nc)) {
    out[q] = 0.0f;
    return;
  }
  // i taps first: plane[dj][dk] combines fine rows 2c-1, 2c, 2c+1
  float plane[3][3];
#pragma unroll
  for (int dj = 0; dj < 3; ++dj) {
#pragma unroll
    for (int dk = 0; dk < 3; ++dk) {
      const int jk = (2 * cj - 1 + dj) * n + (2 * ck - 1 + dk);
      float rr[3];
#pragma unroll
      for (int di = 0; di < 3; ++di) {
        const int t = 2 * c - 1 + di;
        rr[di] = r.row(t)[jk] - inv_h2 * (mg::seg_nbr_sum(e, t, jk, n) - 6.0f * e.row(t)[jk]);
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
  const int Lc = L / 2;
  const mg::Seg e = mg::make_seg(e_lh, e_body, e_rh, kl, L, kr, e_roff, nn);
  const mg::Seg r = mg::make_seg(r_lh, r_body, r_rh, kl, L, kr, r_roff, nn);
  seg_residual_restrict_kernel<<<mg::seg_blocks(Lc, nc * nc), mg::kThreads, 0, stream>>>(
      out, e, r, n, g0 / 2, Lc, inv_h2);
  return (int)cudaGetLastError();
}
