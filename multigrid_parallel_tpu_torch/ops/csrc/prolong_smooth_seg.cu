// Trilinear prolongation of the coarse correction added to the fine one,
// and the first half-sweep of the black-first RB stage, on one rank's
// segmented block (K31), writing a fresh output segment.
//
// Replaces, with K28 launches for the rest of the stage, the Pallas
// kernels multigrid_parallel_tpu/ops/pallas_sharded.py:
// prolong_smooth_ext and prolong_smooth_halo, which compute
// rb_smooth(e + P ec, r, h, n_iter, black first) on a block with a fine
// halo H = 2 * n_iter (coarse halo n_iter on the left, n_iter + 1 on the
// right) in one pass. This is K4 (prolong_smooth.cu) on segments, K4's
// fusion kept: over output rows [-H, L + H), red and boundary points and
// the two edge rows get e + P ec, black interior points their first
// smoothed value from the corrected neighbours (each recomputed). The
// coarse rows are read through a second descriptor at GLOBAL coarse
// indices (mg::SegAt), the fine parity of each plane from its global
// index, so every owned point equals K4's on the whole field bit for bit;
// the other 2 * n_iter - 1 half-sweeps are K28 launches on the output.
//
// Bound: as K4, loads through L1/L2; the device-memory floor is 12 B per
// fine point plus the coarse rows.
#include "seg.cuh"

namespace {

__device__ inline float corrected(const mg::Seg& e, const mg::SegAt& ec, int n, int t,
                                  int g, int j, int k) {
  return e.row(t)[j * n + k] + mg::interp_at(ec, g, j, k);
}

__global__ void seg_prolong_correct_black_kernel(mg::Seg out, mg::SegAt ec, mg::Seg e,
                                                 mg::Seg r, int n, int g0, float h2, int t0,
                                                 int rows, int t_lo, int t_hi) {
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  int t, j, k, jk;
  if (!mg::decode_seg(p, rows, t0, n, t, j, k, jk)) return;
  const int g = g0 + t;
  if (t < t_lo || t > t_hi || !mg::is_interior(g, j, k, n) || ((g + j + k) & 1) != 0) {
    out.row(t)[jk] = corrected(e, ec, n, t, g, j, k);  // 0 = BLACK above
    return;
  }
  // nbr_sum order: i-1, i+1, j-1, j+1, k-1, k+1
  float s = corrected(e, ec, n, t - 1, g - 1, j, k);
  s = s + corrected(e, ec, n, t + 1, g + 1, j, k);
  s = s + corrected(e, ec, n, t, g, j - 1, k);
  s = s + corrected(e, ec, n, t, g, j + 1, k);
  s = s + corrected(e, ec, n, t, g, j, k - 1);
  s = s + corrected(e, ec, n, t, g, j, k + 1);
  out.row(t)[jk] = (s - h2 * r.row(t)[jk]) * (1.0f / 6.0f);
}

}  // namespace

// out rows [-H, L + H) <- e + P ec, black interior rows [-H + 1, L + H - 2]
// swept once; out must not alias e. Fine segments e, r, out have halo H on
// both sides; the coarse segment ec has kl_c on the left and kr_c on the
// right of its Lc = L / 2 rows. g0 = global fine index of body row 0.
extern "C" int mg_seg_prolong_correct_black(float* o_lh, float* o_body, float* o_rh,
                                            float* c_lh, float* c_body, float* c_rh,
                                            int c_roff, int kl_c, int kr_c, float* e_lh,
                                            float* e_body, float* e_rh, int e_roff,
                                            float* r_lh, float* r_body, float* r_rh,
                                            int r_roff, int H, int L, int n, int g0,
                                            float h2, cudaStream_t stream) {
  const int nn = n * n;
  const int nc = (n + 1) / 2;
  const mg::Seg out = mg::make_seg(o_lh, o_body, o_rh, H, L, H, 0, nn);
  const mg::Seg e = mg::make_seg(e_lh, e_body, e_rh, H, L, H, e_roff, nn);
  const mg::Seg r = mg::make_seg(r_lh, r_body, r_rh, H, L, H, r_roff, nn);
  const mg::SegAt ec{mg::make_seg(c_lh, c_body, c_rh, kl_c, L / 2, kr_c, c_roff, nc * nc),
                     g0 / 2, nc};
  const int rows = L + 2 * H;
  seg_prolong_correct_black_kernel<<<mg::seg_blocks(rows, nn), mg::kThreads, 0, stream>>>(
      out, ec, e, r, n, g0, h2, -H, rows, -H + 1, L + H - 2);
  return (int)cudaGetLastError();
}
