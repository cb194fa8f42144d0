// Trilinear prolongation of the coarse correction added to the fine one,
// and the first half-sweep of the black-first RB stage, on one rank's
// segmented block (K31, and K40 on an (i, j) block), writing a fresh
// output segment.
//
// Replaces, with K28 (K37) launches for the rest of the stage, the Pallas
// kernels multigrid_parallel_tpu/ops/pallas_sharded.py:
// prolong_smooth_ext and prolong_smooth_halo, and their (i, j) twins of
// pallas_sharded2d.py, prolong_smooth_ext2d and prolong_smooth_halo2d,
// which compute rb_smooth(e + P ec, r, h, n_iter, black first) on a block
// with a fine halo H = 2 * n_iter (coarse halo n_iter on the left, n_iter
// + 1 on the right; on an (i, j) block in j as in i) in one pass. This is
// K4 (prolong_smooth.cu) on segments, K4's fusion kept: over the output
// points, red and boundary points and the edge rows and columns get e + P
// ec, black interior points their first smoothed value from the corrected
// neighbours (each recomputed). The coarse block is read through a second
// descriptor at GLOBAL coarse indices (mg::SegCoarseAt, mg::interp_coarse;
// its origin is the fine body origin halved), the fine parity of each point from its global
// indices, so every owned point equals K4's on the whole field bit for
// bit; the other 2 * n_iter - 1 half-sweeps are K28 (K37) launches on the
// output.
//
// Bound: as K4, loads through L1/L2; the device-memory floor is 12 B per
// fine point plus the coarse block.
#include "seg2d.cuh"

namespace {

template <class S>
__device__ inline float corrected(const S& e, const mg::SegCoarseAt<S>& ec, int n, int t, int j,
                                  int g, int gj, int k) {
  return mg::seg_at(e, t, j, n)[k] + mg::interp_coarse(ec, g, gj, k);
}

template <class S>
__global__ void seg_prolong_correct_black_kernel(S out, mg::SegCoarseAt<S> ec, S e, S r,
                                                 mg::Span sp, int n, int g0, int gj0, float h2,
                                                 int t_lo, int t_hi, int j_lo, int j_hi) {
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  int t, j, k;
  if (!mg::decode_span(p, sp, n, t, j, k)) return;
  const int g = g0 + t, gj = gj0 + j;
  if (t < t_lo || t > t_hi || j < j_lo || j > j_hi || !mg::is_interior(g, gj, k, n) ||
      ((g + gj + k) & 1) != 0) {
    mg::seg_at(out, t, j, n)[k] = corrected(e, ec, n, t, j, g, gj, k);  // 0 = BLACK above
    return;
  }
  // nbr_sum order: i-1, i+1, j-1, j+1, k-1, k+1
  float s = corrected(e, ec, n, t - 1, j, g - 1, gj, k);
  s = s + corrected(e, ec, n, t + 1, j, g + 1, gj, k);
  s = s + corrected(e, ec, n, t, j - 1, g, gj - 1, k);
  s = s + corrected(e, ec, n, t, j + 1, g, gj + 1, k);
  s = s + corrected(e, ec, n, t, j, g, gj, k - 1);
  s = s + corrected(e, ec, n, t, j, g, gj, k + 1);
  mg::seg_at(out, t, j, n)[k] = (s - h2 * mg::seg_at(r, t, j, n)[k]) * (1.0f / 6.0f);
}

template <class S>
int launch_prolong_correct_black(const S& out, const S& c, const S& e, const S& r,
                                 const mg::Span& sp, int n, int g0, int gj0, float h2, int t_lo,
                                 int t_hi, int j_lo, int j_hi, cudaStream_t stream) {
  const mg::SegCoarseAt<S> ec{c, g0 / 2, gj0 / 2, (n + 1) / 2};
  seg_prolong_correct_black_kernel<<<mg::span_blocks(sp, n), mg::kThreads, 0, stream>>>(
      out, ec, e, r, sp, n, g0, gj0, h2, t_lo, t_hi, j_lo, j_hi);
  return (int)cudaGetLastError();
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
  const mg::Seg c = mg::make_seg(c_lh, c_body, c_rh, kl_c, L / 2, kr_c, c_roff, nc * nc);
  return launch_prolong_correct_black(out, c, e, r, mg::Span{-H, L + 2 * H, 0, n}, n, g0, 0,
                                      h2, -H + 1, L + H - 2, 0, n - 1, stream);
}

// K40's first launch: out rows [-H, L + H) x columns [-H, Lj + H) <- e + P
// ec, black interior points off the edge rows and columns swept once; out
// must not alias e. Descriptors (seg2d.cuh): e, r, out with halo H in i
// and j, the coarse block c of (L / 2, Lj / 2) with n_iter halo rows and
// columns before it and n_iter + 1 after; (g0, gj0) = global fine indices
// of body row and column 0 (both even).
extern "C" int mg_seg2d_prolong_correct_black(const long long* o_desc, const long long* c_desc,
                                              const long long* e_desc, const long long* r_desc,
                                              int H, int L, int Lj, int n, int g0, int gj0,
                                              float h2, cudaStream_t stream) {
  return launch_prolong_correct_black(
      mg::seg2_from_desc(o_desc, L, Lj), mg::seg2_from_desc(c_desc, L / 2, Lj / 2),
      mg::seg2_from_desc(e_desc, L, Lj), mg::seg2_from_desc(r_desc, L, Lj),
      mg::Span{-H, L + 2 * H, -H, Lj + 2 * H}, n, g0, gj0, h2, -H + 1, L + H - 2, -H + 1,
      Lj + H - 2, stream);
}
