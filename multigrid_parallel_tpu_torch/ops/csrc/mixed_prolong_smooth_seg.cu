// Mixed-BC prolongation + correction and the first half-sweep of the
// black-first mixed stage, on one rank's segmented block of an i-sharded
// correction field (K36), writing a fresh output segment.
//
// Replaces, with K34 launches for the rest of the stage, the Pallas kernels
// multigrid_parallel_tpu/ops/pallas_mixed.py: mixed_prolong_smooth_ext and
// mixed_prolong_smooth_halo, which compute the black-first mixed stage of
// e + P ec (the coarse BOUNDARY taking part, copy-BC folded, one BC pass)
// on a block with a fine halo H = 2 * n_iter and a coarse one of n_iter on
// the left and n_iter + 1 on the right, in one pass. This is K15
// (mixed_prolong_smooth.cu) on segments with K31's structure
// (prolong_smooth_seg.cu): over output rows [-kl, L + kr), red and boundary
// points and the two edge rows get e + P ec, black interior points their
// first smoothed value from the corrected neighbours (each recomputed),
// through mixed.cuh's folded neighbour sum at GLOBAL indices. The coarse
// rows are read through a second descriptor at global coarse planes
// (mg::SegAt), so every owned point equals K15's on the whole field bit for
// bit; the other 2 * n_iter - 1 half-sweeps and the BC pass are K34's
// launches on the output. Pad planes (i >= n) keep e's values, zero in the
// cycle: the interpolation is not added there. Where global plane n - 1 is
// body row 0 the caller gives the block kl = H + 1 (and the coarse segment
// n_iter + 1 rows on the left), so the BC pass reads a fresh plane n - 2.
//
// Bound: as K15, loads through L1/L2 (a black point recomputes six
// neighbours' interpolations); the device-memory floor is 12 B per fine
// point plus the coarse rows and the pin planes.
#include "mixed.cuh"
#include "seg.cuh"

namespace {

struct CorrectedSegAt {
  mg::SegFieldAt e;
  mg::SegAt ec;
  __device__ float operator()(int i, int j, int k) const {
    return e(i, j, k) + mg::interp_at(ec, i, j, k);
  }
};

__global__ void seg_mixed_prolong_correct_black_kernel(mg::Seg out, CorrectedSegAt at,
                                                       mg::Seg r, const float* __restrict__ pin,
                                                       int n, int g0, float h2, int t0, int rows,
                                                       int t_lo, int t_hi) {
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  int t, j, k, jk;
  if (!mg::decode_seg(p, rows, t0, n, t, j, k, jk)) return;
  const int g = g0 + t;
  if (g >= n) {  // a pad plane: e's (zero), no correction
    out.row(t)[jk] = at.e(g, j, k);
    return;
  }
  if (t < t_lo || t > t_hi || !mg::is_interior(g, j, k, n) || ((g + j + k) & 1) != 0) {
    out.row(t)[jk] = at(g, j, k);  // 0 = BLACK above
    return;
  }
  const float nbr = mg::mixed_nbr_sum(at, mg::full_pins(pin, n), g, j, k, n);
  out.row(t)[jk] = (nbr - h2 * r.row(t)[jk]) * (1.0f / 6.0f);
}

}  // namespace

// out rows [-kl, L + kr) <- e + P ec, black interior rows [-kl + 1, L + kr - 2]
// swept once; out must not alias e. The fine segments e, r, out have kl
// rows on the left and kr on the right; the coarse segment ec has kl_c and
// kr_c around its Lc = L / 2 rows. g0 = global fine index of body row 0 (even).
extern "C" int mg_seg_mixed_prolong_correct_black(
    float* o_lh, float* o_body, float* o_rh, float* c_lh, float* c_body, float* c_rh,
    int c_roff, int kl_c, int kr_c, float* e_lh, float* e_body, float* e_rh, int e_roff,
    float* r_lh, float* r_body, float* r_rh, int r_roff, const float* pin, int kl, int L,
    int kr, int n, int g0, float h2, cudaStream_t stream) {
  const int nn = n * n;
  const int nc = (n + 1) / 2;
  const mg::Seg out = mg::make_seg(o_lh, o_body, o_rh, kl, L, kr, 0, nn);
  const mg::Seg e = mg::make_seg(e_lh, e_body, e_rh, kl, L, kr, e_roff, nn);
  const mg::Seg r = mg::make_seg(r_lh, r_body, r_rh, kl, L, kr, r_roff, nn);
  const CorrectedSegAt at{
      mg::SegFieldAt{e, g0, n},
      mg::SegAt{mg::make_seg(c_lh, c_body, c_rh, kl_c, L / 2, kr_c, c_roff, nc * nc), g0 / 2,
                nc}};
  const int rows = L + kl + kr;
  seg_mixed_prolong_correct_black_kernel<<<mg::seg_blocks(rows, nn), mg::kThreads, 0,
                                           stream>>>(out, at, r, pin, n, g0, h2, -kl, rows,
                                                     -kl + 1, L + kr - 2);
  return (int)cudaGetLastError();
}
