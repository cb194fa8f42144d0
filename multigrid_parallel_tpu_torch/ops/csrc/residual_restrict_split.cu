// Residual of a split-colour correction pair and full-weighting
// restriction in one kernel: fine pair (er, eb) with RHS pair (rr, rb) ->
// the coarse (nc, nc, nc) RHS, nc = (n + 1) / 2, in the rect layout of the
// levels below, without the fine residual reaching device memory.
//
// Replaces the Pallas kernel multigrid_parallel_tpu/ops/pallas_split.py:
// residual_restrict_split (K9), in its operation order:
//   s(slot)  = r[slot] - inv_h2 * (nbr_sum(other colour) - 6 e[slot])
//              (split.cuh neighbour order; every slot used is interior)
//   k taps   coarse ck on fine row (i, j): with E the colour holding that
//            row's even k's and O the odd one,
//              0.5 * E[ck-1] + 0.25 * (O[ck-1] + O[ck])      (:519-523)
//   i taps   (0.25 a + 0.5 b) + 0.25 c over fine planes 2ci-1, 2ci, 2ci+1
//   j taps   the same over fine rows 2cj-1, 2cj, 2cj+1.
// The TPU kernel applies the j taps as a band-matrix product on its MXU,
// whose sum order is the compiler's; this kernel and its plain version
// fix the left-to-right order above. Coarse boundary points are 0.
//
// The kernel is restrict.cuh's streaming stage on a split pair (Split):
// a block streams both colours of its cone's fine planes through rings in
// shared memory (16-byte cp.async where the rows hold a multiple of 4
// slots, as they do at every 2^m + 1 level past 5), computes each fine
// residual once, takes the k taps within a warp, keeps the i taps' partial
// sums in registers and writes only the coarse RHS. Bound: device memory,
// 8 B a fine grid point read (the two pairs) and 4 B a coarse point
// written (restrict.cuh).
#include "restrict.cuh"

namespace {

using mg::restriction::Args;

// Two chunks (only 513^3 and past) hold too much for two blocks an SM's
// registers: one block an SM, as their shared memory allows anyway.
template <int C>
__global__ void __launch_bounds__(mg::restriction::kMaxThreads, C == 1 ? 2 : 1)
    split_restrict_kernel(Args a) {
  extern __shared__ __align__(16) float tile[];
  mg::restriction::restrict_body<mg::restriction::Split, C>(a, tile);
}

}  // namespace

// out <- the coarse RHS of the pairs (er, eb), (rr, rb) on the plan (bci,
// bcj, bck, chunks, threads, smem) of pallas_split._restrict_plan (split).
extern "C" int mg_split_residual_restrict(float* out, const float* er, const float* eb,
                                          const float* rr, const float* rb, int n, float inv_h2,
                                          int bci, int bcj, int bck, int chunks, int threads,
                                          int smem, cudaStream_t stream) {
  using namespace mg::restriction;
  const int S = mg::split::slots(n);
  const int vec = S % 4 == 0 && (bck >= interior(n) || bck % 4 == 0);
  const Args a{out, {er, eb}, {rr, rb}, n, inv_h2, bci, bcj, bck, vec};
  if (const int err = plan_error(a, true, chunks, threads, smem)) return err;
  return chunks == 1 ? launch(split_restrict_kernel<1>, a, threads, smem, stream)
                     : launch(split_restrict_kernel<kMaxChunks>, a, threads, smem, stream);
}
