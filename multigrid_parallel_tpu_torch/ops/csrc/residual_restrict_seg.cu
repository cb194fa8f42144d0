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
// The kernel is restrict.cuh's streaming stage on the segments
// (SegLayout), one launch a call, on the plan of
// pallas_split._restrict_plan with the rank's interior coarse rows and
// columns (seg_rows, seg_cols): K3's tile, taps and arithmetic, each tile
// row copied from the row its segment gives, looked up once a row (on
// Seg2, Seg2::at's five-way branch once a row, not once a load); the
// blocks tile the rank's interior coarse points, and the launch writes
// every other point of its coarse block 0 (one block where the rank has no
// interior point). It replaced a first form, one thread a coarse point
// with 216 loads through the segment accessor, every fine residual
// computed 27 / 8 times, 1.8-6.3x slower at every level from 9^3 to 257^3
// (utils/stage_plans.py --seg-restrict; PERF.md). The launchers refuse
// halos shorter than the stencil's (2 rows and columns before the block,
// 1 after), an odd rank offset, and a plan that is not the kernel's.
// Bound: device-memory bytes, e and r read once (8 B a fine point of the
// field's part that the rank's interior cones cover) and the coarse block
// written (4 B a coarse point).
#include "restrict.cuh"

namespace {

using mg::restriction::SegArgs;

template <class S, int C>
__global__ void __launch_bounds__(mg::restriction::kMaxThreads, 2)
    seg_restrict_kernel(SegArgs<S> a) {
  extern __shared__ __align__(16) float tile[];
  mg::restriction::restrict_body<mg::restriction::SegLayout<S>, C>(a, tile);
}

// The stage's launch on segments e and r whose halos hold at least kl rows
// before the block and kr after (and, on Seg2, hjl columns before and hjr
// after): 0, or cudaErrorInvalidValue for a halo shorter than the
// stencil's, an odd offset or extent, or a plan the kernel does not take.
template <class S>
int seg_restrict(float* out, const S& e, const S& r, int n, int g0, int L, int gj0, int Lj,
                 bool whole, int kl, int kr, int hjl, int hjr, float inv_h2, int bci, int bcj,
                 int bck, int chunks, int threads, int smem, cudaStream_t stream) {
  using namespace mg::restriction;
  SegArgs<S> a{};
  a.out = out;
  a.n = n;
  a.inv_h2 = inv_h2;
  a.bci = bci;
  a.bcj = bcj;
  a.bck = bck;
  a.e_s = e;
  a.r_s = r;
  if (out == nullptr || kl < 2 || kr < 1 || (!whole && (hjl < 2 || hjr < 1)))
    return (int)cudaErrorInvalidValue;
  if (const int err = seg_setup(a, g0, L, gj0, Lj, whole)) return err;
  if (const int err = seg_plan_error(a, chunks, threads, smem)) return err;
  return chunks == 1 ? launch(seg_restrict_kernel<S, 1>, a, threads, smem, stream)
                     : launch(seg_restrict_kernel<S, kMaxChunks>, a, threads, smem, stream);
}

}  // namespace

// The K30 stage: out (L / 2, nc, nc) <- the restriction of the residual of
// the fine segments e and r (kl rows before the body, at least 2; kr
// after, at least 1), g0 = the global fine plane of body row 0 (even), on
// the plan (bci, bcj, bck, chunks, threads, smem) of
// pallas_split._restrict_plan(n, sms, seg_rows=the rank's interior coarse
// rows); out must not alias e or r.
extern "C" int mg_seg_restrict_stage(float* out, float* e_lh, float* e_body, float* e_rh,
                                     int e_roff, float* r_lh, float* r_body, float* r_rh,
                                     int r_roff, int kl, int L, int kr, int n, int g0,
                                     float inv_h2, int bci, int bcj, int bck, int chunks,
                                     int threads, int smem, cudaStream_t stream) {
  const int nn = n * n;
  const mg::Seg e = mg::make_seg(e_lh, e_body, e_rh, kl, L, kr, e_roff, nn);
  const mg::Seg r = mg::make_seg(r_lh, r_body, r_rh, kl, L, kr, r_roff, nn);
  return seg_restrict(out, e, r, n, g0, L, 0, 0, true, kl, kr, 2, 1, inv_h2, bci, bcj, bck,
                      chunks, threads, smem, stream);
}

// The K39 stage: out (L / 2, Lj / 2, nc) <- the same on (i, j) segments
// (descriptors, seg2d.cuh: their kl rows and hj columns before the block,
// at least 2; kr rows and hjr columns after it, at least 1), (g0, gj0) =
// the global fine row and column of body point (0, 0) (both even), on the
// plan of _restrict_plan(n, sms, seg_rows=, seg_cols=).
extern "C" int mg_seg2d_restrict_stage(float* out, const long long* e_desc,
                                       const long long* r_desc, int kr, int hjr, int L, int Lj,
                                       int n, int g0, int gj0, float inv_h2, int bci, int bcj,
                                       int bck, int chunks, int threads, int smem,
                                       cudaStream_t stream) {
  const mg::Seg2 e = mg::seg2_from_desc(e_desc, L, Lj), r = mg::seg2_from_desc(r_desc, L, Lj);
  if (e.body == nullptr || r.body == nullptr) return (int)cudaErrorInvalidValue;
  const int kl = e.kl < r.kl ? e.kl : r.kl, hjl = e.hj < r.hj ? e.hj : r.hj;
  return seg_restrict(out, e, r, n, g0, L, gj0, Lj, false, kl, kr, hjl, hjr, inv_h2, bci, bcj,
                      bck, chunks, threads, smem, stream);
}
