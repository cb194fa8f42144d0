// The double-float defect-step kernels on split-colour pairs: the
// compensated residual of (u_hi + u_lo) against (f_hi + f_lo) with its
// squared norm (K12), and the same after df_add of a correction pair (K11).
//
// Replaces the Pallas kernels multigrid_parallel_tpu/ops/pallas_split.py:
// residual_df_norm_split (K12) and df_step_split (K11), the split twins of
// the rect K5 / K6 (residual_df_norm.cu, df_step.cu), with their
// arithmetic from eft.cuh: two-sum, df_add and the EFT residual, whose
// six neighbours come here in the split order of split.cuh (i-1, i+1,
// j-1, j+1, B[kk], B[kk -+ 1]), as the Pallas kernels pass them
// (pallas_split.py:801-807). That is not the rect order, so the residual
// agrees with the rect K5 / K6 to a few ulp, not bit for bit.
//
// One thread per slot computes both colours there: the red and black
// residuals (0 off the live interior), and for K11 the updated pairs of
// both colours. K11 cannot work in place (a residual needs its
// neighbours' updated values): it writes fresh outputs and each thread
// recomputes df_add for the six neighbours of each colour, which gives the
// bits their owners store. ||r||^2 is K5's deterministic two-stage f64 sum
// (eft.cuh), of r_red^2 + r_black^2 per slot; the TPU carries an f32 sum
// across its ordered grid, so the two norms differ only in how the sum
// rounds.
//
// Bound: device-memory bytes, as for the rect K5 / K6, since a pair holds
// as many values as a rect field (n - 1 of every n k's): 20 B per grid
// point for K12 (read the u and f pairs, write r), 32 for K11 (also read
// e, write u'). The neighbour rows come from L1/L2.
#include "eft.cuh"
#include "split.cuh"

namespace {

using namespace mg::split;

__global__ void split_residual_df_partials_kernel(
    float* __restrict__ r_r, float* __restrict__ r_b, double* __restrict__ partials,
    const float* __restrict__ uhr, const float* __restrict__ uhb,
    const float* __restrict__ ulr, const float* __restrict__ ulb,
    const float* __restrict__ fhr, const float* __restrict__ fhb,
    const float* __restrict__ flr, const float* __restrict__ flb, int n,
    float inv_h2) {
  const int S = slots(n);
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  int i, j, kk;
  double rr = 0.0;
  if (decode(idx, n, S, i, j, kk)) {
    float v[2];
#pragma unroll
    for (int c = 0; c < 2; ++c) {  // c = 0: red, 1: black
      const int p = parity(i, j, c == 0 ? kRed : kBlack);
      v[c] = 0.0f;
      if (live_interior(i, j, kk, p, n)) {
        float nh[6], nl[6];
        load_nbrs(c == 0 ? uhb : uhr, idx, n, S, kk, p, nh);
        load_nbrs(c == 0 ? ulb : ulr, idx, n, S, kk, p, nl);
        v[c] = mg::eft_residual((c == 0 ? fhr : fhb)[idx], (c == 0 ? flr : flb)[idx],
                                (c == 0 ? uhr : uhb)[idx], nh, (c == 0 ? ulr : ulb)[idx],
                                nl, inv_h2);
      }
    }
    r_r[idx] = v[0];
    r_b[idx] = v[1];
    rr = (double)v[0] * (double)v[0] + (double)v[1] * (double)v[1];
  }
  mg::block_partial(rr, partials);
}

__global__ void split_df_step_partials_kernel(
    float* __restrict__ o_hr, float* __restrict__ o_hb, float* __restrict__ o_lr,
    float* __restrict__ o_lb, float* __restrict__ r_r, float* __restrict__ r_b,
    double* __restrict__ partials, const float* __restrict__ uhr,
    const float* __restrict__ uhb, const float* __restrict__ ulr,
    const float* __restrict__ ulb, const float* __restrict__ er,
    const float* __restrict__ eb, const float* __restrict__ fhr,
    const float* __restrict__ fhb, const float* __restrict__ flr,
    const float* __restrict__ flb, int n, float inv_h2) {
  const int S = slots(n);
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  int i, j, kk;
  double rr = 0.0;
  if (decode(idx, n, S, i, j, kk)) {
    float ch[2], cl[2];
    mg::df_add(uhr[idx], ulr[idx], er[idx], ch[0], cl[0]);
    mg::df_add(uhb[idx], ulb[idx], eb[idx], ch[1], cl[1]);
    o_hr[idx] = ch[0];
    o_lr[idx] = cl[0];
    o_hb[idx] = ch[1];
    o_lb[idx] = cl[1];
    float v[2];
#pragma unroll
    for (int c = 0; c < 2; ++c) {  // c = 0: red, 1: black
      const int p = parity(i, j, c == 0 ? kRed : kBlack);
      v[c] = 0.0f;
      if (live_interior(i, j, kk, p, n)) {
        // the other colour's neighbours, updated (a missing k-neighbour
        // loads as 0 + 0 + 0, whose df_add is 0, 0)
        float oh[6], ol[6], oe[6], nh[6], nl[6];
        load_nbrs(c == 0 ? uhb : uhr, idx, n, S, kk, p, oh);
        load_nbrs(c == 0 ? ulb : ulr, idx, n, S, kk, p, ol);
        load_nbrs(c == 0 ? eb : er, idx, n, S, kk, p, oe);
#pragma unroll
        for (int m = 0; m < 6; ++m) mg::df_add(oh[m], ol[m], oe[m], nh[m], nl[m]);
        v[c] = mg::eft_residual((c == 0 ? fhr : fhb)[idx], (c == 0 ? flr : flb)[idx],
                                ch[c], nh, cl[c], nl, inv_h2);
      }
    }
    r_r[idx] = v[0];
    r_b[idx] = v[1];
    rr = (double)v[0] * (double)v[0] + (double)v[1] * (double)v[1];
  }
  mg::block_partial(rr, partials);
}

}  // namespace

// Number of f64 partials the caller allocates for a pair of n^3 fields.
extern "C" int mg_split_df_partials(int n) { return mg::split::slot_blocks(n); }

extern "C" int mg_split_residual_df_norm(
    float* r_r, float* r_b, float* nrm2, double* partials, const float* u_hr,
    const float* u_hb, const float* u_lr, const float* u_lb, const float* f_hr,
    const float* f_hb, const float* f_lr, const float* f_lb, int n, float inv_h2,
    cudaStream_t stream) {
  const int blocks = mg::split::slot_blocks(n);
  split_residual_df_partials_kernel<<<blocks, mg::kThreads, 0, stream>>>(
      r_r, r_b, partials, u_hr, u_hb, u_lr, u_lb, f_hr, f_hb, f_lr, f_lb, n, inv_h2);
  int err = (int)cudaGetLastError();
  if (err != 0) return err;
  sum_partials_kernel<<<1, mg::kReduceThreads, 0, stream>>>(partials, blocks, nrm2);
  return (int)cudaGetLastError();
}

extern "C" int mg_split_df_step(
    float* o_hr, float* o_hb, float* o_lr, float* o_lb, float* r_r, float* r_b,
    float* nrm2, double* partials, const float* u_hr, const float* u_hb,
    const float* u_lr, const float* u_lb, const float* e_r, const float* e_b,
    const float* f_hr, const float* f_hb, const float* f_lr, const float* f_lb,
    int n, float inv_h2, cudaStream_t stream) {
  const int blocks = mg::split::slot_blocks(n);
  split_df_step_partials_kernel<<<blocks, mg::kThreads, 0, stream>>>(
      o_hr, o_hb, o_lr, o_lb, r_r, r_b, partials, u_hr, u_hb, u_lr, u_lb, e_r, e_b,
      f_hr, f_hb, f_lr, f_lb, n, inv_h2);
  int err = (int)cudaGetLastError();
  if (err != 0) return err;
  sum_partials_kernel<<<1, mg::kReduceThreads, 0, stream>>>(partials, blocks, nrm2);
  return (int)cudaGetLastError();
}
