// One fused tail of a defect-correction step on the double-float
// solution: df_add of the correction, the compensated residual of the
// updated solution and its squared norm.
//
// Replaces the Pallas kernel multigrid_parallel_tpu/ops/pallas3d.py:
// df_step_residual_norm_fused (K6):
//   (u_hi', u_lo') = df_add(u_hi, u_lo, e)                  every point
//   r              = EFT residual of (u_hi', u_lo') vs f    interior, else 0
//   ||r||^2
// with the arithmetic of eft.cuh, so r is bit for bit K5 run on the
// updated pair.
//
// One thread per point, writing FRESH outputs: the residual at p needs
// its neighbours' UPDATED values, which their own threads write, so the
// kernel cannot work in place. Each thread recomputes df_add for its six
// neighbours instead. df_add is deterministic, so those are exactly the
// bits the neighbours' owners store, and no thread reads another's
// output. The TPU kernel sums ||r||^2 in f32 across its ordered grid;
// here it is K5's deterministic two-stage f64 sum (per-block partials,
// then one block in fixed order), so the two norms differ only in how
// the sum rounds.
//
// Bound: device-memory bytes, 32 per point at best (read u_hi, u_lo, e,
// f_hi, f_lo; write u_hi', u_lo', r) against 40 for the unfused df_add
// (20) and K5 (20). The neighbour rows of u_hi, u_lo and e come from L1/L2;
// the 7 df_adds per point are cheap next to the loads.
#include "eft.cuh"

namespace {

__global__ void df_step_partials_kernel(
    float* __restrict__ out_hi, float* __restrict__ out_lo,
    float* __restrict__ out_r, double* __restrict__ partials,
    const float* __restrict__ uh, const float* __restrict__ ul,
    const float* __restrict__ e, const float* __restrict__ fh,
    const float* __restrict__ fl, int n, float inv_h2) {
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  int i, j, k;
  double rr = 0.0;
  if (mg::decode(p, n, i, j, k)) {
    float ch, cl;
    mg::df_add(uh[p], ul[p], e[p], ch, cl);
    out_hi[p] = ch;
    out_lo[p] = cl;
    float v = 0.0f;
    if (mg::is_interior(i, j, k, n)) {
      float oh[6], ol[6], oe[6], nh[6], nl[6];
      mg::load_nbrs(uh, p, n, oh);
      mg::load_nbrs(ul, p, n, ol);
      mg::load_nbrs(e, p, n, oe);
#pragma unroll
      for (int m = 0; m < 6; ++m) mg::df_add(oh[m], ol[m], oe[m], nh[m], nl[m]);
      v = mg::eft_residual(fh[p], fl[p], ch, nh, cl, nl, inv_h2);
    }
    out_r[p] = v;
    rr = (double)v * (double)v;
  }
  mg::block_partial(rr, partials);
}

}  // namespace

// Number of f64 partials the caller allocates for an n^3 field.
extern "C" int mg_df_step_partials(int n) { return mg::point_blocks(n); }

extern "C" int mg_df_step(float* out_hi, float* out_lo, float* r, float* nrm2,
                          double* partials, const float* u_hi,
                          const float* u_lo, const float* e,
                          const float* f_hi, const float* f_lo, int n,
                          float inv_h2, cudaStream_t stream) {
  const int blocks = mg::point_blocks(n);
  df_step_partials_kernel<<<blocks, mg::kThreads, 0, stream>>>(
      out_hi, out_lo, r, partials, u_hi, u_lo, e, f_hi, f_lo, n, inv_h2);
  int err = (int)cudaGetLastError();
  if (err != 0) return err;
  sum_partials_kernel<<<1, mg::kReduceThreads, 0, stream>>>(partials, blocks, nrm2);
  return (int)cudaGetLastError();
}
