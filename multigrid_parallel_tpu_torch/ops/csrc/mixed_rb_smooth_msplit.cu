// The mixed-BC red-black Gauss-Seidel smoothing stage on a split pair
// (msplit.cuh) from a zero pair (K22) or from a loaded one, and K21's
// first form: the in-place half-sweep and the cross-colour BC pass.
//
// Replaces the Pallas kernels multigrid_parallel_tpu/ops/pallas_mixed_split.py:
// mixed_rb_smooth_from_zero_msplit (K22, :479 -> :394) and
// mixed_rb_smooth_msplit (K21, :448 -> :394), which run all 2 * n_iter
// half-sweeps of a stage in one pass over HBM, then the BC pass.
//
// K22 is one launch of split.cuh's stage_body with MIXED and ZERO set
// (mg_msplit_stage with no initial pair), on K8's plan (pallas_split.
// _stage_plan with msplit; up to 65^3 the fewest-steps plan, _steps_plan):
// all 2 n_iter half-sweeps of a call on tiles of both colours in shared
// memory, the faces' neighbours as selects of the slot's own value (0 at a
// pinned x-face node) in mixed_nbr_sum's order, so the iterates equal the
// fold's (K16, K17) bit for bit, and the cross-colour BC pass done at
// store time: a fresh pair, bit for bit the plain version's. The tile planes start as zeros, so a select returns +0
// and half-sweep 1 computes (+0 - h^2 f) (1/6), as the plain version does
// from a zero pair. n_iter > 2: ceil(n_iter / 2) launches, each later one
// the same stage with the pair so far loaded (mg_msplit_stage with an
// initial pair; K24's later launches too). Its first form was 2 n_iter +
// 1 launches a call: a from-zero half-sweep, 2 n_iter - 1 half-sweeps in
// place and the BC pass, each a pass over the pair.
// Bound: device-memory bytes (chip_smoke.bound: each input read once, the
// output written once): f and the pin packs read, the pair written, 135.8
// MB at 257^3, 0.0405 ms at 3.35 TB/s. The arithmetic (8 f32 operations a
// point and half-sweep, and the selects) is two orders of magnitude under.
// What the mixed mode costs over K8's stage, and what the design does:
// the selects. Rows with a face neighbour in i or j (j = 1, n - 2, planes
// 1, n - 2) are a warp-uniform branch of their own, and the k-edge selects
// (slots 0 and S - 1 of the rows of parity 0) are folded into the loads of
// the k neighbours, so the other rows sum as K8 does: a select in every
// slot's six terms took 0.1815 ms a call at 257^3 in the solve, this form
// 0.1583 (PERF.md). The store writes both colours of a plane at one step.
// nvcc -Xptxas -v (CUDA 12.8, sm_90a; launch bound 640 threads): the eight
// msplit_stage_kernel instantiations 67-96 registers, no spills, no stack
// frame; shared memory all dynamic, the plan's (225,280 B at 257^3,
// n_iter 2).
//
// K21's first form (mixed_rb_smooth_msplit), one launch per half-sweep, in
// place on the active colour only:
//   u_c <- (mixed_nbr_sum(pair) - h^2 r_c) * (1/6)   at live interior slots,
// through mixed.cuh's sum and PairAt, then the BC pass
// (pallas_mixed_split.py:198-231): x faces, then y faces from the post-x
// values, each from the OTHER colour at the same slot (the neighbour
// across a face has the other colour and the same slot), then the x-face
// pins to 0. As a gather, one thread per stored boundary slot writes both
// colours: u_c(i, j) = u_c'(c(i), c(j)), the colour flipped once per
// copied coordinate, or 0 where pinned; c maps 0 -> 1, n-1 -> n-2. Reads
// hit interior rows only, so it runs in place. Bound: ~6 B per grid point
// of the pair a half-sweep; the BC pass touches ~4 n S boundary slots per
// colour.
#include "msplit.cuh"

namespace {

using namespace mg::split;
using mg::msplit::PackPinAt;
using mg::msplit::PairAt;

__global__ void msplit_half_sweep_kernel(float* red, float* black,
                                         const float* __restrict__ f,
                                         const float* __restrict__ packs, int n,
                                         float h2, int color) {
  const int S = slots(n);
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  int i, j, kk;
  if (!decode(idx, n, S, i, j, kk)) return;
  const int p = parity(i, j, color);
  if (!live_interior(i, j, kk, p, n)) return;
  const float nbr = mg::mixed_nbr_sum(PairAt{red, black, n}, PackPinAt{packs, n}, i, j,
                                      2 * kk + 1 + p, n);
  (color == kRed ? red : black)[idx] = (nbr - h2 * f[idx]) * (1.0f / 6.0f);
}

// Boundary rows of the pair, 2 n + 2 (n - 2) of them: the two x faces
// whole, then the two y faces without their x-face rows.
__device__ inline void boundary_row(int q, int n, int& i, int& j) {
  if (q < 2 * n) {
    i = q < n ? 0 : n - 1;
    j = q % n;
    return;
  }
  q -= 2 * n;
  j = q < n - 2 ? 0 : n - 1;
  i = 1 + q % (n - 2);
}

__global__ void msplit_bc_pass_kernel(float* red, float* black,
                                      const float* __restrict__ packs, int n) {
  const int S = slots(n);
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= (4 * n - 4) * S) return;
  const int kk = t % S;
  int i, j;
  boundary_row(t / S, n, i, j);
  const int si = mg::copy_source(i, n), sj = mg::copy_source(j, n);
  const int flip = ((si != i) + (sj != j)) & 1;
  const int src = (si * n + sj) * S + kk, dst = (i * n + j) * S + kk;
  const bool x_face = i == 0 || i == n - 1;
  const int face = i == 0 ? 0 : 1;
  float v[2];
#pragma unroll
  for (int c = 0; c < 2; ++c) {  // c = 0: black, 1: red
    v[c] = ((c ^ flip) == kRed ? red : black)[src];
    if (x_face && mg::msplit::pack_pinned(packs, n, parity(i, j, c), face, j, kk)) v[c] = 0.0f;
  }
  black[dst] = v[0];
  red[dst] = v[1];
}

template <int NITER, bool VEC, bool ZERO>
__global__ void __launch_bounds__(kStageMaxThreads) msplit_stage_kernel(StageArgs a) {
  extern __shared__ __align__(16) float tile[];
  stage_body<NITER, VEC, ZERO, true>(a, tile, NoPrep{});
}

template <bool ZERO>
int launch_msplit_stage(const StageArgs& a, int n_iter, int threads, int smem,
                        cudaStream_t stream) {
  if (const int err = stage_plan_error(a, n_iter, threads, smem)) return err;
  const bool vec = stage_vec(a);
  if (n_iter == 1) {
    return vec ? launch_stage(msplit_stage_kernel<1, true, ZERO>, a, threads, smem, stream)
               : launch_stage(msplit_stage_kernel<1, false, ZERO>, a, threads, smem, stream);
  }
  return vec ? launch_stage(msplit_stage_kernel<2, true, ZERO>, a, threads, smem, stream)
             : launch_stage(msplit_stage_kernel<2, false, ZERO>, a, threads, smem, stream);
}

}  // namespace

// The mixed-BC stage on a pair: n_iter (1 or 2) RB-GS iterations of (er,
// eb) against (fr, fb), red first or black first, with the x-face pins
// `packs`, into the fresh pair (out_r, out_b), the BC pass done at store
// time; er and eb null for a zero initial pair (K22). The plan (bi, bj,
// bk, k_halo, threads, smem) is pallas_split._stage_plan's with msplit. The outputs must not alias the inputs.
extern "C" int mg_msplit_stage(float* out_r, float* out_b, const float* er, const float* eb,
                               const float* fr, const float* fb, const float* packs, int n,
                               float h2, int red_first, int n_iter, int bi, int bj, int bk,
                               int k_halo, int threads, int smem, cudaStream_t stream) {
  StageArgs a;
  const int c0 = red_first ? kRed : kBlack;
  float* out[2] = {out_b, out_r};  // by colour: [kBlack], [kRed]
  const float* in[2] = {eb, er};
  const float* f[2] = {fb, fr};
  for (int c = 0; c < 2; ++c) {
    const int color = c ? 1 - c0 : c0;
    a.out[c] = out[color];
    a.in[c] = in[color];
    a.f[c] = f[color];
  }
  a.packs = packs;
  a.color0 = c0;
  a.n = n;
  a.h2 = h2;
  a.bi = bi;
  a.bj = bj;
  a.bk = bk;
  a.k_halo = k_halo;
  return er ? launch_msplit_stage<false>(a, n_iter, threads, smem, stream)
            : launch_msplit_stage<true>(a, n_iter, threads, smem, stream);
}

// One in-place mixed half-sweep of `color` (1 = RED) on the pair (red,
// black) against that colour's RHS f.
extern "C" int mg_msplit_half_sweep(float* red, float* black, const float* f,
                                    const float* packs, int n, float h2, int color,
                                    cudaStream_t stream) {
  msplit_half_sweep_kernel<<<mg::split::slot_blocks(n), mg::kThreads, 0, stream>>>(
      red, black, f, packs, n, h2, color);
  return (int)cudaGetLastError();
}

// The cross-colour BC pass, in place: x then y Neumann copies, the zero pin.
extern "C" int mg_msplit_bc_pass(float* red, float* black, const float* packs, int n,
                                 cudaStream_t stream) {
  const long long count = (4LL * n - 4) * mg::split::slots(n);
  const int blocks = (int)((count + mg::kThreads - 1) / mg::kThreads);
  msplit_bc_pass_kernel<<<blocks, mg::kThreads, 0, stream>>>(red, black, packs, n);
  return (int)cudaGetLastError();
}
