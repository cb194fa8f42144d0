// Mixed-BC interior residual and full-weighting restriction in one kernel:
// split pair in (msplit.cuh), coarse FOLD RHS out (mixed.cuh: (nc, nc,
// nc - 2), slot a holding coarse plane kc = a + 1), nc = (n + 1) / 2,
// without the fine residual ever reaching device memory.
//
// Replaces the Pallas kernel multigrid_parallel_tpu/ops/pallas_mixed_split.py:
// residual_restrict_msplit (K23). Its operations in its order
// (pallas_mixed_split.py:567-599):
//   res(i, j, k) = r - inv_h2 * (nbr - 6 e),  nbr in mixed.cuh's order,
//       the i and j neighbours read from the stored boundary rows the BC
//       pass maintained, the k-edge reads folded to the centre;
//   k taps per fine row into coarse slot a: 0.25 (O[a] + O[a + 1]) +
//       0.5 E[a], O / E the colour holding the row's odd / even k's, i.e.
//       0.25 (res(2a + 1) + res(2a + 3)) + 0.5 res(2a + 2);
//   then the 3-tap weights along i, then along j, each (0.25 a + 0.5 b) +
//       0.25 c (the TPU kernel applies the j taps as an MXU band product in
//       the compiler's sum order).
// Coarse points on the x and y faces are 0; every stored coarse k is
// interior. The coarse field is indexed by its own shape: the fine pair
// has S = (n - 1) / 2 slots and the coarse fold nc - 2 = S - 1 (the TPU's
// 128-lane round-up makes the two widths equal there).
//
// Two forms, one launch a call each, both bit for bit the plain version:
// - the streaming stage (restrict.cuh's MSplit layout: K9's tile and
//   schedule with the mixed k edge and K18's coarse fold out; the plan
//   pallas_split._restrict_plan(n, sms, split=True), K9's, since the tile
//   is K9's): both colours of e and r through rings in shared memory,
//   each fine residual computed once, the k taps within a warp, the i
//   taps' partial sums in registers, only the coarse RHS written; the
//   levels from pallas_split.MSPLIT_RESTRICT_STAGE_MIN_N (257) up, where
//   it is the faster (device ms a launch, one NVIDIA H100 80GB HBM3 at
//   700 W: 0.0644 against 0.1035 at 257^3; the table beside that constant);
// - the first form below that: one thread per stored coarse point; its 27
//   fine residuals lie on the fine interior (216 loads, mostly from
//   L1/L2, as K18's first form), each fine residual computed 27 / 8 times.
//   On a small level a launch is latency: the stage's prologue and
//   2 bci + 1 barrier steps cost more than the loads they save.
// Bound: device-memory bytes, 8 B per fine grid point (the e and r pairs
// read once) plus 4 B per coarse point written: 0.0429 ms at 257^3 at
// 3.35 TB/s.
// nvcc -Xptxas -v (sm_90a): msplit_restrict_kernel<1> 52 registers, <2>
// 94, no spills, no stack frame, shared memory all dynamic (the plan's);
// the first form 72 registers.
#include "msplit.cuh"
#include "restrict.cuh"

namespace {

using mg::msplit::PairAt;
using mg::restriction::Args;
using mg::restriction::tap3;

__device__ inline float residual(const PairAt& e, const PairAt& r, int i, int j, int k,
                                 int n, float inv_h2) {
  const float cen = e(i, j, k);
  float s = e(i - 1, j, k);
  s = s + e(i + 1, j, k);
  s = s + e(i, j - 1, k);
  s = s + e(i, j + 1, k);
  s = s + (k == 1 ? cen : e(i, j, k - 1));
  s = s + (k == n - 2 ? cen : e(i, j, k + 1));
  return r(i, j, k) - inv_h2 * (s - 6.0f * cen);
}

__global__ void residual_restrict_msplit_kernel(float* __restrict__ out,
                                                const float* __restrict__ er,
                                                const float* __restrict__ eb,
                                                const float* __restrict__ rr,
                                                const float* __restrict__ rb, int n,
                                                float inv_h2) {
  const int nc = (n + 1) / 2;
  const int q = blockIdx.x * blockDim.x + threadIdx.x;
  int ci, cj, ck;
  if (!mg::decode_fold(q, nc, ci, cj, ck)) return;
  if (!mg::is_interior_ij(ci, cj, nc)) {
    out[q] = 0.0f;
    return;
  }
  const PairAt e{er, eb, n}, r{rr, rb, n};
  const int k0 = 2 * ck - 1;  // fine k of the coarse plane's lower tap
  float y[3];
#pragma unroll
  for (int dj = 0; dj < 3; ++dj) {
    const int j = 2 * cj - 1 + dj;
    float t[3];
#pragma unroll
    for (int di = 0; di < 3; ++di) {
      const int i = 2 * ci - 1 + di;
      const float lo = residual(e, r, i, j, k0, n, inv_h2);
      const float mid = residual(e, r, i, j, k0 + 1, n, inv_h2);
      const float hi = residual(e, r, i, j, k0 + 2, n, inv_h2);
      t[di] = 0.25f * (lo + hi) + 0.5f * mid;  // k taps
    }
    y[dj] = tap3(t[0], t[1], t[2]);  // i taps
  }
  out[q] = tap3(y[0], y[1], y[2]);  // j taps
}

// Two chunks (only 513^3 and past) hold too much for two blocks an SM's
// registers: one block an SM, as K9's.
template <int C>
__global__ void __launch_bounds__(mg::restriction::kMaxThreads, C == 1 ? 2 : 1)
    msplit_restrict_kernel(Args a) {
  extern __shared__ __align__(16) float tile[];
  mg::restriction::restrict_body<mg::restriction::MSplit, C>(a, tile);
}

}  // namespace

// The first form: out <- the coarse fold RHS of the pairs (er, eb), (rr,
// rb), one thread a stored coarse point.
extern "C" int mg_msplit_residual_restrict(float* out, const float* er, const float* eb,
                                           const float* rr, const float* rb, int n,
                                           float inv_h2, cudaStream_t stream) {
  residual_restrict_msplit_kernel<<<mg::fold_blocks((n + 1) / 2), mg::kThreads, 0,
                                    stream>>>(out, er, eb, rr, rb, n, inv_h2);
  return (int)cudaGetLastError();
}

// The streaming stage: out <- the coarse fold RHS of the pairs (er, eb),
// (rr, rb) on the plan (bci, bcj, bck, chunks, threads, smem) of
// pallas_split._restrict_plan (split); cudaErrorInvalidValue for another
// plan, or an out that meets an input.
extern "C" int mg_msplit_restrict_stage(float* out, const float* er, const float* eb,
                                        const float* rr, const float* rb, int n, float inv_h2,
                                        int bci, int bcj, int bck, int chunks, int threads,
                                        int smem, cudaStream_t stream) {
  using namespace mg::restriction;
  const int S = mg::split::slots(n), nc = (n + 1) / 2;
  const long long fine = (long long)n * n * S, coarse = (long long)nc * nc * (nc - 2);
  for (const float* in : {er, eb, rr, rb})
    if (mg::meet(out, coarse, in, fine)) return (int)cudaErrorInvalidValue;
  const int vec = S % 4 == 0 && (bck >= interior(n) || bck % 4 == 0);
  const Args a{out, {er, eb}, {rr, rb}, n, inv_h2, bci, bcj, bck, vec};
  if (const int err = plan_error(a, true, chunks, threads, smem)) return err;
  return chunks == 1 ? launch(msplit_restrict_kernel<1>, a, threads, smem, stream)
                     : launch(msplit_restrict_kernel<kMaxChunks>, a, threads, smem, stream);
}
