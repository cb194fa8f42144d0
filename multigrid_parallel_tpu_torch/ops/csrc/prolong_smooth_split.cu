// Trilinear prolongation of a rect coarse correction into a split-colour
// pair, added to the fine correction, and the first half-sweep of the
// black-first RB stage: two launches that write a fresh pair.
//
// Replaces, with K7 half-sweeps for the rest of the stage, the Pallas
// kernel multigrid_parallel_tpu/ops/pallas_split.py: prolong_smooth_split
// (K10), which computes post_smooth(e + P ec, r) on the pair in one pass.
// Interpolation in its order (pallas_split.py:672-697): j, then i, then
// k. An even fine j or i copies the coincident coarse value, an odd one
// averages its two coarse neighbours (0.5 a + 0.5 b in j, as the MXU band
// product sums, 0.5 (a + b) in i); in k, slot kk of a colour with parity
// p holds fine k = 2 kk + 1 + p, so p = 0 takes 0.5 (y[kk] + y[kk+1]) and
// p = 1 takes y[kk+1]. Each step rounds once; the plain version takes the
// same steps in the same order, so the two agree bit for bit. The
// correction is added at live interior slots only; everywhere else the
// slot keeps e + 0.
//
// Launch 1 writes red' = e_r + P ec. Launch 2 is the stage's first black
// half-sweep, which overwrites every live black slot from red' and r_b
// alone, so the corrected black values are never needed: it writes black'
// = the smoothed value there and e_b + 0 elsewhere. (The rect K4 has no
// such shortcut: its black points recompute six neighbours'
// interpolations.) The stage's other 2 n_iter - 1 half-sweeps are K7
// launches on (red', black').
//
// Bound: device-memory bytes: launch 1 reads e_r and a red point's up to 8
// coarse values (mostly L1/L2 hits) and writes red', 4 B per grid point;
// launch 2 reads red' and r_b and writes black', 6 B per grid point.
#include "split.cuh"

namespace {

using namespace mg::split;

// (P ec) at slot kk of parity p in fine row (i, j): j, then i, then k.
__device__ inline float interp(const float* __restrict__ ec, int nc, int i,
                               int j, int kk, int p) {
  const int ci0 = i >> 1, cj0 = j >> 1;
  const bool oi = i & 1, oj = j & 1;
  float yk[2];  // at coarse k = kk, kk + 1
#pragma unroll
  for (int b = 0; b < 2; ++b) {
    if (b == 0 && p == 1) continue;
    float yi[2];
#pragma unroll
    for (int a = 0; a < 2; ++a) {
      if (a == 1 && !oi) break;
      const float* col = ec + (ci0 + a) * nc * nc + (kk + b);  // stride nc in j
      yi[a] = oj ? 0.5f * col[cj0 * nc] + 0.5f * col[(cj0 + 1) * nc] : col[cj0 * nc];
    }
    yk[b] = oi ? 0.5f * (yi[0] + yi[1]) : yi[0];
  }
  return p == 0 ? 0.5f * (yk[0] + yk[1]) : yk[1];
}

__global__ void split_prolong_correct_red_kernel(float* __restrict__ out_r,
                                                 const float* __restrict__ ec,
                                                 const float* __restrict__ er,
                                                 int n) {
  const int S = slots(n);
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  int i, j, kk;
  if (!decode(idx, n, S, i, j, kk)) return;
  const int p = parity(i, j, kRed);
  const float c = live_interior(i, j, kk, p, n) ? interp(ec, (n + 1) / 2, i, j, kk, p) : 0.0f;
  out_r[idx] = er[idx] + c;
}

__global__ void split_black_sweep_kernel(float* __restrict__ out_b,
                                         const float* __restrict__ red,
                                         const float* __restrict__ eb,
                                         const float* __restrict__ fb, int n,
                                         float h2) {
  const int S = slots(n);
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  int i, j, kk;
  if (!decode(idx, n, S, i, j, kk)) return;
  const int p = parity(i, j, kBlack);
  out_b[idx] = live_interior(i, j, kk, p, n) ? sweep_value(red, fb, idx, n, S, kk, p, h2)
                                             : eb[idx] + 0.0f;
}

}  // namespace

// out_r <- e_r + P ec (the correction at live interior slots). out_r must
// not alias e_r.
extern "C" int mg_split_prolong_correct_red(float* out_r, const float* ec,
                                            const float* er, int n,
                                            cudaStream_t stream) {
  split_prolong_correct_red_kernel<<<mg::split::slot_blocks(n), mg::kThreads, 0,
                                     stream>>>(out_r, ec, er, n);
  return (int)cudaGetLastError();
}

// out_b <- the black half-sweep of (red, black) at live interior slots,
// e_b + 0 elsewhere. out_b must not alias e_b.
extern "C" int mg_split_black_sweep(float* out_b, const float* red,
                                    const float* eb, const float* fb, int n,
                                    float h2, cudaStream_t stream) {
  split_black_sweep_kernel<<<mg::split::slot_blocks(n), mg::kThreads, 0, stream>>>(
      out_b, red, eb, fb, n, h2);
  return (int)cudaGetLastError();
}
