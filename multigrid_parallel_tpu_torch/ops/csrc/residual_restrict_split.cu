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
// One thread per coarse point, k fastest. It combines 27 fine residuals
// (3 slots on each of 9 fine rows), each reading 7 slots of the other /
// own colour and one of r: 216 loads, mostly L1/L2 hits, as in the rect
// K3. Bound: those loads; the device-memory floor is 8 B per fine grid
// point (the two pairs read once) plus 4 B per coarse point written.
#include "split.cuh"

namespace {

using namespace mg::split;

__device__ inline float tap3(float a, float b, float c) {
  return (0.25f * a + 0.5f * b) + 0.25f * c;
}

// Residual at slot idx (slot kk, parity p) of the colour (e_c, r_c).
__device__ inline float slot_residual(const float* e_c, const float* e_o,
                                      const float* r_c, int idx, int n, int S,
                                      int kk, int p, float inv_h2) {
  return r_c[idx] - inv_h2 * (nbr_sum(e_o, idx, n, S, kk, p) - 6.0f * e_c[idx]);
}

__global__ void split_residual_restrict_kernel(
    float* __restrict__ out, const float* __restrict__ er,
    const float* __restrict__ eb, const float* __restrict__ rr,
    const float* __restrict__ rb, int n, float inv_h2) {
  const int nc = (n + 1) / 2;
  const int q = blockIdx.x * blockDim.x + threadIdx.x;
  int ci, cj, ck;
  if (!mg::decode(q, nc, ci, cj, ck)) return;
  if (!mg::is_interior(ci, cj, ck, nc)) {
    out[q] = 0.0f;
    return;
  }
  const int S = slots(n);
  float rows_j[3];
#pragma unroll
  for (int dj = 0; dj < 3; ++dj) {
    float rows_i[3];
#pragma unroll
    for (int di = 0; di < 3; ++di) {
      const int i = 2 * ci - 1 + di;
      const int j = 2 * cj - 1 + dj;
      // even k's (p = 1): BLACK where i + j is even, RED where odd
      const bool red_even = (i + j) & 1;
      const float* e_e = red_even ? er : eb;
      const float* e_o = red_even ? eb : er;
      const float* r_e = red_even ? rr : rb;
      const float* r_o = red_even ? rb : rr;
      const int base = (i * n + j) * S;
      const float se = slot_residual(e_e, e_o, r_e, base + ck - 1, n, S, ck - 1, 1, inv_h2);
      const float so0 = slot_residual(e_o, e_e, r_o, base + ck - 1, n, S, ck - 1, 0, inv_h2);
      const float so1 = slot_residual(e_o, e_e, r_o, base + ck, n, S, ck, 0, inv_h2);
      rows_i[di] = 0.5f * se + 0.25f * (so0 + so1);
    }
    rows_j[dj] = tap3(rows_i[0], rows_i[1], rows_i[2]);
  }
  out[q] = tap3(rows_j[0], rows_j[1], rows_j[2]);
}

}  // namespace

extern "C" int mg_split_residual_restrict(float* out, const float* er,
                                          const float* eb, const float* rr,
                                          const float* rb, int n, float inv_h2,
                                          cudaStream_t stream) {
  split_residual_restrict_kernel<<<mg::point_blocks((n + 1) / 2), mg::kThreads, 0,
                                   stream>>>(out, er, eb, rr, rb, n, inv_h2);
  return (int)cudaGetLastError();
}
