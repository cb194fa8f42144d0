// Red-black Gauss-Seidel half-sweep on a packed split-colour array (K42).
//
// Replaces the Pallas kernel multigrid_parallel_tpu/ops/pallas_splitcolor.py:
// rb_smooth_split_fused, which runs all 2 * n_iter half-sweeps of a stage
// in one pass over HBM (a slab of block_i + 4 n_iter planes in VMEM).
// This first Hopper form, like K7, runs one launch per half-sweep: a
// colour reads only the other colour, so updating it in place is
// race-free.
//
// The packed array is one contiguous f32 tensor (n, 2n, S), S = (n - 1) / 2:
// the split pair of split.cuh joined along j, red rows [0, n), black rows
// [n, 2n). Flat index ((i * 2n + half * n + j) * S + kk), half 0 = red,
// 1 = black. The i +- 1 neighbours are +- 2nS away, j +- 1 are +- S, and
// the other colour at the same (i, j, kk) is +- nS. Slot map, parity,
// liveness and the dead-slot invariant are the pair's (split.cuh).
//
// Bound: device-memory bytes. A half-sweep reads the other colour and the
// active colour's f and writes the active colour, 6 B per grid point, as
// K7; a stage of 2 n_iter launches moves 2 n_iter times the bytes of one
// half of the array, twice the one-pass stage's bytes at n_iter = 2.
// Temporal blocking (all half-sweeps in one pass) is the follow-up. One
// thread per slot of the active colour, kk fastest: coalesced rows whose
// i +- 1 and j +- 1 neighbours later blocks find in L2.
#include "split.cuh"

namespace {

using namespace mg::split;

// split.cuh numbers the colours RED = 1, BLACK = 0; the packed layout puts
// red first. This is the one place that maps a colour to its half.
__host__ __device__ inline int packed_half(int color) {
  return color == kRed ? 0 : 1;
}

__global__ void splitcolor_half_sweep_kernel(float* __restrict__ u,
                                             const float* __restrict__ f,
                                             int n, float h2, int color) {
  const int S = slots(n);
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  int i, j, kk;
  if (!decode(idx, n, S, i, j, kk)) return;
  const int p = parity(i, j, color);
  if (!live_interior(i, j, kk, p, n)) return;
  const int half = packed_half(color);
  const int nS = n * S;
  const int pos = (i * 2 * n + half * n + j) * S + kk;
  const int o = half == 0 ? pos + nS : pos - nS;  // the other colour, same slot
  // k-neighbours: the other colour at {kk - 1, kk} where p = 0 and
  // {kk, kk + 1} where p = 1; past either end of the row, the zero k face
  float k_other;
  if (p == 0) {
    k_other = kk > 0 ? u[o - 1] : 0.0f;
  } else {
    k_other = kk + 1 < S ? u[o + 1] : 0.0f;
  }
  // the Pallas splitcolor order: i - 1, i + 1, j - 1, j + 1 left to right,
  // then the k pair summed first and added as one term
  float s = u[o - 2 * nS] + u[o + 2 * nS];
  s = s + u[o - S];
  s = s + u[o + S];
  s = s + (u[o] + k_other);
  u[pos] = (s - h2 * f[pos]) * (1.0f / 6.0f);
}

}  // namespace

// One in-place half-sweep of `color` (1 = RED, 0 = BLACK) on the packed
// array u with its packed RHS f.
extern "C" int mg_splitcolor_half_sweep(float* u, const float* f, int n, float h2,
                                        int color, cudaStream_t stream) {
  splitcolor_half_sweep_kernel<<<mg::split::slot_blocks(n), mg::kThreads, 0, stream>>>(
      u, f, n, h2, color);
  return (int)cudaGetLastError();
}
