// Red-black Gauss-Seidel half-sweep on a split-colour pair (split.cuh).
//
// Replaces the Pallas kernels multigrid_parallel_tpu/ops/pallas_split.py:
// rb_smooth_split (K7) and rb_smooth_split_from_zero (K8). Those run all
// 2 * n_iter half-sweeps of a stage in one pass over HBM (trapezoidal
// halo in VMEM). This first Hopper form, like the rect K1, runs one launch
// per half-sweep: a colour reads only the other colour, so updating it in
// place is race-free.
//
// Bound: device-memory bytes. A half-sweep reads the other colour and the
// active colour's f and writes the active colour: 4 B each per slot, so
// 6 B per grid point (a slot is two grid points), against the rect K1's
// 10-12 B, whose launch touches every sector of u and f to use half of
// them. One thread per slot, kk fastest: the i +- 1 / j +- 1 neighbour rows
// of a warp are coalesced rows that neighbouring blocks find in L2, and
// every thread of a launch has work but the dead slot and the boundary rows.
//
// K8's first half-sweep reads only f (the initial guess is an implicit
// zero) and writes every slot of its colour; its second writes every slot
// of the other colour (0 where it has no interior point), so neither output
// needs initialising.
#include "split.cuh"

namespace {

using namespace mg::split;

__global__ void split_half_sweep_kernel(float* __restrict__ dst,
                                        const float* __restrict__ src,
                                        const float* __restrict__ f, int n,
                                        float h2, int color, int fresh) {
  const int S = slots(n);
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  int i, j, kk;
  if (!decode(idx, n, S, i, j, kk)) return;
  const int p = parity(i, j, color);
  if (live_interior(i, j, kk, p, n)) {
    dst[idx] = sweep_value(src, f, idx, n, S, kk, p, h2);
  } else if (fresh) {
    dst[idx] = 0.0f;
  }
}

__global__ void split_half_sweep_from_zero_kernel(float* __restrict__ dst,
                                                  const float* __restrict__ f,
                                                  int n, float h2, int color) {
  const int S = slots(n);
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  int i, j, kk;
  if (!decode(idx, n, S, i, j, kk)) return;
  float v = 0.0f;
  if (live_interior(i, j, kk, parity(i, j, color), n)) {
    const float nbr = 0.0f;  // six zero neighbours, summed: +0
    v = (nbr - h2 * f[idx]) * (1.0f / 6.0f);
  }
  dst[idx] = v;
}

}  // namespace

// One half-sweep of `color` (1 = RED, 0 = BLACK): dst (that colour) from
// src (the other colour) and f (dst's RHS). In place when fresh = 0;
// fresh = 1 also writes 0 to every slot it does not update.
extern "C" int mg_split_half_sweep(float* dst, const float* src, const float* f,
                                   int n, float h2, int color, int fresh,
                                   cudaStream_t stream) {
  split_half_sweep_kernel<<<mg::split::slot_blocks(n), mg::kThreads, 0, stream>>>(
      dst, src, f, n, h2, color, fresh);
  return (int)cudaGetLastError();
}

// First half-sweep from a zero initial guess: writes all of dst.
extern "C" int mg_split_half_sweep_from_zero(float* dst, const float* f, int n,
                                             float h2, int color,
                                             cudaStream_t stream) {
  split_half_sweep_from_zero_kernel<<<mg::split::slot_blocks(n), mg::kThreads, 0, stream>>>(
      dst, f, n, h2, color);
  return (int)cudaGetLastError();
}
