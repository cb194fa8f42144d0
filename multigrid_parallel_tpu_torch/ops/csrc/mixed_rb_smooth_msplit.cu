// Mixed-BC red-black Gauss-Seidel half-sweep on a split pair (msplit.cuh),
// its from-zero first half-sweep, and the cross-colour BC pass that ends
// a smoothing stage.
//
// Replaces the Pallas kernels multigrid_parallel_tpu/ops/pallas_mixed_split.py:
// mixed_rb_smooth_msplit (K21) and mixed_rb_smooth_from_zero_msplit (K22).
// Those run all 2 * n_iter half-sweeps of a stage in one pass over HBM,
// then the BC pass. This first Hopper form is K16's, one launch per
// half-sweep, in place on the active colour only:
//   u_c <- (mixed_nbr_sum(pair) - h^2 r_c) * (1/6)   at live interior slots,
// the i, j and k edge reads folded to the reader's own value (0 at a
// pinned x-face node), through mixed.cuh's sum and PairAt, so the
// iterates equal K16's bit for bit (the same six terms in the same
// order). A K22 stage starts from zero: its first launch writes the whole
// first colour from r alone and zeroes the other, whose edge points the
// second half-sweep reads as its centres, so its output needs no
// initialisation.
//
// The BC pass (pallas_mixed_split.py:198-231) copies x faces, then y faces
// from the post-x values, each from the OTHER colour at the same slot
// (the neighbour across a face has the other colour and the same slot),
// then pins the x-face patches to 0. As a gather, one thread per stored
// boundary slot writes both colours: u_c(i, j) = u_c'(c(i), c(j)), the
// colour flipped once per copied coordinate, or 0 where pinned; c maps
// 0 -> 1, n-1 -> n-2. Reads hit interior rows only, so it runs in place.
//
// Bound: device-memory bytes: a half-sweep reads the other colour's
// neighbours (each once from DRAM, the rest from L1/L2), its own f and
// writes its own colour, ~6 B per grid point of the pair, half K16's;
// the BC pass touches ~4 n S boundary slots per colour.
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

__global__ void msplit_half_sweep_from_zero_kernel(float* __restrict__ out,
                                                   float* __restrict__ other,
                                                   const float* __restrict__ f, int n,
                                                   float h2, int color) {
  const int S = slots(n);
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  int i, j, kk;
  if (!decode(idx, n, S, i, j, kk)) return;
  float v = 0.0f;
  if (live_interior(i, j, kk, parity(i, j, color), n)) {
    const float nbr = 0.0f;  // six zero neighbours, summed: +0
    v = (nbr - h2 * f[idx]) * (1.0f / 6.0f);
  }
  out[idx] = v;
  other[idx] = 0.0f;
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

}  // namespace

// One in-place mixed half-sweep of `color` (1 = RED) on the pair (red,
// black) against that colour's RHS f.
extern "C" int mg_msplit_half_sweep(float* red, float* black, const float* f,
                                    const float* packs, int n, float h2, int color,
                                    cudaStream_t stream) {
  msplit_half_sweep_kernel<<<mg::split::slot_blocks(n), mg::kThreads, 0, stream>>>(
      red, black, f, packs, n, h2, color);
  return (int)cudaGetLastError();
}

// First half-sweep of `color` from a zero pair: writes all of `out` (that
// colour) and zeroes `other`.
extern "C" int mg_msplit_half_sweep_from_zero(float* out, float* other, const float* f,
                                              int n, float h2, int color,
                                              cudaStream_t stream) {
  msplit_half_sweep_from_zero_kernel<<<mg::split::slot_blocks(n), mg::kThreads, 0, stream>>>(
      out, other, f, n, h2, color);
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
