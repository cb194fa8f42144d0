// Shared pieces of the mixed-BC split-colour kernels K21-K25
// (mixed_rb_smooth_msplit.cu, residual_restrict_msplit.cu,
// mixed_prolong_smooth_msplit.cu, residual_df_norm_msplit.cu): the
// electrospray correction and solution fields of the finest level as
// (red, black) PAIRS in split.cuh's layout, (n, n, S) per colour with
// S = (n - 1) / 2, slot kk of colour c in row (i, j) holding fine
// k = 2 kk + 1 + p, p = parity(i, j, c).
//
// The pair stores every i and j row, boundary rows included, and no k
// face: as in the fold layout (mixed.cuh), the mixed BC makes a k-face
// node a copy of its stored neighbour, so a k-edge read returns the
// reader's own value. So the mixed kernels read a pair at grid point
// (i, j, k), 1 <= k <= n-2, through PairAt, and reuse mixed.cuh's sums:
// the iterates equal the fold kernels' (K16-K20) bit for bit.
//
// Invariant, as for split.cuh: the dead slot of every row (the colour
// that holds the row's even k's, slot S - 1, k = n - 1) is exactly 0. No
// kernel writes a live value there.
//
// The x-face Dirichlet pin masks come as two parity packs, (2, 2, n, S)
// f32: packs[p][face][j][kk] = pin(face, j, k = 2 kk + 1 + p), 0 past
// k = n - 2 (ops/pallas_mixed_split.py: msplit_pin_packs).
#pragma once

#include "mixed.cuh"
#include "split.cuh"

namespace mg {
namespace msplit {

using split::slots;

// Flat slot index of colour data at grid point (i, j, k) of the pair, and
// the colour (1 = RED = (i + j + k) odd) that holds it.
__device__ inline int slot_of(int i, int j, int k, int n, int& color) {
  color = (i + j + k) & 1;
  const int p = split::parity(i, j, color);
  return (i * n + j) * slots(n) + ((k - 1 - p) >> 1);
}

// A split pair read at grid point (i, j, k), 1 <= k <= n-2.
struct PairAt {
  const float* red;
  const float* black;
  int n;
  __device__ float operator()(int i, int j, int k) const {
    int c;
    const int idx = slot_of(i, j, k, n, c);
    return c ? red[idx] : black[idx];
  }
};

}  // namespace msplit
}  // namespace mg
