// Mixed-BC prolongation of a coarse FOLD correction into a split pair,
// added to the fine correction, and the first half-sweep of the
// black-first mixed stage: two launches that write a fresh pair.
//
// Replaces, with K21 half-sweeps and its BC pass for the rest of the
// stage, the Pallas kernel multigrid_parallel_tpu/ops/pallas_mixed_split.py:
// mixed_prolong_smooth_msplit (K24). Interpolation in its order
// (pallas_mixed_split.py:734-790), with Y the coarse fold ec (nc, nc,
// nc - 2; slot a holds coarse plane kc = a + 1) interpolated along j
// (even fine j copies, odd 0.5 a + 0.5 b), then i (odd 0.5 (a + b)):
//   p = 1 slots (fine k = 2 kk + 2 = 2 kc) take Y[kk];
//   p = 0 slots (fine k = 2 kk + 1, between kc = kk and kk + 1) take
//       0.5 (Y[lo] + Y[hi]) + 0.5 d, lo = max(kk - 1, 0), hi = min(kk,
//       nc - 3): the unstored coarse k faces kc = 0 and nc - 1 fold to
//       their stored neighbours (slots 0 and nc - 3), and d fixes the x
//       faces' k edges where the BC pins after the z copy. d is D[0] at
//       kk = 0 and D[nc - 3] at kk = nc - 2, 0 elsewhere, D interpolated
//       as Y from the planes sgn[face] * ec[neighbour] at the coarse x faces
//       (0 elsewhere), sgn the coarse level's fold_edge_sign_planes. Pallas
//       adds D only where a static flag says the planes are not all zero;
//       with zero planes d is 0 and the sum the same.
// The coarse field is indexed by its own shape: nc - 2 = S - 1 slots
// against the pair's S (equal on the TPU only after its 128-lane
// round-up), so slot nc - 2 of a p = 0 row takes Y[nc - 3], and a dead
// p = 1 slot reads nothing.
//
// Launch 1 writes red' = e_r + c at the live interior slots (c the
// correction) and e_r + 0 elsewhere. Launch 2 is the stage's first black
// half-sweep, black' = (mixed_nbr_sum - h^2 r_b) * (1/6) with red' for
// the neighbours and the corrected black value for the centre, which the
// folded edge reads return; e_b + 0 off the live interior. The plain
// version takes the same steps in the same order: the two agree bit for
// bit. The stage's other 2 n_iter - 1 half-sweeps and its BC pass are
// K21's launches on (red', black').
//
// Bound: device-memory bytes: launch 1 reads e_r and each point's up to 8
// coarse values (mostly L1/L2 hits) and writes red'; launch 2 reads red',
// e_b and r_b and writes black': ~7 B per grid point of the pair.
#include "msplit.cuh"

namespace {

using namespace mg::split;
using mg::msplit::PackPinAt;
using mg::msplit::PairAt;

// The j- then i-interpolation of a coarse fold plane set at fine row
// (i, j), slot a; Coarse(ci, cj, a) returns the coarse value.
template <class Coarse>
__device__ inline float interp_ji(const Coarse& c, int i, int j, int a) {
  const int ci0 = i >> 1, cj0 = j >> 1;
  float y[2];
#pragma unroll
  for (int b = 0; b < 2; ++b) {
    if (b == 1 && !(i & 1)) break;
    y[b] = (j & 1) ? 0.5f * c(ci0 + b, cj0, a) + 0.5f * c(ci0 + b, cj0 + 1, a)
                   : c(ci0 + b, cj0, a);
  }
  return (i & 1) ? 0.5f * (y[0] + y[1]) : y[0];
}

struct CoarseAt {
  const float* ec;
  int nc;
  __device__ float operator()(int ci, int cj, int a) const {
    return ec[(ci * nc + cj) * (nc - 2) + a];
  }
};

// sgn[face] * ec[neighbour plane] on the coarse x faces, 0 inside.
struct DeltaAt {
  const float* ec;
  const float* sgn;
  int nc;
  __device__ float operator()(int ci, int cj, int a) const {
    if (ci != 0 && ci != nc - 1) return 0.0f;
    const int face = ci == 0 ? 0 : 1, nb = ci == 0 ? 1 : nc - 2;
    const int nk = nc - 2;
    return sgn[(face * nc + cj) * nk + a] * ec[(nb * nc + cj) * nk + a];
  }
};

// The correction at live interior slot kk of parity p in row (i, j).
__device__ inline float correction(const float* ec, const float* sgn, int n, int i, int j,
                                   int kk, int p) {
  const int nc = (n + 1) / 2;
  const CoarseAt c{ec, nc};
  if (p == 1) return interp_ji(c, i, j, kk);
  const int lo = kk > 0 ? kk - 1 : 0, hi = kk < nc - 3 ? kk : nc - 3;
  const float avg = 0.5f * (interp_ji(c, i, j, lo) + interp_ji(c, i, j, hi));
  float d = 0.0f;  // D is 0 away from the fine rows next to the x faces
  if ((kk == 0 || kk == nc - 2) && (i <= 1 || i >= n - 2)) {
    d = interp_ji(DeltaAt{ec, sgn, nc}, i, j, kk == 0 ? 0 : nc - 3);
  }
  return avg + 0.5f * d;
}

__global__ void msplit_prolong_correct_red_kernel(float* __restrict__ out_r,
                                                  const float* __restrict__ ec,
                                                  const float* __restrict__ sgn,
                                                  const float* __restrict__ er, int n) {
  const int S = slots(n);
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  int i, j, kk;
  if (!decode(idx, n, S, i, j, kk)) return;
  const int p = parity(i, j, kRed);
  const float c = live_interior(i, j, kk, p, n) ? correction(ec, sgn, n, i, j, kk, p) : 0.0f;
  out_r[idx] = er[idx] + c;
}

// The pair during launch 2: red' for the neighbours, the corrected black
// value at the centre (the only black point the sum reads).
struct CorrectedAt {
  const float* red;
  const float* eb;
  const float* ec;
  const float* sgn;
  int n;
  __device__ float operator()(int i, int j, int k) const {
    int c;
    const int idx = mg::msplit::slot_of(i, j, k, n, c);
    if (c == kRed) return red[idx];
    const int p = parity(i, j, kBlack);
    return eb[idx] + correction(ec, sgn, n, i, j, (k - 1 - p) >> 1, p);
  }
};

__global__ void msplit_prolong_correct_black_kernel(
    float* __restrict__ out_b, const float* __restrict__ red, const float* __restrict__ ec,
    const float* __restrict__ sgn, const float* __restrict__ eb,
    const float* __restrict__ fb, const float* __restrict__ packs, int n, float h2) {
  const int S = slots(n);
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  int i, j, kk;
  if (!decode(idx, n, S, i, j, kk)) return;
  const int p = parity(i, j, kBlack);
  if (!live_interior(i, j, kk, p, n)) {
    out_b[idx] = eb[idx] + 0.0f;
    return;
  }
  const float nbr = mg::mixed_nbr_sum(CorrectedAt{red, eb, ec, sgn, n}, PackPinAt{packs, n},
                                      i, j, 2 * kk + 1 + p, n);
  out_b[idx] = (nbr - h2 * fb[idx]) * (1.0f / 6.0f);
}

}  // namespace

// out_r <- e_r + P ec (the correction at live interior slots). out_r must
// not alias e_r.
extern "C" int mg_msplit_prolong_correct_red(float* out_r, const float* ec, const float* sgn,
                                             const float* er, int n, cudaStream_t stream) {
  msplit_prolong_correct_red_kernel<<<mg::split::slot_blocks(n), mg::kThreads, 0, stream>>>(
      out_r, ec, sgn, er, n);
  return (int)cudaGetLastError();
}

// out_b <- the first black mixed half-sweep of (red', e_b + P ec) at live
// interior slots, e_b + 0 elsewhere. out_b must not alias e_b or red.
extern "C" int mg_msplit_prolong_correct_black(float* out_b, const float* red,
                                               const float* ec, const float* sgn,
                                               const float* eb, const float* fb,
                                               const float* packs, int n, float h2,
                                               cudaStream_t stream) {
  msplit_prolong_correct_black_kernel<<<mg::split::slot_blocks(n), mg::kThreads, 0, stream>>>(
      out_b, red, ec, sgn, eb, fb, packs, n, h2);
  return (int)cudaGetLastError();
}
