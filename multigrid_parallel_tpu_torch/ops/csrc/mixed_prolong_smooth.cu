// Mixed-BC prolongation + correction and the first half-sweep of the
// black-first mixed stage, in one kernel that writes a fresh fine field.
//
// Replaces, with K13 launches for the rest of the stage, the Pallas kernel
// multigrid_parallel_tpu/ops/pallas_mixed.py: mixed_prolong_smooth_fused
// (K15), which computes the black-first mixed stage of e + P ec in one
// pass: trilinear interpolation with the coarse BOUNDARY taking part (the
// mixed correction's Neumann boundaries are nonzero), j then k then i
// (mg::interp), then the folded half-sweeps (mixed.cuh) and one BC pass.
// The folded sweeps never read the boundary, so no BC pass is needed
// between the correction and the first half-sweep.
//
// This launch: red points and boundary points get the corrected value
// e + P ec (the boundary ones are overwritten by the stage's BC pass);
// black interior points get their first smoothed value
//   (mixed_nbr_sum(e + P ec) - h^2 r) * (1/6),
// each neighbour's corrected value recomputed from e and ec, as K4 does.
// The stage's other 2 * n_iter - 1 half-sweeps and its BC pass are K13's
// launches on the output.
//
// Bound: as K4, loads through L1/L2 (a black point recomputes six
// neighbours' interpolations, up to 8 coarse loads each); the
// device-memory floor is 12 B per fine point (e, r read, output written)
// plus the coarse field and the pin planes.
#include "mixed.cuh"

namespace {

struct CorrectedAt {
  const float* e;
  const float* ec;
  int n, nc;
  __device__ float operator()(int i, int j, int k) const {
    return e[(i * n + j) * n + k] + mg::interp(ec, nc, i, j, k);
  }
};

__global__ void mixed_prolong_correct_black_kernel(
    float* __restrict__ out, const float* __restrict__ ec,
    const float* __restrict__ e, const float* __restrict__ r,
    const float* __restrict__ pin, int n, float h2) {
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  int i, j, k;
  if (!mg::decode(p, n, i, j, k)) return;
  const CorrectedAt at{e, ec, n, (n + 1) / 2};
  if (!mg::is_interior(i, j, k, n) || ((i + j + k) & 1) != 0) {  // 0 = BLACK
    out[p] = at(i, j, k);
    return;
  }
  const float nbr = mg::mixed_nbr_sum(at, mg::full_pins(pin, n), i, j, k, n);
  out[p] = (nbr - h2 * r[p]) * (1.0f / 6.0f);
}

}  // namespace

// out <- e + P ec on red and boundary points, the first black mixed
// half-sweep of that field on black interior points. out must not alias e.
extern "C" int mg_mixed_prolong_correct_black(float* out, const float* ec,
                                              const float* e, const float* r,
                                              const float* pin, int n, float h2,
                                              cudaStream_t stream) {
  mixed_prolong_correct_black_kernel<<<mg::point_blocks(n), mg::kThreads, 0,
                                       stream>>>(out, ec, e, r, pin, n, h2);
  return (int)cudaGetLastError();
}
