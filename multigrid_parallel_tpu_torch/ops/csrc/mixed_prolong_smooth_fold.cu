// Mixed-BC prolongation of the coarse fold correction, added to the fine
// one, and the black-first mixed smoothing stage on the result (K19), on
// the fold layout (mixed.cuh): one launch, one pass, a fresh fine (n, n,
// n - 2) field from the coarse (nc, nc, nc - 2) correction ec.
//
// Replaces the Pallas kernel multigrid_parallel_tpu/ops/pallas_mixed_fold.py:
// mixed_prolong_smooth_fold (K19), K15 on the fold layout.
//
// The stage is rect.cuh's on the fold layout (kFold: the folded reads in the
// sweeps, the BC pass at store time; the wavefront, or up to 129^3 the
// box), black first, with K4's step (prolong_smooth.cu) as each plane of e
// arrives in shared memory: every stored point of the loaded box with i
// and j interior becomes e + P ec, computed once. The boundary nodes are
// neither read by a sweep nor stored from the tile (the store gives them
// their sources' final values), so they take no correction.
//
// The trilinear interpolation (mg::interp_at's order: j, then k, then i,
// one rounding a step) reads coarse k faces that the fold does not store.
// The coarse planes stream through a ring of 3 (the box holds all it
// needs), each copied with the first fine plane that needs it, a coarse
// row as the grid's k = max(ka, 0) .. kb, the k-face columns copies of
// the stored slots 0 and nc - 3 (4-byte cp.async). Where the BC pins an
// x-face node after the z copy, the true k-face value differs from that
// copy: it is v + sgn * (the adjacent interior i plane's value), sgn the
// coarse level's fold_edge_sign_planes (2, nc, nc - 2), read at columns 0
// and nc - 3 (pallas_mixed_fold.unpack_coarse computes the same
// expression). Only fine planes 1 and n - 2 interpolate a coarse x face
// (coarse 0 and nc - 1), each together with its interior neighbour
// (coarse 1 and nc - 2), which the ring holds beside it: both are copied
// by then (coarse 0 with the block's first fine plane, 1 with fine plane
// 1; nc - 2 with fine plane n - 4, nc - 1 with n - 2), so the correction
// adds sgn * the neighbour's column there, in registers.
//
// Bound: device-memory bytes, those the function needs: e and r read, the
// output written, 12 B a stored fine point, ec read, 4 B a stored coarse
// point, and the pins of the two x faces and the coarse sign planes
// (chip_smoke.py, bound). n_iter > 2 continues with ceil(n_iter / 2) - 1
// launches of K17's stage kernel on its initial guess, black first
// (mixed_rb_smooth_fold.cu, mg_fold_stage), counted as K19's.
#include "mixed.cuh"
#include "rect.cuh"

namespace {

using namespace mg::rect;

struct FoldProlongPrep {
  static constexpr bool kActive = true;
  const float* ec;   // the coarse fold correction
  const float* sgn;  // its level's sign planes
  int nc, rows, width, depth;  // coarse field size; the tile's rows, row width, planes
  float* tile;
  int cja, cka;  // coarse row and k of tile row 0 and column 0

  __device__ float* plane(int c) const { return tile + (c % depth) * rows * width; }

  __device__ void start(float* extra, const Geom& t) {
    tile = extra;
    cja = t.ja >> 1;
    cka = max(t.ka, 0);
  }

  __device__ void load(int q, const Geom& t) const {
    // fine plane q needs coarse q >> 1 and (q + 1) >> 1: the first plane
    // loaded copies both, an odd one the second (an even one finds both)
    if (q != t.ia && !(q & 1)) return;
    const int c_lo = q == t.ia ? q >> 1 : (q + 1) >> 1, c_hi = (q + 1) >> 1;
    const int cols = t.kb - cka + 1, rows_c = (t.jb >> 1) - cja + 1, nk = nc - 2;
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, nwarps = blockDim.x >> 5;
    for (int c = c_lo; c <= c_hi; ++c) {
      for (int r = warp; r < rows_c; r += nwarps) {  // a warp a row, lanes along k
        float* d = plane(c) + r * width;
        const float* src = ec + (c * nc + cja + r) * nk;
        for (int k = lane; k < cols; k += 32) cp_async4(d + k, src + min(max(cka + k - 1, 0), nk - 1));
      }
    }
  }

  // e + P ec at every interior point of the loaded box of plane q, in
  // place, the rows spread over a warp's lanes as the sweeps' are.
  __device__ void apply(float* t0, float* t1, int q, const Geom& t, const RowLanes& rl,
                        int color0) const {
    const int warp = threadIdx.x >> 5, nwarps = blockDim.x >> 5;
    for (int j = t.ja + warp * rl.rows + rl.sub; j < t.jb; j += nwarps * rl.rows)
      apply_row(t0, t1, q, j, t, rl, color0);
  }

  // The same for row j of plane q: the slots of both colours at g .. g + 3,
  // the fine k 2 g + 1 .. 2 g + 8, from the coarse values at k g .. g + 4.
  __device__ void apply_row(float* t0, float* t1, int q, int j, const Geom& t,
                            const RowLanes& rl, int color0) const {
    const int n = t.n;
    if (q < 1 || q > n - 2 || j < 1 || j > n - 2) return;
    const bool oi = q & 1, oj = j & 1;
    const int par = (q + j) & 1;  // the colour with p = 1 (even k) is RED where par = 1
    float* even = ((par ^ color0) ? t1 : t0) + (j - t.jb0) * t.W - t.kb0;
    float* odd = ((par ^ 1 ^ color0) ? t1 : t0) + (j - t.jb0) * t.W - t.kb0;
    const int cj = j >> 1;
    const float* c[2] = {plane(q >> 1) + (cj - cja) * width - cka,
                         plane((q >> 1) + 1) + (cj - cja) * width - cka};
    // which of c[0], c[1] is a coarse x face (coarse 0 at fine plane 1,
    // nc - 1 at n - 2), its interior neighbour the other; -1 elsewhere
    const int xf = q == 1 ? 0 : (q == n - 2 ? 1 : -1);
    for (int g = cka + 4 * rl.sl; g < t.kb; g += 4 * rl.lanes) {
      float y[2][5];  // the j step at coarse k g .. g + 4, coarse planes q >> 1 (+ 1)
#pragma unroll
      for (int a = 0; a < 2; ++a) {
        if (a == 1 && !oi) break;
        float v[2][5];  // coarse rows cj and cj + 1
#pragma unroll
        for (int b = 0; b < 2; ++b) {
          if (b == 1 && !oj) break;
          const float4 w = ld4(c[a] + b * width + g);
          v[b][0] = w.x;
          v[b][1] = w.y;
          v[b][2] = w.z;
          v[b][3] = w.w;
          v[b][4] = c[a][b * width + g + 4];
          if (a == xf && (g == 0 || g + 4 >= nc - 1)) {  // a k-face node of an x face
#pragma unroll
            for (int m = 0; m < 5; ++m) {
              const int k = g + m;
              if (k != 0 && k != nc - 1) continue;
              const float s = __ldg(sgn + (xf * nc + cj + b) * (nc - 2) + (k == 0 ? 0 : nc - 3));
              v[b][m] = v[b][m] + s * c[1 - a][b * width + k];
            }
          }
        }
#pragma unroll
        for (int m = 0; m < 5; ++m) y[a][m] = oj ? 0.5f * v[0][m] + 0.5f * v[1][m] : v[0][m];
      }
      float vo[4], ve[4];  // P ec at k = 2 (g + m) + 1 and 2 (g + m) + 2
#pragma unroll
      for (int m = 0; m < 4; ++m) {
        float yo[2], ye[2];
#pragma unroll
        for (int a = 0; a < 2; ++a) {
          if (a == 1 && !oi) break;
          yo[a] = 0.5f * y[a][m] + 0.5f * y[a][m + 1];
          ye[a] = y[a][m + 1];
        }
        vo[m] = oi ? 0.5f * yo[0] + 0.5f * yo[1] : yo[0];
        ve[m] = oi ? 0.5f * ye[0] + 0.5f * ye[1] : ye[0];
      }
      const float4 eo = ld4(odd + g), ee = ld4(even + g);
      st4(odd + g, make_float4(eo.x + vo[0], eo.y + vo[1], eo.z + vo[2], eo.w + vo[3]));
      st4(even + g, make_float4(ee.x + ve[0], ee.y + ve[1], ee.z + ve[2], ee.w + ve[3]));
    }
  }
};

template <int NITER, bool BOX>
__global__ void __launch_bounds__(kStageMaxThreads)
    fold_prolong_stage_kernel(StageArgs a, FoldProlongPrep prep) {
  extern __shared__ __align__(16) float tile[];
  if constexpr (BOX) {
    box_body<NITER, false, Layout::kFold>(a, tile, prep);
  } else {
    stage_body<NITER, false, Layout::kFold>(a, tile, prep);
  }
}

template <int NITER>
int launch_fold_prolong_stage(const StageArgs& a, int box, int threads, int smem,
                              cudaStream_t stream, const FoldProlongPrep& prep) {
  return box ? launch_stage(fold_prolong_stage_kernel<NITER, true>, a, threads, smem, stream,
                            prep)
             : launch_stage(fold_prolong_stage_kernel<NITER, false>, a, threads, smem, stream,
                            prep);
}

}  // namespace

// The K19 stage: out <- n_iter (1 or 2) black-first mixed RB-GS iterations
// of e + P ec against r, ending with the fold BC pass, all in the fold
// layout, ec rebuilt at its k faces with the coarse sign planes sgn, on
// the plan (bi, bj, bk, k_halo, threads, smem, box) of
// pallas_split._stage_plan (rect, prolong). out must not alias e.
extern "C" int mg_fold_prolong_stage(float* out, const float* ec, const float* e, const float* r,
                                     const float* pin, const float* sgn, int n, float h2,
                                     int n_iter, int bi, int bj, int bk, int k_halo, int threads,
                                     int smem, int box, cudaStream_t stream) {
  StageArgs a{};
  a.out = out;
  a.in = e;
  a.f = r;
  a.pin = pin;
  a.color0 = mg::split::kBlack;
  a.n = n;
  a.h2 = h2;
  a.bi = bi;
  a.bj = bj;
  a.bk = bk;
  a.k_halo = k_halo;
  const int rows = coarse_rows(bj, 2 * n_iter), width = coarse_width(tile_width(n, bk, k_halo));
  const int depth = coarse_planes(bi, 2 * n_iter, box);
  if (n % 2 == 0 || n < 5 || e == nullptr || pin == nullptr || sgn == nullptr)
    return (int)cudaErrorInvalidValue;
  if (const int err = stage_plan_error(a, n_iter, threads,
                                       smem - (long long)depth * rows * width * 4, box))
    return err;
  const FoldProlongPrep prep{ec, sgn, (n + 1) / 2, rows, width, depth, nullptr, 0, 0};
  return n_iter == 1 ? launch_fold_prolong_stage<1>(a, box, threads, smem, stream, prep)
                     : launch_fold_prolong_stage<2>(a, box, threads, smem, stream, prep);
}
