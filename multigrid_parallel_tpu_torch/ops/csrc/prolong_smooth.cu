// Trilinear prolongation of the coarse correction, added to the fine
// correction, and the black-first RB smoothing stage on the result (K4):
// one launch, one pass, a fresh fine field.
//
// Replaces the Pallas kernel multigrid_parallel_tpu/ops/pallas3d.py:
// prolong_smooth_fused_padded (K4, :1075), which computes rb_smooth(e + P
// ec, r, h, n_iter, black first) in one pass over HBM.
//
// The stage is rect.cuh's tile body (black first; the wavefront, or up to
// 129^3 the box) with one step more as each plane of e arrives in shared
// memory: every point of the loaded box, of both colours and on the
// boundary too, becomes e + P ec, computed once (the plain version adds P
// ec everywhere and keeps the boundary values).
//
// Interpolation in the order of mg::interp_at (stencil.cuh): j, then k,
// then i; an even fine index copies the coincident coarse value, an odd one
// is 0.5 a + 0.5 b of its two coarse neighbours, each step rounding once,
// so it agrees bit for bit with the plain version's separable products. A
// lane corrects 4 slots of each colour of a tile row, the fine k 2 g + 1 ..
// 2 g + 8, from the j-interpolated values y at the 5 coarse k g .. g + 4
// (an odd k takes 0.5 y[m] + 0.5 y[m + 1], an even one y[m + 1]); the k = 0
// point (slot -1) is one lane's extra; a warp covers rows as its sweeps
// do. The coarse planes stream through a ring of 3 in shared memory beside
// the fine rings (the box holds all it needs), each copied with the first
// fine plane that needs it (4-byte cp.async: a coarse row of nc floats is
// not 16-byte aligned): coarse c serves fine planes 2 c - 1 .. 2 c + 1.
//
// Bound: device-memory bytes, those the function needs: e and r read, the
// output written, 12 B a fine point, and ec read, 4 B a coarse point:
// 212.3 MB at 257^3, 0.0634 ms at 3.35 TB/s (chip_smoke.py, bound). The
// design answers the first form's costs (a correction launch that
// recomputed the interpolation of every neighbour of a black point, six
// times a point, then 2 n_iter - 1 K1 half-sweep launches, each a pass over
// e, r and the field): one pass, each corrected value computed once,
// neighbours from shared memory, one launch a call. n_iter > 2 continues
// with ceil(n_iter / 2) - 1 launches of K2's stage kernel on its initial
// guess, black first (rb_smooth.cu, mg_rect_stage), counted as K4's.
#include "rect.cuh"

namespace {

using namespace mg::rect;

struct ProlongPrep {
  static constexpr bool kActive = true;
  const float* ec;
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
    const int cols = t.kb - cka + 1, rows_c = (t.jb >> 1) - cja + 1;
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, nwarps = blockDim.x >> 5;
    for (int c = c_lo; c <= c_hi; ++c) {
      for (int r = warp; r < rows_c; r += nwarps) {  // a warp a row, lanes along k
        float* d = plane(c) + r * width;
        const float* src = ec + (c * nc + cja + r) * nc + cka;
        for (int k = lane; k < cols; k += 32) cp_async4(d + k, src + k);
      }
    }
  }

  // e + P ec at every point of the loaded box of plane q, in place, the
  // rows spread over a warp's lanes as the sweeps' are.
  __device__ void apply(float* t0, float* t1, int q, const Geom& t, const RowLanes& rl,
                        int color0) const {
    const int warp = threadIdx.x >> 5, nwarps = blockDim.x >> 5;
    for (int j = t.ja + warp * rl.rows + rl.sub; j < t.jb; j += nwarps * rl.rows)
      apply_row(t0, t1, q, j, t, rl, color0);
  }

  // The same for row j of plane q.
  __device__ void apply_row(float* t0, float* t1, int q, int j, const Geom& t,
                            const RowLanes& rl, int color0) const {
    const bool oi = q & 1, oj = j & 1;
    const int par = (q + j) & 1;  // the colour with p = 1 (even k) is RED where par = 1
    float* even = ((par ^ color0) ? t1 : t0) + (j - t.jb0) * t.W - t.kb0;
    float* odd = ((par ^ 1 ^ color0) ? t1 : t0) + (j - t.jb0) * t.W - t.kb0;
    const float* c[2] = {plane(q >> 1) + ((j >> 1) - cja) * width - cka,
                         plane((q >> 1) + 1) + ((j >> 1) - cja) * width - cka};
    // the j step at coarse k: its value in coarse plane a
    auto yj = [&](int a, int k) {
      return oj ? 0.5f * c[a][k] + 0.5f * c[a][width + k] : c[a][k];
    };
    for (int g = cka + 4 * rl.sl; g < t.kb; g += 4 * rl.lanes) {
      float y[2][5];
#pragma unroll
      for (int a = 0; a < 2; ++a) {
        if (a == 1 && !oi) break;
        const float4 v = ld4(c[a] + g);
        float y5 = c[a][g + 4];
        if (oj) {
          const float4 w = ld4(c[a] + width + g);
          y[a][0] = 0.5f * v.x + 0.5f * w.x;
          y[a][1] = 0.5f * v.y + 0.5f * w.y;
          y[a][2] = 0.5f * v.z + 0.5f * w.z;
          y[a][3] = 0.5f * v.w + 0.5f * w.w;
          y5 = 0.5f * y5 + 0.5f * c[a][width + g + 4];
        } else {
          y[a][0] = v.x;
          y[a][1] = v.y;
          y[a][2] = v.z;
          y[a][3] = v.w;
        }
        y[a][4] = y5;
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
    if (t.ka < 0 && rl.sl == rl.lanes - 1) {  // k = 0: the even colour's slot -1, coarse k = 0
      const float v = oi ? 0.5f * yj(0, 0) + 0.5f * yj(1, 0) : yj(0, 0);
      even[-1] = even[-1] + v;
    }
  }
};

template <int NITER, bool BOX>
__global__ void __launch_bounds__(kStageMaxThreads) rect_prolong_stage_kernel(StageArgs a,
                                                                              ProlongPrep prep) {
  extern __shared__ __align__(16) float tile[];
  if constexpr (BOX) {
    box_body<NITER, false>(a, tile, prep);
  } else {
    stage_body<NITER, false>(a, tile, prep);
  }
}

template <int NITER>
int launch_prolong_stage(const StageArgs& a, int box, int threads, int smem, cudaStream_t stream,
                         const ProlongPrep& prep) {
  return box ? launch_stage(rect_prolong_stage_kernel<NITER, true>, a, threads, smem, stream, prep)
             : launch_stage(rect_prolong_stage_kernel<NITER, false>, a, threads, smem, stream,
                            prep);
}

}  // namespace

// The K4 stage: out <- n_iter (1 or 2) black-first RB-GS iterations of e +
// P ec against r, on the plan (bi, bj, bk, k_halo, threads, smem, box) of
// pallas_split._stage_plan (rect, prolong). out must not alias e.
extern "C" int mg_rect_prolong_stage(float* out, const float* ec, const float* e, const float* r,
                                     int n, float h2, int n_iter, int bi, int bj, int bk,
                                     int k_halo, int threads, int smem, int box,
                                     cudaStream_t stream) {
  StageArgs a{};
  a.out = out;
  a.in = e;
  a.f = r;
  a.color0 = mg::split::kBlack;
  a.n = n;
  a.h2 = h2;
  a.bi = bi;
  a.bj = bj;
  a.bk = bk;
  a.k_halo = k_halo;
  const int rows = coarse_rows(bj, 2 * n_iter), width = coarse_width(tile_width(n, bk, k_halo));
  const int depth = coarse_planes(bi, 2 * n_iter, box);
  if (n % 2 == 0 || e == nullptr) return (int)cudaErrorInvalidValue;
  if (const int err = stage_plan_error(a, n_iter, threads,
                                       smem - (long long)depth * rows * width * 4, box))
    return err;
  const ProlongPrep prep{ec, (n + 1) / 2, rows, width, depth, nullptr, 0, 0};
  return n_iter == 1 ? launch_prolong_stage<1>(a, box, threads, smem, stream, prep)
                     : launch_prolong_stage<2>(a, box, threads, smem, stream, prep);
}
