// Trilinear prolongation of a rect coarse correction into a split-colour
// pair, added to the fine correction, and the black-first RB smoothing
// stage on the result (K10): one launch, one pass, a fresh pair.
//
// Replaces the Pallas kernel multigrid_parallel_tpu/ops/pallas_split.py:
// prolong_smooth_split (K10, :746), which computes post_smooth(e + P ec, r)
// on the pair in one pass over HBM, whole (j, k) planes in VMEM with a
// halo of 4 n_iter + 1 planes (:756).
//
// The stage is K7's tile body (stage_body in split.cuh, black first) with
// one step more as each plane of both colours arrives in shared memory:
// red' = e_r + P ec at the live interior slots (e_r + 0 elsewhere), black'
// = e_b + 0, the plain version's e + where(live, P ec, 0) (so -0 becomes
// +0). The first black half-sweep overwrites every live black slot from
// red' and r_b alone, so e_b is loaded only where a slot is not live
// (ProlongPrep::kFixedFirst). Interpolation in the Pallas kernel's order
// (pallas_split.py:672-697): j, then i, then k. An even fine j or i copies the coincident
// coarse value, an odd one averages its two coarse neighbours (0.5 a +
// 0.5 b in j, as the MXU band product sums, 0.5 (a + b) in i); in k, slot
// kk of a colour with parity p holds fine k = 2 kk + 1 + p, so p = 0
// takes 0.5 (y[kk] + y[kk+1]) and p = 1 takes y[kk+1]. Each step rounds
// once; the plain version takes the same steps in the same order, so the
// two agree bit for bit. A lane forms y, the j-then-i interpolation, at
// the 5 coarse k its 4 slots need, from coarse planes that stream through
// a ring of 3 in shared memory beside the fine rings.
//
// Bound: device-memory bytes, those the function needs (utils.timing.
// split_stage_bytes, in 32-byte sectors): K7's, black first (the pair
// written, e_r read whole, e_b where not live, rr and rb where live) plus
// ec, 8.59 MB: 178.2 MB at 257^3, 0.0532 ms at 3.35 TB/s.
// The design answers the same costs as K7's (rb_smooth_split.cu): one pass
// instead of a correction launch, a black half-sweep launch and 2 n_iter -
// 1 K7 launches (~515 MB at n_iter 2); neighbours from shared memory; one
// launch a call. The coarse ring costs the fine tile 2 rows (10, not 12,
// at 257^3), and the correction a pass over each arriving plane. n_iter >
// 2 continues with ceil(n_iter / 2) - 1 K7 stage launches (black first),
// counted as K10's.
// nvcc -Xptxas -v (CUDA 12.8, sm_90a; launch bound 640 threads): the four
// split_prolong_stage_kernel instantiations 86-95 registers, no spills;
// shared memory all dynamic, the plan's (219,780 B at 257^3, n_iter 2).
#include "split.cuh"

namespace {

using namespace mg::split;

// (P ec) at slot kk of parity p in fine row (i, j): j, then i, then k;
// get(ci, cj, ck) is the coarse value.
template <class Get>
__device__ inline float interp(const Get& get, int i, int j, int kk, int p) {
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
      yi[a] = oj ? 0.5f * get(ci0 + a, cj0, kk + b) + 0.5f * get(ci0 + a, cj0 + 1, kk + b)
                 : get(ci0 + a, cj0, kk + b);
    }
    yk[b] = oi ? 0.5f * (yi[0] + yi[1]) : yi[0];
  }
  return p == 0 ? 0.5f * (yk[0] + yk[1]) : yk[1];
}

// The correction of each fine plane as it arrives (stage colour 0 is
// black, 1 red): red' = e_r + P ec at the live interior slots, black' = e_b
// + 0, over the whole loaded box. The coarse planes it interpolates from
// stream through a ring of 3 in shared memory (split.cuh, coarse_rows and
// coarse_width: coarse k ka .. kb; 4-byte cp.async: a coarse row of nc
// floats is not 16-byte aligned), each copied with the first fine plane
// that needs it: coarse c serves fine planes 2 c - 1 .. 2 c + 1.
struct ProlongPrep {
  static constexpr bool kActive = true;
  static constexpr bool kFixedFirst = true;  // e_b only where a slot is not live
  const float* ec;
  int nc, rows, width;  // coarse field size; the tile's rows and row width
  float* tile;
  int cja;

  __device__ float* plane(int c) const { return tile + (c % 3) * rows * width; }

  __device__ void start(float* extra, const StageGeom& t) {
    tile = extra;
    cja = t.ja >> 1;
  }

  __device__ void load(int q, const StageGeom& t) const {
    // fine plane q needs coarse q >> 1 and (q + 1) >> 1: the first plane
    // loaded copies both, an odd one the second (an even one finds both)
    if (q != t.ia && !(q & 1)) return;
    const int c_lo = q == t.ia ? q >> 1 : (q + 1) >> 1, c_hi = (q + 1) >> 1;
    const int cols = t.kb - t.ka + 1, count = ((t.jb >> 1) - cja + 1) * cols;
    for (int c = c_lo; c <= c_hi; ++c) {
      for (int v = threadIdx.x; v < count; v += blockDim.x) {
        const int r = v / cols, k = v - r * cols;
        cp_async4(plane(c) + r * width + k, ec + (c * nc + cja + r) * nc + t.ka + k);
      }
    }
  }

  __device__ float red(int q, int j, int kk, int p, const StageGeom& t) const {
    if (!live_interior(q, j, kk, p, t.n)) return 0.0f;
    const auto get = [&](int ci, int cj, int ck) {
      return plane(ci)[(cj - cja) * width + (ck - t.ka)];
    };
    return interp(get, q, j, kk, p);
  }

  template <bool VEC>
  __device__ void apply(float* black, float* red_tile, int q, const StageGeom& t) const {
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, nwarps = blockDim.x >> 5;
    for (int j = t.ja + warp; j < t.jb; j += nwarps) {
      const int p = parity(q, j, kRed);
      const int row = (j - t.jb0) * t.W - t.kb0;
      if constexpr (VEC) {
        // interior rows: the j-then-i interpolation y at coarse k = g ..
        // g + 4 serves the lane's 4 slots (slot kk takes y at kk and kk + 1)
        const bool inner = q >= 1 && q <= t.n - 2 && j >= 1 && j <= t.n - 2;
        const int ci0 = q >> 1, cj0 = j >> 1;
        const bool oi = q & 1, oj = j & 1;
        const float* c0 = plane(ci0) + (cj0 - cja) * width - t.ka;
        const float* c1 = plane(ci0 + 1) + (cj0 - cja) * width - t.ka;
        for (int g = t.ka + 4 * lane; g < t.kb; g += 128) {
          float corr[4] = {0.0f, 0.0f, 0.0f, 0.0f};
          if (inner) {
            float y[5];
#pragma unroll
            for (int m = 0; m < 5; ++m) {
              const int k = g + m;
              float yi[2];
#pragma unroll
              for (int a = 0; a < 2; ++a) {
                if (a == 1 && !oi) break;
                const float* c = a ? c1 : c0;
                yi[a] = oj ? 0.5f * c[k] + 0.5f * c[width + k] : c[k];
              }
              y[m] = oi ? 0.5f * (yi[0] + yi[1]) : yi[0];
            }
#pragma unroll
            for (int m = 0; m < 4; ++m) {
              if (2 * (g + m) + 1 + p <= t.n - 2)
                corr[m] = p == 0 ? 0.5f * (y[m] + y[m + 1]) : y[m + 1];
            }
          }
          const float4 r = ld4(red_tile + row + g), b = ld4(black + row + g);
          st4(red_tile + row + g,
              make_float4(r.x + corr[0], r.y + corr[1], r.z + corr[2], r.w + corr[3]));
          st4(black + row + g, make_float4(b.x + 0.0f, b.y + 0.0f, b.z + 0.0f, b.w + 0.0f));
        }
      } else {
        for (int kk = t.ka + lane; kk < t.kb; kk += 32) {
          red_tile[row + kk] = red_tile[row + kk] + red(q, j, kk, p, t);
          black[row + kk] = black[row + kk] + 0.0f;
        }
      }
    }
  }
};

template <int NITER, bool VEC>
__global__ void __launch_bounds__(kStageMaxThreads) split_prolong_stage_kernel(StageArgs a, ProlongPrep prep) {
  extern __shared__ __align__(16) float tile[];
  stage_body<NITER, VEC>(a, tile, prep);
}

}  // namespace

// The K10 stage: (out_r, out_b) <- n_iter (1 or 2) black-first RB-GS
// iterations of (e_r + P ec, e_b) against (rr, rb), on the plan (bi, bj,
// bk, k_halo, threads, smem) of pallas_split._stage_plan. The outputs must
// not alias the inputs.
extern "C" int mg_split_prolong_stage(float* out_r, float* out_b, const float* ec,
                                      const float* er, const float* eb, const float* rr,
                                      const float* rb, int n, float h2, int n_iter, int bi,
                                      int bj, int bk, int k_halo, int threads, int smem,
                                      cudaStream_t stream) {
  using namespace mg::split;
  StageArgs a;
  a.out[0] = out_b;
  a.out[1] = out_r;
  a.in[0] = eb;
  a.in[1] = er;
  a.f[0] = rb;
  a.f[1] = rr;
  a.color0 = kBlack;
  a.n = n;
  a.h2 = h2;
  a.bi = bi;
  a.bj = bj;
  a.bk = bk;
  a.k_halo = k_halo;
  const int W = k_halo ? bk + 2 * k_halo : slots(n);
  const int rows = coarse_rows(bj, 2 * n_iter), width = coarse_width(W);
  if (const int err = stage_plan_error(a, n_iter, threads, smem - 3 * rows * width * 4))
    return err;
  const ProlongPrep prep{ec, (n + 1) / 2, rows, width, nullptr, 0};
  const bool vec = stage_vec(a);
  if (n_iter == 1) {
    return vec ? launch_stage(split_prolong_stage_kernel<1, true>, a, threads, smem, stream, prep)
               : launch_stage(split_prolong_stage_kernel<1, false>, a, threads, smem, stream, prep);
  }
  return vec ? launch_stage(split_prolong_stage_kernel<2, true>, a, threads, smem, stream, prep)
             : launch_stage(split_prolong_stage_kernel<2, false>, a, threads, smem, stream, prep);
}
