// Mixed-BC prolongation of a coarse FOLD correction into a split pair,
// added to the fine correction, and the black-first mixed smoothing stage
// on the result, with the cross-colour BC pass at store time (K24): one
// launch, one pass, a fresh pair.
//
// Replaces the Pallas kernel multigrid_parallel_tpu/ops/pallas_mixed_split.py:
// mixed_prolong_smooth_msplit (K24, :831 -> :849), which computes the
// post-smoothing stage of e + P ec on the pair in one pass over HBM.
//
// The stage is split.cuh's stage_body with MIXED set (K22's, black first:
// the faces' neighbours as selects of the slot's own value, the BC pass at
// the store), with one step more as each plane of both colours arrives in
// shared memory (MsplitProlongPrep): e + P ec at the live interior slots
// of both colours, e + 0 elsewhere, the plain version's e + where(live,
// P ec, 0). Both colours are loaded whole: under the mixed selects the
// first black half-sweep reads its own corrected centre at every
// face-adjacent slot, so K10's load of e_b only where a slot is not live
// (its kFixedFirst) would be wrong here. Interpolation in the Pallas
// kernel's order (pallas_mixed_split.py:734-790), with Y the coarse fold
// ec (nc, nc, nc - 2; slot a holds coarse plane kc = a + 1) interpolated
// along j (even fine j copies, odd 0.5 a + 0.5 b), then i (odd 0.5 (a + b)):
//   p = 1 slots (fine k = 2 kk + 2 = 2 kc) take Y[kk];
//   p = 0 slots (fine k = 2 kk + 1, between kc = kk and kk + 1) take
//       0.5 (Y[lo] + Y[hi]) + 0.5 d, lo = max(kk - 1, 0), hi = min(kk,
//       nc - 3): the unstored coarse k faces kc = 0 and nc - 1 fold to
//       their stored neighbours (slots 0 and nc - 3), and d fixes the x
//       faces' k edges where the BC pins after the z copy. d is D[0] at
//       kk = 0 and D[nc - 3] at kk = nc - 2, 0 elsewhere, D interpolated
//       as Y from the planes sgn[face] * ec[neighbour] at the coarse x faces
//       (0 elsewhere), sgn the coarse level's fold_edge_sign_planes; only
//       the fine rows of planes 1 and n - 2 take a d other than 0, read
//       through __ldg from device memory.
// Each step rounds once; the plain version takes the same steps in the
// same order, so the two agree bit for bit. The coarse field is indexed by
// its own shape: nc - 2 = S - 1 slots against the pair's S. Its planes
// stream through a ring of 3 in shared memory beside the fine rings
// (split.cuh, coarse_rows and coarse_width: K10's sizes, so K10's plans),
// coarse slots ka - 1 .. kb - 1 of the loaded rows; a lane forms Y at the
// 5 coarse slots g - 1 .. g + 3 (clamped) that its 4 slots of both colours
// need.
//
// Bound: device-memory bytes (chip_smoke.bound: each input read once, the
// output written once): e, r, ec, the pin packs and sign planes read, the
// pair written, 212.1 MB at 257^3, 0.0633 ms at 3.35 TB/s. Its first form was
// 2 n_iter + 2 launches a call: a red correction, the first black
// half-sweep with its centre corrected in the thread, 2 n_iter - 1 K21
// half-sweeps in place and the BC pass. n_iter > 2: ceil(n_iter / 2) - 1
// further launches of K22's stage with the pair loaded
// (mixed_rb_smooth_msplit.cu, mg_msplit_stage), black first, counted as
// K24's.
// nvcc -Xptxas -v (CUDA 12.8, sm_90a; launch bound 640 threads): the four
// msplit_prolong_stage_kernel instantiations 82-96 registers, no spills, no
// stack frame; shared memory all dynamic, the plan's (219,780 B at 257^3,
// n_iter 2).
#include "msplit.cuh"

namespace {

using namespace mg::split;

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

// sgn[face] * ec[neighbour plane] on the coarse x faces, 0 inside.
struct DeltaAt {
  const float* ec;
  const float* sgn;
  int nc;
  __device__ float operator()(int ci, int cj, int a) const {
    if (ci != 0 && ci != nc - 1) return 0.0f;
    const int face = ci == 0 ? 0 : 1, nb = ci == 0 ? 1 : nc - 2;
    const int nk = nc - 2;
    return __ldg(sgn + (face * nc + cj) * nk + a) * __ldg(ec + (nb * nc + cj) * nk + a);
  }
};

// The correction of each fine plane as it arrives (stage colour 0 is
// black, 1 red): both colours' e + P ec at the live interior slots, e + 0
// elsewhere, over the whole loaded box. The coarse planes it interpolates
// from stream through a ring of 3 (4-byte cp.async: a coarse row of nc - 2
// floats is not 16-byte aligned), each copied with the first fine plane
// that needs it: coarse c serves fine planes 2 c - 1 .. 2 c + 1. Column 0
// of a ring row holds coarse slot cka = ka - 1 (unused where ka = 0).
struct MsplitProlongPrep {
  static constexpr bool kActive = true;
  static constexpr bool kFixedFirst = false;  // the mixed selects read e_b's live slots
  const float* ec;
  const float* sgn;
  int nc, rows, width;  // coarse field size; the ring's rows and row width
  float* tile;
  int cja, cka;

  __device__ float* plane(int c) const { return tile + (c % 3) * rows * width; }

  __device__ void start(float* extra, const StageGeom& t) {
    tile = extra;
    cja = t.ja >> 1;
    cka = t.ka - 1;
  }

  __device__ void load(int q, const StageGeom& t) const {
    // fine plane q needs coarse q >> 1 and (q + 1) >> 1: the first plane
    // loaded copies both, an odd one the second (an even one finds both)
    if (q != t.ia && !(q & 1)) return;
    const int c_lo = q == t.ia ? q >> 1 : (q + 1) >> 1, c_hi = (q + 1) >> 1;
    const int a0 = max(t.ka - 1, 0), a1 = min(t.kb, nc - 2);  // the coarse slots read
    const int cols = a1 - a0, count = ((t.jb >> 1) - cja + 1) * cols;
    for (int c = c_lo; c <= c_hi; ++c) {
      for (int v = threadIdx.x; v < count; v += blockDim.x) {
        const int r = v / cols, k = v - r * cols;
        cp_async4(plane(c) + r * width + a0 - cka + k,
                  ec + (c * nc + cja + r) * (nc - 2) + a0 + k);
      }
    }
  }

  // The interpolation d of the sign planes at fine row (q, j), coarse slot
  // a (0 or nc - 3), from device memory.
  __device__ float delta(int q, int j, int a) const {
    return interp_ji(DeltaAt{ec, sgn, nc}, q, j, a);
  }

  template <bool VEC>
  __device__ void apply(float* black, float* red, int q, const StageGeom& t) const {
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, nwarps = blockDim.x >> 5;
    const int n = t.n, top = nc - 3;  // the last stored coarse slot
    const bool edge = q == 1 || q == n - 2;  // the planes whose k edges take d
    for (int j = t.ja + warp; j < t.jb; j += nwarps) {
      const int pr = parity(q, j, kRed);
      float* even = (pr ? red : black) + (j - t.jb0) * t.W - t.kb0;  // the p = 1 colour's row
      float* odd = (pr ? black : red) + (j - t.jb0) * t.W - t.kb0;   // p = 0
      const bool inner = q >= 1 && q <= n - 2 && j >= 1 && j <= n - 2;
      const bool oi = q & 1, oj = j & 1;
      const float* c0 = plane(q >> 1) + ((j >> 1) - cja) * width - cka;
      const float* c1 = plane((q >> 1) + 1) + ((j >> 1) - cja) * width - cka;
      // Y at coarse slot a: the j step in each coarse plane, then the i step
      auto y_at = [&](int a) {
        float yi[2];
#pragma unroll
        for (int b = 0; b < 2; ++b) {
          if (b == 1 && !oi) break;
          const float* c = b ? c1 : c0;
          yi[b] = oj ? 0.5f * c[a] + 0.5f * c[width + a] : c[a];
        }
        return oi ? 0.5f * (yi[0] + yi[1]) : yi[0];
      };
      // the correction of slot kk of each colour, given Y at max(kk - 1, 0)
      // and min(kk, top); 0 off the live interior
      auto corr_odd = [&](int kk, float ylo, float yhi) {
        const float d = edge && (kk == 0 || kk == nc - 2) ? delta(q, j, kk == 0 ? 0 : top) : 0.0f;
        return 0.5f * (ylo + yhi) + 0.5f * d;
      };
      if constexpr (VEC) {
        for (int g = t.ka + 4 * lane; g < t.kb; g += 128) {
          float ce[4] = {0.0f, 0.0f, 0.0f, 0.0f}, co[4] = {0.0f, 0.0f, 0.0f, 0.0f};
          if (inner) {
            float y[5];  // Y at coarse slots g - 1 .. g + 3, clamped to [0, top]
#pragma unroll
            for (int m = 0; m < 5; ++m) y[m] = y_at(min(max(g - 1 + m, 0), top));
#pragma unroll
            for (int m = 0; m < 4; ++m) {
              if (g + m <= top) ce[m] = y[m + 1];  // live p = 1 slots: kk <= S - 2
              co[m] = corr_odd(g + m, y[m], y[m + 1]);  // every p = 0 slot is live
            }
          }
          const float4 e = ld4(even + g), o = ld4(odd + g);
          st4(even + g, make_float4(e.x + ce[0], e.y + ce[1], e.z + ce[2], e.w + ce[3]));
          st4(odd + g, make_float4(o.x + co[0], o.y + co[1], o.z + co[2], o.w + co[3]));
        }
      } else {
        for (int kk = t.ka + lane; kk < t.kb; kk += 32) {
          float ce = 0.0f, co = 0.0f;
          if (inner) {
            const float ylo = y_at(max(kk - 1, 0)), yhi = y_at(min(kk, top));
            if (kk <= top) ce = y_at(kk);
            co = corr_odd(kk, ylo, yhi);
          }
          even[kk] = even[kk] + ce;
          odd[kk] = odd[kk] + co;
        }
      }
    }
  }
};

template <int NITER, bool VEC>
__global__ void __launch_bounds__(kStageMaxThreads)
    msplit_prolong_stage_kernel(StageArgs a, MsplitProlongPrep prep) {
  extern __shared__ __align__(16) float tile[];
  stage_body<NITER, VEC, false, true>(a, tile, prep);
}

}  // namespace

// The K24 stage: (out_r, out_b) <- n_iter (1 or 2) black-first mixed RB-GS
// iterations of (e_r, e_b) + P ec against (rr, rb), with the x-face pins
// `packs`, the BC pass at store time; ec the (nc, nc, nc - 2) coarse fold
// correction and sgn its (2, nc, nc - 2) sign planes; on the plan (bi, bj,
// bk, k_halo, threads, smem) of pallas_split._stage_plan with prolong and
// msplit. The outputs must not alias the inputs.
extern "C" int mg_msplit_prolong_stage(float* out_r, float* out_b, const float* ec,
                                       const float* sgn, const float* er, const float* eb,
                                       const float* rr, const float* rb, const float* packs,
                                       int n, float h2, int n_iter, int bi, int bj, int bk,
                                       int k_halo, int threads, int smem, cudaStream_t stream) {
  StageArgs a;
  a.out[0] = out_b;
  a.out[1] = out_r;
  a.in[0] = eb;
  a.in[1] = er;
  a.f[0] = rb;
  a.f[1] = rr;
  a.packs = packs;
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
  const MsplitProlongPrep prep{ec, sgn, (n + 1) / 2, rows, width, nullptr, 0, 0};
  const bool vec = stage_vec(a);
  if (n_iter == 1) {
    return vec ? launch_stage(msplit_prolong_stage_kernel<1, true>, a, threads, smem, stream, prep)
               : launch_stage(msplit_prolong_stage_kernel<1, false>, a, threads, smem, stream,
                              prep);
  }
  return vec ? launch_stage(msplit_prolong_stage_kernel<2, true>, a, threads, smem, stream, prep)
             : launch_stage(msplit_prolong_stage_kernel<2, false>, a, threads, smem, stream,
                            prep);
}
