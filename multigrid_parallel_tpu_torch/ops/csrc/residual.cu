// Interior residual r = f - (1/h^2) (sum6(u) - 6 u), zero on the
// boundary, of an (n, n, n) f32 field.
//
// Replaces the Pallas kernel multigrid_parallel_tpu/ops/pallas3d.py:
// residual_fused_pipelined (R), the unfused half of K3.
//
// Bound: device-memory bytes, 12 per point at best (read u and f, write
// r). One thread per point, k fastest: the row loads of a warp are
// coalesced and the i +- 1 / j +- 1 rows are re-read from L2 by the
// neighbouring blocks, so the kernel streams each field about once.
//
// The other entry, K33, is the same residual on one rank's segmented
// block (seg.cuh), replacing multigrid_parallel_tpu/ops/pallas_sharded.py:
// residual_ext: the owned rows, the i neighbours of rows 0 and L - 1 from
// one-plane halos, interior on global plane indices; every owned point
// equals R's on the whole field bit for bit. As in the JAX package, no
// solve path launches it. Its bound is the bytes the function needs, 12 per
// interior point (read u and f, write r) and 4 per other point of the block
// (write 0).
//
// K33 is one streaming stage a call (resid_stage_kernel) on the plan of
// pallas_split._df_plan(..., stage="resid"): K32's stage
// (residual_df_norm_seg.cu, the geometry in seg_stream.cuh) with one field
// and no norm. A block owns
// a box of bi planes x bj rows (a warp each) x bk k of the rank's interior
// and marches in i; the planes of u go by cp.async into a ring of kRing
// tile planes (the box's rows and k with one of halo on each side, one
// ring: a third of K32's shared memory at most), plane p + 2 in flight
// while plane p is computed, one barrier a plane. Lane l owns the points k
// = ka + l + 32 c of its row; it keeps u of the plane before in registers
// (the i - 1 neighbour), takes i + 1 from the next ring plane, j - 1, j + 1,
// k - 1 and k + 1 from the tile, and f one plane ahead into registers, and
// sums the neighbours in seg_nbr_sum's order. Every point off the interior
// (the boundary and pad planes, the j and k ends) is written 0 by the same
// launch with no load. On an H100 at 257^3 the stage takes 0.0346 ms a call
// on rank 1's block of four (L = 96) and 0.0979 on the one-rank block (L =
// 320), 65-66% of the bound, against the first form's 0.0471 and 0.1365
// (one thread a point: a divide to decode each point, a segment lookup for
// each of its seven reads of u, every pad point decoded); the stage runs at
// every size (utils/stage_plans.py --offpath --kernels K33; PERF.md).
#include "seg.cuh"
#include "seg_stream.cuh"

namespace {

__global__ void residual_kernel(float* __restrict__ r,
                                const float* __restrict__ u,
                                const float* __restrict__ f, int n,
                                float inv_h2) {
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  int i, j, k;
  if (!mg::decode(p, n, i, j, k)) return;
  float v = 0.0f;
  if (mg::is_interior(i, j, k, n)) {
    const float nbr = mg::nbr_sum(u, p, n);
    v = f[p] - inv_h2 * (nbr - 6.0f * u[p]);
  }
  r[p] = v;
}

}  // namespace

extern "C" int mg_residual(float* r, const float* u, const float* f, int n,
                           float inv_h2, cudaStream_t stream) {
  residual_kernel<<<mg::point_blocks(n), mg::kThreads, 0, stream>>>(
      r, u, f, n, inv_h2);
  return (int)cudaGetLastError();
}

// ------------------------------------------------------------ the K33 stage

namespace {

using mg::restriction::cp_async_wait_all;
using mg::split::cp_async4;
using mg::split::cp_async_commit;
using namespace mg::stream;

constexpr int kFields = 1;  // u, with its ring

struct ResidArgs {
  float* out;
  mg::Seg u;
  const float* f;      // the owned rows, (L, n, n)
  int n, L, Lj;        // the rank's block: L rows x Lj = n columns x n
  int t0, t1, j0, j1;  // its interior rows and columns, local (all 0 where it has none)
  int bi, bj, bk;      // the plan
  float inv_h2;
};

// The box's residuals and its zeros. Ring slot of plane q: (q - ta + 1) %
// kRing; tile row r of a slot holds row ja - 1 + r, its column c k = ka - 1
// + c.
template <int C>
__device__ void resid_box(const ResidArgs& a, float* ring) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, nwarps = blockDim.x >> 5;
  const int n = a.n, m = n - 2;
  const int nk = (m + a.bk - 1) / a.bk, nj = (a.j1 - a.j0 + a.bj - 1) / a.bj;
  const int tk = blockIdx.x % nk, tj = (blockIdx.x / nk) % nj, ti = blockIdx.x / (nk * nj);
  const int ta = a.t0 + ti * a.bi, tb = imin(ta + a.bi, a.t1);
  const int ja = a.j0 + tj * a.bj, jb = imin(ja + a.bj, a.j1);
  const int ka = 1 + tk * a.bk, kb = imin(ka + a.bk, n - 1);
  const int rows = jb - ja, W = tile_width(a.bk), PT = (a.bj + 2) * W;
  float* const uring = ring - (ka - 1);  // indexed by k
  auto slot = [&](int q) { return ((q - ta + 1) % kRing) * PT; };
  // start copying plane q's rows ja - 1 .. jb, k ka - 1 .. kb, of u
  auto load = [&](int q) {
    const int s = slot(q);
    for (int r = warp; r < rows + 2; r += nwarps) {
      const float* src = mg::seg_at(a.u, q, ja - 1 + r, n);
      float* dst = uring + s + r * W;
      for (int k = ka - 1 + lane; k <= kb; k += 32) cp_async4(dst + k, src + k);
    }
  };
  const bool mine = warp < rows;  // a warp a row of the box
  const int j = ja + warp;
  // f of plane p at the lane's points
  auto load_f = [&](int p, float (&v)[C]) {
    const float* row = a.f + (p * n + j) * n;
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const int k = ka + lane + 32 * c;
      if (k < kb) v[c] = row[k];
    }
  };
  for (int q = ta - 1; q <= ta + 1; ++q) load(q);
  cp_async_commit();
  float fv[C], prev[C];
  if (mine) load_f(ta, fv);
  zero_box(a, ta, tb, ja, jb, ka, kb, warp, lane, nwarps);  // while the copies fly
  cp_async_wait_all();
  __syncthreads();
  if (mine) {
    const int o = slot(ta - 1) + (warp + 1) * W;
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const int k = ka + lane + 32 * c;
      if (k < kb) prev[c] = uring[o + k];
    }
  }
  for (int p = ta; p < tb; ++p) {
    float g[C];  // plane p + 1's f, in flight across the step's barrier
    if (mine && p + 1 < tb) load_f(p + 1, g);
    cp_async_wait_all();
    __syncthreads();  // plane p + 1 of u in; the ring slot of plane p - 1 read
    if (p + 2 <= tb) load(p + 2);
    cp_async_commit();
    if (mine) {
      const float* mid = uring + slot(p) + (warp + 1) * W;
      const float* nxt = uring + slot(p + 1) + (warp + 1) * W;
      float* o = a.out + (p * n + j) * n;
#pragma unroll
      for (int c = 0; c < C; ++c) {
        const int k = ka + lane + 32 * c;
        if (k < kb) {
          const float uc = mid[k];
          float s = prev[c];  // seg_nbr_sum's order
          s = s + nxt[k];
          s = s + mid[k - W];
          s = s + mid[k + W];
          s = s + mid[k - 1];
          s = s + mid[k + 1];
          o[k] = fv[c] - a.inv_h2 * (s - 6.0f * uc);
          prev[c] = uc;
        }
      }
#pragma unroll
      for (int c = 0; c < C; ++c) fv[c] = g[c];
    }
  }
}

template <int C>
__global__ void __launch_bounds__(kMaxThreads) resid_stage_kernel(ResidArgs a) {
  extern __shared__ __align__(16) float ring[];
  if (a.t1 > a.t0) resid_box<C>(a, ring);
  zero_planes(a);
}

template <int C>
int launch_resid(const ResidArgs& a, int blocks, int threads, int smem, cudaStream_t stream) {
  resid_stage_kernel<C><<<blocks, threads, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

// The K33 stage: r (L, n, n) <- the residual on the owned rows, on the plan
// (bi, bj, bk, chunks, threads, smem) of pallas_split._df_plan(n, sms, rows,
// n - 2, stage="resid"): the u segment with kl rows before the body and kr
// after it (at least 1 each), f the owned rows; g0 = the global plane of
// body row 0. 0, or cudaErrorInvalidValue for a plan the kernel does not
// take or an r that meets u's segment or f.
extern "C" int mg_seg_resid_stage(float* r, float* u_lh, float* u_body, float* u_rh, int u_roff,
                                  const float* f, int kl, int L, int kr, int n, int g0,
                                  float inv_h2, int bi, int bj, int bk, int chunks, int threads,
                                  int smem, cudaStream_t stream) {
  const int nn = n * n;
  const long long count = (long long)L * nn;
  ResidArgs a{};
  a.out = r;
  a.u = mg::make_seg(u_lh, u_body, u_rh, kl, L, kr, u_roff, nn);
  a.f = f;
  a.n = n;
  a.L = L;
  a.Lj = n;
  a.inv_h2 = inv_h2;
  if (n < 3 || L < 1 || r == nullptr || f == nullptr || u_body == nullptr || kl < 1 || kr < 1 ||
      count >= (1LL << 31) || mg::meets(r, count, a.u, kr) || mg::meet(r, count, f, count))
    return (int)cudaErrorInvalidValue;
  setup(a, g0, 0, true);
  a.bi = bi;
  a.bj = bj;
  a.bk = bk;
  if (const int err = plan_error(a, chunks, threads, smem, kFields)) return err;
  const int blocks = launch_blocks(a, threads);
  switch (chunks) {
    case 1: return launch_resid<1>(a, blocks, threads, smem, stream);
    case 2: return launch_resid<2>(a, blocks, threads, smem, stream);
    case 4: return launch_resid<4>(a, blocks, threads, smem, stream);
    default: return launch_resid<kMaxChunks>(a, blocks, threads, smem, stream);
  }
}
