// Compensated (EFT) residual of a double-float solution on one rank's
// segmented block, and the rank's partial ||r||^2 (K32, and K41 on an
// (i, j) block).
//
// Replaces the Pallas kernels multigrid_parallel_tpu/ops/pallas_sharded.py:
// residual_df_norm_ext and residual_df_norm_halo, and their (i, j) twins
// of pallas_sharded2d.py, residual_df_norm_ext2d and
// residual_df_norm_halo2d. The residual is K5's (residual_df_norm.cu:
// mg::eft_residual, the operation order of the JAX _eft_residual) on the
// rank's owned points, the neighbours across the block's edges from the
// one-deep halos of u_hi and u_lo, interior and pad masks on global
// indices; every owned point equals K5's on the whole field bit for bit.
// The caller all-reduces the partials of the ranks.
//
// The kernel is one streaming stage a call (df_stage_kernel). A block owns
// a box of the rank's interior points, bj rows (a warp each) of bk k (a
// tile of the row, from k = 1), and marches in i over a chunk of bi
// planes, on the plan of pallas_split._df_plan (the geometry in
// seg_stream.cuh, shared with K33's stage). The planes of u_hi and
// u_lo go by cp.async into a ring in shared memory, kRing planes of the
// box's rows and k with one row and one k of halo on each side: plane p + 2
// is in flight while plane p is computed, one barrier a plane. Each tile
// row is found once through the segment (Seg::row, Seg2::at: the halo rows
// and, on Seg2, the halo columns from their buffers). Lane l of a warp owns
// the points k = ka + l + 32 c of its row (C chunks, a template argument),
// so every load and store of a warp is 32 consecutive floats (the rows of
// an odd n floats do not start on 16 bytes: no float4). It keeps u_hi and
// u_lo of the plane before in registers (the i - 1 neighbour), takes i + 1
// from the next ring plane, j - 1, j + 1, k - 1 and k + 1 from the tile,
// f_hi and f_lo from device memory one plane ahead into registers, and
// calls mg::eft_residual as K5 does, neighbours in nbr_sum order. Every
// point of the rank's block off the interior is written 0 by the same
// launch with no load: the planes outside the interior rows (the boundary
// and pad planes, grid-stride over every thread), and around each box its
// boundary rows, pad columns and k ends. A rank without interior points
// launches blocks that write only zeros.
//
// The norm: each thread sums the squares of its residuals in f64 (exact
// products of f32 values), planes in order, then its chunks; the block
// reduces them by a fixed warp tree and a fixed sum over its warps into
// partials[blockIdx]; then one block sums the partials in a fixed order
// (eft.cuh, sum_partials_kernel). No atomics: every run gives the same
// bits, which differ from the plain version's only by the order of the f64
// sum.
//
// Bound: device-memory bytes, 20 per interior point (read u_hi, u_lo,
// f_hi, f_lo, write r) and 4 per other point of the block (write 0). The
// ring re-reads each box's halo rows and planes, (bj + 2) / bj and (bi +
// 2) / bi of u, mostly from L2. On an H100 the stage takes 0.161 ms a call
// on the one-rank 257^3 segment (L = 320) against the first form's 0.292,
// and beats it from 129^3 up; on a smaller level a launch is latency, and
// the first form (below), one thread a point through the segment accessor
// (a divide to decode each point, a segment lookup a read, 14 reads of u a
// point, every pad point decoded), is faster: the wrappers take it below
// pallas_split.DF_STAGE_MIN_N (utils/stage_plans.py --seg-df; PERF.md).
#include "eft.cuh"
#include "seg_stream.cuh"

namespace {

using mg::restriction::cp_async_wait_all;
using mg::split::cp_async4;
using mg::split::cp_async_commit;
using namespace mg::stream;

constexpr int kFields = 2;  // u_hi and u_lo, each with its ring

template <class S>
struct DfArgs {
  float* out;
  double* partials;
  S uh, ul, fh, fl;
  int n, L, Lj;        // the rank's block: L rows x Lj columns (Seg: n) x n
  int t0, t1, j0, j1;  // its interior rows and columns, local (all 0 where it has none)
  int bi, bj, bk;      // the plan
  float inv_h2;
};

// The box's residuals, its zeros, and the sum of the thread's squares in
// acc. Ring slot of plane q: (q - ta + 1) % kRing; tile row r of a slot
// holds row ja - 1 + r, its column c k = ka - 1 + c.
template <class S, int C>
__device__ void df_box(const DfArgs<S>& a, float* ring, double& acc) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, nwarps = blockDim.x >> 5;
  const int n = a.n, m = n - 2;
  const int nk = (m + a.bk - 1) / a.bk, nj = (a.j1 - a.j0 + a.bj - 1) / a.bj;
  const int tk = blockIdx.x % nk, tj = (blockIdx.x / nk) % nj, ti = blockIdx.x / (nk * nj);
  const int ta = a.t0 + ti * a.bi, tb = imin(ta + a.bi, a.t1);
  const int ja = a.j0 + tj * a.bj, jb = imin(ja + a.bj, a.j1);
  const int ka = 1 + tk * a.bk, kb = imin(ka + a.bk, n - 1);
  const int rows = jb - ja, W = tile_width(a.bk), PT = (a.bj + 2) * W;
  float* const hring = ring - (ka - 1);  // indexed by k
  float* const lring = hring + kRing * PT;
  auto slot = [&](int q) { return ((q - ta + 1) % kRing) * PT; };
  // start copying plane q's rows ja - 1 .. jb, k ka - 1 .. kb, of u_hi and u_lo
  auto load = [&](int q) {
    const int s = slot(q);
    for (int r = warp; r < rows + 2; r += nwarps) {
      const float* sh = mg::seg_at(a.uh, q, ja - 1 + r, n);
      const float* sl = mg::seg_at(a.ul, q, ja - 1 + r, n);
      float* dh = hring + s + r * W;
      float* dl = lring + s + r * W;
      for (int k = ka - 1 + lane; k <= kb; k += 32) {
        cp_async4(dh + k, sh + k);
        cp_async4(dl + k, sl + k);
      }
    }
  };
  const bool mine = warp < rows;  // a warp a row of the box
  const int j = ja + warp;
  // f_hi and f_lo of plane p at the lane's points
  auto load_f = [&](int p, float (&vh)[C], float (&vl)[C]) {
    const float* rh = mg::seg_at(a.fh, p, j, n);
    const float* rl = mg::seg_at(a.fl, p, j, n);
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const int k = ka + lane + 32 * c;
      if (k < kb) {
        vh[c] = rh[k];
        vl[c] = rl[k];
      }
    }
  };
  for (int q = ta - 1; q <= ta + 1; ++q) load(q);
  cp_async_commit();
  float fh[C], fl[C], ph[C], pl[C];
  if (mine) load_f(ta, fh, fl);
  zero_box(a, ta, tb, ja, jb, ka, kb, warp, lane, nwarps);  // while the copies fly
  cp_async_wait_all();
  __syncthreads();
  if (mine) {
    const int o = slot(ta - 1) + (warp + 1) * W;
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const int k = ka + lane + 32 * c;
      if (k < kb) {
        ph[c] = hring[o + k];
        pl[c] = lring[o + k];
      }
    }
  }
  for (int p = ta; p < tb; ++p) {
    float gh[C], gl[C];  // plane p + 1's f, in flight across the step's barrier
    if (mine && p + 1 < tb) load_f(p + 1, gh, gl);
    cp_async_wait_all();
    __syncthreads();  // plane p + 1 of u in; the ring slot of plane p - 1 read
    if (p + 2 <= tb) load(p + 2);
    cp_async_commit();
    if (mine) {
      const float* mh = hring + slot(p) + (warp + 1) * W;
      const float* ml = lring + slot(p) + (warp + 1) * W;
      const float* nh = hring + slot(p + 1) + (warp + 1) * W;
      const float* nl = lring + slot(p + 1) + (warp + 1) * W;
      float* o = a.out + (p * a.Lj + j) * n;
#pragma unroll
      for (int c = 0; c < C; ++c) {
        const int k = ka + lane + 32 * c;
        if (k < kb) {
          const float ch = mh[k], cl = ml[k];
          const float vh[6] = {ph[c], nh[k], mh[k - W], mh[k + W], mh[k - 1], mh[k + 1]};
          const float vl[6] = {pl[c], nl[k], ml[k - W], ml[k + W], ml[k - 1], ml[k + 1]};
          const float v = mg::eft_residual(fh[c], fl[c], ch, vh, cl, vl, a.inv_h2);
          o[k] = v;
          acc = acc + (double)v * (double)v;
          ph[c] = ch;
          pl[c] = cl;
        }
      }
#pragma unroll
      for (int c = 0; c < C; ++c) {
        fh[c] = gh[c];
        fl[c] = gl[c];
      }
    }
  }
}

// The block's partial: its threads' sums by a fixed warp tree, then warp
// by warp in order, into partials[blockIdx.x], through ``warps`` (the
// ring's first bytes, free once every thread has passed the barrier: no
// static shared memory, so that the dynamic limit can be raised to the
// most a block may take). Every thread calls it.
__device__ inline void block_sum(double v, double* partials, double* warps) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int o = 16; o > 0; o >>= 1) v = v + __shfl_down_sync(0xffffffffu, v, o);
  __syncthreads();  // the ring read
  if (lane == 0) warps[warp] = v;
  __syncthreads();
  if (threadIdx.x == 0) {
    double s = warps[0];
    for (int w = 1; w < (int)(blockDim.x >> 5); ++w) s = s + warps[w];
    partials[blockIdx.x] = s;
  }
}

template <class S, int C>
__global__ void __launch_bounds__(kMaxThreads) df_stage_kernel(DfArgs<S> a) {
  extern __shared__ __align__(16) float ring[];
  double acc = 0.0;
  if (a.t1 > a.t0) df_box<S, C>(a, ring, acc);
  zero_planes(a);
  block_sum(acc, a.partials, reinterpret_cast<double*>(ring));
}

// The stage's launch (chunks C), then the sum of its partials into nrm2.
template <class S, int C>
int launch_df(const DfArgs<S>& a, float* nrm2, int blocks, int threads, int smem,
              cudaStream_t stream) {
  const auto kernel = df_stage_kernel<S, C>;
  if (const int err = mg::split::raise_smem_limit((const void*)kernel)) return err;
  kernel<<<blocks, threads, smem, stream>>>(a);
  if (const int err = (int)cudaGetLastError()) return err;
  sum_partials_kernel<<<1, mg::kReduceThreads, 0, stream>>>(a.partials, blocks, nrm2);
  return (int)cudaGetLastError();
}

// The plan's checks and the launch of a stage whose segments, output and
// geometry are set: 0, or cudaErrorInvalidValue for a plan the kernels do
// not take or a partials count that is not the launch's blocks.
template <class S>
int df_stage(DfArgs<S>& a, float* nrm2, int nparts, int bi, int bj, int bk, int chunks,
             int threads, int smem, cudaStream_t stream) {
  a.bi = bi;
  a.bj = bj;
  a.bk = bk;
  if (const int err = plan_error(a, chunks, threads, smem, kFields)) return err;
  const int blocks = launch_blocks(a, threads);
  if (nparts != blocks) return (int)cudaErrorInvalidValue;
  switch (chunks) {
    case 1: return launch_df<S, 1>(a, nrm2, blocks, threads, smem, stream);
    case 2: return launch_df<S, 2>(a, nrm2, blocks, threads, smem, stream);
    case 4: return launch_df<S, 4>(a, nrm2, blocks, threads, smem, stream);
    default: return launch_df<S, kMaxChunks>(a, nrm2, blocks, threads, smem, stream);
  }
}

}  // namespace

// The K32 stage: r (L, n, n) and nrm2 <- the compensated residual on the
// owned rows and its partial ||r||^2, into nparts f64 partials (the
// launch's blocks, pallas_sharded.seg_df_parts), on the plan (bi, bj, bk,
// chunks, threads, smem) of pallas_split._df_plan(n, sms, rows, cols): u_hi
// and u_lo segments with kl rows before the body and kr after it (at least
// 1 each), f_hi and f_lo the owned rows; g0 = the global plane of body row
// 0. r must meet no input.
extern "C" int mg_seg_df_stage(float* r, float* nrm2, double* partials, int nparts,
                               float* uh_lh, float* uh_body, float* uh_rh, int uh_roff,
                               float* ul_lh, float* ul_body, float* ul_rh, int ul_roff,
                               const float* f_hi, const float* f_lo, int kl, int L, int kr, int n,
                               int g0, float inv_h2, int bi, int bj, int bk, int chunks,
                               int threads, int smem, cudaStream_t stream) {
  const int nn = n * n;
  const long long count = (long long)L * nn;
  float* fh = const_cast<float*>(f_hi);
  float* fl = const_cast<float*>(f_lo);
  DfArgs<mg::Seg> a{};
  a.out = r;
  a.partials = partials;
  a.uh = mg::make_seg(uh_lh, uh_body, uh_rh, kl, L, kr, uh_roff, nn);
  a.ul = mg::make_seg(ul_lh, ul_body, ul_rh, kl, L, kr, ul_roff, nn);
  a.fh = mg::make_seg(fh, fh, fh, 0, L, 0, 0, nn);  // owned rows only
  a.fl = mg::make_seg(fl, fl, fl, 0, L, 0, 0, nn);
  a.n = n;
  a.L = L;
  a.Lj = n;
  a.inv_h2 = inv_h2;
  if (n < 3 || L < 1 || r == nullptr || nrm2 == nullptr || partials == nullptr || kl < 1 ||
      kr < 1 || count >= (1LL << 31) || mg::meets(r, count, a.uh, kr) ||
      mg::meets(r, count, a.ul, kr) || mg::meet(r, count, fh, count) ||
      mg::meet(r, count, fl, count))
    return (int)cudaErrorInvalidValue;
  setup(a, g0, 0, true);
  return df_stage(a, nrm2, nparts, bi, bj, bk, chunks, threads, smem, stream);
}

// The K41 stage: r (L, Lj, n) and nrm2 <- the same on (i, j) descriptors
// (seg2d.cuh): u_hi and u_lo with at least 1 row and column of halo before
// the block (their kl and hj) and kr rows and hjr columns after it (at
// least 1 each), f_hi and f_lo whose owned points alone are read; (g0,
// gj0) = the global row and column of body point (0, 0); the plan of
// _df_plan(n, sms, rows, cols). r must meet no input.
extern "C" int mg_seg2d_df_stage(float* r, float* nrm2, double* partials, int nparts,
                                 const long long* uh_desc, const long long* ul_desc,
                                 const long long* fh_desc, const long long* fl_desc, int kr,
                                 int hjr, int L, int Lj, int n, int g0, int gj0, float inv_h2,
                                 int bi, int bj, int bk, int chunks, int threads, int smem,
                                 cudaStream_t stream) {
  const long long count = (long long)L * Lj * n;
  DfArgs<mg::Seg2> a{};
  a.out = r;
  a.partials = partials;
  a.uh = mg::seg2_from_desc(uh_desc, L, Lj);
  a.ul = mg::seg2_from_desc(ul_desc, L, Lj);
  a.fh = mg::seg2_from_desc(fh_desc, L, Lj);
  a.fl = mg::seg2_from_desc(fl_desc, L, Lj);
  a.n = n;
  a.L = L;
  a.Lj = Lj;
  a.inv_h2 = inv_h2;
  if (n < 3 || L < 1 || Lj < 1 || r == nullptr || nrm2 == nullptr || partials == nullptr ||
      a.uh.body == nullptr || a.ul.body == nullptr || a.fh.body == nullptr ||
      a.fl.body == nullptr || a.uh.kl < 1 || a.ul.kl < 1 || a.uh.hj < 1 || a.ul.hj < 1 ||
      kr < 1 || hjr < 1 || count >= (1LL << 31) || mg::meets(r, count, a.uh, kr, hjr, n) ||
      mg::meets(r, count, a.ul, kr, hjr, n) || mg::meets(r, count, a.fh, 0, 0, n) ||
      mg::meets(r, count, a.fl, 0, 0, n))
    return (int)cudaErrorInvalidValue;
  setup(a, g0, gj0, false);
  return df_stage(a, nrm2, nparts, bi, bj, bk, chunks, threads, smem, stream);
}

// ------------------------------------------------------------ the first form
// (one thread a point through the segment accessor), which K32 and K41 take
// on levels below pallas_split.DF_STAGE_MIN_N

namespace {

template <class S>
__global__ void seg_residual_df_partials_kernel(float* __restrict__ out,
                                                double* __restrict__ partials, S uh, S ul, S fh,
                                                S fl, mg::Span sp, int n, int g0, int gj0,
                                                float inv_h2) {
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  int t, j, k;
  double rr = 0.0;
  if (mg::decode_span(p, sp, n, t, j, k)) {
    float v = 0.0f;
    if (mg::is_interior(g0 + t, gj0 + j, k, n)) {
      float nh[6], nl[6];
      mg::load_nbrs_at(uh, t, j, k, n, nh);
      mg::load_nbrs_at(ul, t, j, k, n, nl);
      v = mg::eft_residual(mg::seg_at(fh, t, j, n)[k], mg::seg_at(fl, t, j, n)[k],
                           mg::seg_at(uh, t, j, n)[k], nh, mg::seg_at(ul, t, j, n)[k], nl,
                           inv_h2);
    }
    out[p] = v;
    rr = (double)v * (double)v;
  }
  mg::block_partial(rr, partials);
}

template <class S>
int launch_residual_df_norm(float* r, float* nrm2, double* partials, const S& uh, const S& ul,
                            const S& fh, const S& fl, const mg::Span& sp, int n, int g0,
                            int gj0, float inv_h2, cudaStream_t stream) {
  const int blocks = mg::span_blocks(sp, n);
  seg_residual_df_partials_kernel<<<blocks, mg::kThreads, 0, stream>>>(
      r, partials, uh, ul, fh, fl, sp, n, g0, gj0, inv_h2);
  int err = (int)cudaGetLastError();
  if (err != 0) return err;
  sum_partials_kernel<<<1, mg::kReduceThreads, 0, stream>>>(partials, blocks, nrm2);
  return (int)cudaGetLastError();
}

}  // namespace

// Number of f64 partials the caller allocates for L owned planes of n^2.
extern "C" int mg_seg_residual_df_norm_partials(int L, int n) {
  return mg::seg_blocks(L, n * n);
}

// r (L, n, n) and nrm2 <- the compensated residual on the owned rows and
// its partial ||r||^2 (u_hi / u_lo segments with halo 1 on both sides;
// f_hi / f_lo the owned rows).
extern "C" int mg_seg_residual_df_norm(float* r, float* nrm2, double* partials, float* uh_lh,
                                       float* uh_body, float* uh_rh, int uh_roff,
                                       float* ul_lh, float* ul_body, float* ul_rh,
                                       int ul_roff, const float* f_hi, const float* f_lo,
                                       int L, int n, int g0, float inv_h2,
                                       cudaStream_t stream) {
  const int nn = n * n;
  const mg::Seg uh = mg::make_seg(uh_lh, uh_body, uh_rh, 1, L, 1, uh_roff, nn);
  const mg::Seg ul = mg::make_seg(ul_lh, ul_body, ul_rh, 1, L, 1, ul_roff, nn);
  float* fh = const_cast<float*>(f_hi);
  float* fl = const_cast<float*>(f_lo);
  const mg::Seg fhs = mg::make_seg(fh, fh, fh, 0, L, 0, 0, nn);  // owned rows only
  const mg::Seg fls = mg::make_seg(fl, fl, fl, 0, L, 0, 0, nn);
  return launch_residual_df_norm(r, nrm2, partials, uh, ul, fhs, fls, mg::Span{0, L, 0, n}, n,
                                 g0, 0, inv_h2, stream);
}

// Number of f64 partials K41 takes for an (L, Lj, n) block.
extern "C" int mg_seg2d_residual_df_norm_partials(int L, int Lj, int n) {
  return mg::span_blocks(mg::Span{0, L, 0, Lj}, n);
}

// K41: r (L, Lj, n) and nrm2 <- the same on (i, j) descriptors: u_hi /
// u_lo with halo 1 in i and j, f_hi / f_lo (only their owned points are
// read); (g0, gj0) = global indices of body row and column 0.
extern "C" int mg_seg2d_residual_df_norm(float* r, float* nrm2, double* partials,
                                         const long long* uh_desc, const long long* ul_desc,
                                         const long long* fh_desc, const long long* fl_desc,
                                         int L, int Lj, int n, int g0, int gj0, float inv_h2,
                                         cudaStream_t stream) {
  return launch_residual_df_norm(
      r, nrm2, partials, mg::seg2_from_desc(uh_desc, L, Lj), mg::seg2_from_desc(ul_desc, L, Lj),
      mg::seg2_from_desc(fh_desc, L, Lj), mg::seg2_from_desc(fl_desc, L, Lj),
      mg::Span{0, L, 0, Lj}, n, g0, gj0, inv_h2, stream);
}
