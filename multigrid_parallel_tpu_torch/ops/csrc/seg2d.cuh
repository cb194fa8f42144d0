// A 2D segmented block: one rank's block of an (i, j)-sharded field, with
// its i and j halos from the neighbours, read as one field of rows
// [-kl, L + kr) x columns [-hj, Lj + hjr) x n, and the point loops shared
// by the i-sharded kernels K28-K32 (on seg.cuh's Seg) and their (i, j)
// twins K37-K41 (on Seg2): each kernel is one template instantiated on
// both accessors, so K37-K41 run the arithmetic that K28-K32 hold bit for
// bit to the single-device K1-K5 (K30 and K39: restrict.cuh's SegLayout
// on either accessor; K31 and K40 at n_iter <= 2: rect.cuh's kSegRect).
//
// The JAX package hands its 2D kernels an ext copy (rows and columns
// extended, multigrid_parallel_tpu/ops/pallas_sharded2d.py *_ext2d), a
// j-extended block plus two i-edge buffers, or the copy-free five parts of
// its _halo_parts2dj (parallel/sharded2d_padded.py): the body, the two
// j-halo buffers jl and jr (L rows each), and the two j-extended i-halo
// buffers lh and rh (rows of hj + Lj + hjr columns, corners included).
// Here all three are one descriptor of five pointers, each part with its
// own row pitch, so an ext tensor or a j-extended block is passed as
// strided views of its one buffer (no copy). Point (t, j) maps to
//   t <  0:           lh   + (t + kl) rows,           column j + hj
//   t >= L:           rh   + (t - L + r_off) rows,    column j + hj
//   j <  0:           jl   + t rows,                  column j + hj
//   j >= Lj:          jr   + t rows,                  column j - Lj
//   otherwise:        body + t rows,                  column j
// where r_off skips the local tail rows of a composite right buffer (the
// JAX _halo_parts2d(tail_local) layout; 0 for a plain halo). The corner
// blocks live in lh and rh: the JAX package and the port fill them by
// exchanging j first and then sending j-extended edge rows over i.
//
// Masks and colours use GLOBAL indices g = g0 + t and gj = gj0 + j (g0,
// gj0 the global indices of body row and column 0; halo indices on the
// first rank of an axis are negative): interior is 1 <= g, gj, k <= n - 2,
// RED is (g + gj + k) odd. Pad rows and columns (g or gj >= n) are never
// updated. On Seg the j axis is whole: gj0 = 0, columns [0, n).
#pragma once

#include "seg.cuh"

namespace mg {

struct Seg2 {
  float* body;
  float* jl;
  float* jr;
  float* lh;
  float* rh;
  int pb, pjl, pjr, ph;  // floats per row of each part
  int kl, L, r_off;      // rows [-kl, L + ...)
  int hj, Lj;            // columns [-hj, Lj + ...)

  __device__ float* at(int t, int j, int n) const {
    if (t < 0) return lh + (t + kl) * ph + (j + hj) * n;
    if (t >= L) return rh + (t - L + r_off) * ph + (j + hj) * n;
    if (j < 0) return jl + t * pjl + (j + hj) * n;
    if (j >= Lj) return jr + t * pjr + (j - Lj) * n;
    return body + t * pb + j * n;
  }
};

// The host's descriptor of one Seg2: int64 {body, jl, jr, lh, rh, pb, pjl,
// pjr, ph, kl, r_off, hj} (pointers as integers), L and Lj from the launch.
inline Seg2 seg2_from_desc(const long long* d, int L, int Lj) {
  return Seg2{(float*)d[0], (float*)d[1], (float*)d[2], (float*)d[3], (float*)d[4],
              (int)d[5],    (int)d[6],    (int)d[7],    (int)d[8],    (int)d[9],
              L,            (int)d[10],   (int)d[11],   Lj};
}

// The k row of point (t, j) of either accessor.
__device__ inline float* seg_at(const Seg& s, int t, int j, int n) {
  return s.row(t) + j * n;
}

__device__ inline float* seg_at(const Seg2& s, int t, int j, int n) { return s.at(t, j, n); }

// The launch range of a point loop: rows [t0, t0 + rows) x columns
// [j0, j0 + cols) x n.
struct Span {
  int t0, rows, j0, cols;
};

inline int span_blocks(const Span& sp, int n) {
  long long total = (long long)sp.rows * sp.cols * n;
  return (int)((total + kThreads - 1) / kThreads);
}

// Decode a flat point index of the span; false when p is past it.
__device__ inline bool decode_span(int p, const Span& sp, int n, int& t, int& j, int& k) {
  const int rn = sp.cols * n;
  if (p >= sp.rows * rn) return false;
  const int q = p / rn;
  t = sp.t0 + q;
  const int rem = p - q * rn;
  const int jj = rem / n;
  j = sp.j0 + jj;
  k = rem - jj * n;
  return true;
}

// stencil.cuh's nbr_sum on either accessor, in its order:
// (t-1) + (t+1) + (j-1) + (j+1) + (k-1) + (k+1); interior points only.
// On Seg a row is whole, so the in-row neighbours are one pointer away
// (seg.cuh's seg_nbr_sum, the i-sharded kernels' own loads); on Seg2 so
// are the column neighbours that lie in the same part as (t, j): always
// in a j-extended i-halo row, and in a block row unless the step crosses
// from the body into jl or jr. Every variant reads the same values in the
// same order, so the sum's bits do not depend on which one runs.
__device__ inline float nbr_sum_at(const Seg& u, int t, int j, int k, int n) {
  return seg_nbr_sum(u, t, j * n + k, n);
}

__device__ inline void load_nbrs_at(const Seg& u, int t, int j, int k, int n, float (&v)[6]) {
  seg_load_nbrs(u, t, j * n + k, n, v);
}

// The k rows of (t, j - 1) and (t, j + 1), given c = the k row of (t, j).
__device__ inline void seg2_col_nbrs(const Seg2& u, int t, int j, int n, const float* c,
                                     const float*& jm, const float*& jp) {
  const bool whole_row = t < 0 || t >= u.L;
  jm = (whole_row || (j != 0 && j != u.Lj)) ? c - n : u.at(t, j - 1, n);
  jp = (whole_row || (j != -1 && j != u.Lj - 1)) ? c + n : u.at(t, j + 1, n);
}

__device__ inline float nbr_sum_at(const Seg2& u, int t, int j, int k, int n) {
  const float* c = u.at(t, j, n);
  const float *jm, *jp;
  seg2_col_nbrs(u, t, j, n, c, jm, jp);
  float s = u.at(t - 1, j, n)[k];
  s = s + u.at(t + 1, j, n)[k];
  s = s + jm[k];
  s = s + jp[k];
  s = s + c[k - 1];
  s = s + c[k + 1];
  return s;
}

__device__ inline void load_nbrs_at(const Seg2& u, int t, int j, int k, int n, float (&v)[6]) {
  const float* c = u.at(t, j, n);
  const float *jm, *jp;
  seg2_col_nbrs(u, t, j, n, c, jm, jp);
  v[0] = u.at(t - 1, j, n)[k];
  v[1] = u.at(t + 1, j, n)[k];
  v[2] = jm[k];
  v[3] = jp[k];
  v[4] = c[k - 1];
  v[5] = c[k + 1];
}

// A coarse segment read at GLOBAL coarse (ci, cj, ck) (interp_at's
// accessor): (cg0, cgj0) the global indices of its body row and column 0.
template <class S>
struct SegCoarseAt {
  S c;
  int cg0, cgj0, nc;
  __device__ float operator()(int ci, int cj, int ck) const {
    return seg_at(c, ci - cg0, cj - cgj0, nc)[ck];
  }
};

// interp_at (stencil.cuh) on a coarse segment: Seg reads through the
// generic accessor; Seg2 in interp_at's order and arithmetic, the coarse
// columns cj0 and cj0 + 1 of a row from one lookup where they lie in the
// same part (as seg2_col_nbrs), so its bits are interp_at's.
__device__ inline float interp_coarse(const SegCoarseAt<Seg>& c, int fi, int fj, int fk) {
  return interp_at(c, fi, fj, fk);
}

__device__ inline float interp_coarse(const SegCoarseAt<Seg2>& c, int fi, int fj, int fk) {
  const int ci0 = fi >> 1, cj0 = fj >> 1, ck0 = fk >> 1;
  const bool oi = fi & 1, oj = fj & 1, ok = fk & 1;
  const int j = cj0 - c.cgj0;
  float y2[2];
#pragma unroll
  for (int a = 0; a < 2; ++a) {
    if (a == 1 && !oi) break;
    const int t = ci0 + a - c.cg0;
    const float* p0 = c.c.at(t, j, c.nc);
    const float* p1 = p0;
    if (oj) {
      const bool whole_row = t < 0 || t >= c.c.L;
      p1 = (whole_row || (j != -1 && j != c.c.Lj - 1)) ? p0 + c.nc : c.c.at(t, j + 1, c.nc);
    }
    float y1[2];
#pragma unroll
    for (int b = 0; b < 2; ++b) {
      if (b == 1 && !ok) break;
      const int ck = ck0 + b;
      y1[b] = oj ? 0.5f * p0[ck] + 0.5f * p1[ck] : p0[ck];
    }
    y2[a] = ok ? 0.5f * y1[0] + 0.5f * y1[1] : y1[0];
  }
  return oi ? 0.5f * y2[0] + 0.5f * y2[1] : y2[0];
}

// Whether the body out of ``count`` floats meets a part of the segment s
// of rows [-kl, L + kr) (rh from row r_off on).
inline bool meets(const float* out, long long count, const Seg& s, int kr) {
  return meet(out, count, s.lh, (long long)s.kl * s.nn) ||
         meet(out, count, s.body, (long long)s.L * s.nn) ||
         meet(out, count, s.rh, (long long)(s.r_off + kr) * s.nn);
}

// The same for a Seg2 of hjr columns after the block: each part's extent
// from its first point to its last.
inline bool meets(const float* out, long long count, const Seg2& s, int kr, int hjr, int n) {
  auto span = [&](int rows, int pitch, int cols) {
    return rows > 0 && cols > 0 ? (long long)(rows - 1) * pitch + (long long)cols * n : 0LL;
  };
  const int width = s.hj + s.Lj + hjr;
  return meet(out, count, s.body, span(s.L, s.pb, s.Lj)) ||
         meet(out, count, s.jl, span(s.L, s.pjl, s.hj)) ||
         meet(out, count, s.jr, span(s.L, s.pjr, hjr)) ||
         meet(out, count, s.lh, span(s.kl, s.ph, width)) ||
         meet(out, count, s.rh, span(s.r_off + kr, s.ph, width));
}

}  // namespace mg
