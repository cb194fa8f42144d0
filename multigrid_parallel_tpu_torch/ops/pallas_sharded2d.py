"""The kernels of the (i, j)-sharded distributed solve, hand-written in
CUDA for Hopper, with their plain PyTorch versions.

Counterpart of ``multigrid_parallel_tpu.ops.pallas_sharded2d``: K1-K5 on
one rank's block of a field sharded over i AND j (k stays whole). The
JAX package has three forms of each kernel: ``*_ext2d`` takes an
extended copy (Li + 2 halo rows, Lj + 2 HJ columns), and ``*_halo2d`` a
j-extended block plus two i-edge buffers (its ``_halo_parts2d`` triple)
or the copy-free five parts of ``_halo_parts2dj`` (body, j halos jl and
jr, j-extended i halos lh and rhc). Here all three forms launch ONE
kernel on a 2D segment (``ops/csrc/seg2d.cuh``): five pointers, each with
its own row pitch, read as one field of rows [-kl, Li + kr) and columns
[-hjl, Lj + hjr); an ext tensor or a j-extended block goes in as strided
views of its buffer, with no copy. The kernels are the i-sharded ones'
(K28-K32) sources, instantiated on the 2D accessor. Wrapper (ext and
halo forms), Pallas kernel it replaces in
multigrid_parallel_tpu/ops/pallas_sharded2d.py, and CUDA source in
ops/csrc/:

  K37 rb_smooth_ext2d / _halo2d                :226 / :927    rb_smooth_seg_stage.cu
  K38 rb_smooth_from_zero_ext2d / _halo2d      :246 / :952    rb_smooth_seg_stage.cu
  K39 residual_restrict_ext2d / _halo2d        :370 / :1021   residual_restrict_seg.cu
  K40 prolong_smooth_ext2d / _halo2d           :522 / :1144   prolong_smooth_seg.cu
  K41 residual_df_norm_ext2d / _halo2d         :666 / :973    residual_df_norm_seg.cu

Geometry: the global i and j axes (n valid planes and columns, padded to
nx * Li and ny * Lj) are sharded and k is not; a rank's block is a plain
(Li, Lj, n) tensor (no lane padding). The JAX kernels take a fixed j
halo of HJ = 8 columns (the TPU's sublane tile); the port's take the
halo that each stage needs, in j as in i, and read a deeper one (an
HJ-wide JAX input) as it comes: the j halo of each input is read off its
shape. ``gij0`` is the GLOBAL (i, j) of the stage's first halo row and
column, [rank_i * Li - halo, rank_j * Lj - halo] with the stage's halo
(2 n_iter for smoothing, 2 for the restriction, 1 for the norm), a pair of
ints or a (2,) int tensor; the coarse origin of the prolongation is the
fine body origin halved. Interior masks and colours use global indices
(RED = global (i + j + k) odd); pad rows and columns (global index >= n)
are never updated. Chain ends hold zeros. Each function returns the
rank's owned (Li, Lj, n) block (or its (Li / 2, Lj / 2, nc) coarse
block), which equals the single-device kernel's points of the whole field
bit for bit.

Halo forms, as in the JAX package: a triple (B, lh, rhc) with B the
j-extended (Li, Lj + 2 hj, n) block, or five parts (x, jl, jr, lh, rhc);
lh holds the left neighbour's last rows and rhc the right neighbour's
first rows after ``tail`` local tail rows (the composite layout, its tail
read off the shape), both j-extended, so they carry the corner (diagonal
neighbour) values that a stage recomputing its halo reads. K41 reads only
the owned points of f, which may come as (x, None, None, None, None).
``block_i`` and ``skc`` are accepted and ignored (a VMEM tile and the
TPU's lane width); the JAX ``*_block_i`` planners are not ported.

Like the i-sharded wrappers (``ops.pallas_sharded``): a CPU tensor takes
the plain version, a CUDA tensor (float32, unit stride in k, k rows of
n) the kernel, and anything else raises; there is no fallback. Every
wrapper returns fresh tensors and leaves its inputs as they were. Each
kernel launch adds one to ``LAUNCHES`` (past n_iter 2 every launch of a
K37, K38 or K40 call counts as the call's, K38's K37 half-sweeps included;
K41's partials-and-sum pair counts once). K37, K38 and K40 at n_iter <= 2
are one launch each of K1's, K2's and K4's one-pass stages on the 2D
segments (ops/csrc/rect.cuh, ``Layout::kSegRect`` on ``Seg2``; K38's from
a zero tile, f alone read). K39 is one launch of K3's streaming
restriction stage on them (ops/csrc/restrict.cuh, ``SegLayout`` on
``Seg2``), and K41 of K32's streaming double-float residual-and-norm
stage (ops/csrc/residual_df_norm_seg.cu on ``Seg2``) from
``pallas_split.DF_STAGE_MIN_N`` up, of its first form below, then the sum
of the partials.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional

import numpy as np
import torch

from multigrid_parallel_tpu_torch.ops import pallas3d as pk
from multigrid_parallel_tpu_torch.ops import pallas_sharded as px
from multigrid_parallel_tpu_torch.ops import pallas_split as ps
from multigrid_parallel_tpu_torch.ops import stencils_3d as ops3
from multigrid_parallel_tpu_torch.ops.stencils_3d import BLACK, RED

KERNELS = (
    "rb_smooth_seg2d",            # K37
    "rb_smooth_from_zero_seg2d",  # K38
    "residual_restrict_seg2d",    # K39
    "prolong_smooth_seg2d",       # K40
    "residual_df_norm_seg2d",     # K41
)
# kernel launches per kernel, since the last reset_launches()
LAUNCHES = dict.fromkeys(KERNELS, 0)


def reset_launches() -> None:
    for name in KERNELS:
        LAUNCHES[name] = 0


# ------------------------------------------------------------- segments


class _Seg2(NamedTuple):
    """One field's points of rows [-kl, L + ...) x columns [-hj, Lj + ...):
    body (L, Lj, n), jl (L, hj, n), jr (L, hjr, n), lh (kl, hj + Lj + hjr,
    n) and rh (its rows from r_off on), each possibly a strided view."""

    body: torch.Tensor
    jl: torch.Tensor
    jr: torch.Tensor
    lh: torch.Tensor
    rh: torch.Tensor
    r_off: int

    @property
    def kl(self) -> int:
        return self.lh.shape[0]

    @property
    def hj(self) -> int:
        return self.jl.shape[1]

    def slab(self, kl: int, kr: int, hjl: int, hjr: int) -> torch.Tensor:
        """The plain (kl + L + kr, hjl + Lj + hjr, n) slab of those rows
        and columns."""
        c0, c1 = self.hj - hjl, self.hj + self.body.shape[1] + hjr
        mid = torch.cat([self.jl[:, self.hj - hjl:], self.body, self.jr[:, :hjr]], dim=1)
        return torch.cat([self.lh[self.kl - kl:, c0:c1], mid,
                          self.rh[self.r_off:self.r_off + kr, c0:c1]])

    def parts(self):
        return (self.body, self.jl, self.jr, self.lh, self.rh)

    @property
    def kr(self) -> int:
        """The rows of the right halo after the composite tail."""
        return self.rh.shape[0] - self.r_off

    @property
    def ph(self) -> int:
        """The row pitch that lh and rh share (the j-extended rows; the
        stride of a one-row part is never used, whatever it is)."""
        return self.lh.stride(0) if self.lh.shape[0] > 1 else self.rh.stride(0)

    def desc(self):
        """The kernels' host descriptor (seg2d.cuh): int64 {body, jl, jr,
        lh, rh, the row pitches of body, jl, jr and lh / rh, kl, r_off,
        hj}."""
        return (ctypes.c_longlong * 12)(*(t.data_ptr() for t in self.parts()),
                                        self.body.stride(0), self.jl.stride(0),
                                        self.jr.stride(0), self.ph, self.kl, self.r_off, self.hj)


def _seg2(x, L: int, Lj: int, kl: int, kr: int, hjl: int, hjr: int, k_ext: int = 0,
          composite: bool = True) -> _Seg2:
    """One input as a segment holding at least kl / kr halo rows and
    hjl / hjr halo columns around its (L, Lj) body: an ext tensor (k_ext
    halo rows on each side, its column halo read off the shape), a
    j-extended triple (B, lh, rhc) or five parts (x, jl, jr, lh, rhc).
    ``composite``: rhc may start with local tail rows (read off the shape);
    else it is the plain halo. Missing parts (None) stand for halos that
    are not read."""
    if isinstance(x, torch.Tensor):
        hj = (x.shape[1] - Lj) // 2
        if x.shape[0] != L + 2 * k_ext or x.shape[1] != Lj + 2 * hj:
            raise ValueError(f"expected an ext block of {L + 2 * k_ext} rows (L = {L}, halo "
                             f"{k_ext}) and Lj = {Lj} plus an even halo, got {tuple(x.shape)}")
        rows = x[k_ext:k_ext + L]
        body, jl, jr = rows[:, hj:hj + Lj], rows[:, :hj], rows[:, hj + Lj:]
        lh, rh, r_off = x[:k_ext], x[k_ext + L:], 0
    elif len(x) == 3:
        b, lh, rh = x
        if b.shape[0] != L:
            raise ValueError(f"expected L = {L} local rows, got {b.shape[0]}")
        hj = (b.shape[1] - Lj) // 2
        if b.shape[1] != Lj + 2 * hj:
            raise ValueError(f"a j-extended block of Lj = {Lj} has an even halo, got "
                             f"{tuple(b.shape)}")
        body, jl, jr = b[:, hj:hj + Lj], b[:, :hj], b[:, hj + Lj:]
        r_off = rh.shape[0] - kr if composite else 0
    elif len(x) == 5:
        body, jl, jr, lh, rh = x
        if jl is None:  # the owned points only
            jl = jr = body[:, :0]
            lh = rh = body[:0]
        r_off = rh.shape[0] - kr if composite else 0
    else:
        raise ValueError(f"expected an ext tensor, a triple or five parts, got {len(x)} parts")
    if tuple(body.shape[:2]) != (L, Lj):
        raise ValueError(f"expected an (L, Lj) = ({L}, {Lj}) body, got {tuple(body.shape)}")
    width = jl.shape[1] + Lj + jr.shape[1]
    if (jl.shape[1] < hjl or jr.shape[1] < hjr or lh.shape[0] < kl or r_off < 0
            or rh.shape[0] - r_off < kr or (kl and lh.shape[1] != width)
            or (kr and rh.shape[1] != width)):
        raise ValueError(f"halo buffers jl {tuple(jl.shape)}, jr {tuple(jr.shape)}, lh "
                         f"{tuple(lh.shape)}, rh {tuple(rh.shape)} do not hold a {kl} / {kr} "
                         f"row, {hjl} / {hjr} column halo around ({L}, {Lj})")
    return _Seg2(body, jl, jr, lh, rh, r_off)


def _gij(gij0):
    """(gi0, gj0) as ints from a pair, an array or a (2,) tensor."""
    if isinstance(gij0, torch.Tensor):
        g = gij0.reshape(-1).tolist()
    else:
        g = np.asarray(gij0).reshape(-1).tolist()
    return int(g[0]), int(g[1])


def _on_cuda(n: int, *segs: _Seg2, coarse: Optional[_Seg2] = None) -> bool:
    """False on the CPU (plain path); True for float32 CUDA segments on one
    device whose parts have unit stride in k and k rows of n (coarse: nc);
    raises for anything else."""
    groups = [(s, n) for s in segs] + ([(coarse, (n + 1) // 2)] if coarse is not None else [])
    for s, _ in groups:
        if s.lh.shape[0] > 1 and s.rh.shape[0] > 1 and s.lh.stride(0) != s.rh.stride(0):
            raise ValueError(f"lh and rh rows of one pitch, got {s.lh.stride()}, {s.rh.stride()}")
    tensors = [(t, m) for s, m in groups for t in s.parts()]
    dev = tensors[0][0].device
    if any(t.device != dev for t, _ in tensors):
        raise ValueError(f"tensors on different devices: {[t.device for t, _ in tensors]}")
    if dev.type == "cpu":
        return False
    if dev.type != "cuda":
        raise ValueError(f"no kernel for device {dev}")
    for t, m in tensors:
        if t.dtype != torch.float32:
            raise TypeError(f"CUDA kernels take float32, got {t.dtype}")
        if t.dim() != 3 or t.shape[2] != m or m < 3:
            raise ValueError(f"expected (rows, cols, {m}) parts, got {tuple(t.shape)}")
        # (the stride of a dimension of size one is never used)
        if t.numel() and (t.stride(2) != 1 or (t.shape[1] > 1 and t.stride(1) != m)
                          or (t.shape[0] > 1 and t.stride(0) < t.shape[1] * m)):
            raise ValueError(f"CUDA kernels take parts of unit k stride and k rows of {m}, got "
                             f"strides {t.stride()}")
        if t.stride(0) * (t.shape[0] + 1) >= 2 ** 31:
            raise ValueError("a part overflows the kernels' int32 point index")
    return True


def _fresh(body_like: torch.Tensor, hh: int) -> _Seg2:
    """An output segment with an hh-deep halo in i and j: a contiguous
    (L, Lj, n) body and four scratch buffers."""
    L, Lj, n = body_like.shape
    new = body_like.new_empty
    return _Seg2(torch.empty_like(body_like, memory_format=torch.contiguous_format),
                 new((L, hh, n)), new((L, hh, n)), new((hh, Lj + 2 * hh, n)),
                 new((hh, Lj + 2 * hh, n)), 0)


# ------------------------------------------------- plain slab arithmetic


def _slab_masks2d(g_first: int, gj_first: int, rows: int, cols: int, n: int, device):
    """(interior, parity) of a slab whose first row and column are global
    (g_first, gj_first): interior on global indices, parity (g + gj + k)
    mod 2 (non-negative for negative indices)."""
    g = torch.arange(rows, device=device) + g_first
    gj = torch.arange(cols, device=device) + gj_first
    k = torch.arange(n, device=device)
    inner = lambda x: (x >= 1) & (x <= n - 2)  # noqa: E731
    interior = inner(g)[:, None, None] & inner(gj)[None, :, None] & inner(k)[None, None, :]
    parity = (g[:, None, None] + gj[None, :, None] + k[None, None, :]) % 2
    return interior, parity


def _rb_stage_slab2d(u, f, g_first: int, gj_first: int, h: float, n_iter: int, n: int,
                     red_first: bool):
    """n_iter RB iterations on a slab (ops3's half-sweep arithmetic); its
    edge rows and columns, which lack a neighbour, are never updated."""
    interior, parity = _slab_masks2d(g_first, gj_first, u.shape[0], u.shape[1], n, u.device)
    interior[[0, -1]] = False
    interior[:, [0, -1]] = False
    red, black = interior & (parity == RED), interior & (parity == BLACK)
    first, second = (red, black) if red_first else (black, red)
    for _ in range(n_iter):
        u = ops3._half_sweep(u, f, h, first)
        u = ops3._half_sweep(u, f, h, second)
    return u


# ------------------------------------------------------ K37: RB stage


def _smooth_segs(u3, f3, n_iter, L, Lj, k_ext=0):
    hh = 2 * n_iter
    return (_seg2(u3, L, Lj, hh, hh, hh, hh, k_ext), _seg2(f3, L, Lj, hh, hh, hh, hh, k_ext))


def _rb_smooth_plain(u: _Seg2, f: _Seg2, gij0, h, n_iter, n, red_first):
    hh = 2 * n_iter
    L, Lj = u.body.shape[:2]
    gi, gj = _gij(gij0)
    out = _rb_stage_slab2d(u.slab(hh, hh, hh, hh), f.slab(hh, hh, hh, hh), gi, gj, h, n_iter,
                           n, red_first)
    return out[hh:hh + L, hh:hh + Lj]


def rb_smooth_halo2d_plain(u3, f3, gij0, h: float, n_iter: int, n: int, L: int, sjl: int,
                           red_first: bool = True):
    """Plain version of K37: the stage on the slab of rows [-H, L + H) and
    columns [-H, Lj + H), H = 2 n_iter; returns the owned (L, Lj, n) block
    (u3 untouched)."""
    u, f = _smooth_segs(u3, f3, n_iter, L, sjl)
    return _rb_smooth_plain(u, f, gij0, h, n_iter, n, red_first)


def _rb_smooth(u: _Seg2, f: _Seg2, gij0, h, n_iter, n, red_first, what):
    if n_iter < 1:
        raise ValueError(f"n_iter must be >= 1, got {n_iter}")
    if not _on_cuda(n, u, f):
        return _rb_smooth_plain(u, f, gij0, h, n_iter, n, red_first).contiguous()
    hh = 2 * n_iter
    L, Lj = u.body.shape[:2]
    gi, gj = _gij(gij0)
    g0, gj0 = gi + hh, gj + hh
    lib, stream = pk._lib(), pk._stream()
    if n_iter <= 2:
        out = u.body.new_empty((L, Lj, n))
        pk._check(lib.mg_seg2d_smooth_stage(
            out.data_ptr(), u.desc(), f.desc(), min(u.kr, f.kr),
            min(u.jr.shape[1], f.jr.shape[1]), L, Lj, n, g0, gj0, h * h, int(red_first),
            *ps._plan_args(n, n_iter, u.body.device, rect=True,
                           seg_planes=px.seg_rect_planes(g0, L, n),
                           seg_cols=px.seg_rect_planes(gj0, Lj, n)), stream), what)
        LAUNCHES["rb_smooth_seg2d"] += 1
        return out
    u = _Seg2(*(t.clone(memory_format=torch.contiguous_format) for t in u.parts()), u.r_off)
    ud, fd = u.desc(), f.desc()
    for _ in range(n_iter):
        for c in pk._colors(red_first):
            pk._check(lib.mg_seg2d_half_sweep(ud, fd, hh, L, Lj, n, g0, gj0, h * h, c, stream),
                      what)
            LAUNCHES["rb_smooth_seg2d"] += 1
    return u.body


def rb_smooth_halo2d(u3, f3, gij0, h: float, n_iter: int, n: int, L: int, sjl: int,
                     red_first: bool = True, block_i: int = 8):
    """All 2 n_iter RB half-sweeps of a smoothing stage on a rank's (L,
    sjl) block from triples or five parts with a 2 n_iter halo in i and j:
    a fresh (L, sjl, n) block (u3 is left as it is), its pad rows and
    columns (past n - 1) u's. The CUDA form for n_iter <= 2 is one launch
    of K1's one-pass stage on the 2D segments (a row's pointer looked up
    once, the corner blocks read where a block meets both halos; bound: u's
    and f's points read and the body written, 12 B a point). Past n_iter 2
    it keeps its first form, which no solve runs: 2 n_iter K37 half-sweep
    launches in place on a copy of u's parts."""
    del block_i
    u, f = _smooth_segs(u3, f3, n_iter, L, sjl)
    return _rb_smooth(u, f, gij0, h, n_iter, n, red_first, "rb_smooth_halo2d")


def rb_smooth_ext2d(u_ext, f_ext, gij0, h: float, n_iter: int, n: int, L: int, sjl: int,
                    red_first: bool = True, block_i: int = 8):
    """rb_smooth_halo2d on ext tensors (L + 4 n_iter rows, sjl + 2 hj
    columns, hj >= 2 n_iter): the same launches on their views; a fresh
    block (u_ext is left as it is)."""
    del block_i
    u, f = _smooth_segs(u_ext, f_ext, n_iter, L, sjl, k_ext=2 * n_iter)
    return _rb_smooth(u, f, gij0, h, n_iter, n, red_first, "rb_smooth_ext2d")


# ------------------------------------------- K38: RB stage from zero


def _rb_smooth_from_zero_plain(f: _Seg2, gij0, h, n_iter, n, red_first):
    hh = 2 * n_iter
    L, Lj = f.body.shape[:2]
    fs = f.slab(hh, hh, hh, hh)
    gi, gj = _gij(gij0)
    out = _rb_stage_slab2d(torch.zeros_like(fs), fs, gi, gj, h, n_iter, n, red_first)
    return out[hh:hh + L, hh:hh + Lj].contiguous()


def rb_smooth_from_zero_halo2d_plain(f3, gij0, h: float, n_iter: int, n: int, L: int,
                                     sjl: int, red_first: bool = True):
    """Plain version of K38: the K37 plain stage from a zero slab."""
    hh = 2 * n_iter
    return _rb_smooth_from_zero_plain(_seg2(f3, L, sjl, hh, hh, hh, hh), gij0, h, n_iter, n,
                                      red_first)


def _rb_smooth_from_zero(f: _Seg2, gij0, h, n_iter, n, red_first, what):
    if n_iter < 1:
        raise ValueError(f"n_iter must be >= 1, got {n_iter}")
    hh = 2 * n_iter
    L, Lj = f.body.shape[:2]
    if not _on_cuda(n, f):
        return _rb_smooth_from_zero_plain(f, gij0, h, n_iter, n, red_first)
    gi, gj = _gij(gij0)
    lib, stream = pk._lib(), pk._stream()
    g0, gj0 = gi + hh, gj + hh
    if n_iter <= 2:
        out = f.body.new_empty((L, Lj, n))
        pk._check(lib.mg_seg2d_smooth_from_zero_stage(
            out.data_ptr(), f.desc(), f.kr, f.jr.shape[1], L, Lj, n, g0, gj0, h * h,
            int(red_first), *ps._plan_args(n, n_iter, f.body.device, rect=True,
                                           seg_planes=px.seg_rect_planes(g0, L, n),
                                           seg_cols=px.seg_rect_planes(gj0, Lj, n)), stream),
            what)
        LAUNCHES["rb_smooth_from_zero_seg2d"] += 1
        return out
    out = _fresh(f.body, hh)
    od, fd = out.desc(), f.desc()
    first, second = pk._colors(red_first)
    pk._check(lib.mg_seg2d_half_sweep_from_zero(od, fd, hh, L, Lj, n, g0, gj0, h * h, first,
                                                stream), what)
    LAUNCHES["rb_smooth_from_zero_seg2d"] += 1
    for c in [second] + list(pk._colors(red_first)) * (n_iter - 1):
        pk._check(lib.mg_seg2d_half_sweep(od, fd, hh, L, Lj, n, g0, gj0, h * h, c, stream), what)
        LAUNCHES["rb_smooth_from_zero_seg2d"] += 1
    return out.body


def rb_smooth_from_zero_halo2d(f3, gij0, h: float, n_iter: int, n: int, L: int, sjl: int,
                               red_first: bool = True, block_i: int = 8):
    """rb_smooth_halo2d from an implicit zero initial guess: a fresh (L,
    sjl, n) block, its pad rows and columns (past n - 1) 0 (f3 is left as
    it is). The CUDA form for n_iter <= 2 is one launch of K2's one-pass
    stage on f's 2D segments (a zero tile, a row's pointer looked up once,
    the corner blocks read where a block meets both halos; bound: f's
    points read and the body written, 8 B a point). Past n_iter 2 it keeps
    its first form, which no solve runs: a launch that reads only f and
    writes the body and four H-deep scratch buffers, then 2 n_iter - 1 K37
    half-sweep launches, all counted as K38's."""
    del block_i
    hh = 2 * n_iter
    return _rb_smooth_from_zero(_seg2(f3, L, sjl, hh, hh, hh, hh), gij0, h, n_iter, n,
                                red_first, "rb_smooth_from_zero_halo2d")


def rb_smooth_from_zero_ext2d(f_ext, gij0, h: float, n_iter: int, n: int, L: int, sjl: int,
                              red_first: bool = True, block_i: int = 8):
    """rb_smooth_from_zero_halo2d on an ext tensor (L + 4 n_iter rows)."""
    del block_i
    hh = 2 * n_iter
    return _rb_smooth_from_zero(_seg2(f_ext, L, sjl, hh, hh, hh, hh, k_ext=hh), gij0, h,
                                n_iter, n, red_first, "rb_smooth_from_zero_ext2d")


# ---------------------------------- K41: df residual + partial norm


def _norm_segs(states, L, Lj, k_ext=0):
    uh, ul = (_seg2(x, L, Lj, 1, 1, 1, 1, k_ext) for x in states[:2])
    fh, fl = (_seg2(x, L, Lj, 0, 0, 0, 0, k_ext) for x in states[2:])
    return uh, ul, fh, fl


def _residual_df_norm_plain(uh: _Seg2, ul: _Seg2, fh: _Seg2, fl: _Seg2, gij0, h, n):
    L, Lj = uh.body.shape[:2]
    sh_, sl_ = uh.slab(1, 1, 1, 1), ul.slab(1, 1, 1, 1)

    def nbrs(s):
        c = s[1:-1, 1:-1]
        return [s[:-2, 1:-1], s[2:, 1:-1], s[1:-1, :-2], s[1:-1, 2:],
                torch.roll(c, 1, 2), torch.roll(c, -1, 2)]

    r = pk._eft_residual(fh.body, fl.body, sh_[1:-1, 1:-1], nbrs(sh_), sl_[1:-1, 1:-1],
                         nbrs(sl_), 1.0 / (h * h))
    gi, gj = _gij(gij0)
    interior, _ = _slab_masks2d(gi + 1, gj + 1, L, Lj, n, r.device)
    r = torch.where(interior, r, torch.zeros_like(r))
    r64 = r.to(torch.float64)
    return r, torch.sum(r64 * r64).to(r.dtype)


def residual_df_norm_halo2d_plain(uhi3, ulo3, fhi3, flo3, gij0, h: float, n: int, L: int,
                                  sjl: int):
    """Plain version of K41: K5's EFT residual on the owned points (the
    neighbours across the edges from the one-deep halos) and its partial
    ||r||^2, summed in f64 and returned in r's dtype."""
    return _residual_df_norm_plain(*_norm_segs((uhi3, ulo3, fhi3, flo3), L, sjl), gij0, h, n)


def _residual_df_norm(segs, gij0, h, n, what):
    uh, ul, fh, fl = segs
    if not _on_cuda(n, *segs):
        return _residual_df_norm_plain(uh, ul, fh, fl, gij0, h, n)
    L, Lj = uh.body.shape[:2]
    gi, gj = _gij(gij0)
    lib, g0, gj0, dev = pk._lib(), gi + 1, gj + 1, uh.body.device
    r = torch.empty((L, Lj, n), dtype=torch.float32, device=dev)
    nrm2 = torch.empty((), dtype=torch.float32, device=dev)
    if n >= ps.DF_STAGE_MIN_N:
        rows, cols = px.seg_df_extents(n, g0, L, gj0, Lj)
        nparts, plan = px.seg_df_parts(n, dev, rows, cols, L * Lj * n)
        partials = torch.empty(nparts, dtype=torch.float64, device=dev)
        err = lib.mg_seg2d_df_stage(r.data_ptr(), nrm2.data_ptr(), partials.data_ptr(), nparts,
                                    *(s.desc() for s in segs), min(uh.kr, ul.kr),
                                    min(uh.jr.shape[1], ul.jr.shape[1]), L, Lj, n, g0, gj0,
                                    1.0 / (h * h), *plan, pk._stream())
    else:
        partials = torch.empty(lib.mg_seg2d_residual_df_norm_partials(L, Lj, n),
                               dtype=torch.float64, device=dev)
        err = lib.mg_seg2d_residual_df_norm(r.data_ptr(), nrm2.data_ptr(), partials.data_ptr(),
                                            *(s.desc() for s in segs), L, Lj, n, g0, gj0,
                                            1.0 / (h * h), pk._stream())
    pk._check(err, what)
    LAUNCHES["residual_df_norm_seg2d"] += 1
    return r, nrm2


def residual_df_norm_halo2d(uhi3, ulo3, fhi3, flo3, gij0, h: float, n: int, L: int, sjl: int,
                            block_i: int = 8):
    """(r_local (L, sjl, n), partial ||r||^2 0-d): the compensated residual
    of the double-float solution on a rank's block from triples or five
    parts with one-deep halos (f's halos are not read); the caller
    all-reduces the partial over both mesh axes. One K41 launch: from
    ``DF_STAGE_MIN_N`` up K32's streaming stage on the 2D segments (the
    plan of ``_df_plan`` with the block's interior rows and columns), below
    it the first form, one thread a point; then the sum of the partials."""
    del block_i
    return _residual_df_norm(_norm_segs((uhi3, ulo3, fhi3, flo3), L, sjl), gij0, h, n,
                             "residual_df_norm_halo2d")


def residual_df_norm_ext2d(uhi_ext, ulo_ext, fhi_ext, flo_ext, gij0, h: float, n: int, L: int,
                           sjl: int, block_i: int = 8):
    """residual_df_norm_halo2d on ext tensors with a one-row i halo."""
    del block_i
    return _residual_df_norm(_norm_segs((uhi_ext, ulo_ext, fhi_ext, flo_ext), L, sjl, k_ext=1),
                             gij0, h, n, "residual_df_norm_ext2d")


# ------------------------------------- K39: residual + restriction


def _rr_segs(u3, f3, L, Lj, k_ext=0):
    # the right halo is plain (no composite tail), as the JAX kernel takes it
    return (_seg2(u3, L, Lj, 2, 1, 2, 1, k_ext, composite=False),
            _seg2(f3, L, Lj, 2, 1, 2, 1, k_ext, composite=False))


def _residual_restrict_plain(e: _Seg2, f: _Seg2, gij0, h, n):
    L, Lj = e.body.shape[:2]
    Lc, Ljc, nc = L // 2, Lj // 2, (n + 1) // 2
    gi, gj = _gij(gij0)                          # global of slab row / column 0 (local -2)
    e_s, f_s = e.slab(2, 1, 2, 1), f.slab(2, 1, 2, 1)   # rows, columns [-2, L]
    interior, _ = _slab_masks2d(gi, gj, L + 3, Lj + 3, n, e_s.device)
    res = f_s - (1.0 / (h * h)) * (ops3.neighbor_sum(e_s) - 6.0 * e_s)
    res = torch.where(interior, res, torch.zeros_like(res))
    t = pk._tap3(res[1:2 * Lc:2], res[2:2 * Lc + 1:2], res[3:2 * Lc + 2:2])             # i
    t = pk._tap3(t[:, 1:2 * Ljc:2], t[:, 2:2 * Ljc + 1:2], t[:, 3:2 * Ljc + 2:2])       # j
    t = pk._restrict_axis(t, 2)                                                          # k
    out = torch.zeros((Lc, Ljc, nc), dtype=t.dtype, device=t.device)
    out[:, :, 1:-1] = t
    interior_c, _ = _slab_masks2d((gi + 2) // 2, (gj + 2) // 2, Lc, Ljc, nc, t.device)
    return torch.where(interior_c, out, torch.zeros_like(out))


def residual_restrict_halo2d_plain(u3, f3, gij0, h: float, n: int, Lc: int, sjlc: int):
    """Plain version of K39: R on fine rows and columns [-1, L - 1] (their
    halo from the segments), then K3's plain 3-tap order: i, then j, then
    k; zero off the global coarse interior."""
    return _residual_restrict_plain(*_rr_segs(u3, f3, 2 * Lc, 2 * sjlc), gij0, h, n)


def _residual_restrict(e: _Seg2, f: _Seg2, gij0, h, n, what):
    if not _on_cuda(n, e, f):
        return _residual_restrict_plain(e, f, gij0, h, n)
    L, Lj = e.body.shape[:2]
    gi, gj = _gij(gij0)
    g0, gj0 = gi + 2, gj + 2
    out = e.body.new_empty((L // 2, Lj // 2, (n + 1) // 2))
    rows, cols = px.seg_restrict_extents(n, g0, L, gj0, Lj)
    err = pk._lib().mg_seg2d_restrict_stage(
        out.data_ptr(), e.desc(), f.desc(), min(e.kr, f.kr), min(e.jr.shape[1], f.jr.shape[1]), L,
        Lj, n, g0, gj0, 1.0 / (h * h),
        *ps._restrict_args(n, e.body.device, seg_rows=rows, seg_cols=cols), pk._stream())
    pk._check(err, what)
    LAUNCHES["residual_restrict_seg2d"] += 1
    return out


def residual_restrict_halo2d(u3, f3, gij0, h: float, n: int, Lc: int, sjlc: int, skc: int = 0,
                             block_i: int = 8, sjl: Optional[int] = None):
    """Fused residual + full-weighting restriction on a rank's (2 Lc, 2
    sjlc) block from triples or five parts: 2 halo rows and columns before
    the block, a PLAIN halo (>= 1, no composite tail) after it; gij0 =
    [rank_i L - 2, rank_j Lj - 2]. Returns the rank's (Lc, sjlc, nc)
    coarse block. One K39 launch on the card: K3's streaming stage on the
    2D segments (restrict.cuh's SegLayout on Seg2, a tile row's pointer
    looked up once, the corner blocks read where a block meets both halos;
    the plan of ``_restrict_plan`` with the rank's interior rows and
    columns)."""
    del skc, block_i
    if sjl is not None and sjl != 2 * sjlc:
        raise ValueError(f"sjl = {sjl} is not 2 sjlc = {2 * sjlc}")
    return _residual_restrict(*_rr_segs(u3, f3, 2 * Lc, 2 * sjlc), gij0, h, n,
                              "residual_restrict_halo2d")


def residual_restrict_ext2d(u_ext, f_ext, gij0, h: float, n: int, Lc: int, sjlc: int,
                            skc: int = 0, block_i: int = 8):
    """residual_restrict_halo2d on ext tensors (2 Lc + 4 rows, a column
    halo >= 2 on each side)."""
    del skc, block_i
    return _residual_restrict(*_rr_segs(u_ext, f_ext, 2 * Lc, 2 * sjlc, k_ext=2), gij0, h, n,
                              "residual_restrict_ext2d")


# ----------------------- K40: prolongation + correction + RB stage


def _ps_segs(ec3, e3, r3, n_iter, L, Lj, k_ext=0):
    hh, kc = 2 * n_iter, n_iter + 1
    c = _seg2(ec3, L // 2, Lj // 2, n_iter, kc, n_iter, kc, kc if k_ext else 0)
    return (c, _seg2(e3, L, Lj, hh, hh, hh, hh, k_ext), _seg2(r3, L, Lj, hh, hh, hh, hh, k_ext))


def _prolong_smooth_plain(c: _Seg2, e: _Seg2, r: _Seg2, gij0, h, n_iter, n):
    hh, kc = 2 * n_iter, n_iter + 1
    L, Lj = e.body.shape[:2]
    t = c.slab(n_iter, kc, n_iter, kc)     # coarse rows and columns [-n_iter, Lc + n_iter]
    for axis in (1, 2, 0):
        t = pk._interp_axis(t, axis)       # fine [-H, L + H]
    u = e.slab(hh, hh, hh, hh) + t[:L + 2 * hh, :Lj + 2 * hh]
    gi, gj = _gij(gij0)
    out = _rb_stage_slab2d(u, r.slab(hh, hh, hh, hh), gi, gj, h, n_iter, n, red_first=False)
    return out[hh:hh + L, hh:hh + Lj]


def prolong_smooth_halo2d_plain(ec3, e3, r3, gij0, h: float, n_iter: int, n: int, L: int,
                                sjl: int):
    """Plain version of K40: e + trilinear interpolation of ec (j, then
    k, then i, as K4's plain version) on the fine slab [-H, L + H) x [-H,
    Lj + H), then the black-first K37 plain stage; returns the owned
    block."""
    return _prolong_smooth_plain(*_ps_segs(ec3, e3, r3, n_iter, L, sjl), gij0, h, n_iter, n)


def _prolong_smooth(c: _Seg2, e: _Seg2, r: _Seg2, gij0, h, n_iter, n, what):
    if n_iter < 1:
        raise ValueError(f"n_iter must be >= 1, got {n_iter}")
    if not _on_cuda(n, e, r, coarse=c):
        return _prolong_smooth_plain(c, e, r, gij0, h, n_iter, n)
    hh = 2 * n_iter
    L, Lj = e.body.shape[:2]
    gi, gj = _gij(gij0)
    g0, gj0 = gi + hh, gj + hh
    lib, stream = pk._lib(), pk._stream()
    if n_iter <= 2:
        out = e.body.new_empty((L, Lj, n))
        pk._check(lib.mg_seg2d_prolong_stage(
            out.data_ptr(), c.desc(), e.desc(), r.desc(), min(e.kr, r.kr),
            min(e.jr.shape[1], r.jr.shape[1]), c.kr, c.jr.shape[1], L, Lj, n, g0, gj0, h * h,
            *ps._plan_args(n, n_iter, e.body.device, prolong=True, rect=True,
                           seg_planes=px.seg_rect_planes(g0, L, n),
                           seg_cols=px.seg_rect_planes(gj0, Lj, n)), stream), what)
        LAUNCHES["prolong_smooth_seg2d"] += 1
        return out
    out = _fresh(e.body, hh)
    od, rd = out.desc(), r.desc()
    pk._check(lib.mg_seg2d_prolong_correct_black(od, c.desc(), e.desc(), rd, hh, L, Lj, n, g0,
                                                 gj0, h * h, stream), what)
    LAUNCHES["prolong_smooth_seg2d"] += 1
    for color in [RED] + [BLACK, RED] * (n_iter - 1):
        pk._check(lib.mg_seg2d_half_sweep(od, rd, hh, L, Lj, n, g0, gj0, h * h, color, stream),
                  what)
        LAUNCHES["prolong_smooth_seg2d"] += 1
    return out.body


def prolong_smooth_halo2d(ec3, e3, r3, gij0, h: float, n_iter: int, n: int, L: int, sjl: int,
                          block_i: int = 8):
    """post_smooth(e + trilinear(ec), r) on a rank's (L, sjl) block: fine
    triples or five parts with H = 2 n_iter halos in i and j (composite
    tails read off the shapes), the coarse one of (L / 2, sjl / 2) with
    n_iter rows and columns before it and n_iter + 1 after; gij0 = [rank_i
    L - H, rank_j Lj - H]. A fresh (L, sjl, n) block (e is left as it is),
    its pad rows and columns (past n - 1) e + P ec. The CUDA form for n_iter
    <= 2 is one launch of K4's one-pass stage on the 2D segments (e + P ec
    made as each plane reaches shared memory, a row's pointer looked up
    once, the corner blocks read where a block meets both halos; bound:
    e's and r's points read and the body written, 12 B a fine point, and
    the coarse block). Past n_iter 2 it keeps its first form, which no solve
    runs: one launch of the correction and the first black half-sweep into
    a fresh segment, then 2 n_iter - 1 K37 launches. Every launch counts as
    K40's."""
    del block_i
    return _prolong_smooth(*_ps_segs(ec3, e3, r3, n_iter, L, sjl), gij0, h, n_iter, n,
                           "prolong_smooth_halo2d")


def prolong_smooth_ext2d(ec_ext, e_ext, r_ext, gij0, h: float, n_iter: int, n: int, L: int,
                         sjl: int, block_i: int = 8):
    """prolong_smooth_halo2d on ext tensors: e_ext, r_ext with a 2 n_iter
    halo, ec_ext (L / 2 + 2 (n_iter + 1) rows) with a halo of n_iter + 1
    rows and at least that many columns on each side."""
    del block_i
    return _prolong_smooth(*_ps_segs(ec_ext, e_ext, r_ext, n_iter, L, sjl, k_ext=2 * n_iter),
                           gij0, h, n_iter, n, "prolong_smooth_ext2d")
