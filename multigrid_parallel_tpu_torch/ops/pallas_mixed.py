"""The mixed-BC (electrospray) smoothing kernels of the full-layout
correction cycle, hand-written in CUDA for Hopper, with their plain
PyTorch versions, the Dirichlet pin planes and the BC pass.

Counterpart of ``multigrid_parallel_tpu.ops.pallas_mixed``: its single-
device kernels and the i-sharded ``*_ext`` / ``*_halo`` ones. Wrapper,
the Pallas kernel it replaces in multigrid_parallel_tpu/ops/pallas_mixed.py,
and its CUDA source in ops/csrc/ (all share mixed.cuh; K34-K36 seg.cuh too):

  K13 mixed_rb_smooth_fused            mixed_rb_smooth_fused            mixed_rb_smooth.cu
  K14 mixed_rb_smooth_from_zero_fused  mixed_rb_smooth_from_zero_fused  mixed_rb_smooth.cu
  K15 mixed_prolong_smooth_fused       mixed_prolong_smooth_fused       mixed_prolong_smooth.cu
  K34 mixed_rb_smooth_ext / _halo      :552 / :814                      mixed_rb_smooth_seg.cu
  K35 mixed_rb_smooth_from_zero_ext / _halo  :572 / :833                mixed_rb_smooth_seg.cu
  K36 mixed_prolong_smooth_ext / _halo :591 / :851                      mixed_prolong_smooth_seg.cu

K34-K36 are K13-K15 on one rank's block of an i-sharded field, in the
geometry of ``ops.pallas_sharded`` (K28-K33): one kernel on a segmented
block serves the ext and the halo form, ``gi0`` is the global plane of the
first halo row (rank * L - 2 n_iter), masks, colours and pins use global
indices, and the L owned planes equal K13-K15's rows of the whole field
bit for bit. K34, K35 and K36 are K13's, K14's and K15's one-pass stages
on the segments (rect.cuh's ``Layout::kSeg``; one launch a call for n_iter
<= 2, a fresh body, the input and the halos only read, pad rows written as
u's by K34, 0 by K35 and as e's by K36, the plan ``_stage_plan(...,
seg_planes=)`` of the planes a rank tiles). One geometry needs more than
the JAX halo: where global plane n - 1 is the block's first row (L
divides n - 1), the stage's BC copy there reads plane n - 2, the left
halo's last row, which 2 n_iter half-sweeps leave stale in a 2 n_iter
halo. There the stage takes 2 n_iter + 1 left halo planes (and K36 n_iter
+ 1 coarse ones), so that plane n - 2 is swept to its final value: a halo
triple whose left buffer is that deep serves it, an ext tensor (2 n_iter a
side) raises.

The boundary condition of the correction equation: homogeneous Neumann
on every face, enforced by the BC pass (``apply_bcs_padded``: face
copies in x, y, z order, then the pin), except the Dirichlet patches of
the x = 0 and x = n-1 faces, pinned to zero. Their masks are the (2, n,
n) f32 0/1 ``pin`` planes of ``dirichlet_pin_planes``.

The kernels fold the copy-BC into the stencil (a face-adjacent
neighbour reads the reader's own value, or 0 at a pinned x-face node)
and end each stage with one BC pass, as the Pallas kernels do. K13, K14
and K15 are one-pass stages (rect.cuh on the full layout): one launch a
call for n_iter <= 2, all 2 n_iter half-sweeps in shared memory and the
BC pass, z faces included, at the store, into a fresh field. The
plain versions are written in the COPY form instead: a half-sweep, then a BC
pass, after every half-sweep (``mixed_padded._mixed_smooth_padded_jnp``
in the JAX package). The two agree bit for bit on BC-consistent input,
which is what the cycle hands over (the zero field, or a stage's
output); so comparing a kernel with its plain version on the card checks
the fold too. Random test inputs go through a BC pass first.

A wrapper takes the plain version for tensors on the CPU, launches its
kernel for CUDA tensors (float32, contiguous, cubic fields; pin (2, n,
n)), and raises for anything else: no fallback from the kernel to the
plain version. Each kernel launch adds one to its entry in ``LAUNCHES``
(every half-sweep and BC pass of the segment stages' first forms, past
n_iter 2, counts as a launch of the stage's kernel). Every wrapper returns
a fresh field or body and leaves its inputs as they are, so a caller
rebinds (``e = mixed_rb_smooth_fused(e, ...)``); ``block_i`` is accepted
and ignored (a VMEM tile).
"""

from __future__ import annotations

import numpy as np
import torch

from multigrid_parallel_tpu_torch.ops import pallas3d as pk
from multigrid_parallel_tpu_torch.ops import pallas_sharded as px
from multigrid_parallel_tpu_torch.ops import pallas_split as ps
from multigrid_parallel_tpu_torch.ops import stencils_3d as ops3
from multigrid_parallel_tpu_torch.ops.pallas3d import _check, _colors, _lib, _stream
from multigrid_parallel_tpu_torch.ops.stencils_3d import BLACK, RED

KERNELS = (
    "mixed_rb_smooth_fused",
    "mixed_rb_smooth_from_zero_fused",
    "mixed_prolong_smooth_fused",
    "mixed_rb_smooth_seg",            # K34
    "mixed_rb_smooth_from_zero_seg",  # K35
    "mixed_prolong_smooth_seg",       # K36
)
# kernel launches per wrapper, since the last reset_launches()
LAUNCHES = dict.fromkeys(KERNELS, 0)


def reset_launches() -> None:
    for name in KERNELS:
        LAUNCHES[name] = 0


def dirichlet_pin_planes(problem, n: int, device="cuda") -> torch.Tensor:
    """(2, n, n) f32 pin mask (1.0 at the Dirichlet patch nodes of the
    x = 0 / x = n-1 faces) on ``device``, from the problem's f64 geometry
    (``boundary_masks``), so the kernels' patch membership matches it
    exactly."""
    mask, _ = problem.boundary_masks(n)
    # The kernels pin Dirichlet nodes only on the two x faces; a patch
    # anywhere else would be silently treated as Neumann.
    if np.any(np.asarray(mask)[1 : n - 1]):
        raise ValueError(
            "pallas_mixed supports Dirichlet patches on the i=0/i=n-1 "
            "faces only; this problem has patch nodes on other faces"
        )
    out = np.stack([mask[0], mask[n - 1]]).astype(np.float32)
    return torch.from_numpy(out).to(device)


def apply_bcs_padded(e, pin, vals=None):
    """The BC pass (plain torch): whole-face Neumann copies in x, y, z
    order (``ops.stencils_3d.apply_neumann_copy``), then the Dirichlet pin
    of the x faces. ``pin``: (2, n, n) 0/1 patch masks; ``vals``: the
    (2, n, n) patch values, or None for the zero pin of a correction.
    Returns a new tensor (the JAX name is kept; the port has no padding)."""
    n = e.shape[0]
    e = ops3.apply_neumann_copy(e)
    v0 = torch.zeros_like(e[0]) if vals is None else vals[0]
    v1 = torch.zeros_like(e[0]) if vals is None else vals[1]
    e[0] = torch.where(pin[0] > 0.5, v0, e[0])
    e[n - 1] = torch.where(pin[1] > 0.5, v1, e[n - 1])
    return e


def _check_pin(pin, n: int, device, on_cuda: bool) -> bool:
    """The pin planes: (2, n, n) on the fields' device (float32 and
    contiguous on CUDA). Returns on_cuda."""
    if pin.device != device:
        raise ValueError(f"pin planes on {pin.device}, fields on {device}")
    if tuple(pin.shape) != (2, n, n):
        raise ValueError(f"expected (2, {n}, {n}) pin planes, got {tuple(pin.shape)}")
    if on_cuda and (pin.dtype != torch.float32 or not pin.is_contiguous()):
        raise TypeError("CUDA kernels take contiguous float32 pin planes")
    return on_cuda


def _on_cuda(pin, *fields, coarse=None) -> bool:
    """pallas3d's field checks, plus the pin planes."""
    return _check_pin(pin, fields[0].shape[0], fields[0].device,
                      pk._on_cuda(*fields, coarse=coarse))


# -------------------------------------------------- K13 / K14: mixed RB-GS


def mixed_rb_smooth_plain(e, r, pin, h: float, n_iter: int, red_first: bool = True):
    """Plain version of K13 in the copy form: each half-sweep followed by
    the zero-pin BC pass. Returns a new field."""
    red, black, _ = ops3._masks(e.shape[0], e.device)
    colors = (red, black) if red_first else (black, red)
    for _ in range(n_iter):
        for cmask in colors:
            e = apply_bcs_padded(ops3._half_sweep(e, r, h, cmask), pin)
    return e


def mixed_rb_smooth_from_zero_plain(r, pin, h: float, n_iter: int, red_first: bool = True):
    """Plain version of K14: K13 from a zero initial guess."""
    return mixed_rb_smooth_plain(torch.zeros_like(r), r, pin, h, n_iter, red_first)


def mixed_rb_smooth_fused(e, r, pin, h: float, n_iter: int, red_first: bool = True):
    """n_iter mixed-BC RB-GS iterations on the correction e (red first =
    pre-smoothing, black first = post-smoothing), ending with the BC pass,
    as a fresh field (e is left as it is; on both devices). ``e`` must be
    BC-consistent (the cycle's fields are). The CUDA form is one one-pass
    launch of the full-layout mixed stage on the loaded e for n_iter <= 2
    (the BC pass, z faces too, at its store); ceil(n_iter / 2) in all, each
    later one the same stage on the field so far, all counted as K13
    launches. Bound: e and r read and the output written, 12 B a point, and
    the pins (bytes over 3.35 TB/s: 0.0610 ms at 257^3)."""
    if n_iter < 1:
        raise ValueError(f"n_iter must be >= 1, got {n_iter}")
    if not _on_cuda(pin, e, r):
        return mixed_rb_smooth_plain(e, r, pin, h, n_iter, red_first)
    lib, stream, h2 = _lib(), _stream(), h * h
    for chunk in ps._stage_chunks(n_iter):
        e = _stage_launch(lib, e, r, pin, h2, chunk, red_first, stream, "mixed_rb_smooth_fused")
    return e


def mixed_rb_smooth_from_zero_fused(r, pin, h: float, n_iter: int, red_first: bool = True):
    """mixed_rb_smooth_fused from an implicit zero initial guess, as a
    fresh field. The CUDA form is one one-pass launch of the full-layout
    mixed stage for n_iter <= 2, its tile starting as zeros, the BC pass
    (z faces too) at its store; ceil(n_iter / 2) in all, each later one the
    same stage on the field so far, all counted as K14 launches. Bound: r
    read and the output written, 8 B a point, and the pins (bytes over
    3.35 TB/s: 0.0407 ms at 257^3)."""
    if n_iter < 1:
        raise ValueError(f"n_iter must be >= 1, got {n_iter}")
    if not _on_cuda(pin, r):
        return mixed_rb_smooth_from_zero_plain(r, pin, h, n_iter, red_first)
    lib, stream, h2 = _lib(), _stream(), h * h
    u = None
    for chunk in ps._stage_chunks(n_iter):
        u = _stage_launch(lib, u, r, pin, h2, chunk, red_first, stream,
                          "mixed_rb_smooth_from_zero_fused")
    return u


def _stage_launch(lib, u, r, pin, h2, n_iter, red_first, stream, name):
    """One launch of the full-layout mixed stage (on u, or from a zero field
    where u is None) against r into a fresh field, counted as ``name``'s."""
    n = r.shape[0]
    out = torch.empty_like(r)
    _check(lib.mg_mixed_stage(out.data_ptr(), None if u is None else u.data_ptr(), r.data_ptr(),
                              pin.data_ptr(), n, h2, int(red_first),
                              *ps._plan_args(n, n_iter, r.device, rect=True), stream), name)
    LAUNCHES[name] += 1
    return out


# ------------------------------ K15: mixed prolongation + correction + smooth


def mixed_prolong_smooth_plain(ec, e, r, pin, h: float, n_iter: int):
    """Plain version of K15: e + trilinear interpolation of ec (coarse
    boundary included; j, then k, then i), the BC pass, then the black-
    first copy-form stage."""
    t = ec
    for axis in (1, 2, 0):
        t = pk._interp_axis(t, axis)
    return mixed_rb_smooth_plain(apply_bcs_padded(e + t, pin), r, pin, h, n_iter,
                                 red_first=False)


def mixed_prolong_smooth_fused(ec, e, r, pin, h: float, n_iter: int):
    """The black-first mixed stage of e + P ec as a fresh field (e is left
    as it is): the post-smoothing stage of a mixed V-cycle level. The CUDA
    form is one one-pass launch for n_iter <= 2 (e + P ec made as each
    plane reaches shared memory, the live coarse boundary included, the BC
    pass at its store); a larger n_iter goes on with launches of K14's
    stage kernel on the field so far, black first, all counted as K15
    launches. Bound: e and r read and the output written, 12 B a fine
    point, ec and the pins read (bytes over 3.35 TB/s: 0.0635 ms at
    257^3)."""
    if n_iter < 1:
        raise ValueError(f"n_iter must be >= 1, got {n_iter}")
    if not _on_cuda(pin, e, r, coarse=ec):
        return mixed_prolong_smooth_plain(ec, e, r, pin, h, n_iter)
    name, n, h2 = "mixed_prolong_smooth_fused", e.shape[0], h * h
    lib, stream = _lib(), _stream()
    first, *rest = ps._stage_chunks(n_iter)
    out = torch.empty_like(e)
    _check(lib.mg_mixed_prolong_stage(
        out.data_ptr(), ec.data_ptr(), e.data_ptr(), r.data_ptr(), pin.data_ptr(), n, h2,
        *ps._plan_args(n, first, e.device, prolong=True, rect=True), stream), name)
    LAUNCHES[name] += 1
    for chunk in rest:
        out = _stage_launch(lib, out, r, pin, h2, chunk, False, stream, name)
    return out


# ------------------------------------- K34-K36: the stages on i-sharded blocks


def _stage_kl(gi0, n_iter: int, n: int) -> int:
    """Left halo planes of a sharded stage: 2 n_iter, and one more where
    global plane n - 1 is the block's first row (the BC copy there reads
    plane n - 2, which 2 n_iter half-sweeps leave stale in a 2 n_iter
    halo)."""
    hh = 2 * n_iter
    return hh + int(px._gi0_int(gi0) + hh == n - 1)


def _bcs_slab(u, g_first: int, n: int, pin):
    """The zero-pin BC pass on a slab whose first plane is global plane
    g_first (plain torch; a new tensor): the x-face copies where the slab
    holds the source plane, then the y and z copies and the pin on the
    planes 0 <= g <= n - 1 (``apply_bcs_padded``'s order)."""
    u = u.clone()
    rows = u.shape[0]
    t0, t1 = -g_first, n - 1 - g_first  # slab rows of global planes 0 and n - 1
    if 0 <= t0 < rows - 1:
        u[t0] = u[t0 + 1]
    if 1 <= t1 < rows:
        u[t1] = u[t1 - 1]
    v = u[max(t0, 0):max(min(t1 + 1, rows), 0)]
    v[:, 0] = v[:, 1]
    v[:, n - 1] = v[:, n - 2]
    v[:, :, 0] = v[:, :, 1]
    v[:, :, n - 1] = v[:, :, n - 2]
    for face, t in ((0, t0), (1, t1)):
        if 0 <= t < rows:
            u[t] = torch.where(pin[face] > 0.5, 0.0, u[t])
    return u


def _stage_slab(u, f, g_first: int, pin, h: float, n_iter: int, n: int, red_first: bool):
    """n_iter mixed RB iterations in the copy form on a slab (each
    half-sweep followed by ``_bcs_slab``); its first and last planes,
    which lack a neighbour, are never swept."""
    interior, parity = px._slab_masks(g_first, u.shape[0], n, u.device)
    interior[0] = False
    interior[-1] = False
    red, black = interior & (parity == RED), interior & (parity == BLACK)
    for _ in range(n_iter):
        for cmask in ((red, black) if red_first else (black, red)):
            u = _bcs_slab(ops3._half_sweep(u, f, h, cmask), g_first, n, pin)
    return u


def _seg_planes(gi0, n_iter: int, n: int, L: int) -> int:
    """The planes a K34, K35 or K36 launch tiles (rect.cuh, seg_geometry): the
    rank's rows clipped to n - 1, with plane n - 2 where plane n - 1 is row
    0; at least 1, the plan of a rank of pad rows only."""
    g0 = px._gi0_int(gi0) + 2 * n_iter
    return max(1, min(g0 + L, n) - g0 + (g0 == n - 1))


def _seg_on_cuda(pin, n: int, *segs, coarse=None) -> bool:
    """pallas_sharded's segment checks, plus the pin planes."""
    return _check_pin(pin, n, segs[0].body.device, px._segs_on_cuda(n, *segs, coarse=coarse))


def _seg_stage(u, f, pin, kl: int, kr: int, L: int, n: int, g0: int, h2: float, colors, name):
    """Launch the first form's in-place half-sweeps of ``colors`` on
    segment u, then its BC pass over the body rows, each counted as a
    launch of ``name``."""
    lib, stream = _lib(), _stream()
    for c in colors:
        _check(lib.mg_seg_mixed_half_sweep(*px._ptrs(u), *px._ptrs(f), pin.data_ptr(), kl, L, kr,
                                           n, g0, h2, c, stream), name)
        LAUNCHES[name] += 1
    _check(lib.mg_seg_mixed_bc_pass(*px._ptrs(u), pin.data_ptr(), kl, L, kr, n, g0, stream), name)
    LAUNCHES[name] += 1


def _seg_mixed_stage(u, f, pin, kl: int, L: int, kr: int, n: int, g0: int, h2: float,
                     red_first: bool, n_iter: int, name: str):
    """One launch of the segment mixed stage (K34 on the segment u, K35
    from a zero tile where u is None) against f into a fresh (L, n, n)
    body, counted as ``name``'s."""
    out = torch.empty_like(f.body)
    _check(_lib().mg_seg_mixed_stage(
        out.data_ptr(), *((None, None, None, 0) if u is None else px._ptrs(u)), *px._ptrs(f),
        pin.data_ptr(), kl, L, kr, n, g0, h2, int(red_first),
        *ps._plan_args(n, n_iter, f.body.device, rect=True,
                       seg_planes=_seg_planes(g0 - 2 * n_iter, n_iter, n, L)), _stream()), name)
    LAUNCHES[name] += 1
    return out


def mixed_rb_smooth_halo_plain(u3, f3, pin, gi0, h: float, n_iter: int, n: int, L: int,
                               red_first: bool = True):
    """Plain version of K34: the copy-form stage on the slab of rows
    [-kl, L + 2 n_iter) (kl of ``_stage_kl``); returns the L owned planes
    (u3 untouched). ``u3`` must be BC-consistent, as for K13."""
    hh, kl = 2 * n_iter, _stage_kl(gi0, n_iter, n)
    u, f = px._seg(u3, kl, hh, L), px._seg(f3, kl, hh, L)
    out = _stage_slab(u.rows(kl, hh), f.rows(kl, hh), px._gi0_int(gi0) + hh - kl, pin, h,
                      n_iter, n, red_first)
    return out[kl:kl + L]


def mixed_rb_smooth_halo(u3, f3, pin, gi0, h: float, n_iter: int, n: int, L: int,
                         red_first: bool = True, block_i: int = 8):
    """All 2 n_iter mixed RB half-sweeps of a smoothing stage and its BC
    pass on a rank's block from (local, lh, rhc) triples with 2 n_iter
    halo planes (2 n_iter + 1 on the left where global plane n - 1 is the
    first row; composite tails read off the shapes); gi0 = rank * L -
    2 n_iter. A fresh (L, n, n) block, its pad rows u's (u3 is left as it
    is, on both devices). The CUDA form for n_iter <= 2 is one launch of
    K13's one-pass stage on the segments (u's and f's rows read through
    them, the BC pass at the store; bound: u's and f's rows read and the
    body written, 12 B a point, and the pins). Past n_iter 2 it keeps its
    first form, which no solve runs: 2 n_iter half-sweep launches and a
    BC-pass launch in place on a copy of u's segments. Every launch counts
    as K34's."""
    del block_i
    if n_iter < 1:
        raise ValueError(f"n_iter must be >= 1, got {n_iter}")
    hh, kl = 2 * n_iter, _stage_kl(gi0, n_iter, n)
    u, f = px._seg(u3, kl, hh, L), px._seg(f3, kl, hh, L)
    if not _seg_on_cuda(pin, n, u, f):
        return mixed_rb_smooth_halo_plain(u3, f3, pin, gi0, h, n_iter, n, L, red_first)
    name, g0, h2 = "mixed_rb_smooth_seg", px._gi0_int(gi0) + hh, h * h
    if n_iter <= 2:
        return _seg_mixed_stage(u, f, pin, kl, L, hh, n, g0, h2, red_first, n_iter, name)
    u = px._Seg(*(t.clone() for t in u[:3]), u.r_off)
    _seg_stage(u, f, pin, kl, hh, L, n, g0, h2, list(_colors(red_first)) * n_iter, name)
    return u.body


def mixed_rb_smooth_ext(u_ext, f_ext, pin, gi0, h: float, n_iter: int, n: int, L: int,
                        red_first: bool = True, block_i: int = 8):
    """mixed_rb_smooth_halo on ext tensors (L + 4 n_iter planes, as the
    JAX kernel takes them): the same launches on their views; a fresh (L,
    n, n) block (u_ext is left as it is). Raises where global plane n - 1
    is the first row (the halo form serves it)."""
    hh = 2 * n_iter
    return mixed_rb_smooth_halo(px._ext_parts(u_ext, hh, L), px._ext_parts(f_ext, hh, L), pin,
                                gi0, h, n_iter, n, L, red_first, block_i)


def mixed_rb_smooth_from_zero_halo_plain(f3, pin, gi0, h: float, n_iter: int, n: int, L: int,
                                         red_first: bool = True):
    """Plain version of K35: the K34 plain stage from a zero slab."""
    hh, kl = 2 * n_iter, _stage_kl(gi0, n_iter, n)
    f = px._seg(f3, kl, hh, L).rows(kl, hh)
    out = _stage_slab(torch.zeros_like(f), f, px._gi0_int(gi0) + hh - kl, pin, h, n_iter, n,
                      red_first)
    return out[kl:kl + L]


def mixed_rb_smooth_from_zero_halo(f3, pin, gi0, h: float, n_iter: int, n: int, L: int,
                                   red_first: bool = True, block_i: int = 8):
    """mixed_rb_smooth_halo from an implicit zero initial guess: a fresh
    (L, n, n) block, its pad rows zero. The CUDA form for n_iter <= 2 is one
    launch of K14's one-pass stage on the segment (f's rows read through it,
    the BC pass at the store; bound: f's rows read and the body written, 8 B
    a point, and the pins). Past n_iter 2 it keeps its first form, which no
    solve runs: K29's from-zero half-sweep (from a zero field the folded
    reads are zero too) into the body and two scratch halo buffers, then 2
    n_iter - 1 K34 half-sweeps and the BC pass. Every launch counts as
    K35's."""
    del block_i
    hh, kl = 2 * n_iter, _stage_kl(gi0, n_iter, n)
    f = px._seg(f3, kl, hh, L)
    if not _seg_on_cuda(pin, n, f):
        return mixed_rb_smooth_from_zero_halo_plain(f3, pin, gi0, h, n_iter, n, L, red_first)
    name, g0, h2 = "mixed_rb_smooth_from_zero_seg", px._gi0_int(gi0) + hh, h * h
    if n_iter <= 2:
        return _seg_mixed_stage(None, f, pin, kl, L, hh, n, g0, h2, red_first, n_iter, name)
    out = px._Seg(f.body.new_empty((kl, n, n)), torch.empty_like(f.body),
                  f.body.new_empty((hh, n, n)), 0)
    first, second = _colors(red_first)
    _check(_lib().mg_seg_half_sweep_from_zero(*px._ptrs(out)[:3], *px._ptrs(f), kl, L, hh, n, g0,
                                              h2, first, _stream()), name)
    LAUNCHES[name] += 1
    _seg_stage(out, f, pin, kl, hh, L, n, g0, h2,
               [second] + list(_colors(red_first)) * (n_iter - 1), name)
    return out.body


def mixed_rb_smooth_from_zero_ext(f_ext, pin, gi0, h: float, n_iter: int, n: int, L: int,
                                  red_first: bool = True, block_i: int = 8):
    """mixed_rb_smooth_from_zero_halo on an ext tensor (L + 4 n_iter planes)."""
    return mixed_rb_smooth_from_zero_halo(px._ext_parts(f_ext, 2 * n_iter, L), pin, gi0, h,
                                          n_iter, n, L, red_first, block_i)


def _prolong_segs(ec3, e3, r3, gi0, n_iter: int, n: int, L: int):
    """(kl, coarse, e, r segments) of a K36 call: the coarse segment with
    kl - n_iter planes on the left and n_iter + 1 on the right."""
    if n_iter < 1:
        raise ValueError(f"n_iter must be >= 1, got {n_iter}")
    hh, kl = 2 * n_iter, _stage_kl(gi0, n_iter, n)
    return (kl, px._seg(ec3, kl - n_iter, n_iter + 1, L // 2), px._seg(e3, kl, hh, L),
            px._seg(r3, kl, hh, L))


def mixed_prolong_smooth_halo_plain(ec3, e3, r3, pin, gi0, h: float, n_iter: int, n: int,
                                    L: int):
    """Plain version of K36: e + trilinear interpolation of ec (coarse
    boundary included; j, then k, then i, as K15's plain version) on fine
    rows [-kl, L + 2 n_iter) (not on pad planes), the BC pass, then the
    black-first K34 plain stage; returns the L owned planes."""
    hh = 2 * n_iter
    kl, c, e, r = _prolong_segs(ec3, e3, r3, gi0, n_iter, n, L)
    t = c.rows(c.kl, n_iter + 1)              # coarse rows [-kl_c, Lc + n_iter]
    for axis in (1, 2, 0):
        t = pk._interp_axis(t, axis)          # fine rows [-2 kl_c, L + hh]
    skip = 2 * c.kl - kl
    g_first = px._gi0_int(gi0) + hh - kl
    t = t[skip:skip + kl + L + hh]
    pad = (torch.arange(t.shape[0], device=t.device) + g_first >= n)[:, None, None]
    t = torch.where(pad, torch.zeros_like(t), t)  # pad planes take no correction
    u = _bcs_slab(e.rows(kl, hh) + t, g_first, n, pin)
    out = _stage_slab(u, r.rows(kl, hh), g_first, pin, h, n_iter, n, red_first=False)
    return out[kl:kl + L]


def mixed_prolong_smooth_halo(ec3, e3, r3, pin, gi0, h: float, n_iter: int, n: int, L: int,
                              block_i: int = 8):
    """The black-first mixed stage of e + P ec on a rank's block: fine
    triples with 2 n_iter halo planes (2 n_iter + 1 on the left where
    global plane n - 1 is the first row), the coarse triple with n_iter
    (there n_iter + 1) on the left and n_iter + 1 on the right (composite
    tails read off the shapes); gi0 = rank * L - 2 n_iter. A fresh (L, n,
    n) block, its pad rows e's (e is left as it is). The CUDA form for
    n_iter <= 2 is one launch of K15's one-pass stage on the segments (e +
    P ec made as each plane reaches shared memory, the coarse rows read
    through their segment, the BC pass at the store; bound: e's and r's
    rows read and the body written, 12 B a fine point, the coarse rows and
    the pins). Past n_iter 2 it keeps its first form, which no solve runs:
    one launch of the correction and the first black half-sweep into a
    fresh segment, 2 n_iter - 1 K34 half-sweeps and the BC pass. Every
    launch counts as K36's."""
    del block_i
    hh = 2 * n_iter
    kl, c, e, r = _prolong_segs(ec3, e3, r3, gi0, n_iter, n, L)
    if not _seg_on_cuda(pin, n, e, r, coarse=c):
        return mixed_prolong_smooth_halo_plain(ec3, e3, r3, pin, gi0, h, n_iter, n, L)
    name, g0, h2 = "mixed_prolong_smooth_seg", px._gi0_int(gi0) + hh, h * h
    if n_iter <= 2:
        out = torch.empty_like(e.body)
        _check(_lib().mg_seg_mixed_prolong_stage(
            out.data_ptr(), *px._ptrs(c), c.kl, c.rh.shape[0] - c.r_off, *px._ptrs(e),
            *px._ptrs(r), pin.data_ptr(), kl, L, hh, n, g0, h2,
            *ps._plan_args(n, n_iter, e.body.device, prolong=True, rect=True,
                           seg_planes=_seg_planes(gi0, n_iter, n, L)), _stream()), name)
        LAUNCHES[name] += 1
        return out
    out = px._Seg(e.body.new_empty((kl, n, n)), torch.empty_like(e.body),
                  e.body.new_empty((hh, n, n)), 0)
    _check(_lib().mg_seg_mixed_prolong_correct_black(
        *px._ptrs(out)[:3], *px._ptrs(c), c.kl, c.rh.shape[0] - c.r_off, *px._ptrs(e),
        *px._ptrs(r), pin.data_ptr(), kl, L, hh, n, g0, h2, _stream()), name)
    LAUNCHES[name] += 1
    _seg_stage(out, r, pin, kl, hh, L, n, g0, h2, [RED] + [BLACK, RED] * (n_iter - 1), name)
    return out.body


def mixed_prolong_smooth_ext(ec_ext, e_ext, r_ext, pin, gi0, h: float, n_iter: int, n: int,
                             L: int, block_i: int = 8):
    """mixed_prolong_smooth_halo on ext tensors, as the JAX kernel takes
    them: e_ext, r_ext with a 2 n_iter fine halo, ec_ext with an n_iter + 1
    coarse halo on both sides. Raises where global plane n - 1 is the
    first row (the halo form serves it)."""
    hh = 2 * n_iter
    return mixed_prolong_smooth_halo(px._ext_parts(ec_ext, n_iter + 1, L // 2),
                                     px._ext_parts(e_ext, hh, L), px._ext_parts(r_ext, hh, L),
                                     pin, gi0, h, n_iter, n, L, block_i)
