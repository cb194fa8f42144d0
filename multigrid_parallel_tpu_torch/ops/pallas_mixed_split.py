"""The mixed-BC (electrospray) split-colour kernels of the finest level,
hand-written in CUDA for Hopper, with their plain PyTorch versions, the
pin and value packs, the fold <-> pair conversions and the outer step's
BC pass.

Counterpart of ``multigrid_parallel_tpu.ops.pallas_mixed_split``. A field
is a (red, black) pair in ``ops.pallas_split``'s layout, ``split_shape(n)
= (n, n, (n - 1) // 2)`` per colour, slot kk of a colour in row (i, j)
holding grid plane k = 2 kk + 1 + p. As in the fold layout
(``ops.pallas_mixed_fold``), the k faces are not stored: the mixed BC
makes a k-face node a copy of its stored neighbour, so the kernels fold
their k-edge reads to the reader's own value. The i and j boundary rows
are stored and kept by a cross-colour BC pass. The dead slot of each row
(slot S - 1 of the colour holding the row's even k's) is 0, as in
``pallas_split``.

Wrapper, the Pallas kernel it replaces in
multigrid_parallel_tpu/ops/pallas_mixed_split.py, and its CUDA source in
ops/csrc/ (all share msplit.cuh, on mixed.cuh and split.cuh):

  K21 mixed_rb_smooth_msplit            mixed_rb_smooth_msplit            mixed_rb_smooth_msplit.cu
  K22 mixed_rb_smooth_from_zero_msplit  mixed_rb_smooth_from_zero_msplit  mixed_rb_smooth_msplit.cu
  K23 residual_restrict_msplit          residual_restrict_msplit          residual_restrict_msplit.cu
  K24 mixed_prolong_smooth_msplit       mixed_prolong_smooth_msplit       mixed_prolong_smooth_msplit.cu
  K25 residual_df_norm_msplit           residual_df_norm_msplit           residual_df_norm_msplit.cu

K23 emits the coarse RHS in the fold layout and K24 reads the coarse fold
correction: the levels below run the fold cycle. On the TPU the pair's
128-lane width equals the coarse fold's; here the pair has (n - 1) / 2
slots and the coarse fold nc - 2 = (n - 3) / 2 columns, so both kernels
index the coarse field by its own shape.

The plain versions of K21, K22 and K25 are the fold plain versions (K16,
K17, K20) between ``split_to_fold`` and ``fold_to_split``: the kernels
sum the same six terms in the same order, so the split tier is tied to
the fold tier bit for bit. K23 and K24 keep the Pallas kernels' order of
taps (k, i, j for the restriction; j, i, k for the interpolation), which
is not K18's or K19's, so their plain versions follow that order; K24's
smoothing is then K21's plain version.

Not carried over (TPU planning, the same half-sweep sequence):
``msplit_widths_ok`` (a lane contract, above), the ``msplit_*_block_i``
planners and the ``block_i`` and ``with_delta`` arguments (K24 reads the
sign planes at the x faces' k edges only).

K21, K22 and K24 are one-pass stages: one launch of split.cuh's
``stage_body`` in its mixed-BC mode a call for n_iter <= 2, on
``pallas_split._stage_plan``'s plan with ``msplit`` (K7's and, for K24,
K10's; the fewest-steps plan on a level up to 65^3), all 2 n_iter
half-sweeps on tiles of both colours in shared memory, the faces'
neighbours selects of the slot's own value, the cross-colour BC pass done
at store time, K21's tiles loaded from its pair (only the live interior
slots of which reach the output), K22's zeros, K24's e + P ec made as each
plane arrives: a fresh pair, bit for bit the plain version's. A larger
n_iter goes on with the same stage on the pair so far (``mg_msplit_stage``
with u loaded), ceil(n_iter / 2) launches in all. K23 is restrict.cuh's
streaming restriction stage on the pair (K9's tile and plan, the mixed k
edge, the coarse fold out), one launch a call, bit for bit the plain
version's, on levels from ``pallas_split.MSPLIT_RESTRICT_STAGE_MIN_N`` up
and its first form, one thread a coarse point, below. Bound: device-memory
bytes (``chip_smoke.bound``; their sources' headers give them and ptxas's
registers and spills).

A wrapper takes the plain version for tensors on the CPU, launches its
kernel for CUDA tensors (float32, contiguous, pairs of ``split_shape(n)``
with n odd >= 5; packs (2, 2, n, (n - 1) // 2); K24's coarse fold field
and sign planes of the next coarser level), and raises for anything else:
no fallback from the kernel to the plain version. Each kernel launch adds
one to its entry in ``LAUNCHES`` (K25's is the pair, partials then
their sum).
"""

from __future__ import annotations

import torch

from multigrid_parallel_tpu_torch.ops import pallas3d as pk
from multigrid_parallel_tpu_torch.ops import pallas_mixed as pm
from multigrid_parallel_tpu_torch.ops import pallas_mixed_fold as pmf
from multigrid_parallel_tpu_torch.ops import pallas_split as ps
from multigrid_parallel_tpu_torch.ops import stencils_3d as ops3
from multigrid_parallel_tpu_torch.ops.pallas3d import _check, _lib, _stream

KERNELS = (
    "mixed_rb_smooth_msplit",
    "mixed_rb_smooth_from_zero_msplit",
    "residual_restrict_msplit",
    "mixed_prolong_smooth_msplit",
    "residual_df_norm_msplit",
)
# kernel launches per wrapper, since the last reset_launches()
LAUNCHES = dict.fromkeys(KERNELS, 0)


def reset_launches() -> None:
    for name in KERNELS:
        LAUNCHES[name] = 0


# ------------------------------------------------------------------ layout


def msplit_plane_packs(planes: torch.Tensor) -> torch.Tensor:
    """(2, n, n) x-face planes (k last) -> (2, 2, n, (n - 1) // 2) parity
    packs: packs[p][face][j, kk] = planes[face][j, 2 kk + 1 + p], 0 past
    k = n - 2. A reader of colour c in row (i, j) takes pack p =
    (i + j) % 2 for red and 1 - that for black. For the outer step's
    Dirichlet patch values."""
    n = planes.shape[-1]
    if tuple(planes.shape) != (2, n, n):
        raise ValueError(f"expected (2, n, n) face planes, got {tuple(planes.shape)}")
    s = ps.split_shape(n)[2]
    out = planes.new_zeros((2, 2, n, s))
    out[0] = planes[..., 1 : 2 * s : 2]
    out[1, ..., : s - 1] = planes[..., 2 : n - 2 : 2]
    return out


def msplit_pin_packs(problem, n: int, device="cuda") -> torch.Tensor:
    """(2, 2, n, (n - 1) // 2) f32 x-face Dirichlet pin masks in parity
    packs (``msplit_plane_packs`` of ``pallas_mixed.dirichlet_pin_planes``,
    which raises for a patch off the x faces) on ``device``."""
    return msplit_plane_packs(pm.dirichlet_pin_planes(problem, n, device))


def _fold_pins(packs: torch.Tensor) -> torch.Tensor:
    """Parity packs -> the (2, n, n - 2) fold pin planes (slot a = 2 kk + p
    holds grid plane k = a + 1)."""
    n = packs.shape[2]
    return torch.stack([packs[0], packs[1]], dim=-1).flatten(-2)[..., : n - 2]


def fold_to_split(xf: torch.Tensor):
    """An (n, n, n - 2) fold field -> (red, black) pair, the dead slots 0.
    Torch indexing, for setup and tests only: the cycle never converts
    layouts."""
    n = xf.shape[0]
    if tuple(xf.shape) != pmf.fold_shape(n):
        raise ValueError(f"expected an (n, n, n - 2) fold field, got {tuple(xf.shape)}")
    out = []
    for k in ps._slot_k(n, xf.device):
        k = k.expand(ps.split_shape(n))
        vals = torch.gather(xf, 2, torch.clamp(k - 1, max=n - 3))
        out.append(torch.where(k <= n - 2, vals, torch.zeros_like(vals)))
    return out[0], out[1]


def split_to_fold(xr: torch.Tensor, xb: torch.Tensor) -> torch.Tensor:
    """(red, black) pair -> the (n, n, n - 2) fold field (the dead slots
    are dropped)."""
    n = xr.shape[0]
    idx = torch.arange(n, device=xr.device)
    q = (idx[:, None, None] + idx[None, :, None]) % 2  # red's p in row (i, j)
    a = torch.arange(n - 2, device=xr.device)[None, None, :]  # slot a: k = a + 1
    shape = pmf.fold_shape(n)
    kk_r = torch.clamp((a - q) // 2, min=0).expand(shape)
    kk_b = torch.clamp((a - 1 + q) // 2, min=0).expand(shape)
    return torch.where((q + a) % 2 == 0, torch.gather(xr, 2, kk_r), torch.gather(xb, 2, kk_b))


def apply_bcs_split_pair(ar, ab, packs, vals=None):
    """``mixed_padded.apply_bcs_fold`` on a pair (plain torch, as JAX
    leaves it to XLA): x then y Neumann copies, each from the OTHER colour
    at the same slot (the node across a face has the other colour and the
    same slot), the y copies from the post-x values, then the x-face pin
    to ``vals`` (``msplit_plane_packs`` of the patch values; None for the
    zero pin of a correction). Returns a new pair."""
    n = ar.shape[0]
    r, b = ar.clone(), ab.clone()
    r[0], r[n - 1] = ab[1], ab[n - 2]
    b[0], b[n - 1] = ar[1], ar[n - 2]
    r[:, 0], r[:, n - 1] = b[:, 1], b[:, n - 2]
    b[:, 0], b[:, n - 1] = r[:, 1], r[:, n - 2]
    # rows i = 0 and n - 1 are even (n odd): red's pack is p = j % 2
    even_j = (torch.arange(n, device=ar.device) % 2 == 0)[:, None]
    for out, red in ((r, True), (b, False)):
        for face, i in ((0, 0), (1, n - 1)):
            p_even, p_odd = (0, 1) if red else (1, 0)
            pin = torch.where(even_j, packs[p_even, face], packs[p_odd, face])
            v = (torch.zeros_like(out[i]) if vals is None
                 else torch.where(even_j, vals[p_even, face], vals[p_odd, face]))
            out[i] = torch.where(pin > 0.5, v, out[i])
    return r, b


# ------------------------------------------------------------------ checks


def _on_cuda(*fields, packs=None, coarse=None, sgn=None) -> bool:
    """False for CPU tensors (plain path); True for CUDA tensors that the
    kernels take; raises for anything else. ``fields`` are one level's
    pair tensors, ``split_shape(n)`` with n odd >= 5; ``packs``, if given,
    (2, 2, n, (n - 1) // 2); ``coarse`` a fold field of the next coarser
    level and ``sgn`` its (2, nc, nc - 2) sign planes."""
    n = fields[0].shape[0]
    if n < 5 or n % 2 == 0:
        raise ValueError(f"a split level has an odd size n >= 5, got n = {n}")
    s = ps.split_shape(n)[2]
    want = [(x, ps.split_shape(n)) for x in fields]
    if packs is not None:
        want.append((packs, (2, 2, n, s)))
    if coarse is not None:
        nc = (n + 1) // 2
        want += [(coarse, pmf.fold_shape(nc)), (sgn, (2, nc, nc - 2))]
    for x, shape in want:
        if tuple(x.shape) != shape:
            raise ValueError(f"expected a tensor of shape {shape}, got {tuple(x.shape)}")
    dev = fields[0].device
    if any(x.device != dev for x, _ in want):
        raise ValueError(f"tensors on different devices: {[str(x.device) for x, _ in want]}")
    if dev.type == "cpu":
        return False
    if dev.type != "cuda":
        raise ValueError(f"no kernel for device {dev}")
    for x, _ in want:
        if x.dtype != torch.float32:
            raise TypeError(f"CUDA kernels take float32, got {x.dtype}")
        if not x.is_contiguous():
            raise ValueError("CUDA kernels take contiguous tensors")
    if n * n * s >= 2 ** 31:
        raise ValueError(f"n = {n} overflows the kernels' int32 slot index")
    return True


# -------------------------------------------------- K21 / K22: mixed RB-GS


def mixed_rb_smooth_msplit_plain(er, eb, fr, fb, packs, h: float, n_iter: int,
                                 red_first: bool = True):
    """Plain version of K21: K16's plain version on the fold field of the
    pair, back to a pair. Returns a new pair."""
    out = pmf.mixed_rb_smooth_fold_plain(split_to_fold(er, eb), split_to_fold(fr, fb),
                                         _fold_pins(packs), h, n_iter, red_first)
    return fold_to_split(out)


def mixed_rb_smooth_from_zero_msplit_plain(fr, fb, packs, h: float, n_iter: int,
                                           red_first: bool = True):
    """Plain version of K22: K21 from a zero initial pair."""
    return mixed_rb_smooth_msplit_plain(torch.zeros_like(fr), torch.zeros_like(fb), fr, fb,
                                        packs, h, n_iter, red_first)


def mixed_rb_smooth_msplit(er, eb, fr, fb, packs, h: float, n_iter: int,
                           red_first: bool = True):
    """n_iter mixed-BC RB-GS iterations on the correction pair (red first
    = pre-smoothing, black first = post-smoothing), ending with the
    cross-colour BC pass, as a fresh pair: er and eb are left as they are
    (on both devices), and only their live interior slots are read. The
    CUDA form is one one-pass launch of the mixed stage on the pair for
    n_iter <= 2; ceil(n_iter / 2) in all, each later one on the pair so
    far."""
    if n_iter < 1:
        raise ValueError(f"n_iter must be >= 1, got {n_iter}")
    if not _on_cuda(er, eb, fr, fb, packs=packs):
        return mixed_rb_smooth_msplit_plain(er, eb, fr, fb, packs, h, n_iter, red_first)
    lib, stream, h2, name = _lib(), _stream(), h * h, "mixed_rb_smooth_msplit"
    for chunk in ps._stage_chunks(n_iter):
        er, eb = _stage_launch(lib, er, eb, fr, fb, packs, h2, chunk, red_first, stream, name)
    return er, eb


def _stage_launch(lib, er, eb, fr, fb, packs, h2, n_iter, red_first, stream, name):
    """One launch of the mixed stage on a pair (K21's; K22's from a zero
    pair, where er and eb are None) into a fresh pair, counted as
    ``name``'s."""
    n = fr.shape[0]
    out_r, out_b = torch.empty_like(fr), torch.empty_like(fb)
    _check(lib.mg_msplit_stage(out_r.data_ptr(), out_b.data_ptr(),
                               None if er is None else er.data_ptr(),
                               None if eb is None else eb.data_ptr(), fr.data_ptr(),
                               fb.data_ptr(), packs.data_ptr(), n, h2, int(red_first),
                               *ps._plan_args(n, n_iter, fr.device, msplit=True), stream), name)
    LAUNCHES[name] += 1
    return out_r, out_b


def mixed_rb_smooth_from_zero_msplit(fr, fb, packs, h: float, n_iter: int,
                                     red_first: bool = True):
    """mixed_rb_smooth_msplit from an implicit zero initial pair, as a
    fresh pair (dead slots 0, the boundary rows holding the BC). The CUDA
    form is one one-pass launch of the mixed stage from a zero tile for
    n_iter <= 2 (nothing is read but f and the pins); ceil(n_iter / 2) in
    all, each later one the stage on the pair so far, all counted as K22
    launches."""
    if n_iter < 1:
        raise ValueError(f"n_iter must be >= 1, got {n_iter}")
    if not _on_cuda(fr, fb, packs=packs):
        return mixed_rb_smooth_from_zero_msplit_plain(fr, fb, packs, h, n_iter, red_first)
    lib, stream, h2 = _lib(), _stream(), h * h
    er = eb = None
    for chunk in ps._stage_chunks(n_iter):
        er, eb = _stage_launch(lib, er, eb, fr, fb, packs, h2, chunk, red_first, stream,
                               "mixed_rb_smooth_from_zero_msplit")
    return er, eb


# -------------------------------------------- K23: residual + restriction


def residual_restrict_msplit_plain(er, eb, rr, rb, h: float):
    """Plain version of K23: the residual on the unpacked fold field (the
    k-edge reads fold to the centre), then the Pallas kernel's taps in its
    order: k, 0.25 (res(2kc - 1) + res(2kc + 1)) + 0.5 res(2kc); then i;
    then j. The coarse x and y faces are zero."""
    n = er.shape[0]
    e, r = (pmf.unpack_fold(split_to_fold(a, b)) for a, b in ((er, eb), (rr, rb)))
    res = ops3.residual(e, r, h)
    t = 0.25 * (res[..., 1 : n - 2 : 2] + res[..., 3:n:2]) + 0.5 * res[..., 2 : n - 1 : 2]
    t = pk._restrict_axis(pk._restrict_axis(t, 0), 1)
    nc = (n + 1) // 2
    out = er.new_zeros(pmf.fold_shape(nc))
    out[1:-1, 1:-1] = t
    return out


def residual_restrict_msplit(er, eb, rr, rb, h: float):
    """Correction pair (er, eb) and its RHS pair -> the (nc, nc, nc - 2)
    coarse fold RHS, nc = (n + 1) / 2: full weighting of the interior
    residual, zero coarse x and y faces, without storing the fine
    residual; the inputs are left as they are. The CUDA form is one
    launch: the streaming restriction stage on K9's plan
    (``_restrict_plan(n, sms, split=True)``) where n >=
    ``pallas_split.MSPLIT_RESTRICT_STAGE_MIN_N``, else the first form."""
    if not _on_cuda(er, eb, rr, rb):
        return residual_restrict_msplit_plain(er, eb, rr, rb, h)
    n = er.shape[0]
    out = er.new_empty(pmf.fold_shape((n + 1) // 2))
    lib, inv_h2 = _lib(), 1.0 / (h * h)
    ptrs = (out.data_ptr(), er.data_ptr(), eb.data_ptr(), rr.data_ptr(), rb.data_ptr())
    if n >= ps.MSPLIT_RESTRICT_STAGE_MIN_N:
        err = lib.mg_msplit_restrict_stage(*ptrs, n, inv_h2,
                                           *ps._restrict_args(n, er.device, split=True),
                                           _stream())
    else:
        err = lib.mg_msplit_residual_restrict(*ptrs, n, inv_h2, _stream())
    _check(err, "residual_restrict_msplit")
    LAUNCHES["residual_restrict_msplit"] += 1
    return out


# --------------------------- K24: mixed prolongation + correction + smooth


def _interp_ji(c, n: int):
    """(nc, nc, m) -> (n, n, m): j (even fine j copy, odd 0.5 a + 0.5 b),
    then i (odd 0.5 (a + b)), as the Pallas kernel and K24 do."""
    y = pk._interp_axis(c, 1)
    out = y.new_empty((n,) + tuple(y.shape[1:]))
    out[0::2] = y
    out[1::2] = 0.5 * (y[:-1] + y[1:])
    return out


def _prolong_msplit(ec, sgn_c, n: int):
    """(corr_r, corr_b): the coarse fold correction at each colour's slots
    in the Pallas kernel's order. Y = ec interpolated j, then i; a slot of
    parity 1 (k = 2 kc) takes Y[kk]; one of parity 0 (k = 2 kk + 1)
    takes 0.5 (Y[lo] + Y[hi]) + 0.5 d, lo = max(kk - 1, 0), hi = min(kk,
    nc - 3): the unstored coarse k faces fold to their stored neighbours,
    and d, the same interpolation of sgn_c * (the adjacent interior i
    plane) on the coarse x faces, fixes the x faces' k edges (at kk = 0
    and nc - 2; 0 elsewhere)."""
    nc, s = ec.shape[0], ps.split_shape(n)[2]
    y = _interp_ji(ec, n)
    delta = torch.zeros_like(ec)
    delta[0], delta[-1] = sgn_c[0] * ec[1], sgn_c[1] * ec[-2]
    d = _interp_ji(delta, n)
    kk = torch.arange(s, device=ec.device)
    lo, hi = torch.clamp(kk - 1, min=0), torch.clamp(kk, max=nc - 3)
    dd = torch.zeros_like(y[..., :1]).expand(n, n, s).clone()
    dd[..., 0], dd[..., s - 1] = d[..., 0], d[..., nc - 3]
    avg = 0.5 * (y[..., lo] + y[..., hi]) + 0.5 * dd
    even = torch.cat([y, torch.zeros_like(y[..., :1])], dim=-1)  # slot s - 1 is dead
    red_odd = ps._masks(n, ec.device)[0]
    return torch.where(red_odd, avg, even), torch.where(red_odd, even, avg)


def mixed_prolong_smooth_msplit_plain(ec, er, eb, rr, rb, packs, sgn_c, h: float, n_iter: int):
    """Plain version of K24: the correction added at each colour's live
    interior slots, then K21's plain version, black first."""
    _, live_r, live_b = ps._masks(er.shape[0], er.device)
    corr_r, corr_b = _prolong_msplit(ec, sgn_c, er.shape[0])
    er = er + torch.where(live_r, corr_r, torch.zeros_like(corr_r))
    eb = eb + torch.where(live_b, corr_b, torch.zeros_like(corr_b))
    return mixed_rb_smooth_msplit_plain(er, eb, rr, rb, packs, h, n_iter, red_first=False)


def mixed_prolong_smooth_msplit(ec, er, eb, rr, rb, packs, sgn_c, h: float, n_iter: int):
    """The black-first mixed stage of (er, eb) + P ec as a fresh pair (er,
    eb are left as they are): the post-smoothing stage of the finest level,
    ec the (nc, nc, nc - 2) coarse fold correction and ``sgn_c`` its
    level's ``fold_edge_sign_planes`` (or the coarsest level's LU rule).
    The CUDA form is one one-pass launch for n_iter <= 2 (the correction
    made as each plane reaches shared memory, the BC pass at store time); a
    larger n_iter goes on with the mixed stage on the pair so far, black
    first, counted as K24's."""
    if n_iter < 1:
        raise ValueError(f"n_iter must be >= 1, got {n_iter}")
    if not _on_cuda(er, eb, rr, rb, packs=packs, coarse=ec, sgn=sgn_c):
        return mixed_prolong_smooth_msplit_plain(ec, er, eb, rr, rb, packs, sgn_c, h, n_iter)
    name, lib, stream, n, h2 = "mixed_prolong_smooth_msplit", _lib(), _stream(), er.shape[0], h * h
    first, *rest = ps._stage_chunks(n_iter)
    out_r, out_b = torch.empty_like(er), torch.empty_like(eb)
    _check(lib.mg_msplit_prolong_stage(out_r.data_ptr(), out_b.data_ptr(), ec.data_ptr(),
                                       sgn_c.data_ptr(), er.data_ptr(), eb.data_ptr(),
                                       rr.data_ptr(), rb.data_ptr(), packs.data_ptr(), n, h2,
                                       *ps._plan_args(n, first, er.device, prolong=True,
                                                      msplit=True),
                                       stream), name)
    LAUNCHES[name] += 1
    for chunk in rest:
        out_r, out_b = _stage_launch(lib, out_r, out_b, rr, rb, packs, h2, chunk, False, stream,
                                     name)
    return out_r, out_b


# ------------------------------------- K25: double-float residual + norm


def residual_df_norm_msplit_plain(u_hr, u_hb, u_lr, u_lb, f_hr, f_hb, f_lr, f_lb, h: float):
    """Plain version of K25: K20's plain version on the fold fields of the
    pairs, the residual back to a pair (its norm is the same)."""
    pairs = ((u_hr, u_hb), (u_lr, u_lb), (f_hr, f_hb), (f_lr, f_lb))
    r, nrm2 = pmf.residual_df_norm_fold_plain(*(split_to_fold(*p) for p in pairs), h)
    return (*fold_to_split(r), nrm2)


def residual_df_norm_msplit(u_hr, u_hb, u_lr, u_lb, f_hr, f_hb, f_lr, f_lb, h: float):
    """(r_r, r_b, ||r||^2): the compensated residual pair of the
    double-float solution pair (0 off the live interior slots) and its
    squared norm (a 0-d tensor on the fields' device). The stored i and j
    boundary rows must hold the BCs (the outer step's
    ``apply_bcs_split_pair``)."""
    fields = (u_hr, u_hb, u_lr, u_lb, f_hr, f_hb, f_lr, f_lb)
    if not _on_cuda(*fields):
        return residual_df_norm_msplit_plain(*fields, h)
    lib, n = _lib(), u_hr.shape[0]
    r_r, r_b = torch.empty_like(u_hr), torch.empty_like(u_hb)
    nrm2 = torch.empty((), dtype=torch.float32, device=u_hr.device)
    partials = torch.empty(lib.mg_msplit_residual_df_norm_partials(n), dtype=torch.float64,
                           device=u_hr.device)
    _check(lib.mg_msplit_residual_df_norm(
        r_r.data_ptr(), r_b.data_ptr(), nrm2.data_ptr(), partials.data_ptr(),
        *(x.data_ptr() for x in fields), n, 1.0 / (h * h), _stream()),
        "residual_df_norm_msplit")
    LAUNCHES["residual_df_norm_msplit"] += 1
    return r_r, r_b, nrm2
