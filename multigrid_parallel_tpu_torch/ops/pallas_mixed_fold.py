"""The mixed-BC (electrospray) kernels of the k-FOLD correction cycle,
hand-written in CUDA for Hopper, with their plain PyTorch versions and
the fold layout.

Counterpart of ``multigrid_parallel_tpu.ops.pallas_mixed_fold``. The
fold layout stores an (n, n, n) field as (n, n, n - 2): slot kk holds
grid plane k = kk + 1. The k-face planes are not stored: the mixed BC
makes every k-face node a copy of its stored neighbour (the z copies
come last), so a kernel folds its k-edge reads to the reader's own value
and unpacking rebuilds them as copies. The i and j boundary planes stay
stored. On the TPU the fold trims 128-wide lanes (384 -> 256 at 257^3);
the port has no lane padding, so here it saves 2/n of the bytes.

Wrapper, the Pallas kernel it replaces in
multigrid_parallel_tpu/ops/pallas_mixed_fold.py, and its CUDA source in
ops/csrc/ (all share mixed.cuh):

  K16 mixed_rb_smooth_fold            mixed_rb_smooth_fold            mixed_rb_smooth_fold.cu
  K17 mixed_rb_smooth_from_zero_fold  mixed_rb_smooth_from_zero_fold  mixed_rb_smooth_fold.cu
  K18 residual_restrict_fold          residual_restrict_fold          residual_restrict_fold.cu
  K19 mixed_prolong_smooth_fold       mixed_prolong_smooth_fold       mixed_prolong_smooth_fold.cu
  K20 residual_df_norm_fold           residual_df_norm_fold           residual_df_norm_fold.cu

Each plain version is the full-layout plain version (``pallas_mixed``'s
K13 / K15, ``pallas3d``'s K3 / K5) between a fold -> full conversion of
its inputs and ``pack_fold`` of its output: ``unpack_fold`` for the
fields (the k-face copies are what the kernels' folded reads return),
then, for the smoothing stages, the BC pass (``apply_bcs_padded``),
which rebuilds every boundary node from the interior; K19's coarse
correction gets the pin-priority k-edge fix of ``fold_edge_sign_planes``
instead (``unpack_coarse``). So the plain versions hold the fold tier to
the full tier that ``pallas_mixed`` holds against JAX. Not carried over
(TPU planning, same half-sweep sequence): ``fold_pays``, the
``*_block_i`` planners and the ``block_i`` and ``with_delta`` arguments
(K19 reads the sign planes at the k-edge x-face nodes only).

K16, K17 and K19 are one-pass stages (rect.cuh on the fold layout): one
launch a call for n_iter <= 2, all 2 n_iter half-sweeps and the BC pass
in shared memory, into a fresh field (K16 and K19 on a loaded one, K17
from zeros). K18 is restrict.cuh's streaming restriction stage on the
fold layout on the levels from ``pallas_split.FOLD_RESTRICT_STAGE_MIN_N``
up, and its first form, one thread a coarse point, below; one launch a
call either way.

A wrapper takes the plain version for tensors on the CPU, launches its
kernel for CUDA tensors (float32, contiguous, fold shapes; pin (2, n,
n - 2)), and raises for anything else: no fallback from the kernel to
the plain version. Each kernel launch adds one to its entry in
``LAUNCHES`` (K20's is the pair, partials then their sum).
"""

from __future__ import annotations

import torch

from multigrid_parallel_tpu_torch.ops import pallas3d as pk
from multigrid_parallel_tpu_torch.ops import pallas_mixed as pm
from multigrid_parallel_tpu_torch.ops import pallas_split as ps
from multigrid_parallel_tpu_torch.ops.pallas3d import _check, _lib, _stream

KERNELS = (
    "mixed_rb_smooth_fold",
    "mixed_rb_smooth_from_zero_fold",
    "residual_restrict_fold",
    "mixed_prolong_smooth_fold",
    "residual_df_norm_fold",
)
# kernel launches per wrapper, since the last reset_launches()
LAUNCHES = dict.fromkeys(KERNELS, 0)


def reset_launches() -> None:
    for name in KERNELS:
        LAUNCHES[name] = 0


# ------------------------------------------------------------------ layout


def fold_shape(n: int):
    """(n, n, n - 2): the stored planes k = 1 .. n-2."""
    return (n, n, n - 2)


def pack_fold(x):
    """(..., n) -> (..., n - 2): drop the k = 0 and k = n-1 planes (whose
    values are copies of their stored neighbours), as a contiguous copy."""
    return x[..., 1:-1].contiguous()


def unpack_fold(xf):
    """Fold -> full, the k faces rebuilt as copies of the adjacent stored
    plane: exact for every k-face node except the Dirichlet patch nodes on
    the x faces' k edges, which the callers re-pin (a BC pass, the f64 BC
    pass of ``unpack_mixed_fold_solution``) or fix (``unpack_coarse``)."""
    return torch.cat([xf[..., :1], xf, xf[..., -1:]], dim=-1)


def fold_to_full_rhs(rc_f):
    """A fold-layout RHS (interior-only residual) -> full, with ZERO k
    boundary planes (what the full-layout restriction emits)."""
    n = rc_f.shape[0]
    y = rc_f.new_zeros((n, n, n))
    y[:, :, 1 : n - 1] = rc_f
    return y


def full_to_fold(x):
    """A full-layout correction -> fold (drop the k boundary planes)."""
    return pack_fold(x)


def fold_pin_planes(problem, n: int, device="cuda") -> torch.Tensor:
    """(2, n, n - 2) f32 x-face Dirichlet patch masks in fold k
    coordinates (``pallas_mixed.dirichlet_pin_planes`` on the stored k
    range) on ``device``."""
    return pack_fold(pm.dirichlet_pin_planes(problem, n, device))


def fold_edge_sign_planes(problem, n: int, device="cuda") -> torch.Tensor:
    """(2, n, n - 2) f32 signed coefficients of the pin-priority k-edge
    fix (JAX ``fold_edge_sign_planes``): on an x face the pin is applied
    after the z copy, so the unstored k-face node is

        true(k = 0)   = 0 if pin(j, 0) else u_nbr(j, 1)
        stored(k = 1) = 0 if pin(j, 1) else u_nbr(j, 1)
        true - stored = (pin(j, 1) - pin(j, 0)) * u_nbr(j, 1),

    u_nbr the adjacent interior i plane; likewise at k = n-1. Nonzero only
    at columns 0 and n-3 of the two x faces, and only where the patch
    reaches the k-edge-adjacent plane (coarse levels of the electrospray
    geometry)."""
    full = pm.dirichlet_pin_planes(problem, n, device)
    sgn = torch.zeros((2, n, n - 2), dtype=full.dtype, device=full.device)
    sgn[:, :, 0] = full[:, :, 1] - full[:, :, 0]
    sgn[:, :, n - 3] = full[:, :, n - 2] - full[:, :, n - 1]
    return sgn


def unpack_coarse(ec_f, sgn_c):
    """The coarse fold correction -> full, the way K19 reads it: k faces
    as copies of the stored neighbour columns, the x faces' k-edge nodes
    then corrected by sgn * (the adjacent interior i plane), as one
    expression ``v + sgn * nbr`` (exact on BC-consistent input, where v is
    0 or nbr wherever sgn is not 0)."""
    nc = ec_f.shape[0]
    out = unpack_fold(ec_f)
    for face, i, nb in ((0, 0, 1), (1, nc - 1, nc - 2)):
        for k, kk in ((0, 0), (nc - 1, nc - 3)):
            out[i, :, k] = ec_f[i, :, kk] + sgn_c[face, :, kk] * ec_f[nb, :, kk]
    return out


# ------------------------------------------------------------------ checks


def _on_cuda(*fields, pin=None, coarse=None, sgn=None) -> bool:
    """False for CPU tensors (plain path); True for CUDA tensors that the
    kernels take; raises for anything else. ``fields`` are (n, n, n - 2)
    fold fields; ``pin``, if given, (2, n, n - 2); ``coarse`` a fold field
    of the next coarser level, with n odd, and ``sgn`` its (2, nc, nc - 2)
    sign planes."""
    n = fields[0].shape[0]
    if n < 3:
        raise ValueError(f"a fold field has n >= 3, got n = {n}")
    want = [(x, fold_shape(n)) for x in fields]
    if pin is not None:
        want.append((pin, (2, n, n - 2)))
    if coarse is not None:
        if n % 2 == 0:
            raise ValueError(f"a level with a coarser one has an odd size, got n = {n}")
        nc = (n + 1) // 2
        want += [(coarse, fold_shape(nc)), (sgn, (2, nc, nc - 2))]
    for x, shape in want:
        if tuple(x.shape) != shape:
            raise ValueError(f"expected a fold tensor of shape {shape}, got {tuple(x.shape)}")
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
    if n * n * (n - 2) >= 2 ** 31:
        raise ValueError(f"n = {n} overflows the kernels' int32 point index")
    return True


# -------------------------------------------------- K16 / K17: mixed RB-GS


def mixed_rb_smooth_fold_plain(e, r, pin, h: float, n_iter: int, red_first: bool = True):
    """Plain version of K16: K13's plain version on the unpacked fields,
    after one BC pass, packed. ``unpack_fold(pin)`` stands for the full
    pin planes: their k-face columns pin only k-face nodes, which no
    interior stencil reads and the pack drops. Returns a new field."""
    pin_full = unpack_fold(pin)
    e_full = pm.apply_bcs_padded(unpack_fold(e), pin_full)
    return pack_fold(pm.mixed_rb_smooth_plain(e_full, unpack_fold(r), pin_full, h, n_iter,
                                              red_first))


def mixed_rb_smooth_from_zero_fold_plain(r, pin, h: float, n_iter: int, red_first: bool = True):
    """Plain version of K17: K16 from a zero initial guess."""
    return mixed_rb_smooth_fold_plain(torch.zeros_like(r), r, pin, h, n_iter, red_first)


def mixed_rb_smooth_fold(e, r, pin, h: float, n_iter: int, red_first: bool = True):
    """n_iter mixed-BC RB-GS iterations on the fold correction e (red first
    = pre-smoothing, black first = post-smoothing), ending with the fold
    BC pass (x and y faces), as a fresh field: e is left as it is (on both
    devices), and only its interior is read. The CUDA form is one one-pass
    launch of the fold stage on e for n_iter <= 2, ceil(n_iter / 2) in
    all, each later one on the field so far, all counted as K16 launches."""
    if n_iter < 1:
        raise ValueError(f"n_iter must be >= 1, got {n_iter}")
    if not _on_cuda(e, r, pin=pin):
        return mixed_rb_smooth_fold_plain(e, r, pin, h, n_iter, red_first)
    lib, stream, h2 = _lib(), _stream(), h * h
    for chunk in ps._stage_chunks(n_iter):
        e = _fold_stage_launch(lib, e, r, pin, h2, chunk, red_first, stream,
                               "mixed_rb_smooth_fold")
    return e


def mixed_rb_smooth_from_zero_fold(r, pin, h: float, n_iter: int, red_first: bool = True):
    """mixed_rb_smooth_fold from an implicit zero initial guess, as a fresh
    field. The CUDA form is one one-pass launch of the fold stage for
    n_iter <= 2, its tile starting as zeros, the BC pass at its store;
    ceil(n_iter / 2) in all, each later one the same stage on the field so
    far, all counted as K17 launches."""
    if n_iter < 1:
        raise ValueError(f"n_iter must be >= 1, got {n_iter}")
    if not _on_cuda(r, pin=pin):
        return mixed_rb_smooth_from_zero_fold_plain(r, pin, h, n_iter, red_first)
    lib, stream, h2 = _lib(), _stream(), h * h
    u = None
    for chunk in ps._stage_chunks(n_iter):
        u = _fold_stage_launch(lib, u, r, pin, h2, chunk, red_first, stream,
                               "mixed_rb_smooth_from_zero_fold")
    return u


def _fold_stage_launch(lib, u, r, pin, h2, n_iter, red_first, stream, name):
    """One launch of the fold stage (on u, or from a zero field where u is
    None) against r into a fresh field, counted as ``name``'s."""
    n = r.shape[0]
    out = torch.empty_like(r)
    _check(lib.mg_fold_stage(out.data_ptr(), None if u is None else u.data_ptr(), r.data_ptr(),
                             pin.data_ptr(), n, h2, int(red_first),
                             *ps._plan_args(n, n_iter, r.device, rect=True), stream), name)
    LAUNCHES[name] += 1
    return out


# -------------------------------------------- K18: residual + restriction


def residual_restrict_fold_plain(e, r, h: float):
    """Plain version of K18: K3's plain version on the unpacked fields,
    packed (the coarse x and y faces are zero)."""
    return pack_fold(pk.residual_restrict_plain(unpack_fold(e), unpack_fold(r), h))


def residual_restrict_fold(e, r, h: float):
    """(n, n, n - 2) fold correction e and its RHS r -> the (nc, nc,
    nc - 2) fold coarse RHS, nc = (n + 1) / 2: full weighting of the
    interior residual (k-edge reads folded), zero coarse x and y faces,
    without storing the fine residual; the inputs are left as they are.
    The CUDA form is one launch: the streaming restriction stage on
    ``_restrict_plan(n, sms, fold=True)`` where n >=
    ``pallas_split.FOLD_RESTRICT_STAGE_MIN_N``, else the first form."""
    n = e.shape[0]
    if n % 2 == 0:
        raise ValueError(f"restriction needs an odd size, got n = {n}")
    if not _on_cuda(e, r):
        return residual_restrict_fold_plain(e, r, h)
    out = e.new_empty(fold_shape((n + 1) // 2))
    lib, ptrs, inv_h2 = _lib(), (out.data_ptr(), e.data_ptr(), r.data_ptr()), 1.0 / (h * h)
    if n >= ps.FOLD_RESTRICT_STAGE_MIN_N:
        err = lib.mg_fold_residual_restrict(*ptrs, n, inv_h2,
                                            *ps._restrict_args(n, e.device, fold=True), _stream())
    else:
        err = lib.mg_residual_restrict_fold(*ptrs, n, inv_h2, _stream())
    _check(err, "residual_restrict_fold")
    LAUNCHES["residual_restrict_fold"] += 1
    return out


# --------------------------- K19: mixed prolongation + correction + smooth


def mixed_prolong_smooth_fold_plain(ec, e, r, pin, sgn_c, h: float, n_iter: int):
    """Plain version of K19: K15's plain version on the unpacked fine
    fields and the coarse correction as ``unpack_coarse`` rebuilds it,
    packed (pin planes as in ``mixed_rb_smooth_fold_plain``)."""
    return pack_fold(pm.mixed_prolong_smooth_plain(unpack_coarse(ec, sgn_c), unpack_fold(e),
                                                   unpack_fold(r), unpack_fold(pin), h, n_iter))


def mixed_prolong_smooth_fold(ec, e, r, pin, sgn_c, h: float, n_iter: int):
    """The black-first mixed stage of e + P ec on the fold layout, as a
    fresh field (e is left as it is): the post-smoothing stage of a fold
    cycle level. ``sgn_c``: ``fold_edge_sign_planes`` of the COARSE level.
    The CUDA form is one one-pass launch for n_iter <= 2 (e + P ec made as
    each plane reaches shared memory, the BC pass at its store); a larger
    n_iter goes on with launches of K17's stage kernel on the field so far,
    black first, all counted as K19 launches."""
    if n_iter < 1:
        raise ValueError(f"n_iter must be >= 1, got {n_iter}")
    if not _on_cuda(e, r, pin=pin, coarse=ec, sgn=sgn_c):
        return mixed_prolong_smooth_fold_plain(ec, e, r, pin, sgn_c, h, n_iter)
    name, n, h2 = "mixed_prolong_smooth_fold", e.shape[0], h * h
    if n < 5:
        raise ValueError(f"K19 takes a fine level of n >= 5, got n = {n}")
    lib, stream = _lib(), _stream()
    first, *rest = ps._stage_chunks(n_iter)
    out = torch.empty_like(e)
    _check(lib.mg_fold_prolong_stage(
        out.data_ptr(), ec.data_ptr(), e.data_ptr(), r.data_ptr(), pin.data_ptr(),
        sgn_c.data_ptr(), n, h2, *ps._plan_args(n, first, e.device, prolong=True, rect=True),
        stream), name)
    LAUNCHES[name] += 1
    for chunk in rest:
        out = _fold_stage_launch(lib, out, r, pin, h2, chunk, False, stream, name)
    return out


# ------------------------------------- K20: double-float residual + norm


def residual_df_norm_fold_plain(u_hi, u_lo, f_hi, f_lo, h: float):
    """Plain version of K20: K5's plain version on the unpacked fields,
    the residual packed (its k faces are zero, so the norm is the same)."""
    r, nrm2 = pk.residual_df_norm_plain(*(unpack_fold(x) for x in (u_hi, u_lo, f_hi, f_lo)), h)
    return pack_fold(r), nrm2


def residual_df_norm_fold(u_hi, u_lo, f_hi, f_lo, h: float):
    """(r, ||r||^2): the compensated residual of the double-float fold
    solution (zero on the stored x and y faces) and its squared norm (a
    0-d tensor on the fields' device)."""
    if not _on_cuda(u_hi, u_lo, f_hi, f_lo):
        return residual_df_norm_fold_plain(u_hi, u_lo, f_hi, f_lo, h)
    lib, n = _lib(), u_hi.shape[0]
    r = torch.empty_like(u_hi)
    nrm2 = torch.empty((), dtype=torch.float32, device=u_hi.device)
    partials = torch.empty(lib.mg_residual_df_norm_fold_partials(n), dtype=torch.float64,
                           device=u_hi.device)
    _check(lib.mg_residual_df_norm_fold(
        r.data_ptr(), nrm2.data_ptr(), partials.data_ptr(), u_hi.data_ptr(), u_lo.data_ptr(),
        f_hi.data_ptr(), f_lo.data_ptr(), n, 1.0 / (h * h), _stream()),
        "residual_df_norm_fold")
    LAUNCHES["residual_df_norm_fold"] += 1
    return r, nrm2
