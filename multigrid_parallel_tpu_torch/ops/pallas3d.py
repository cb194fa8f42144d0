"""The stencil kernels of the double-float Poisson path, hand-written in
CUDA for Hopper, with their plain PyTorch versions and the double-float
helpers.

Counterpart of ``multigrid_parallel_tpu.ops.pallas3d`` (the module name
is kept so each port sits beside its Pallas original). Wrapper, the
Pallas kernel it replaces in multigrid_parallel_tpu/ops/pallas3d.py,
and its CUDA source in ops/csrc/:

  K1  rb_smooth_fused             rb_smooth_fused_pipelined,      rb_smooth.cu, rect.cuh
                                  rb_smooth_fused_padded, and the
                                  cube wrapper rb_smooth_fused
  K2  rb_smooth_from_zero_fused   rb_smooth_from_zero_fused       rb_smooth.cu, rect.cuh
  R   residual_fused              residual_fused_pipelined,       residual.cu
                                  residual_fused_padded, and the
                                  cube wrapper residual_fused
  K3  residual_restrict_fused     residual_restrict_fused_padded  residual_restrict.cu
  K4  prolong_smooth_fused        prolong_smooth_fused_padded     prolong_smooth.cu, rect.cuh
  K5  residual_df_norm_fused      residual_df_norm_fused_padded   residual_df_norm.cu
  K6  df_step_residual_norm_fused df_step_residual_norm_fused     df_step.cu
  K26 rb_smooth_residual_fused    rb_smooth_residual_fused_padded rb_smooth_residual.cu
  K27 residual_df_fused           residual_df_fused_padded        residual_df_norm.cu

The JAX package's single-buffered and pipelined Pallas forms of K1 and R
differ only in how the TPU overlaps its DMAs, so one Hopper kernel
serves both. ``residual_norm_fused`` is R and then a torch sum, as the
JAX function takes its norm outside the kernel. (K5, K6 and K27 share
the double-float arithmetic of eft.cuh; K26 runs its stage as K1's
per-sweep form does, one half-sweep a launch.) K1, K2 and K4 are one-pass
stage kernels (rect.cuh): one launch runs all 2 n_iter <= 4 half-sweeps
of a stage on tiles in shared memory (``pallas_split._stage_plan`` with
``rect=True`` cuts the level into blocks) and writes a fresh field, its
inputs left as they are (K1 loads its initial guess, K2's tile starts as
zeros). Fields are plain contiguous (n, n, n)
tensors: the port has none of the TPU's lane padding. A wrapper takes
the plain version for a tensor on the CPU, launches its kernel for a
CUDA tensor (float32, contiguous, cubic), and raises for anything else:
there is no fallback from the kernel to the plain version. Each kernel
launch adds one to its entry in ``LAUNCHES`` (the launch of K5 or K6 is
the pair: per-block partials, then their sum; each K1 half-sweep that K26
runs counts as a K26 launch; a K1, K2 or K4 call makes ceil(n_iter / 2)
launches; K1's per-sweep form counts in ``PER_SWEEP_LAUNCHES``).
"""

from __future__ import annotations

import torch

from multigrid_parallel_tpu_torch.ops import stencils_3d as ops3
from multigrid_parallel_tpu_torch.ops.stencils_3d import BLACK, RED

KERNELS = (
    "rb_smooth_fused",
    "rb_smooth_from_zero_fused",
    "residual_fused",
    "residual_df_norm_fused",
    "residual_restrict_fused",
    "prolong_smooth_fused",
    "df_step_residual_norm_fused",
    "rb_smooth_residual_fused",
    "residual_df_fused",
)
# kernel launches per wrapper, since the last reset_launches()
LAUNCHES = dict.fromkeys(KERNELS, 0)


# the per-sweep form of K1, counted apart from K1's launches
PER_SWEEP_LAUNCHES = {"rb_smooth_fused_per_sweep": 0}


def reset_launches() -> None:
    for name in KERNELS:
        LAUNCHES[name] = 0
    PER_SWEEP_LAUNCHES["rb_smooth_fused_per_sweep"] = 0


def _on_cuda(*fields: torch.Tensor, coarse: torch.Tensor = None) -> bool:
    """False for CPU tensors (plain path); True for CUDA tensors that the
    kernels take; raises for anything else. ``fields`` are (n, n, n);
    ``coarse``, if given, is a field of the next coarser level,
    ((n + 1) / 2)^3 with n odd."""
    n = fields[0].shape[0]
    cubes = [(x, n) for x in fields]
    if coarse is not None:
        if n % 2 == 0:
            raise ValueError(f"a level with a coarser one has an odd size, got n = {n}")
        cubes.append((coarse, (n + 1) // 2))
    dev = fields[0].device
    if any(x.device != dev for x, _ in cubes):
        raise ValueError(f"fields on different devices: {[x.device for x, _ in cubes]}")
    if dev.type == "cpu":
        return False
    if dev.type != "cuda":
        raise ValueError(f"no kernel for device {dev}")
    for x, m in cubes:
        if x.dtype != torch.float32:
            raise TypeError(f"CUDA kernels take float32, got {x.dtype}")
        if x.shape != (m, m, m) or m < 3:
            raise ValueError(f"expected an (n, n, n) field with n = {m} >= 3, "
                             f"got {tuple(x.shape)}")
        if not x.is_contiguous():
            raise ValueError("CUDA kernels take contiguous fields")
    if n ** 3 >= 2 ** 31:
        raise ValueError(f"n = {n} overflows the kernels' int32 point index")
    return True


def _lib():
    from multigrid_parallel_tpu_torch.ops import _build

    return _build.load()


def _check(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with cudaError {err}")


def _stream() -> int:
    return torch.cuda.current_stream().cuda_stream


def _colors(red_first: bool):
    return (RED, BLACK) if red_first else (BLACK, RED)


# ----------------------------------------------------------- K1 / K2: RB-GS


def rb_smooth_plain(u, f, h: float, n_iter: int, red_first: bool = True):
    """Plain version of K1: returns the smoothed field (u untouched)."""
    return ops3.rb_smooth(u, f, h, n_iter, red_first=red_first)


def rb_smooth_from_zero_plain(f, h: float, n_iter: int, red_first: bool = True):
    """Plain version of K2: K1 from a zero initial guess."""
    return ops3.rb_smooth(torch.zeros_like(f), f, h, n_iter, red_first=red_first)


def rb_smooth_fused(u, f, h: float, n_iter: int, red_first: bool = True):
    """n_iter red-black GS iterations (red first = preSmoother ordering,
    mg_3d.h:640-709; black first = postSmoother, mg_3d.h:711-781), as a
    fresh field: u is left as it is (on both devices), its boundary carried
    to the output unchanged. The CUDA form is one one-pass launch of the
    rect stage (rect.cuh) for n_iter <= 2, its tile loaded from u;
    ceil(n_iter / 2) in all, each later one the same stage on the field so
    far."""
    if n_iter < 1:
        raise ValueError(f"n_iter must be >= 1, got {n_iter}")
    if not _on_cuda(u, f):
        return rb_smooth_plain(u, f, h, n_iter, red_first)
    from multigrid_parallel_tpu_torch.ops import pallas_split as ps

    lib, stream, h2 = _lib(), _stream(), h * h
    for chunk in ps._stage_chunks(n_iter):
        u = _rect_stage_launch(lib, u, f, h2, chunk, red_first, stream, "rb_smooth_fused")
    return u


def rb_smooth_fused_per_sweep(u, f, h: float, n_iter: int, red_first: bool = True):
    """K1's first CUDA form, kept as the yardstick of its stage bench and
    of its timing in chip_smoke.py: one launch a half-sweep, 2 n_iter
    launches, each a pass over u's neighbours, f and the active colour.
    Updates u IN PLACE and returns it; the plain version on the CPU. Its
    launches count in ``PER_SWEEP_LAUNCHES``."""
    if not _on_cuda(u, f):
        return u.copy_(rb_smooth_plain(u, f, h, n_iter, red_first))
    lib, stream, n, h2 = _lib(), _stream(), u.shape[0], h * h
    for _ in range(n_iter):
        for c in _colors(red_first):
            _check(lib.mg_rb_half_sweep(u.data_ptr(), f.data_ptr(), n, h2, c, stream),
                   "rb_smooth_fused_per_sweep")
            PER_SWEEP_LAUNCHES["rb_smooth_fused_per_sweep"] += 1
    return u


def rb_smooth_from_zero_fused(f, h: float, n_iter: int, red_first: bool = True):
    """rb_smooth_fused from an implicit zero initial guess, as a fresh
    field whose boundary is zero. The CUDA form is one one-pass launch of
    the rect stage (rect.cuh) for n_iter <= 2, its tile starting as zeros;
    ceil(n_iter / 2) in all, each later one K1's stage on the field so far,
    all counted as K2 launches."""
    if n_iter < 1:
        raise ValueError(f"n_iter must be >= 1, got {n_iter}")
    if not _on_cuda(f):
        return rb_smooth_from_zero_plain(f, h, n_iter, red_first)
    from multigrid_parallel_tpu_torch.ops import pallas_split as ps

    lib, stream, h2 = _lib(), _stream(), h * h
    u = None
    for chunk in ps._stage_chunks(n_iter):
        u = _rect_stage_launch(lib, u, f, h2, chunk, red_first, stream,
                               "rb_smooth_from_zero_fused")
    return u


def _rect_stage_launch(lib, u, f, h2, n_iter, red_first, stream, name):
    """One launch of the rect stage (K1's kernel; K2's where ``u`` is None,
    a zero initial guess) against f into a fresh field, counted as
    ``name``'s."""
    from multigrid_parallel_tpu_torch.ops import pallas_split as ps

    n = f.shape[0]
    out = torch.empty_like(f)
    _check(lib.mg_rect_stage(out.data_ptr(), None if u is None else u.data_ptr(),
                             f.data_ptr(), n, h2, int(red_first),
                             *ps._plan_args(n, n_iter, f.device, rect=True), stream), name)
    LAUNCHES[name] += 1
    return out


# ------------------------------------------------------------ R: residual


def residual_plain(u, f, h: float):
    return ops3.residual(u, f, h)


def residual_fused(u, f, h: float):
    """Interior residual f - (1/h^2)(sum6 u - 6u), zero boundary."""
    if not _on_cuda(u, f):
        return residual_plain(u, f, h)
    r = torch.empty_like(u)
    _check(_lib().mg_residual(r.data_ptr(), u.data_ptr(), f.data_ptr(),
                              u.shape[0], 1.0 / (h * h), _stream()),
           "residual_fused")
    LAUNCHES["residual_fused"] += 1
    return r


def residual_norm_plain(u, f, h: float):
    return ops3.residual_norm(u, f, h)


def residual_norm_fused(u, f, h: float):
    """||r||_2 of the interior residual, a 0-d tensor: R (counted as an R
    launch on the card), then the sum in torch."""
    r = residual_fused(u, f, h)
    return torch.sqrt(torch.sum(r * r))


# ------------------------------------- K26: RB-GS stage + residual of it


def rb_smooth_residual_plain(u, f, h: float, n_iter: int, red_first: bool = True):
    """Plain version of K26: K1's plain version, then R's on its result."""
    u2 = rb_smooth_plain(u, f, h, n_iter, red_first)
    return u2, residual_plain(u2, f, h)


def rb_smooth_residual_fused(u, f, h: float, n_iter: int, red_first: bool = True):
    """(u', r): n_iter red-black GS iterations and the interior residual
    of their result (the pre-smoothing stage and its residual in one
    call). Updates ``u`` IN PLACE and returns it with a fresh r (on both
    devices). The CUDA form is 2 * n_iter - 1 half-sweeps (the kernel of
    K1's per-sweep form) and one launch that sweeps the last colour and
    writes r, all counted as K26 launches."""
    if n_iter < 1:
        raise ValueError(f"n_iter must be >= 1, got {n_iter}")
    if not _on_cuda(u, f):
        u.copy_(rb_smooth_plain(u, f, h, n_iter, red_first))
        return u, residual_plain(u, f, h)
    lib, stream, n, h2 = _lib(), _stream(), u.shape[0], h * h
    colors = list(_colors(red_first)) * n_iter
    for c in colors[:-1]:
        _check(lib.mg_rb_half_sweep(u.data_ptr(), f.data_ptr(), n, h2, c, stream),
               "rb_smooth_residual_fused")
        LAUNCHES["rb_smooth_residual_fused"] += 1
    r = torch.empty_like(u)
    _check(lib.mg_rb_last_sweep_residual(u.data_ptr(), r.data_ptr(), f.data_ptr(), n, h2,
                                         1.0 / (h * h), colors[-1], stream),
           "rb_smooth_residual_fused")
    LAUNCHES["rb_smooth_residual_fused"] += 1
    return u, r


# ------------------------------------------- K3: residual + restriction


def _tap3(a, b, c):
    """Full-weighting 3-tap, in the kernel's order (0.25 a + 0.5 b) + 0.25 c."""
    return 0.25 * a + 0.5 * b + 0.25 * c


def _restrict_axis(x, axis: int):
    """3-tap restriction along ``axis`` to the coarse INTERIOR points
    (n -> (n + 1) / 2 - 2): coarse c takes fine 2c - 1, 2c, 2c + 1."""
    x = x.movedim(axis, 0)
    n = x.shape[0]
    return _tap3(x[1:n - 2:2], x[2:n - 1:2], x[3:n:2]).movedim(0, axis)


def residual_restrict_plain(e, r, h: float):
    """Plain version of K3: the fine residual (R), then the 3-tap weights
    along i, then j, then k; the coarse boundary is zero."""
    t = ops3.residual(e, r, h)
    for axis in (0, 1, 2):
        t = _restrict_axis(t, axis)
    nc = (e.shape[0] + 1) // 2
    out = torch.zeros((nc, nc, nc), dtype=e.dtype, device=e.device)
    out[1:-1, 1:-1, 1:-1] = t
    return out


def residual_restrict_fused(e, r, h: float):
    """(n, n, n) correction e and its RHS r -> the (nc, nc, nc) coarse
    RHS, nc = (n + 1) / 2: full weighting of the interior residual, zero
    coarse boundary, without storing the fine residual."""
    n = e.shape[0]
    if n % 2 == 0:
        raise ValueError(f"restriction needs an odd size, got n = {n}")
    if not _on_cuda(e, r):
        return residual_restrict_plain(e, r, h)
    nc = (n + 1) // 2
    out = torch.empty((nc, nc, nc), dtype=e.dtype, device=e.device)
    _check(_lib().mg_residual_restrict(out.data_ptr(), e.data_ptr(), r.data_ptr(),
                                       n, 1.0 / (h * h), _stream()),
           "residual_restrict_fused")
    LAUNCHES["residual_restrict_fused"] += 1
    return out


# ------------------------------------ K4: prolongation + correction + smooth


def _interp_axis(x, axis: int):
    """Linear interpolation along ``axis`` (nc -> 2 nc - 1): even fine
    points copy, odd ones are 0.5 a + 0.5 b, as the kernel computes."""
    x = x.movedim(axis, 0)
    nc = x.shape[0]
    out = x.new_empty((2 * nc - 1,) + tuple(x.shape[1:]))
    out[0::2] = x
    out[1::2] = 0.5 * x[:-1] + 0.5 * x[1:]
    return out.movedim(0, axis)


def prolong_smooth_plain(ec, e, r, h: float, n_iter: int):
    """Plain version of K4: e + trilinear interpolation of ec (j, then
    k, then i), then the black-first RB stage."""
    t = ec
    for axis in (1, 2, 0):
        t = _interp_axis(t, axis)
    return rb_smooth_plain(e + t, r, h, n_iter, red_first=False)


def prolong_smooth_fused(ec, e, r, h: float, n_iter: int):
    """rb_smooth(e + P ec, r, h, n_iter, black first) as a fresh field (e
    is left as it is): the post-smoothing stage of a V-cycle level, with
    the coarse correction ec interpolated and added. The CUDA form is one
    one-pass launch for n_iter <= 2 (e + P ec made as each plane reaches
    shared memory); a larger n_iter goes on with launches of K2's stage
    kernel on the field so far, black first, counted as K4's."""
    if n_iter < 1:
        raise ValueError(f"n_iter must be >= 1, got {n_iter}")
    if not _on_cuda(e, r, coarse=ec):
        return prolong_smooth_plain(ec, e, r, h, n_iter)
    from multigrid_parallel_tpu_torch.ops import pallas_split as ps

    lib, stream, n, h2 = _lib(), _stream(), e.shape[0], h * h
    first, *rest = ps._stage_chunks(n_iter)
    out = torch.empty_like(e)
    _check(lib.mg_rect_prolong_stage(out.data_ptr(), ec.data_ptr(), e.data_ptr(), r.data_ptr(),
                                     n, h2, *ps._plan_args(n, first, e.device, prolong=True,
                                                           rect=True), stream),
           "prolong_smooth_fused")
    LAUNCHES["prolong_smooth_fused"] += 1
    for chunk in rest:
        out = _rect_stage_launch(lib, out, r, h2, chunk, False, stream, "prolong_smooth_fused")
    return out


# ------------------------------------------- K5: double-float residual + norm


def two_sum(a, b):
    """Knuth's error-free transformation: a + b = s + err exactly."""
    s = a + b
    bb = s - a
    err = (a - (s - bb)) + (b - bb)
    return s, err


def _eft_residual(f_hi, f_lo, hi_center, hi_nbrs, lo_center, lo_nbrs, inv_h2):
    """Double-float residual combine, in the operation order of the JAX
    package's _eft_residual: a two-sum chain over the hi stencil's 8
    terms (6 neighbours, -4u, -2u: exact scalings), a plain sum over the
    lo terms, then r_hi ~= f - inv_h2 (sum6(u) - 6u), ~ulp-relative.
    ``inv_h2`` is 1 / h^2 computed in f64 and rounded once to the field's
    dtype, as the JAX package's weak-typed scalar is: the scaling is exact
    only on dyadic grids (h = 2^-k); on others, such as the electrospray's
    h = 3e-4 / (n - 1), it rounds as in JAX."""
    terms = list(hi_nbrs) + [-4.0 * hi_center, -2.0 * hi_center]
    s_hi = terms[0]
    c_hi = torch.zeros_like(s_hi)
    for t in terms[1:]:
        s_hi, err = two_sum(s_hi, t)
        c_hi = c_hi + err
    terms_lo = list(lo_nbrs) + [-4.0 * lo_center, -2.0 * lo_center]
    s_lo = terms_lo[0]
    for t in terms_lo[1:]:
        s_lo = s_lo + t
    r, e1 = two_sum(f_hi, -inv_h2 * s_hi)
    return r + (f_lo - inv_h2 * (c_hi + s_lo) + e1)


def _roll_nbrs(u):
    return [
        torch.roll(u, 1, 0), torch.roll(u, -1, 0),
        torch.roll(u, 1, 1), torch.roll(u, -1, 1),
        torch.roll(u, 1, 2), torch.roll(u, -1, 2),
    ]


def residual_df_norm_plain(u_hi, u_lo, f_hi, f_lo, h: float):
    """Plain version of K5: the EFT residual r of u_hi + u_lo against
    f_hi + f_lo (zero boundary) and ||r||^2, the sum taken in f64 and
    returned in r's dtype, as the kernel does."""
    r = residual_df_plain(u_hi, u_lo, f_hi, f_lo, h)
    r64 = r.to(torch.float64)
    return r, torch.sum(r64 * r64).to(r.dtype)


def residual_df_norm_fused(u_hi, u_lo, f_hi, f_lo, h: float):
    """(r, ||r||^2): the compensated residual of the double-float
    solution and its squared norm (a 0-d tensor on the fields' device)."""
    if not _on_cuda(u_hi, u_lo, f_hi, f_lo):
        return residual_df_norm_plain(u_hi, u_lo, f_hi, f_lo, h)
    lib, n = _lib(), u_hi.shape[0]
    r = torch.empty_like(u_hi)
    nrm2 = torch.empty((), dtype=torch.float32, device=u_hi.device)
    partials = torch.empty(lib.mg_residual_df_norm_partials(n),
                           dtype=torch.float64, device=u_hi.device)
    _check(lib.mg_residual_df_norm(
        r.data_ptr(), nrm2.data_ptr(), partials.data_ptr(),
        u_hi.data_ptr(), u_lo.data_ptr(), f_hi.data_ptr(), f_lo.data_ptr(),
        n, 1.0 / (h * h), _stream()), "residual_df_norm_fused")
    LAUNCHES["residual_df_norm_fused"] += 1
    return r, nrm2


# ------------------------------------------ K27: double-float residual


def residual_df_plain(u_hi, u_lo, f_hi, f_lo, h: float):
    """Plain version of K27, and K5's residual: the EFT residual of u_hi +
    u_lo against f_hi + f_lo, zero boundary."""
    r = _eft_residual(f_hi, f_lo, u_hi, _roll_nbrs(u_hi), u_lo,
                      _roll_nbrs(u_lo), 1.0 / (h * h))
    _, _, interior = ops3._masks(u_hi.shape[0], u_hi.device)
    return torch.where(interior, r, torch.zeros_like(r))


def residual_df_fused(u_hi, u_lo, f_hi, f_lo, h: float):
    """The compensated residual of the double-float solution (zero
    boundary), as K5 computes it, without the norm."""
    if not _on_cuda(u_hi, u_lo, f_hi, f_lo):
        return residual_df_plain(u_hi, u_lo, f_hi, f_lo, h)
    r = torch.empty_like(u_hi)
    _check(_lib().mg_residual_df(r.data_ptr(), u_hi.data_ptr(), u_lo.data_ptr(),
                                 f_hi.data_ptr(), f_lo.data_ptr(), u_hi.shape[0],
                                 1.0 / (h * h), _stream()), "residual_df_fused")
    LAUNCHES["residual_df_fused"] += 1
    return r


# ------------------------------------ K6: df_add + residual + norm (one step)


def df_step_residual_norm_plain(u_hi, u_lo, e, f_hi, f_lo, h: float):
    """Plain version of K6: df_add, then K5's plain version."""
    u_hi, u_lo = df_add(u_hi, u_lo, e)
    r, nrm2 = residual_df_norm_plain(u_hi, u_lo, f_hi, f_lo, h)
    return u_hi, u_lo, r, nrm2


def df_step_residual_norm_fused(u_hi, u_lo, e, f_hi, f_lo, h: float):
    """(u_hi', u_lo', r, ||r||^2): the tail of a defect-correction step,
    (u_hi, u_lo) + e and the compensated residual of the result with its
    squared norm. All outputs are fresh tensors (the inputs are left as
    they are); the norm is a 0-d tensor on the fields' device."""
    if not _on_cuda(u_hi, u_lo, e, f_hi, f_lo):
        return df_step_residual_norm_plain(u_hi, u_lo, e, f_hi, f_lo, h)
    lib, n = _lib(), u_hi.shape[0]
    o_hi, o_lo, r = (torch.empty_like(u_hi) for _ in range(3))
    nrm2 = torch.empty((), dtype=torch.float32, device=u_hi.device)
    partials = torch.empty(lib.mg_df_step_partials(n), dtype=torch.float64,
                           device=u_hi.device)
    _check(lib.mg_df_step(
        o_hi.data_ptr(), o_lo.data_ptr(), r.data_ptr(), nrm2.data_ptr(),
        partials.data_ptr(), u_hi.data_ptr(), u_lo.data_ptr(), e.data_ptr(),
        f_hi.data_ptr(), f_lo.data_ptr(), n, 1.0 / (h * h), _stream()),
        "df_step_residual_norm_fused")
    LAUNCHES["df_step_residual_norm_fused"] += 1
    return o_hi, o_lo, r, nrm2


# ------------------------------------------------------ double-float helpers


def df_split(x64):
    """f64 tensor -> (hi, lo) f32 double-float pair."""
    hi = x64.to(torch.float32)
    lo = (x64 - hi.to(x64.dtype)).to(torch.float32)
    return hi, lo


def df_add(hi, lo, delta):
    """(hi, lo) + delta (f32), renormalized via two_sum."""
    s, e = two_sum(hi, delta)
    lo = lo + e
    return two_sum(s, lo)


def df_to_f64(hi, lo):
    return hi.to(torch.float64) + lo.to(torch.float64)
