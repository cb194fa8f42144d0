"""The stencil kernels of the double-float Poisson path, hand-written in
CUDA for Hopper, with their plain PyTorch versions and the double-float
helpers.

Counterpart of ``multigrid_parallel_tpu.ops.pallas3d`` (the module name
is kept so each port sits beside its Pallas original). Wrapper, the
Pallas kernel it replaces in multigrid_parallel_tpu/ops/pallas3d.py,
and its CUDA source in ops/csrc/:

  K1 rb_smooth_fused            rb_smooth_fused_pipelined       rb_smooth.cu
  K2 rb_smooth_from_zero_fused  rb_smooth_from_zero_fused       rb_smooth.cu
  R  residual_fused             residual_fused_pipelined        residual.cu
  K5 residual_df_norm_fused     residual_df_norm_fused_padded   residual_df_norm.cu

Fields are plain contiguous (n, n, n) tensors: the port has none of the
TPU's lane padding. A wrapper takes the plain version for a tensor on
the CPU, launches its kernel for a CUDA tensor (float32, contiguous,
cubic), and raises for anything else: there is no fallback from the
kernel to the plain version. Each kernel launch adds one to its entry in
``LAUNCHES`` (K5's launch is the pair: per-block partials, then their
sum).
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
)
# kernel launches per wrapper, since the last reset_launches()
LAUNCHES = dict.fromkeys(KERNELS, 0)


def reset_launches() -> None:
    for name in KERNELS:
        LAUNCHES[name] = 0


def _on_cuda(*fields: torch.Tensor) -> bool:
    """False for CPU tensors (plain path); True for CUDA tensors that the
    kernels take; raises for anything else."""
    dev = fields[0].device
    if any(x.device != dev for x in fields):
        raise ValueError(f"fields on different devices: {[x.device for x in fields]}")
    if dev.type == "cpu":
        return False
    if dev.type != "cuda":
        raise ValueError(f"no kernel for device {dev}")
    n = fields[0].shape[0]
    for x in fields:
        if x.dtype != torch.float32:
            raise TypeError(f"CUDA kernels take float32, got {x.dtype}")
        if x.shape != (n, n, n) or n < 3:
            raise ValueError(f"expected an (n, n, n) field with n >= 3, got {tuple(x.shape)}")
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
    mg_3d.h:640-709; black first = postSmoother, mg_3d.h:711-781).

    Updates ``u`` IN PLACE and returns it (on both devices): the CUDA
    form sweeps one colour per launch, 2 * n_iter launches. The boundary
    of u is left as it is."""
    if not _on_cuda(u, f):
        return u.copy_(rb_smooth_plain(u, f, h, n_iter, red_first))
    lib, stream, n, h2 = _lib(), _stream(), u.shape[0], h * h
    for _ in range(n_iter):
        for c in _colors(red_first):
            _check(lib.mg_rb_half_sweep(u.data_ptr(), f.data_ptr(), n, h2, c,
                                        stream), "rb_smooth_fused")
            LAUNCHES["rb_smooth_fused"] += 1
    return u


def rb_smooth_from_zero_fused(f, h: float, n_iter: int, red_first: bool = True):
    """rb_smooth_fused from an implicit zero initial guess: the first
    half-sweep reads only f and writes the whole (new) output, whose
    boundary is zero."""
    if not _on_cuda(f):
        return rb_smooth_from_zero_plain(f, h, n_iter, red_first)
    lib, stream, n, h2 = _lib(), _stream(), f.shape[0], h * h
    out = torch.empty_like(f)
    first, second = _colors(red_first)
    _check(lib.mg_rb_half_sweep_from_zero(out.data_ptr(), f.data_ptr(), n, h2,
                                          first, stream),
           "rb_smooth_from_zero_fused")
    LAUNCHES["rb_smooth_from_zero_fused"] += 1
    sweeps = [second] + list(_colors(red_first)) * (n_iter - 1)
    for c in sweeps:
        _check(lib.mg_rb_half_sweep(out.data_ptr(), f.data_ptr(), n, h2, c,
                                    stream), "rb_smooth_from_zero_fused")
        LAUNCHES["rb_smooth_from_zero_fused"] += 1
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
    ``inv_h2`` must be an exact power of two (h = 2^-k grids)."""
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
    r = _eft_residual(f_hi, f_lo, u_hi, _roll_nbrs(u_hi), u_lo,
                      _roll_nbrs(u_lo), 1.0 / (h * h))
    _, _, interior = ops3._masks(u_hi.shape[0], u_hi.device)
    r = torch.where(interior, r, torch.zeros_like(r))
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
