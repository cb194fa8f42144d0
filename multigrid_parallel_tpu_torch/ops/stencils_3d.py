"""3D multigrid stencil ops as plain torch tensor code: the port's f64
oracles, and the plain versions behind the CUDA kernels of
``ops.pallas3d``.

Counterpart of ``multigrid_parallel_tpu.ops.stencils_3d`` (the subset the
double-float Poisson slice needs). Each op reproduces the arithmetic of
the corresponding C kernel in mg_3d.h as whole-array tensor ops:

  * red-black Gauss-Seidel half-sweeps -> masked whole-array updates.
    Within one colour sweep every update reads only opposite-colour
    neighbours, so the masked update is exactly the sequential C loop
    (mg_3d.h:640-781).
  * residual -> one stencil expression (mg_3d.h:794-842).
  * full-weighting restriction -> three separable 3-tap matrix products,
    injection on boundary faces (mg_3d.h:844-998).
  * trilinear prolongate-and-correct -> three separable interpolation
    matrix products (mg_3d.h:1000-1145).

Scalars (h) are python floats, so they adopt the tensor dtype: the same
code runs f32 (the kernels' plain versions) and f64 (the oracles).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

# Colour convention (mg_3d.h:669, 693): RED = nodes with (i+j+k) odd
# (the red loop starts k at 1+(i+j)%2), BLACK = (i+j+k) even.
RED, BLACK = 1, 0


def _masks(n: int, device):
    """(red_interior, black_interior, interior) boolean masks, n^3."""
    idx = torch.arange(n, device=device)
    par = (idx[:, None, None] + idx[None, :, None] + idx[None, None, :]) % 2
    inner = (idx >= 1) & (idx <= n - 2)
    interior = inner[:, None, None] & inner[None, :, None] & inner[None, None, :]
    return (par == RED) & interior, (par == BLACK) & interior, interior


def zero_boundary(x: torch.Tensor) -> torch.Tensor:
    """Zero all boundary nodes. Used on coarse-level corrections, whose
    boundary is exactly zero in exact arithmetic (identity boundary rows
    x zero RHS, mg_3d.h:185) but picks up O(eps) noise from the pivoted
    coarse solve."""
    _, _, interior = _masks(x.shape[0], x.device)
    return torch.where(interior, x, torch.zeros_like(x))


def apply_neumann_copy(u: torch.Tensor) -> torch.Tensor:
    """Homogeneous-Neumann enforcement by copying the adjacent interior
    plane onto each boundary plane (the mg_3d_bkup.c:84-133 rule), as a
    new tensor. Faces go x, then y, then z, so later faces win at edges
    and corners: afterwards a boundary node holds u[c(i), c(j), c(k)],
    with c mapping 0 -> 1, n-1 -> n-2 and every interior index to itself.
    Every face is Neumann (the JAX function's per-face ``neumann_masks``
    has no caller in either package)."""
    n = u.shape[0]
    u = u.clone()
    u[0] = u[1]
    u[n - 1] = u[n - 2]
    u[:, 0] = u[:, 1]
    u[:, n - 1] = u[:, n - 2]
    u[:, :, 0] = u[:, :, 1]
    u[:, :, n - 1] = u[:, :, n - 2]
    return u


def neighbor_sum(u: torch.Tensor) -> torch.Tensor:
    """Sum of the 6 face neighbours in the reference's addition order
    (i-1)+(i+1)+(j-1)+(j+1)+(k-1)+(k+1) (mg_3d.h:439-441). Wrapped roll
    values land only on boundary rows, which no caller uses."""
    return (
        torch.roll(u, 1, 0)
        + torch.roll(u, -1, 0)
        + torch.roll(u, 1, 1)
        + torch.roll(u, -1, 1)
        + torch.roll(u, 1, 2)
        + torch.roll(u, -1, 2)
    )


def _half_sweep(u, f, h: float, color_mask) -> torch.Tensor:
    """One RB-GS colour sweep: u <- (nbr_sum - h^2 f) * (1/6) on
    `color_mask` (smoothenAtIndex, mg_3d.h:438-443)."""
    h2 = h * h
    upd = (neighbor_sum(u) - h2 * f) * (1.0 / 6.0)
    return torch.where(color_mask, upd, u)


def rb_smooth(u: torch.Tensor, f: torch.Tensor, h: float, n_iter: int,
              red_first: bool = True) -> torch.Tensor:
    """Red-black Gauss-Seidel sweeps: ``red_first=True`` is the reference
    preSmoother (mg_3d.h:640-709), ``False`` the postSmoother
    (mg_3d.h:711-781)."""
    red, black, _ = _masks(u.shape[0], u.device)
    first, second = (red, black) if red_first else (black, red)
    for _ in range(n_iter):
        u = _half_sweep(u, f, h, first)
        u = _half_sweep(u, f, h, second)
    return u


def residual(u: torch.Tensor, f: torch.Tensor, h: float) -> torch.Tensor:
    """r = f - (1/h^2)(nbr_sum - 6 u) on the interior, 0 on the boundary
    (calculateResidual, mg_3d.h:794-842)."""
    _, _, interior = _masks(u.shape[0], u.device)
    inv_h2 = 1.0 / (h * h)
    r = f - inv_h2 * (neighbor_sum(u) - 6.0 * u)
    return torch.where(interior, r, torch.zeros_like(r))


def residual_norm(u: torch.Tensor, f: torch.Tensor, h: float) -> torch.Tensor:
    """||r||_2 over the interior (the vcycle return value, mg_3d.h:1354)."""
    r = residual(u, f, h)
    return torch.sqrt(torch.sum(r * r))


@functools.lru_cache(maxsize=None)
def _restrict_matrix_np(nf: int) -> np.ndarray:
    """(nc, nf) separable full-weighting matrix: interior rows the 3-tap
    [1/4, 1/2, 1/4] stencil at stride 2, end rows injection. The 27-point
    table of mg_3d.h:851-872 is the tensor product of three of these."""
    nc = (nf + 1) // 2
    s = np.zeros((nc, nf))
    s[0, 0] = 1.0
    s[nc - 1, nf - 1] = 1.0
    for ic in range(1, nc - 1):
        s[ic, 2 * ic - 1 : 2 * ic + 2] = (0.25, 0.5, 0.25)
    return s


@functools.lru_cache(maxsize=None)
def _prolong_matrix_np(nc: int) -> np.ndarray:
    """(nf, nc) linear-interpolation matrix: even fine rows copy the
    coincident coarse point, odd rows average the two neighbours. The
    tensor product of three is the trilinear kernel of mg_3d.h:1000-1145."""
    nf = 2 * nc - 1
    p = np.zeros((nf, nc))
    p[2 * np.arange(nc), np.arange(nc)] = 1.0
    p[2 * np.arange(nc - 1) + 1, np.arange(nc - 1)] = 0.5
    p[2 * np.arange(nc - 1) + 1, np.arange(nc - 1) + 1] = 0.5
    return p


def restrict_full_weighting(r: torch.Tensor) -> torch.Tensor:
    """Fine (Nf^3) -> coarse (Nc^3), Nc = (Nf+1)/2: 27-point full
    weighting on the interior (mg_3d.h:961-995), injection of the
    coincident fine value on the six faces (mg_3d.h:879-958)."""
    s = torch.as_tensor(_restrict_matrix_np(r.shape[0]), dtype=r.dtype,
                        device=r.device)
    t = torch.einsum("ai,ijk->ajk", s, r)
    t = torch.einsum("bj,ajk->abk", s, t)
    t = torch.einsum("ck,abk->abc", s, t)
    # the separable end rows alone would 2D-filter the tangential axes
    t[0] = r[0, ::2, ::2]
    t[-1] = r[-1, ::2, ::2]
    t[:, 0] = r[::2, 0, ::2]
    t[:, -1] = r[::2, -1, ::2]
    t[:, :, 0] = r[::2, ::2, 0]
    t[:, :, -1] = r[::2, ::2, -1]
    return t


def prolong_correct(ec: torch.Tensor, ef: torch.Tensor) -> torch.Tensor:
    """ef + trilinear_interp(ec), all fine nodes (mg_3d.h:1000-1145)."""
    p = torch.as_tensor(_prolong_matrix_np(ec.shape[0]), dtype=ec.dtype,
                        device=ec.device)
    t = torch.einsum("ia,abc->ibc", p, ec)
    t = torch.einsum("jb,ibc->ijc", p, t)
    t = torch.einsum("kc,ijc->ijk", p, t)
    return ef + t
