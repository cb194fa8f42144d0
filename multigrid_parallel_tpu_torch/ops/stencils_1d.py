"""1D multigrid stencil ops as plain torch tensor code (counterpart of
``multigrid_parallel_tpu.ops.stencils_1d``).

A functional port of mg_1d.c's kernels, with the JAX package's two
deliberate deviations:

  * the smoother is red-black (odd/even) Gauss-Seidel or weighted Jacobi
    instead of the reference's sequential lexicographic GS (mg_1d.c:58-68),
    the parallelization the reference itself applies in 3D
    (mg_3d.h:640-781). The sequential sweep is kept as
    ``gauss_seidel_lex`` for oracle comparisons;
  * the residual is the unscaled r = f - (1/h^2)(u[j-1] + u[j+1] - 2u),
    consistent with the 3D solver (mg_3d.h:819-821), not the h^2-scaled
    form of mg_1d.c:105-106.

Scalars are python floats, so they adopt the tensor dtype.
"""

from __future__ import annotations

import functools

import torch

RED, BLACK = 1, 0


@functools.lru_cache(maxsize=None)
def _masks(n: int, device):
    """(red_interior, black_interior, interior) boolean masks of n points,
    built once per (n, device)."""
    par = torch.arange(n, device=device) % 2
    interior = torch.zeros(n, dtype=torch.bool, device=device)
    interior[1:-1] = True
    return (par == RED) & interior, (par == BLACK) & interior, interior


def zero_boundary(x: torch.Tensor) -> torch.Tensor:
    """Zero the two endpoint nodes (see stencils_3d.zero_boundary)."""
    _, _, interior = _masks(x.shape[0], x.device)
    return torch.where(interior, x, torch.zeros_like(x))


def neighbor_sum(u: torch.Tensor) -> torch.Tensor:
    return torch.roll(u, 1, 0) + torch.roll(u, -1, 0)


def _half_sweep(u, f, h: float, mask):
    # v[j] = (v[j-1] + v[j+1] - h^2 f[j]) / 2 (mg_1d.c:66-67)
    upd = (neighbor_sum(u) - (h * h) * f) * 0.5
    return torch.where(mask, upd, u)


def rb_smooth(u, f, h: float, n_iter: int, red_first: bool = True):
    red, black, _ = _masks(u.shape[0], u.device)
    first, second = (red, black) if red_first else (black, red)
    for _ in range(n_iter):
        u = _half_sweep(u, f, h, first)
        u = _half_sweep(u, f, h, second)
    return u


def jacobi_smooth(u, f, h: float, n_iter: int, omega: float = 2.0 / 3.0):
    _, _, interior = _masks(u.shape[0], u.device)
    for _ in range(n_iter):
        upd = (neighbor_sum(u) - (h * h) * f) * 0.5
        u = torch.where(interior, (1.0 - omega) * u + omega * upd, u)
    return u


def gauss_seidel_lex(u, f, h: float, n_iter: int):
    """Sequential GS sweeps (mg_1d.c:58-68), as a new tensor.

    Each point reads the value its left neighbour got one step before, so
    the sweep is a recurrence with no parallel form: it runs as a host
    loop over numpy scalars of the field's dtype (one IEEE operation each,
    as the JAX scan does), and the result goes back to u's device."""
    a = u.detach().cpu().numpy().copy()
    fa = f.detach().cpu().numpy()
    h2 = a.dtype.type(h * h)
    half = a.dtype.type(0.5)
    for _ in range(n_iter):
        for j in range(1, a.shape[0] - 1):
            a[j] = (a[j - 1] + a[j + 1] - h2 * fa[j]) * half
    return torch.from_numpy(a).to(u.device)


def residual(u, f, h: float):
    _, _, interior = _masks(u.shape[0], u.device)
    inv_h2 = 1.0 / (h * h)
    r = f - inv_h2 * (neighbor_sum(u) - 2.0 * u)
    return torch.where(interior, r, torch.zeros_like(r))


def residual_norm(u, f, h: float):
    r = residual(u, f, h)
    return torch.sqrt(torch.sum(r * r))


def restrict_full_weighting(r):
    """[1/4, 1/2, 1/4] restriction (mg_1d.c:112-114), boundary injection."""
    nf = r.shape[0]
    out = r[::2].clone()
    out[1:-1] = 0.25 * r[1:nf - 3:2] + 0.5 * r[2:nf - 2:2] + 0.25 * r[3:nf - 1:2]
    return out


def prolong_correct(ec, ef):
    """ef + linear_interp(ec): coincident copy + midpoint averaging
    (mg_1d.c:124-135), as a new tensor."""
    ef = ef.clone()
    ef[::2] += ec
    ef[1::2] += 0.5 * (ec[:-1] + ec[1:])
    return ef

