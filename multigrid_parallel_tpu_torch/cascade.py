"""Cascadic (non-recursive, one-pass down/up) 1D multigrid (counterpart of
``multigrid_parallel_tpu.cascade``).

Port of the reference's legacy driver mg_1d_old.c:63-144: a single
fine-to-coarse leg (smooth, residual, restrict-into-f, all on strided
views of ONE flat fine-grid array), a direct tridiagonal solve on the
coarsest stride, then a coarse-to-fine leg (midpoint interpolation-add
+ smoothing against the ORIGINAL equation's RHS, mg_1d_old.c:123-144).
It is not a correction scheme: the same array holds solution values at
every level and the up-leg re-smooths the original problem, so it
behaves as a cascadic / nested-iteration method.

Two reference quirks are reproduced under ``faithful=True`` (default),
because this module exists for parity:

  * the coarse-solve RHS vector ``b`` is never filled from the restricted
    residuals (mg_1d_old.c:99-110 allocates it with calloc and only
    re-zeroes the endpoints), so the direct solve returns x == 0 and the
    coarse strided points are overwritten with zero;
  * the coarse boundary rows use b = 0 even when the boundary values are
    nonzero (func(1) = 1 in the shipped driver).

``faithful=False`` fills ``b`` with the ORIGINAL equation on the coarse
grid (b[i] = -h_c^2 rhs(x_i) interior, true boundary values at the
ends); it can overshoot at deeper hierarchies, because the up-leg's
midpoint interpolation ADDS the interpolant onto already-smoothed values
(mg_1d_old.c:129-130).

The array work runs in f64 on ``device``. The strided Gauss-Seidel sweeps
are sequential recurrences and run as host loops (a legacy-parity driver,
not a performance path: the 1D solver is cycles.solve with red-black
smoothing).
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch

F64 = torch.float64


def _default_func(x):
    # mg_1d_old.c:17-18: exact solution / BC generator func(x) = x
    return x


def _default_rhs(x):
    # mg_1d_old.c:23-24: rhsFunc(x) = 0
    return torch.zeros_like(x)


@dataclasses.dataclass
class CascadeResult:
    v: torch.Tensor
    error_sq: float  # sum of squared error vs func (mg_1d_old.c:148-157)
    finest_n: int


def _strided_gs(v, f, h2: float, m: int, n_level: int, gs_iters: int):
    """gs_iters sequential GS sweeps over the strided interior
    j = m, 2m, ..., (n_level-2)*m (mg_1d_old.c:69-76), as a new tensor:
    a host loop over python floats (IEEE f64, one operation at a time)."""
    vv = v.tolist()
    ff = f.tolist()
    for _ in range(gs_iters):
        for j in range(m, (n_level - 1) * m, m):
            vv[j] = (vv[j - m] + vv[j + m] - h2 * ff[j]) * 0.5
    return torch.tensor(vv, dtype=F64, device=v.device)


def _eval(fn, x, like):
    return torch.as_tensor(fn(x), dtype=F64, device=like.device)


def cascade_solve_1d(coarse_n: int, num_levels: int, gs_iters: int,
                     func: Callable = _default_func, rhs_func: Callable = _default_rhs,
                     faithful: bool = True, device="cuda") -> CascadeResult:
    """Run the full mg_1d_old.c main() pipeline (lines 27-158).

    coarse_n / num_levels / gs_iters mirror the reference's argv triple;
    ``func`` and ``rhs_func`` take f64 tensors on ``device``."""
    if coarse_n < 3:
        raise ValueError("coarse grid needs at least 3 points")
    if num_levels < 1:
        raise ValueError("num_levels must be >= 1")

    nf = (coarse_n - 1) * (1 << (num_levels - 1)) + 1
    h_fine = 1.0 / (nf - 1)
    x = torch.arange(nf, dtype=F64, device=device) * h_fine

    v = torch.zeros(nf, dtype=F64, device=device)
    # enforce bcs (mg_1d_old.c:48)
    v[0] = _eval(func, torch.tensor(0.0, dtype=F64, device=device), v)
    v[-1] = _eval(func, torch.tensor(1.0, dtype=F64, device=device), v)
    f = _eval(rhs_func, x, v)
    r = torch.zeros_like(v)

    # ---- down leg (mg_1d_old.c:62-90) ----
    h, m, n_level = h_fine, 1, nf
    index = torch.arange(nf, device=device)
    for _ in range(num_levels - 1):
        h2 = h * h
        v = _strided_gs(v, f, h2, m, n_level, gs_iters)
        # residual on the strided interior (mg_1d_old.c:80-81)
        on_level = (index % m == 0) & (index > 0) & (index < nf - 1)
        res = f - (torch.roll(v, m) + torch.roll(v, -m) - 2.0 * v) / h2
        r = torch.where(on_level, res, r)
        # restrict into f at even strided points (mg_1d_old.c:84-85)
        on_coarse = (index % (2 * m) == 0) & (index > 0) & (index < nf - 1)
        rest = 0.25 * (torch.roll(r, m) + torch.roll(r, -m)) + 0.5 * r
        f = torch.where(on_coarse, rest, f)
        h *= 2.0
        m *= 2
        n_level = (n_level + 1) // 2

    # ---- coarse direct solve (mg_1d_old.c:92-119) ----
    nc = n_level
    # Boundary rows are identities: only the BOUNDARY rows' off-diagonal
    # entries vanish (A[0,1] on the super-diagonal, A[nc-1,nc-2] on the
    # sub-diagonal); interior rows adjacent to the boundary keep their -1
    # coupling (mg_1d_old.c fills A[nii-1] for i=1 and A[nii+1] for
    # i=N-2), so the two off-diagonals zero DIFFERENT ends.
    diag = np.full(nc, 2.0)
    diag[0] = diag[-1] = 1.0
    sup = np.full(nc - 1, -1.0)
    sup[0] = 0.0
    sub = np.full(nc - 1, -1.0)
    sub[-1] = 0.0
    a_mat = np.diag(diag) + np.diag(sup, 1) + np.diag(sub, -1)
    if faithful:
        b = np.zeros(nc)  # never filled: mg_1d_old.c:99
    else:
        # The coarse solution OVERWRITES v (mg_1d_old.c:113-114, not a
        # correction), so the consistent coarse problem is the original
        # equation on the coarse grid: -x_{i-1}+2x_i-x_{i+1} = -h_c^2
        # rhs(x_i) with the true boundary values in the identity rows.
        xc_coords = torch.arange(nc, dtype=F64, device=device) * h
        b = (-(h * h)) * _eval(rhs_func, xc_coords, v).cpu().numpy()
        b[0], b[-1] = float(v[0]), float(v[-1])
    # host solve: the system is tiny (nc points)
    xc = torch.as_tensor(np.linalg.solve(a_mat, b), dtype=F64, device=device)
    # map the interior coarse solution back (mg_1d_old.c:113-114)
    on_coarse_int = (index % m == 0) & (index > 0) & (index < nf - 1)
    v = torch.where(on_coarse_int, xc[torch.clamp(index // m, max=nc - 1)], v)

    # ---- up leg (mg_1d_old.c:122-144) ----
    for _ in range(num_levels - 1):
        h /= 2.0
        n_level = 2 * n_level - 1
        m //= 2
        # midpoint interpolation-add at odd strided multiples
        # (mg_1d_old.c:129-130: j = m, 3m, 5m, ...)
        on_mid = (index % (2 * m) == m) & (index < (n_level - 1) * m)
        v = torch.where(on_mid, v + 0.5 * (torch.roll(v, m) + torch.roll(v, -m)), v)
        # smooth against the ORIGINAL RHS re-evaluated at the points
        # (mg_1d_old.c:140-141), not the restricted f. Faithful mode keeps
        # the reference's coordinate quirk: rhsFunc(j*h) uses the flat
        # index times the LEVEL spacing, the physical coordinate only on
        # the finest level (invisible for the shipped rhs == 0).
        coords = torch.arange(nf, dtype=F64, device=device) * (h if faithful else h_fine)
        v = _strided_gs(v, _eval(rhs_func, coords, v), h * h, m, n_level, gs_iters)

    diff = v - _eval(func, x, v)
    return CascadeResult(v=v, error_sq=float(torch.sum(diff * diff)), finest_n=nf)
