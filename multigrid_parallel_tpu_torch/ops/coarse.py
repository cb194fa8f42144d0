"""Coarsest-grid direct solve (counterpart of
``multigrid_parallel_tpu.ops.coarse``).

The reference builds a dense (N^3)^2 matrix — interior rows the 7-point
Laplacian scaled by 1/h^2, boundary rows identity (constructCoarseMatrixA,
mg_3d.h:147-273) — LU-factorizes it once at setup (gauss_elim.h:9-29) and
back-substitutes per V-cycle (gauss_elim.h:31-60). Here the matrix is
built in numpy and factored once on the host in f64; the per-cycle solve
runs on the device as ``torch.linalg.lu_solve`` ("lu") or as one matvec
with the precomputed inverse ("inverse"). This is a library call, not a
kernel: it replaces no Pallas kernel of the JAX package.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch


def build_coarse_matrix_3d(n: int, h: float) -> np.ndarray:
    """Dense (n^3, n^3) matrix, matching constructCoarseMatrixA
    (mg_3d.h:147-273): interior rows off-diag +1/h^2 and diag -6/h^2,
    boundary rows identity (mg_3d.h:158-159, 185, 259-267)."""
    nn = n * n
    total = n * n * n
    a = np.zeros((total, total), dtype=np.float64)
    inv_h2 = 1.0 / (h * h)
    idx = np.arange(total)
    i, rem = np.divmod(idx, nn)
    j, k = np.divmod(rem, n)
    boundary = (i == 0) | (i == n - 1) | (j == 0) | (j == n - 1) | (k == 0) | (k == n - 1)
    a[idx[boundary], idx[boundary]] = 1.0
    interior = idx[~boundary]
    a[interior, interior] = -6.0 * inv_h2
    for off in (nn, -nn, n, -n, 1, -1):
        a[interior, interior + off] = inv_h2
    return a


def build_coarse_matrix_1d(n: int, h: float) -> np.ndarray:
    """Tridiagonal {1, -2, 1}/h^2 with identity end rows (mg_1d.c:77-86,
    which builds the unscaled {1, -2, 1} form; the 1/h^2 scaling keeps it
    consistent with the 3D matrix, as in the JAX package)."""
    a = np.zeros((n, n), dtype=np.float64)
    inv_h2 = 1.0 / (h * h)
    a[0, 0] = 1.0
    a[n - 1, n - 1] = 1.0
    for j in range(1, n - 1):
        a[j, j - 1] = inv_h2
        a[j, j] = -2.0 * inv_h2
        a[j, j + 1] = inv_h2
    return a


def _build_matrix(n: int, h: float, ndim: int) -> np.ndarray:
    return build_coarse_matrix_3d(n, h) if ndim == 3 else build_coarse_matrix_1d(n, h)


def make_coarse_solver(n: int, h: float, dtype: torch.dtype, device,
                       method: str = "lu", ndim: int = 3
                       ) -> Callable[[torch.Tensor], torch.Tensor]:
    """Return solve(f_grid) -> u_grid for the coarsest level, (n,) * ndim.

    The factorization runs once here, on the host in f64 (the analogue
    of the one-time convertToLU_InPlace call at mg_3d.h:289). torch's LU
    pivots are 1-based LAPACK ipiv, so the factor comes from
    ``torch.linalg.lu_factor`` itself rather than from scipy (0-based)."""
    a = torch.from_numpy(_build_matrix(n, h, ndim))
    shape = (n,) * ndim

    if method == "lu":
        lu, piv = torch.linalg.lu_factor(a)
        lu_d = lu.to(device=device, dtype=dtype)
        piv_d = piv.to(device=device)

        def solve(f: torch.Tensor) -> torch.Tensor:
            b = f.reshape(-1, 1).to(dtype)
            return torch.linalg.lu_solve(lu_d, piv_d, b).reshape(shape).to(f.dtype)

    elif method == "inverse":
        a_inv = torch.linalg.inv(a).to(device=device, dtype=dtype)

        def solve(f: torch.Tensor) -> torch.Tensor:
            x = a_inv @ f.reshape(-1).to(dtype)
            return x.reshape(shape).to(f.dtype)

    else:
        raise ValueError(f"unknown coarse method {method!r}")

    return solve


def direct_solve_poisson(f: torch.Tensor, h: float) -> torch.Tensor:
    """One-shot dense direct solve of the FULL n^d Poisson system, with
    Dirichlet boundary values read from f's boundary entries: the
    capability of test_lu.c:23-43 (practical only for small n). Factored
    and solved on the host in f64; the result is in f's dtype on f's
    device."""
    a = torch.from_numpy(_build_matrix(f.shape[0], h, f.ndim))
    lu, piv = torch.linalg.lu_factor(a)
    b = f.detach().to(device="cpu", dtype=torch.float64).reshape(-1, 1)
    x = torch.linalg.lu_solve(lu, piv, b)
    return x.reshape(f.shape).to(device=f.device, dtype=f.dtype)
