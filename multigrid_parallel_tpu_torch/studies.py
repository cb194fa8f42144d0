"""Standalone smoother convergence studies (counterpart of
``multigrid_parallel_tpu.studies``).

The reference ships two study drivers: test_rb_gs_3d.c (red-black GS
under OpenMP, the workload behind red_black_gs_scalability.txt) and
test_gs_3d.c (sequential lexicographic GS). Each runs one pre- + one
post-smoother pair per iteration on the analytic Dirichlet problem and
prints the per-iteration residual ratio until it stagnates near the
smoother's asymptotic value (~0.98 at 50^3).
"""

from __future__ import annotations

import dataclasses
import time
from typing import List

import numpy as np
import torch

from multigrid_parallel_tpu_torch.cycles import setup_problem
from multigrid_parallel_tpu_torch.hierarchy import Hierarchy, apply_boundary
from multigrid_parallel_tpu_torch.models.poisson import poisson_3d_quadratic
from multigrid_parallel_tpu_torch.ops import stencils_3d as ops3


@dataclasses.dataclass
class StudyResult:
    residual_norms: List[float]
    initial_residual: float
    n_iters: int
    converged: bool
    wall_time_s: float

    @property
    def final_ratio(self) -> float:
        return self.residual_norms[-1] / self.residual_norms[-2]


def _setup_any_n(n: int, dtype=torch.float64, device="cuda"):
    """Reference-style (u0, f, h) on an arbitrary n^3 grid: the studies do
    not need a 2^k + 1 hierarchy (the reference's is 50^3,
    red_black_gs_scalability.txt:1)."""
    h = 1.0 / (n - 1)
    c = torch.as_tensor(np.arange(n) * h, dtype=dtype, device=device)
    bc = poisson_3d_quadratic().bc(c[:, None, None], c[None, :, None], c[None, None, :])
    bc = torch.broadcast_to(bc, (n, n, n))
    f = apply_boundary(torch.zeros((n, n, n), dtype=dtype, device=device), bc)
    u = apply_boundary(torch.zeros_like(f), bc)
    return u, f, h


def smoother_study(num_levels: int = 4, coarse_n: int = 5, smoother: str = "rb",
                   rel_tol: float = 1e-8, max_iters: int = 2000, use_pallas: bool = False,
                   verbose: bool = False, n: int = 0, n_smooth: int = 1,
                   dtype=torch.float64, device="cuda") -> StudyResult:
    """Pure-smoother convergence study (no multigrid): per iteration one
    red-first + one black-first smoothing pair, like the
    preSmoother + postSmoother pair per iteration of test_rb_gs_3d.c:69-71.

    ``n`` > 0 overrides the hierarchy-derived size (any n, e.g. the
    reference's 50). ``use_pallas`` smooths with K1 (``ops.pallas3d.
    rb_smooth_fused``): on a CUDA device u and f are cast to f32 once,
    outside the loop (K1 takes f32 only), and the iteration carries the
    f32 field; on the CPU the plain versions run in ``dtype``."""
    if n:
        u, f, h = _setup_any_n(n, dtype, device)
    else:
        hier = Hierarchy(ndim=3, coarse_n=coarse_n, num_levels=num_levels, dtype=dtype)
        u, f = setup_problem(poisson_3d_quadratic(), hier, device)
        h = hier.finest_spacing
    init = float(torch.sqrt(torch.sum(f * f)))

    if smoother == "rb" and use_pallas:
        from multigrid_parallel_tpu_torch.ops import pallas3d as pk

        if u.is_cuda:
            u, f = u.float(), f.float()
        fk = f

        def step(u):
            pk.rb_smooth_fused(u, fk, h, n_smooth, red_first=True)  # in place
            pk.rb_smooth_fused(u, fk, h, n_smooth, red_first=False)
            return u, ops3.residual_norm(u, fk, h)

    elif smoother == "rb":

        def step(u):
            u = ops3.rb_smooth(u, f, h, n_smooth, red_first=True)
            u = ops3.rb_smooth(u, f, h, n_smooth, red_first=False)
            return u, ops3.residual_norm(u, f, h)

    elif smoother == "lex":

        def step(u):
            u = ops3.gauss_seidel_lex(u, f, h, 2 * n_smooth)
            u = ops3.update_edge_values(u)  # GaussSeidelSmoother does this
            return u, ops3.residual_norm(u, f, h)

    elif smoother == "jacobi":

        def step(u):
            u = ops3.jacobi_smooth(u, f, h, 2 * n_smooth)
            return u, ops3.residual_norm(u, f, h)

    else:
        raise ValueError(f"unknown smoother {smoother!r}")

    t0 = time.perf_counter()
    norms: List[float] = []
    converged = False
    old = init
    for it in range(max_iters):
        u, norm = step(u)
        v = float(norm)
        norms.append(v)
        if verbose and (it < 10 or it % 50 == 0):
            print(f"iter {it:5d}  resid {v:.6e}  ResidRatio {v / old:.6f}")
        old = v
        if v <= rel_tol * init:
            converged = True
            break
    if u.is_cuda:
        torch.cuda.synchronize(u.device)
    return StudyResult(residual_norms=norms, initial_residual=init, n_iters=len(norms),
                       converged=converged, wall_time_s=time.perf_counter() - t0)
