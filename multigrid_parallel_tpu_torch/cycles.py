"""Cycle configuration, problem setup and the solve record (the subset of
``multigrid_parallel_tpu.cycles`` that the double-float slice needs; the
f64 reference V-cycle and its host solve loop come in a later slice)."""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import torch

from multigrid_parallel_tpu_torch.hierarchy import (
    Hierarchy,
    apply_boundary,
    evaluate_on_grid,
)
from multigrid_parallel_tpu_torch.models.poisson import Problem


@dataclasses.dataclass(frozen=True)
class CycleConfig:
    """Cycle hyper-parameters (the reference's argv: gsIterNum, mg_3d.h:118).

    smoother: "rb" (red-black GS, the reference's parallel default),
      "jacobi" or "lex"; the double-float solver takes "rb" only.
    coarse_method: "lu" | "inverse" (see ops.coarse).
    gamma: recursion count per level — 1 = V-cycle, 2 = W-cycle.
    gamma_min_n: W-cycle depth cap — gamma revisits apply only to
      sub-levels of size >= gamma_min_n (0 = full W-cycle).
    """

    n_smooth: int = 2
    smoother: str = "rb"
    omega: float = 2.0 / 3.0
    coarse_method: str = "lu"
    gamma: int = 1
    gamma_min_n: int = 0


@dataclasses.dataclass
class SolveResult:
    u: torch.Tensor
    residual_norms: List[float]
    initial_residual: float
    n_cycles: int
    converged: bool
    error_norm: Optional[float] = None
    wall_time_s: float = 0.0

    @property
    def residual_ratios(self) -> List[float]:
        norms = [self.initial_residual] + self.residual_norms
        return [b / a for a, b in zip(norms, norms[1:])]


def setup_problem(problem: Problem, hier: Hierarchy, device="cuda"):
    """Build (u0, f) on the finest grid, reference-style:

    * f interior = rhs, f boundary = Dirichlet values (the reference
      writes BCFunc onto the finest d, mg_3d.h:1412-1413 — they enter only
      through the initial-residual norm, ||f||_2 over the WHOLE cube,
      mg_3d.h:1430-1433);
    * u0 interior = 0, u0 boundary = Dirichlet values (test_mg_3d.c:29).
    """
    lvl = hier.num_levels - 1
    bc_vals = evaluate_on_grid(problem.bc, hier, lvl, device)
    f = apply_boundary(evaluate_on_grid(problem.rhs, hier, lvl, device), bc_vals)
    u0 = apply_boundary(torch.zeros_like(f), bc_vals)
    return u0, f
