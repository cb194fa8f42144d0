"""Stateful solver facade over the reference's Solver* API surface
(counterpart of ``multigrid_parallel_tpu.solver``).

The reference exposes a global-state facade (mg_3d.h:107-1467):
SolverInitialize / SolverGetDetails / SolverSetupBoundaryConditions /
SolverLinSolve / SolverGetResidual / SolverGetInitialResidual /
SolverSmoothenEdgeValues / SolverResetTimingInfo / SolverPrintTimingInfo /
SolverFinalize. This class gives the same surface as instance methods
over the functional core (cycles.py), so any number of solvers coexist.
"""

from __future__ import annotations

from typing import Optional

import torch

from multigrid_parallel_tpu_torch.cycles import (
    CycleConfig,
    _coarse_solver,
    _ops,
    fmg_initialize,
    setup_problem,
    v_cycle,
)
from multigrid_parallel_tpu_torch.hierarchy import Hierarchy, evaluate_on_grid
from multigrid_parallel_tpu_torch.models.poisson import Problem, poisson_3d_quadratic
from multigrid_parallel_tpu_torch.ops import stencils_3d
from multigrid_parallel_tpu_torch.utils.checkpoint import load_state, save_state
from multigrid_parallel_tpu_torch.utils.timing import STAGE_NAMES, TimingInfo, profile_cycle


class MultigridSolver:
    """Facade over the functional multigrid core; fields live on
    ``device`` in ``dtype`` (f64 unless given).

    Reference-API mapping (reference file:line in parens):
      __init__            = SolverInitialize (mg_3d.h:107-144)
      get_details         = SolverGetDetails (mg_3d.h:275-293)
      setup_boundary_conditions = SolverSetupBoundaryConditions (mg_3d.h:1412)
      lin_solve           = SolverLinSolve, one V-cycle (mg_3d.h:1415-1420)
      get_residual        = SolverGetResidual (mg_3d.h:1425-1428)
      get_initial_residual= SolverGetInitialResidual (mg_3d.h:1430-1433)
      smoothen_edge_values= SolverSmoothenEdgeValues (mg_3d.h:1422-1423)
      reset_timing_info   = SolverResetTimingInfo (mg_3d.h:1435-1440)
      print_timing_info   = SolverPrintTimingInfo (mg_3d.h:1442-1450)
      finalize            = SolverFinalize (mg_3d.h:1452-1467): drops the
                            fields
    """

    def __init__(self, coarse_n: int, num_levels: int, gs_iter: int,
                 problem: Optional[Problem] = None, length: Optional[float] = None,
                 dtype: Optional[torch.dtype] = None, smoother: str = "rb",
                 coarse_method: str = "lu", device="cuda"):
        self.problem = problem or poisson_3d_quadratic()
        self.device = torch.device(device)
        self.hier = Hierarchy(
            ndim=self.problem.ndim,
            coarse_n=coarse_n,
            num_levels=num_levels,
            length=length if length is not None else self.problem.length,
            dtype=dtype if dtype is not None else torch.float64,
        )
        self.cfg = CycleConfig(n_smooth=gs_iter, smoother=smoother, coarse_method=coarse_method)
        self._coarse_solve = _coarse_solver(self.hier, self.cfg, self.hier.dtype, self.device)
        self.u = self.hier.zeros(num_levels - 1, self.device)
        self.f = self.hier.zeros(num_levels - 1, self.device)
        self.timing = [TimingInfo(STAGE_NAMES) for _ in range(num_levels)]
        self._bc_done = False

    # -- reference facade surface ------------------------------------

    def get_details(self):
        """Finest (u, f, h) (SolverGetDetails, mg_3d.h:275-293; the coarse
        matrix build and factorization that call performs happened in
        __init__)."""
        return self.u, self.f, self.hier.finest_spacing

    def setup_boundary_conditions(self):
        """Write Dirichlet values onto the boundaries of f AND u
        (mg_3d.h:1412-1413 plus the driver's u-side call, test_mg_3d.c:29)."""
        self.u, self.f = setup_problem(self.problem, self.hier, self.device)
        self._bc_done = True

    def get_initial_residual(self) -> float:
        """||f||_2 over the whole finest cube (mg_3d.h:1430-1433)."""
        return float(torch.sqrt(torch.sum(self.f * self.f)))

    def lin_solve(self) -> float:
        """One V-cycle; returns the post-cycle residual norm."""
        self.u, norm = v_cycle(self.u, self.f, self.hier, self._coarse_solve, self.cfg)
        return float(norm)

    def lin_solve_profiled(self) -> float:
        """One V-cycle with per-level per-stage timing into self.timing."""
        self.u, norm = profile_cycle(self.hier, self._coarse_solve, self.cfg, self.u, self.f,
                                     self.timing)
        return float(norm)

    def get_residual(self) -> float:
        ops = _ops(self.hier.ndim)
        return float(ops.residual_norm(self.u, self.f, self.hier.finest_spacing))

    def smoothen_edge_values(self):
        if self.hier.ndim == 3:
            self.u = stencils_3d.update_edge_values(self.u)

    def reset_timing_info(self):
        for t in self.timing:
            t.reset()

    def print_timing_info(self):
        for lvl, t in enumerate(self.timing):
            print(f"-- level {lvl} (n={self.hier.sizes[lvl]}) --")
            print(t.table())

    def finalize(self):
        self.u = self.f = None

    # -- conveniences beyond the reference API -----------------------

    def fmg_initialize(self):
        """FMG bootstrap (mg_dirichlet_analytic.c:771-806)."""
        bc_fn = lambda lvl: evaluate_on_grid(self.problem.bc, self.hier, lvl, self.device)  # noqa: E731
        self.u = fmg_initialize(self.f, self.hier, self._coarse_solve, self.cfg, bc_fn)

    def solve(self, rel_tol: float = 1e-8, max_cycles: int = 100, verbose=False):
        """The reference driver loop (test_mg_3d.c:37-67); returns the
        per-cycle residual norms."""
        if not self._bc_done:
            self.setup_boundary_conditions()
        init = self.get_initial_residual()
        norms = []
        for it in range(max_cycles):
            norm = self.lin_solve()
            norms.append(norm)
            if verbose:
                ratio = norm / (norms[-2] if len(norms) > 1 else init)
                print(f"cycle {it:3d}  resid {norm:.6e}  ratio {ratio:.4f}")
            if norm <= rel_tol * init:
                break
        return norms

    def save(self, path: str):
        """Checkpoint the solver state in the JAX package's npz format
        (resumes bit-exactly; the reference has no such capability)."""
        save_state(path, self.u, self.f, self.hier, self.cfg)

    @classmethod
    def restore(cls, path: str, problem: Optional[Problem] = None, device="cuda"):
        """A solver resumed from a checkpoint written by ``save`` or by the
        JAX package's ``MultigridSolver.save``."""
        u, f, hier, cfg, _ = load_state(path, device)
        s = cls(
            hier.coarse_n,
            hier.num_levels,
            cfg.n_smooth if cfg else 2,
            problem=problem,
            length=hier.length,
            dtype=hier.dtype,
            smoother=cfg.smoother if cfg else "rb",
            coarse_method=cfg.coarse_method if cfg else "lu",
            device=device,
        )
        s.u, s.f = u, f
        s._bc_done = True
        return s

    def error_vs_analytic(self) -> Optional[float]:
        """||u - analytic||_2 over the whole cube (test_mg_3d.c:79-97)."""
        if self.problem.analytic is None:
            return None
        exact = evaluate_on_grid(self.problem.analytic, self.hier, self.hier.num_levels - 1,
                                 self.device)
        return float(torch.sqrt(torch.sum((self.u - exact) ** 2)))
