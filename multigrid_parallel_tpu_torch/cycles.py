"""Cycle orchestration: the reference V-cycle, the FMG bootstrap and the
outer solve loops (counterpart of ``multigrid_parallel_tpu.cycles``).

The recursive vcycle (mg_3d.h:1242-1362) and driver loop
(test_mg_3d.c:37-67) as plain torch on the hierarchy's dtype, f64 unless
the caller asks for another, in 3D (``ops.stencils_3d``) and 1D
(``ops.stencils_1d``):

  * the recursion over levels is a Python recursion; coarse arrays are
    values created inside the cycle (the reference zeroes every
    non-finest solution at cycle entry, mg_3d.h:1254-1260, and overwrites
    every non-finest RHS by restriction), so the only cycle state is the
    finest ``u``;
  * the outer convergence loops run on the host with one scalar readback
    per cycle. The JAX package's ``lax.while_loop`` solvers
    (``solve_on_device``, ``make_on_device_mixed_solver``) become host
    loops with the same stop rule and return values.

These paths are jnp/XLA in the JAX package, outside any Pallas kernel,
and stay plain torch here: the hand kernels serve ``cycles_padded`` and
``cycles_split``.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, List, Optional

import numpy as np
import torch

from multigrid_parallel_tpu_torch.hierarchy import (
    Hierarchy,
    apply_boundary,
    evaluate_on_grid,
)
from multigrid_parallel_tpu_torch.models.poisson import Problem
from multigrid_parallel_tpu_torch.ops import coarse as coarse_ops
from multigrid_parallel_tpu_torch.ops import stencils_1d, stencils_3d


@dataclasses.dataclass(frozen=True)
class CycleConfig:
    """Cycle hyper-parameters (the reference's argv: gsIterNum, mg_3d.h:118).

    smoother: "rb" (red-black GS, the reference's parallel default),
      "jacobi" (weighted Jacobi) or "lex" (sequential GS oracle); the
      double-float solvers take "rb" only.
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


def _ops(ndim: int):
    return stencils_3d if ndim == 3 else stencils_1d


def _smooth(ops, cfg: CycleConfig, u, f, h, red_first: bool):
    if cfg.smoother == "rb":
        return ops.rb_smooth(u, f, h, cfg.n_smooth, red_first=red_first)
    if cfg.smoother == "jacobi":
        return ops.jacobi_smooth(u, f, h, cfg.n_smooth, omega=cfg.omega)
    if cfg.smoother == "lex":
        return ops.gauss_seidel_lex(u, f, h, cfg.n_smooth)
    raise ValueError(f"unknown smoother {cfg.smoother!r}")


def _coarse_solver(hier: Hierarchy, cfg: CycleConfig, dtype, device):
    return coarse_ops.make_coarse_solver(hier.coarse_n, hier.spacing(0), dtype, device,
                                         cfg.coarse_method, ndim=hier.ndim)


def _descend(ops, hier: Hierarchy, cfg: CycleConfig, coarse_solve, u, f, level: int,
             correction: bool = False):
    """One V-cycle from ``level`` down; returns the updated solution at
    ``level``, in the stage order of mg_3d.h:1242-1362.

    ``correction=True`` marks a sub-solve of the error equation, whose RHS
    boundary is exactly zero; its coarse-solve output boundary is
    re-zeroed to kill O(eps) pivoted-solve noise that the interior-only
    outer residual could never correct."""
    if level == 0:
        # coarsest: direct solve (mg_3d.h:1262-1277)
        x = coarse_solve(f)
        return ops.zero_boundary(x) if correction else x
    h = hier.spacing(level)
    u = _smooth(ops, cfg, u, f, h, red_first=True)  # preSmoother
    r = ops.residual(u, f, h)  # calculateResidual
    fc = ops.restrict_full_weighting(r)  # restrictResidual
    # recurse from a zero guess (the mg_3d.h:1254-1260 memset); gamma > 1
    # revisits the coarse correction (W-cycle) from the previous ec
    ec = torch.zeros((hier.sizes[level - 1],) * hier.ndim, dtype=u.dtype, device=u.device)
    n_rec = cfg.gamma if (level - 1 > 0 and hier.sizes[level - 1] >= cfg.gamma_min_n) else 1
    for _ in range(n_rec):
        ec = _descend(ops, hier, cfg, coarse_solve, ec, fc, level - 1, correction=True)
    u = ops.prolong_correct(ec, u)  # prolongateAndCorrectError
    return _smooth(ops, cfg, u, f, h, red_first=False)  # postSmoother


def v_cycle(u: torch.Tensor, f: torch.Tensor, hier: Hierarchy, coarse_solve: Callable,
            cfg: CycleConfig = CycleConfig()):
    """One V-cycle from the finest level. Returns (u_new, residual_norm),
    the norm being the post-cycle interior residual (mg_3d.h:1354-1361),
    a 0-d tensor on u's device."""
    ops = _ops(hier.ndim)
    level = hier.num_levels - 1
    u = _descend(ops, hier, cfg, coarse_solve, u, f, level)
    return u, ops.residual_norm(u, f, hier.spacing(level))


def fmg_initialize(f: torch.Tensor, hier: Hierarchy, coarse_solve: Callable,
                   cfg: CycleConfig, bc_fn=None):
    """Full-multigrid bootstrap (mg_dirichlet_analytic.c:771-806): solve the
    coarsest grid directly, then per finer level prolongate the solution
    up, re-impose boundary conditions and run one V-cycle.

    ``f`` is the finest RHS (boundary entries = Dirichlet values, as the
    driver sets them up); the coarser RHS are injected from it, and
    ``bc_fn(level)`` gives the boundary-value grid of a level (None = zero
    BCs)."""
    ops = _ops(hier.ndim)
    f_levels: List[torch.Tensor] = [f]
    for _ in range(hier.num_levels - 1):
        f_levels.append(f_levels[-1][(slice(None, None, 2),) * hier.ndim])
    f_levels.reverse()  # coarsest first

    u = coarse_solve(f_levels[0])
    for lvl in range(1, hier.num_levels):
        uf = torch.zeros((hier.sizes[lvl],) * hier.ndim, dtype=f.dtype, device=f.device)
        u = ops.prolong_correct(u, uf)  # prolong the solution up (":795")
        if bc_fn is not None:
            u = apply_boundary(u, bc_fn(lvl))  # re-impose BCs (":798")
        sub = dataclasses.replace(hier, num_levels=lvl + 1)
        u = _descend(ops, sub, cfg, coarse_solve, u, f_levels[lvl], lvl)
    return u


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


def _norm(x: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(torch.sum(x * x))


def _sync(x: torch.Tensor) -> None:
    if x.is_cuda:
        torch.cuda.synchronize(x.device)


def make_cycle_fn(hier: Hierarchy, cfg: CycleConfig = CycleConfig(), device="cuda"):
    """cycle(u, f) -> (u', ||r||): one V-cycle of this hierarchy and
    configuration, its coarse solver factored once, on ``device``."""
    coarse_solve = _coarse_solver(hier, cfg, hier.dtype, device)
    return lambda u, f: v_cycle(u, f, hier, coarse_solve, cfg)


def _fmg_start(problem: Problem, hier: Hierarchy, cfg: CycleConfig, f, device):
    coarse_solve = _coarse_solver(hier, cfg, hier.dtype, device)
    bc_fn = lambda lvl: evaluate_on_grid(problem.bc, hier, lvl, device)  # noqa: E731
    return fmg_initialize(f, hier, coarse_solve, cfg, bc_fn)


def solve(problem: Problem, hier: Hierarchy, cfg: CycleConfig = CycleConfig(),
          rel_tol: float = 1e-8, max_cycles: int = 100, use_fmg: bool = False,
          verbose: bool = False, device="cuda") -> SolveResult:
    """Full solve: setup, optional FMG bootstrap, V-cycles to convergence.

    Convergence criterion of test_mg_3d.c:40: residual norm (interior)
    <= rel_tol * ||f||_2 (whole finest cube, BC values included)."""
    cycle = make_cycle_fn(hier, cfg, device)
    u, f = setup_problem(problem, hier, device)
    if use_fmg:
        u = _fmg_start(problem, hier, cfg, f, device)
    return _host_solve_loop(problem, hier, cycle, u, f, rel_tol, max_cycles, verbose)


def _mixed_correction(hier: Hierarchy, cfg: CycleConfig, device):
    """correct(u, r, ||r||) -> u + s * e: one f32 V-cycle on the defect r
    scaled by s = ||r|| (so the f32 correction solve is O(1)), added to
    the state in its own dtype."""
    ops = _ops(hier.ndim)
    f32 = torch.float32
    hier32 = dataclasses.replace(hier, dtype=f32)
    coarse32 = _coarse_solver(hier, cfg, f32, device)
    level = hier.num_levels - 1

    def correct(u, r, nrm):
        # guard: if already fully converged, avoid dividing by ~0
        safe = torch.clamp(nrm, min=1e-300)
        r32 = (r / safe).to(f32)
        e32 = _descend(ops, hier32, cfg, coarse32, torch.zeros_like(r32), r32, level,
                       correction=True)
        return u + safe * e32.to(u.dtype)

    return correct


def make_mixed_cycle(hier: Hierarchy, cfg: CycleConfig = CycleConfig(), device="cuda"):
    """Mixed-precision defect-correction cycle: state in hier.dtype (f64),
    one f32 V-cycle on the defect:

        r64 = f - A u64          (one f64 stencil pass)
        e32 = Vcycle32(A, r64/s) (all smoothing in f32, s = ||r|| scaling
                                  so the f32 correction solve is O(1))
        u64 += s * e64(e32)

    Returns cycle(u, f) -> (u', ||r|| after the update)."""
    ops = _ops(hier.ndim)
    h = hier.spacing(hier.num_levels - 1)
    correct = _mixed_correction(hier, cfg, device)

    def cycle(u, f):
        r = ops.residual(u, f, h)
        u = correct(u, r, _norm(r))
        return u, ops.residual_norm(u, f, h)

    return cycle


def _host_solve_loop(problem: Problem, hier: Hierarchy, cycle, u, f, rel_tol: float,
                     max_cycles: int, verbose: bool) -> SolveResult:
    """Shared host convergence loop (the test_mg_3d.c:37-67 driver shape):
    one scalar readback per cycle, per-iteration residual/ratio printing."""
    init_resid = float(_norm(f))
    t0 = time.perf_counter()
    norms: List[float] = []
    converged = False
    old = init_resid
    for it in range(max_cycles):
        u, norm = cycle(u, f)
        n = float(norm)
        norms.append(n)
        if verbose:
            print(f"cycle {it:3d}  resid {n:.6e}  ratio {n / old:.4f}")
        old = n
        if n <= rel_tol * init_resid:
            converged = True
            break
    _sync(u)
    wall = time.perf_counter() - t0
    err = None
    if problem.analytic is not None:
        exact = evaluate_on_grid(problem.analytic, hier, hier.num_levels - 1, u.device)
        err = float(torch.sqrt(torch.sum((u - exact) ** 2)))
    return SolveResult(u=u, residual_norms=norms, initial_residual=init_resid,
                       n_cycles=len(norms), converged=converged, error_norm=err,
                       wall_time_s=wall)


def solve_mixed(problem: Problem, hier: Hierarchy, cfg: CycleConfig = CycleConfig(),
                rel_tol: float = 1e-8, max_cycles: int = 100, use_fmg: bool = False,
                verbose: bool = False, device="cuda") -> SolveResult:
    """Host-loop driver around the mixed-precision cycle (f64 hierarchy).

    ``use_fmg`` bootstraps with a full-multigrid pass in the outer
    precision before the mixed defect loop."""
    cycle = make_mixed_cycle(hier, cfg, device)
    u, f = setup_problem(problem, hier, device)
    if use_fmg:
        u = _fmg_start(problem, hier, cfg, f, device)
    return _host_solve_loop(problem, hier, cycle, u, f, rel_tol, max_cycles, verbose)


def make_on_device_mixed_solver(hier: Hierarchy, cfg: CycleConfig = CycleConfig(),
                                rel_tol: float = 1e-8, max_cycles: int = 100,
                                device="cuda"):
    """Build run(u0, f) -> (u, norm, n_cycles): the whole mixed-precision
    solve in one host loop with one scalar readback per cycle (the JAX
    package's one ``lax.while_loop``), ``norm`` a 0-d tensor.

    One residual pass per cycle: the loop carries (u, r, ||r||), so the
    post-update residual doubles as the next defect. Stop rule of the JAX
    function: ``tol = rel_tol * ||f||`` over the whole cube, ``while nrm >
    tol and it < max_cycles``."""
    ops = _ops(hier.ndim)
    h = hier.spacing(hier.num_levels - 1)
    correct = _mixed_correction(hier, cfg, device)

    def run(u0, f):
        tol = float(rel_tol * _norm(f))
        u = u0
        r = ops.residual(u, f, h)
        nrm = _norm(r)
        it = 0
        while nrm.item() > tol and it < max_cycles:
            u = correct(u, r, nrm)
            r = ops.residual(u, f, h)
            nrm = _norm(r)
            it += 1
        return u, nrm, it

    return run


def solve_on_device_mixed(problem: Problem, hier: Hierarchy, cfg: CycleConfig = CycleConfig(),
                          rel_tol: float = 1e-8, max_cycles: int = 100, device="cuda"):
    """The mixed-precision solve from the problem's setup. Returns (u,
    final_norm, n_cycles, ||f||)."""
    run = make_on_device_mixed_solver(hier, cfg, rel_tol, max_cycles, device)
    u0, f = setup_problem(problem, hier, device)
    init = float(_norm(f))
    u, norm, n_cycles = run(u0, f)
    return u, float(norm), int(n_cycles), init


def solve_on_device(problem: Problem, hier: Hierarchy, cfg: CycleConfig = CycleConfig(),
                    rel_tol: float = 1e-8, max_cycles: int = 100, device="cuda"):
    """The whole solve with the JAX function's on-device stop rule, in a
    host loop: the norm starts at the f32 maximum, ``while norm > rel_tol *
    ||f|| and it < max_cycles`` (the product in hier.dtype). Returns (u,
    final_norm, n_cycles, ||f||)."""
    cycle = make_cycle_fn(hier, cfg, device)
    u, f = setup_problem(problem, hier, device)
    init = _norm(f)
    tol = float(rel_tol * init)
    norm = float(np.finfo(np.float32).max)
    it = 0
    while norm > tol and it < max_cycles:
        u, nrm = cycle(u, f)
        norm = nrm.item()
        it += 1
    return u, norm, it, float(init)
