"""The double-float defect-correction solver, its f32 correction
V-cycle, the full-multigrid bootstrap and the f64-outer mixed solver
(counterpart of ``multigrid_parallel_tpu.cycles_padded``).

The module keeps its JAX name so a reader finds each counterpart, but
the port's layout has NO padding: every field is a plain contiguous
(n, n, n) tensor, where the JAX package stores (n, rup(n,8), rup(n,128))
lane-padded arrays (and trims or folds k to save lanes — TPU layout work
with no counterpart here; ``trim=True`` is not ported).

Everything inside the V-cycle computes CORRECTIONS (zero-boundary
fields): restriction inputs are residuals and every level boundary is
pinned to zero (mg_3d.h:879-958 injection of zero faces; identity
boundary rows x zero RHS, mg_3d.h:185).

The V-cycle is the JAX ``_make_descend`` in one of its two
configurations, chosen by ``fused``:

* fused (the default; what the JAX solver runs at 257, 129 and 65, where
  its VMEM planners accept every fusion): RB stage (K2/K1), residual +
  restriction (K3), coarse recursion, prolongation + correction +
  black-first RB stage (K4); the outer step ends with df_add + EFT
  residual + norm in one kernel (K6).
* unfused (the branch the JAX planners fall back to): RB stage (K1/K2),
  residual (R), separable matrix-product restriction, coarse recursion,
  matrix-product prolongation + correction, RB stage (K1); outside the
  cycle ``df_add`` + the EFT residual with its norm (K5).

Both give the same half-sweep sequence and agree to f32 rounding. On a
CUDA device every level above the coarsest runs the hand kernels (the
JAX package's jnp crossover at 33³ measured TPU launch overhead and is
not carried over); CPU tensors take the plain versions.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from multigrid_parallel_tpu_torch.cycles import CycleConfig, setup_problem
from multigrid_parallel_tpu_torch.hierarchy import Hierarchy
from multigrid_parallel_tpu_torch.ops import coarse as coarse_ops
from multigrid_parallel_tpu_torch.ops import pallas3d as pk
from multigrid_parallel_tpu_torch.ops import stencils_3d as ops3


@functools.lru_cache(maxsize=None)
def _restrict_matrix(nf: int, dtype: torch.dtype, device: torch.device):
    """(nc, nf) 3-tap restriction matrix; rows 0 and nc-1 (injection in
    the f64 oracle) are zero: correction boundaries are zero by
    construction."""
    s = ops3._restrict_matrix_np(nf).copy()
    s[0, 0] = s[-1, -1] = 0.0
    return torch.as_tensor(s, dtype=dtype, device=device)


@functools.lru_cache(maxsize=None)
def _prolong_matrix(nc: int, dtype: torch.dtype, device: torch.device):
    """(nf, nc) linear-interpolation matrix."""
    return torch.as_tensor(ops3._prolong_matrix_np(nc), dtype=dtype, device=device)


def restrict_padded(r: torch.Tensor, nf: int) -> torch.Tensor:
    """(nf, nf, nf) residual -> (nc, nc, nc) coarse RHS: full weighting
    on the interior, zero boundary (correction semantics). Three
    separable 3-tap matrix products, j then k then i as in the JAX
    package; full f32 (the solver turns TF32 off)."""
    s = _restrict_matrix(nf, r.dtype, r.device)
    t = torch.matmul(s, r)                       # j: (nf, nc, nf)
    t = torch.matmul(t, s.T)                     # k: (nf, nc, nc)
    nc = s.shape[0]
    return torch.matmul(s, t.reshape(nf, nc * nc)).reshape(nc, nc, nc)  # i


def prolong_correct_padded(ec: torch.Tensor, ef: torch.Tensor, nc: int) -> torch.Tensor:
    """ef + trilinear interpolation of ec (correction fields), separable
    matrix products j, k, i as in the JAX package."""
    p = _prolong_matrix(nc, ec.dtype, ec.device)
    nf = p.shape[0]
    t = torch.matmul(p, ec)                      # j: (nc, nf, nc)
    t = torch.matmul(t, p.T)                     # k: (nc, nf, nf)
    t = torch.matmul(p, t.reshape(nc, nf * nf)).reshape(nf, nf, nf)  # i
    return ef + t


def _make_descend(hier32: Hierarchy, cfg: CycleConfig, coarse_solve, fused: bool = True):
    """Build descend(e, r, level, from_zero) -> e': one correction
    V-cycle from ``level`` down, fused (K3, K4) or unfused (R, matrix
    products, K1) as the module docstring says.

    ``cfg.gamma`` > 1 revisits each coarse correction (W-cycle); the
    coarsest level is always visited once and ``cfg.gamma_min_n`` caps
    the revisits to sub-levels of at least that size.

    Not carried over from the JAX function: ``jnp_level_max`` and
    ``block_i`` (the TPU's launch-overhead crossover and VMEM blocks) and
    the split post-smooth it takes when the full fusion does not fit VMEM
    (K4 with one iteration, then single-iteration K1 passes): that is the
    same half-sweep sequence, and VMEM planning has no counterpart here."""
    n_smooth = cfg.n_smooth

    def _recurse(descend, rc, level):
        ec = descend(None, rc, level, from_zero=True)
        if level > 0 and hier32.sizes[level] >= cfg.gamma_min_n:
            for _ in range(cfg.gamma - 1):
                ec = descend(ec, rc, level)
        return ec

    def descend(e, r, level, from_zero=False):
        """One correction V-cycle level; e=None with from_zero=True means
        a zero initial guess (no zeros field is materialized). A given e
        is left as it is: every stage returns a fresh field."""
        n = hier32.sizes[level]
        if level == 0:
            return ops3.zero_boundary(coarse_solve(r))
        h = hier32.spacing(level)
        if from_zero:
            e = pk.rb_smooth_from_zero_fused(r, h, n_smooth, red_first=True)
        else:
            e = pk.rb_smooth_fused(e, r, h, n_smooth, red_first=True)
        if fused:
            ec = _recurse(descend, pk.residual_restrict_fused(e, r, h), level - 1)
            return pk.prolong_smooth_fused(ec, e, r, h, n_smooth)
        rc = restrict_padded(pk.residual_fused(e, r, h), n)
        ec = _recurse(descend, rc, level - 1)
        e = prolong_correct_padded(ec, e, hier32.sizes[level - 1])
        return pk.rb_smooth_fused(e, r, h, n_smooth, red_first=False)

    return descend


def _coarse_solver(hier32: Hierarchy, cfg: CycleConfig, device):
    """The coarsest level's direct solve; every factory of the correction
    cycle comes through here, so it also sets what the cycle needs."""
    if cfg.smoother != "rb":
        raise ValueError(f"the correction cycle smooths with 'rb', got {cfg.smoother!r}")
    # the matrix-product transfers must be full f32, as JAX's Precision.HIGHEST is
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return coarse_ops.make_coarse_solver(
        hier32.coarse_n, hier32.spacing(0), hier32.dtype, device, cfg.coarse_method
    )


def make_padded_correction_cycle(hier32: Hierarchy, cfg: CycleConfig, device="cuda",
                                 fused: bool = True):
    """Build cycle(e, r, from_zero=False) -> e': one V-cycle on the
    correction equation A e = r at the finest level (f32 fields on
    ``device``), as a fresh field; a given e is left as it is."""
    descend = _make_descend(hier32, cfg, _coarse_solver(hier32, cfg, device), fused)
    level = hier32.num_levels - 1

    def cycle(e, r, from_zero=False):
        return descend(e, r, level, from_zero=from_zero)

    return cycle


def make_padded_fmg_bootstrap(hier32: Hierarchy, cfg: CycleConfig, device="cuda",
                              fused: bool = True):
    """Build bootstrap(r) -> e: one full-multigrid pass on the CORRECTION
    equation A e = r (f32 fields on ``device``), the JAX package's
    defect-equation recast of SolverFMGInitialize
    (mg_dirichlet_analytic.c:771-806): the RHS ladder is restricted from
    r (matrix products, as in JAX, where it lies outside any Pallas
    kernel), the coarsest level is solved directly, and each finer level
    starts from the prolonged coarser correction and runs one V-cycle."""
    coarse_solve = _coarse_solver(hier32, cfg, device)
    descend = _make_descend(hier32, cfg, coarse_solve, fused)
    top = hier32.num_levels - 1

    def bootstrap(r):
        rs = [r]  # finest first
        for level in range(top, 0, -1):
            rs.append(restrict_padded(rs[-1], hier32.sizes[level]))
        rs.reverse()  # coarsest first
        e = ops3.zero_boundary(coarse_solve(rs[0]))
        for level in range(1, hier32.num_levels):
            ef = prolong_correct_padded(e, torch.zeros_like(rs[level]), hier32.sizes[level - 1])
            e = descend(ef, rs[level], level)
        return e

    return bootstrap


def make_on_device_df_solver(
    hier: Hierarchy,
    cfg: CycleConfig = CycleConfig(),
    rel_tol: float = 1e-8,
    max_cycles: int = 40,
    inner_cycles: int = 4,
    init_norm: float = None,
    device="cuda",
    fused: bool = True,
    use_fmg: bool = False,
):
    """run(u_hi, u_lo, f_hi, f_lo) -> (u_hi, u_lo, norm, n_outer): the
    all-f32 double-float solver. The solution is a double-float pair
    (two f32), the outer defect residual is compensated (EFT), and each
    outer step runs ``inner_cycles`` f32 correction V-cycles on the
    defect, then df_add + residual + norm: K6 when ``fused``, df_add and
    K5 otherwise. The initial residual is K5's.

    ``use_fmg``: before the loop, one full-multigrid pass on the initial
    defect (``make_padded_fmg_bootstrap``), df_add, and K5's residual;
    the bootstrap is not counted in n_outer.

    The outer loop is a host loop with one scalar readback per outer
    step, with the JAX package's stop rule: ``init`` and ``tol =
    f32(rel_tol) * init`` in f32, the initial residual before the loop,
    ``while nrm > tol and it < max_cycles``. ``init_norm`` is the
    reference's ||f||-whole-cube constant (``ref_init_norm``); it
    defaults to ||f_hi|| computed from the inputs.
    """
    hier32 = dataclasses.replace(hier, dtype=torch.float32)
    inner = make_padded_correction_cycle(hier32, cfg, device, fused)
    fmg = make_padded_fmg_bootstrap(hier32, cfg, device, fused) if use_fmg else None
    h = hier.spacing(hier.num_levels - 1)

    def residual(u_hi, u_lo, f_hi, f_lo):
        r, nrm2 = pk.residual_df_norm_fused(u_hi, u_lo, f_hi, f_lo, h)
        return r, torch.sqrt(nrm2)

    def step(u_hi, u_lo, e, f_hi, f_lo):
        if fused:
            u_hi, u_lo, r, nrm2 = pk.df_step_residual_norm_fused(u_hi, u_lo, e, f_hi, f_lo, h)
            return u_hi, u_lo, r, torch.sqrt(nrm2)
        u_hi, u_lo = pk.df_add(u_hi, u_lo, e)
        return (u_hi, u_lo) + residual(u_hi, u_lo, f_hi, f_lo)

    def run(u_hi, u_lo, f_hi, f_lo):
        if init_norm is not None:
            init = np.float32(init_norm)
        else:
            init = np.float32(torch.sqrt(torch.sum(f_hi * f_hi)).item())
        tol = float(np.float32(rel_tol) * init)
        r, nrm = residual(u_hi, u_lo, f_hi, f_lo)
        if fmg is not None:
            u_hi, u_lo = pk.df_add(u_hi, u_lo, fmg(r))
            r, nrm = residual(u_hi, u_lo, f_hi, f_lo)
        it = 0
        while it < max_cycles and nrm.item() > tol:
            e = inner(None, r, from_zero=True)
            for _ in range(inner_cycles - 1):
                e = inner(e, r)
            u_hi, u_lo, r, nrm = step(u_hi, u_lo, e, f_hi, f_lo)
            it += 1
        return u_hi, u_lo, nrm, it

    return run


def setup_df_problem(problem, hier: Hierarchy, device="cuda"):
    """(u_hi, u_lo, f_hi, f_lo) double-float (n, n, n) f32 setup with the
    reference semantics of cycles.setup_problem, evaluated in hier.dtype
    (full layout: the JAX package's trim=False)."""
    u64, f64 = setup_problem(problem, hier, device)
    u_hi, u_lo = pk.df_split(u64)
    f_hi, f_lo = pk.df_split(f64)
    return u_hi, u_lo, f_hi, f_lo


def ref_init_norm(problem, hier: Hierarchy, device="cuda") -> float:
    """||f||_2 over the WHOLE finest cube, boundary Dirichlet values
    included — the reference's initial-residual convention
    (mg_3d.h:1430-1433)."""
    _, f64 = setup_problem(problem, hier, device)
    return float(torch.sqrt(torch.sum(f64 * f64)))


def make_on_device_mixed_solver_pallas(
    hier: Hierarchy,
    cfg: CycleConfig = CycleConfig(),
    rel_tol: float = 1e-8,
    max_cycles: int = 40,
    inner_cycles: int = 2,
    device="cuda",
):
    """run(u0, f) -> (u, norm, n_outer): the f64-outer mixed-precision
    solve on the same (fused) f32 correction cycle. Each outer step
    scales the f64 defect by its norm, runs ``inner_cycles`` f32 V-cycles
    on it and adds the scaled correction to u in f64; the outer residual
    and its norm are plain f64 torch ops (in JAX they are XLA outside any
    Pallas kernel). ``u0`` and ``f`` are (n, n, n) f64 tensors on ``device``
    (``cycles.setup_problem``). Host loop with one scalar readback per
    outer step; stop rule of the JAX function: ``tol = rel_tol * ||f||``
    over the whole cube, in f64, ``while nrm > tol and it < max_cycles``.
    """
    hier32 = dataclasses.replace(hier, dtype=torch.float32)
    inner = make_padded_correction_cycle(hier32, cfg, device)
    h = hier.spacing(hier.num_levels - 1)

    def residual(u, f):
        r = ops3.residual(u, f, h)
        return r, torch.sqrt(torch.sum(r * r))

    def run(u0, f):
        tol = rel_tol * float(torch.sqrt(torch.sum(f * f)))
        u = u0
        r, nrm = residual(u, f)
        it = 0
        while it < max_cycles and nrm.item() > tol:
            safe = torch.clamp(nrm, min=1e-300)
            r32 = (r / safe).to(torch.float32)
            e = inner(None, r32, from_zero=True)
            for _ in range(inner_cycles - 1):
                e = inner(e, r32)
            u = u + safe * e.to(u.dtype)
            r, nrm = residual(u, f)
            it += 1
        return u, nrm, it

    return run
