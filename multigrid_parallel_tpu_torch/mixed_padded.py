"""The electrospray (mixed-BC) solve on the fused-kernel tier: the full-
layout double-float defect-correction solver (counterpart of the full-
layout part of ``multigrid_parallel_tpu.mixed_padded``; the k-fold and
split tiers wait for their kernels).

The f32 correction V-cycle runs the mixed-BC smoothing kernels of
``ops.pallas_mixed`` (K14 / K13 pre-smoothing, K15 prolongation +
post-smoothing, each stage ending with the BC pass), and the Dirichlet
fused residual + restriction (K3) unchanged: the interior residual reads
the boundary values the BC pass maintained. The coarsest level is an f32
LU solve of the mixed matrix, then the zero pin of the x-face patches
(no zero boundary, no BC pass). The outer loop is the double-float EFT
defect iteration of ``cycles_padded.make_on_device_df_solver`` with the
BCs re-enforced on the solution pair after each step, then K5.

The module keeps its JAX name; the port's fields are plain (n, n, n)
tensors. Not carried over (TPU planning with the same half-sweep
sequence): ``jnp_level_max``, ``block_i`` and the ``mixed_*_block_i``
VMEM planners; every level above the coarsest runs the kernels on a
CUDA device, the plain versions on the CPU.

Convergence criterion as ``MixedBCSolver.solve_on_device``: ||r|| <=
rel_tol * ||r0|| (the charge-free problem has f = 0, so the reference's
||f|| convention is vacuous and the initial residual is the anchor).
"""

from __future__ import annotations

import dataclasses
import warnings

import numpy as np
import torch

from multigrid_parallel_tpu_torch.hierarchy import Hierarchy
from multigrid_parallel_tpu_torch.mixed_bc import MixedBCSolver
from multigrid_parallel_tpu_torch.ops import pallas3d as pk
from multigrid_parallel_tpu_torch.ops import pallas_mixed as pm
from multigrid_parallel_tpu_torch.ops.pallas_mixed import apply_bcs_padded

__all__ = [
    "apply_bcs_padded",
    "make_mixed_padded_df_solver",
    "setup_mixed_df_problem",
    "unpack_mixed_solution",
]


def _make_mixed_descend(solver: MixedBCSolver, hier32: Hierarchy):
    """descend(e, r, level, from_zero) for the mixed correction equation
    (zero Dirichlet pins, Neumann copies at every level): K14 / K13, K3,
    the coarse recursion (revisited ``gamma - 1`` times where the coarse
    size is at least ``gamma_min_n``), K15. A given e is updated in place
    by the pre-smoother."""
    n_smooth = solver.n_smooth
    pins = [pm.dirichlet_pin_planes(solver.problem, n, solver.device)
            for n in hier32.sizes]
    coarse_solve = solver._coarse_solver(torch.float32)
    pin0 = pins[0] > 0.5

    def coarse32(fc):
        # the correction pins the Dirichlet patch nodes to exactly zero
        x = coarse_solve(fc)
        x[0] = torch.where(pin0[0], 0.0, x[0])
        x[-1] = torch.where(pin0[1], 0.0, x[-1])
        return x

    def descend(e, r, level, from_zero=False):
        if level == 0:
            return coarse32(r)
        h = hier32.spacing(level)
        pin = pins[level]
        if from_zero:
            e = pm.mixed_rb_smooth_from_zero_fused(r, pin, h, n_smooth, red_first=True)
        else:
            e = pm.mixed_rb_smooth_fused(e, r, pin, h, n_smooth, red_first=True)
        rc = pk.residual_restrict_fused(e, r, h)
        ec = descend(None, rc, level - 1, from_zero=True)
        for _ in range(solver._revisits(level - 1)):  # W-cycle revisits (depth-capped)
            ec = descend(ec, rc, level - 1)
        return pm.mixed_prolong_smooth_fused(ec, e, r, pin, h, n_smooth)

    return descend


def make_mixed_padded_df_solver(solver: MixedBCSolver, rel_tol: float = 1e-8,
                                max_cycles: int = 100, inner_cycles: int = 2):
    """run(u_hi, u_lo, f_hi, f_lo) -> (u_hi, u_lo, norm, n_outer): the
    electrospray solve on the fused-kernel tier, the mixed-BC twin of
    ``cycles_padded.make_on_device_df_solver``, on ``solver.device``.
    Honors ``solver.gamma`` and ``solver.gamma_min_n``; the boundary band
    applies only to ``MixedBCSolver``'s own paths (a warning says so).

    Each outer step runs ``inner_cycles`` f32 correction cycles on the
    defect r, then df_add, the BCs on u_hi and u_lo (the f64 patch values
    split into hi and lo), and K5's residual and norm. Host loop with one
    scalar readback per step and the JAX stop rule: ``tol = f32(rel_tol)
    * n0`` with n0 the initial K5 norm, ``while nrm > tol and it <
    max_cycles``. Pair with ``setup_mixed_df_problem``; recover the
    solution with ``unpack_mixed_solution``."""
    if solver.boundary_band_iters:
        warnings.warn(
            "make_mixed_padded_df_solver honors gamma but NOT "
            "boundary_band_width/iters — a solver configured with the "
            "MIXED_BC.md band fix converges differently on this tier "
            "than on solve_on_device (use gamma=2 W-cycles here)",
            stacklevel=2,
        )
    hier = solver.hier
    inner = _make_mixed_descend(solver, dataclasses.replace(hier, dtype=torch.float32))
    level = hier.num_levels - 1
    n = hier.sizes[level]
    h = hier.spacing(level)
    pin_top = pm.dirichlet_pin_planes(solver.problem, n, solver.device)
    _, vals64 = solver.problem.boundary_masks(n)
    vals_hi, vals_lo = pk.df_split(
        torch.from_numpy(np.stack([vals64[0], vals64[n - 1]])).to(solver.device))

    def residual(u_hi, u_lo, f_hi, f_lo):
        r, nrm2 = pk.residual_df_norm_fused(u_hi, u_lo, f_hi, f_lo, h)
        return r, torch.sqrt(nrm2)

    def run(u_hi, u_lo, f_hi, f_lo):
        r, nrm = residual(u_hi, u_lo, f_hi, f_lo)
        tol = float(np.float32(rel_tol) * np.float32(nrm.item()))
        it = 0
        while nrm.item() > tol and it < max_cycles:
            e = inner(None, r, level, from_zero=True)
            for _ in range(inner_cycles - 1):
                e = inner(e, r, level)
            u_hi, u_lo = pk.df_add(u_hi, u_lo, e)
            u_hi = apply_bcs_padded(u_hi, pin_top, vals_hi)
            u_lo = apply_bcs_padded(u_lo, pin_top, vals_lo)
            r, nrm = residual(u_hi, u_lo, f_hi, f_lo)
            it += 1
        return u_hi, u_lo, nrm, it

    return run


def setup_mixed_df_problem(solver: MixedBCSolver):
    """(u_hi, u_lo, f_hi, f_lo): the double-float (n, n, n) f32 split of
    the electrospray initial state (BC-enforced zeros; f = 0) on
    ``solver.device``."""
    u0, f = solver.initial_state()
    u_hi, u_lo = pk.df_split(u0.to(torch.float64))
    f_hi, f_lo = pk.df_split(f.to(torch.float64))
    return u_hi, u_lo, f_hi, f_lo


def unpack_mixed_solution(u_hi, u_lo, hier: Hierarchy):
    """The double-float solution as an (n, n, n) f64 tensor (the port
    has no padding to strip)."""
    return pk.df_to_f64(u_hi, u_lo)
