"""The electrospray (mixed-BC) solve on the fused-kernel tiers: the full-
layout, the k-fold and the split-colour double-float defect-correction
solvers (counterpart of ``multigrid_parallel_tpu.mixed_padded``).

Full tier: the f32 correction V-cycle runs the mixed-BC smoothing kernels
of ``ops.pallas_mixed`` (K14 / K13 pre-smoothing, K15 prolongation +
post-smoothing, each stage ending with the BC pass), and the Dirichlet
fused residual + restriction (K3) unchanged: the interior residual reads
the boundary values the BC pass maintained. The coarsest level is an f32
LU solve of the mixed matrix, then the zero pin of the x-face patches
(no zero boundary, no BC pass). The outer loop is the double-float EFT
defect iteration of ``cycles_padded.make_on_device_df_solver`` with the
BCs re-enforced on the solution pair after each step, then K5.

Fold tier: the same solve on fields in the k-fold layout of
``ops.pallas_mixed_fold`` ((n, n, n - 2), the k faces not stored): K17 /
K16, K18, K19, and K20 for the outer residual, on every level above the
coarsest. The coarsest level goes through the full layout
(``fold_to_full_rhs``, the f32 LU + pin, ``full_to_fold``); JAX's
delegation of small levels to the full layout (``jnp_level_max`` and the
fold planners) is not carried over.

Split-colour tier: the finest level on red / black pairs
(``ops.pallas_mixed_split``: K22 / K21, K23 to the coarse fold RHS, K24
from the coarse fold correction, K25 for the outer residual), every
coarser level on the fold cycle; the outer step's BCs on the pairs in
plain torch (``apply_bcs_split_pair``).

The module keeps its JAX name; the port's fields are plain tensors.
Not carried over (TPU planning with the same half-sweep sequence):
``jnp_level_max``, ``block_i``, the ``*_block_i`` VMEM planners, the
fold and split tiers' split ladders, and the split tier's lane gate and
``force`` flag; every level above the coarsest runs the kernels on a
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

from multigrid_parallel_tpu_torch import cycles_split as cs
from multigrid_parallel_tpu_torch.hierarchy import Hierarchy
from multigrid_parallel_tpu_torch.mixed_bc import MixedBCSolver
from multigrid_parallel_tpu_torch.ops import pallas3d as pk
from multigrid_parallel_tpu_torch.ops import pallas_mixed as pm
from multigrid_parallel_tpu_torch.ops import pallas_mixed_fold as pmf
from multigrid_parallel_tpu_torch.ops import pallas_mixed_split as pms
from multigrid_parallel_tpu_torch.ops import pallas_split as ps
from multigrid_parallel_tpu_torch.ops.pallas_mixed import apply_bcs_padded

__all__ = [
    "apply_bcs_fold",
    "apply_bcs_padded",
    "make_mixed_fold_df_solver",
    "make_mixed_padded_df_solver",
    "make_mixed_split_df_solver",
    "mixed_split_available",
    "setup_mixed_df_problem",
    "setup_mixed_fold_df_problem",
    "setup_mixed_split_df_problem",
    "unpack_mixed_fold_solution",
    "unpack_mixed_solution",
    "unpack_mixed_split_solution",
]


def _mixed_coarse32(solver: MixedBCSolver, hier32: Hierarchy):
    """coarse32(fc): the f32 LU solve of the coarsest mixed system, then
    the zero pin of the x-face patches (the correction's Dirichlet
    value)."""
    coarse_solve = solver._coarse_solver(torch.float32)
    pin0 = pm.dirichlet_pin_planes(solver.problem, hier32.sizes[0], solver.device) > 0.5

    def coarse32(fc):
        x = coarse_solve(fc)
        x[0] = torch.where(pin0[0], 0.0, x[0])
        x[-1] = torch.where(pin0[1], 0.0, x[-1])
        return x

    return coarse32


def _make_mixed_descend(solver: MixedBCSolver, hier32: Hierarchy):
    """descend(e, r, level, from_zero) for the mixed correction equation
    (zero Dirichlet pins, Neumann copies at every level): K14 / K13, K3,
    the coarse recursion (revisited ``gamma - 1`` times where the coarse
    size is at least ``gamma_min_n``), K15. A given e is left as it is:
    the pre-smoother returns a fresh field."""
    n_smooth = solver.n_smooth
    pins = [pm.dirichlet_pin_planes(solver.problem, n, solver.device)
            for n in hier32.sizes]
    coarse32 = _mixed_coarse32(solver, hier32)

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


def _patch_values(solver: MixedBCSolver, n: int):
    """(vals_hi, vals_lo): the f64 Dirichlet patch values of the two x
    faces, (2, n, n), split into a double-float pair on the device."""
    _, vals64 = solver.problem.boundary_masks(n)
    return pk.df_split(torch.from_numpy(np.stack([vals64[0], vals64[n - 1]])).to(solver.device))


def _outer_loop(inner, level: int, residual, update, rel_tol, max_cycles, inner_cycles):
    """run(u_hi, u_lo, f_hi, f_lo) -> (u_hi, u_lo, norm, n_outer): each
    outer step runs ``inner_cycles`` f32 correction cycles on the defect
    r, then ``update`` (df_add of the correction and the BCs on the pair)
    and ``residual``. Host loop with one scalar readback per step and the
    JAX stop rule: ``tol = f32(rel_tol) * n0`` with n0 the initial norm,
    ``while nrm > tol and it < max_cycles``."""

    def run(u_hi, u_lo, f_hi, f_lo):
        r, nrm = residual(u_hi, u_lo, f_hi, f_lo)
        tol = float(np.float32(rel_tol) * np.float32(nrm.item()))
        it = 0
        while nrm.item() > tol and it < max_cycles:
            e = inner(None, r, level, from_zero=True)
            for _ in range(inner_cycles - 1):
                e = inner(e, r, level)
            u_hi, u_lo = update(u_hi, u_lo, e)
            r, nrm = residual(u_hi, u_lo, f_hi, f_lo)
            it += 1
        return u_hi, u_lo, nrm, it

    return run


def make_mixed_padded_df_solver(solver: MixedBCSolver, rel_tol: float = 1e-8,
                                max_cycles: int = 100, inner_cycles: int = 2):
    """run(u_hi, u_lo, f_hi, f_lo) -> (u_hi, u_lo, norm, n_outer): the
    electrospray solve on the fused-kernel tier, the mixed-BC twin of
    ``cycles_padded.make_on_device_df_solver``, on ``solver.device``.
    Honors ``solver.gamma`` and ``solver.gamma_min_n``; the boundary band
    applies only to ``MixedBCSolver``'s own paths (a warning says so).

    Each outer step runs ``inner_cycles`` f32 correction cycles on the
    defect r, then df_add, the BCs on u_hi and u_lo (the f64 patch values
    split into hi and lo), and K5's residual and norm, in
    ``_outer_loop``'s host loop with the JAX stop rule. Pair with
    ``setup_mixed_df_problem``; recover the solution with
    ``unpack_mixed_solution``."""
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
    vals_hi, vals_lo = _patch_values(solver, n)

    def residual(u_hi, u_lo, f_hi, f_lo):
        r, nrm2 = pk.residual_df_norm_fused(u_hi, u_lo, f_hi, f_lo, h)
        return r, torch.sqrt(nrm2)

    def update(u_hi, u_lo, e):
        u_hi, u_lo = pk.df_add(u_hi, u_lo, e)
        return apply_bcs_padded(u_hi, pin_top, vals_hi), apply_bcs_padded(u_lo, pin_top, vals_lo)

    return _outer_loop(inner, level, residual, update, rel_tol, max_cycles, inner_cycles)


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


# ------------------------------------------------------------ k-FOLD tier


def _edge_sign_planes(solver: MixedBCSolver, level: int) -> torch.Tensor:
    """The sign planes (2, n, n - 2) with which a finer level's
    prolongation rebuilds the unstored k-face edge nodes of this level's
    fold correction (K19, K24).

    The planes rebuild a coarse k-face edge node by the BC pass's rule
    (the pin after the z copy, ``fold_edge_sign_planes``), which every
    level's stage output follows. The coarsest correction comes from the
    LU solve instead, whose Neumann rows copy a k-face node from its
    k-edge neighbour, pinned or not (``mixed_bc._neumann_source_index``):
    there the node is the stored copy, or 0 where it is pinned itself, so
    level 0's planes keep only the -1 entries. With the BC rule at level 0
    the 33^3 V-cycle takes 27 outer steps where the full tier takes 29."""
    sgn = pmf.fold_edge_sign_planes(solver.problem, solver.hier.sizes[level], solver.device)
    return torch.clamp(sgn, max=0.0) if level == 0 else sgn


def _make_mixed_descend_fold(solver: MixedBCSolver, hier32: Hierarchy):
    """descend(e, r, level, from_zero) on fold-layout fields: K17 / K16,
    K18, the coarse recursion (revisits as the full tier), K19 with the
    coarse level's ``_edge_sign_planes``. Level 0 is the full tier's
    coarse32 between ``fold_to_full_rhs`` and ``full_to_fold``. A given e
    is left as it is: the pre-smoother returns a fresh field."""
    n_smooth = solver.n_smooth
    pins = [pmf.fold_pin_planes(solver.problem, n, solver.device) for n in hier32.sizes]
    sgns = [_edge_sign_planes(solver, lvl) for lvl in range(hier32.num_levels)]
    coarse32 = _mixed_coarse32(solver, hier32)

    def descend(e, r, level, from_zero=False):
        if level == 0:
            return pmf.full_to_fold(coarse32(pmf.fold_to_full_rhs(r)))
        h = hier32.spacing(level)
        pin = pins[level]
        if from_zero:
            e = pmf.mixed_rb_smooth_from_zero_fold(r, pin, h, n_smooth, red_first=True)
        else:
            e = pmf.mixed_rb_smooth_fold(e, r, pin, h, n_smooth, red_first=True)
        rc = pmf.residual_restrict_fold(e, r, h)
        ec = descend(None, rc, level - 1, from_zero=True)
        for _ in range(solver._revisits(level - 1)):  # W-cycle revisits (depth-capped)
            ec = descend(ec, rc, level - 1)
        return pmf.mixed_prolong_smooth_fold(ec, e, r, pin, sgns[level - 1], h, n_smooth)

    return descend


def apply_bcs_fold(e, pin, vals=None):
    """``apply_bcs_padded`` on a fold (n, n, n - 2) field (plain torch, as
    JAX leaves it to XLA): x and y Neumann copies, then the x-face pin to
    ``vals`` ((2, n, n - 2), or None for zero); the z faces are not
    stored. Returns a new tensor."""
    n = e.shape[0]
    e = e.clone()
    e[0] = e[1]
    e[n - 1] = e[n - 2]
    e[:, 0] = e[:, 1]
    e[:, n - 1] = e[:, n - 2]
    v0 = torch.zeros_like(e[0]) if vals is None else vals[0]
    v1 = torch.zeros_like(e[0]) if vals is None else vals[1]
    e[0] = torch.where(pin[0] > 0.5, v0, e[0])
    e[n - 1] = torch.where(pin[1] > 0.5, v1, e[n - 1])
    return e


def make_mixed_fold_df_solver(solver: MixedBCSolver, rel_tol: float = 1e-8,
                              max_cycles: int = 100, inner_cycles: int = 2):
    """The k-fold twin of ``make_mixed_padded_df_solver``: the same solve
    and stop rule on fold-layout fields, the outer step's BCs through
    ``apply_bcs_fold`` and its residual and norm through K20. Pair with
    ``setup_mixed_fold_df_problem`` / ``unpack_mixed_fold_solution``."""
    if solver.boundary_band_iters:
        warnings.warn(
            "make_mixed_fold_df_solver honors gamma but NOT "
            "boundary_band_width/iters (use gamma=2 W-cycles here)",
            stacklevel=2,
        )
    hier = solver.hier
    inner = _make_mixed_descend_fold(solver, dataclasses.replace(hier, dtype=torch.float32))
    level = hier.num_levels - 1
    n = hier.sizes[level]
    h = hier.spacing(level)
    pin_top = pmf.fold_pin_planes(solver.problem, n, solver.device)
    vals_hi, vals_lo = (pmf.pack_fold(v) for v in _patch_values(solver, n))

    def residual(u_hi, u_lo, f_hi, f_lo):
        r, nrm2 = pmf.residual_df_norm_fold(u_hi, u_lo, f_hi, f_lo, h)
        return r, torch.sqrt(nrm2)

    def update(u_hi, u_lo, e):
        u_hi, u_lo = pk.df_add(u_hi, u_lo, e)
        return apply_bcs_fold(u_hi, pin_top, vals_hi), apply_bcs_fold(u_lo, pin_top, vals_lo)

    return _outer_loop(inner, level, residual, update, rel_tol, max_cycles, inner_cycles)


def setup_mixed_fold_df_problem(solver: MixedBCSolver):
    """``setup_mixed_df_problem`` packed into the fold layout."""
    return tuple(pmf.pack_fold(x) for x in setup_mixed_df_problem(solver))


def unpack_mixed_fold_solution(u_hi, u_lo, solver: MixedBCSolver):
    """The double-float fold solution as an (n, n, n) f64 tensor, after
    one f64 BC pass (``MixedBCSolver._apply_bcs``, as JAX does): it
    restores the Dirichlet patch values on the x faces' k-edge nodes,
    which unpacking rebuilds as Neumann copies."""
    u = pk.df_to_f64(pmf.unpack_fold(u_hi), pmf.unpack_fold(u_lo))
    return solver._apply_bcs(u, solver.hier.num_levels - 1, zero_dirichlet=False)


# ------------------------------------------------------ SPLIT-COLOUR tier


def mixed_split_available(solver: MixedBCSolver) -> bool:
    """True when the finest level has a coarser one, which K23 and K24
    need: the one gate of the split tier, which
    ``make_mixed_split_df_solver`` applies too. The JAX package also asks
    that the pair halve the TPU's lane tiles and that every kernel fit
    VMEM (its two gates disagree there); neither has a counterpart here."""
    return cs.split_available(solver.hier)


def make_mixed_split_df_solver(solver: MixedBCSolver, rel_tol: float = 1e-8,
                               max_cycles: int = 100, inner_cycles: int = 2):
    """run(u_hr, u_hb, u_lr, u_lb, f_hr, f_hb, f_lr, f_lb) -> (u_hr',
    u_hb', u_lr', u_lb', norm, n_outer): the split-colour twin of
    ``make_mixed_fold_df_solver``, the same solve and stop rule with the
    finest level on red / black pairs (``ops.pallas_mixed_split``) and
    every coarser level on the fold cycle. Pair with
    ``setup_mixed_split_df_problem`` / ``unpack_mixed_split_solution``.

    A finest-level cycle: K22 from a zero guess (K21 for the
    ``inner_cycles - 1`` later ones), K23 to the coarse fold RHS, the fold
    cycle on the level below (revisited as the fold tier revisits it), K24
    with that level's ``_edge_sign_planes``. The outer step: df_add per
    colour, ``apply_bcs_split_pair`` on the hi and lo pairs with the
    patch-value packs, then K25, which also gives the initial residual.
    Not carried over (TPU planning): the split ladder, ``force`` and the
    ``block_i`` / ``smooth_block_i`` / ``ps_block_i`` / ``jnp_level_max``
    arguments."""
    if not mixed_split_available(solver):
        raise ValueError(f"the split tier needs a 3D hierarchy of >= 2 levels, got {solver.hier}")
    if solver.boundary_band_iters:
        warnings.warn(
            "make_mixed_split_df_solver honors gamma but NOT "
            "boundary_band_width/iters (use gamma=2 W-cycles here)",
            stacklevel=2,
        )
    hier = solver.hier
    fold_descend = _make_mixed_descend_fold(solver, dataclasses.replace(hier, dtype=torch.float32))
    level = hier.num_levels - 1
    n = hier.sizes[level]
    h = hier.spacing(level)
    ns = solver.n_smooth
    packs = pms.msplit_pin_packs(solver.problem, n, solver.device)
    sgn_c = _edge_sign_planes(solver, level - 1)
    vals_hi, vals_lo = (pms.msplit_plane_packs(v) for v in _patch_values(solver, n))

    def cycle(e2, r2, lvl, from_zero=False):
        """One finest-level cycle on the correction pair; a given e2 is
        left as it is (the pre-smoother returns a fresh pair)."""
        rr, rb = r2
        if from_zero:
            er, eb = pms.mixed_rb_smooth_from_zero_msplit(rr, rb, packs, h, ns, red_first=True)
        else:
            er, eb = pms.mixed_rb_smooth_msplit(*e2, rr, rb, packs, h, ns, red_first=True)
        rc = pms.residual_restrict_msplit(er, eb, rr, rb, h)
        ec = fold_descend(None, rc, lvl - 1, from_zero=True)
        for _ in range(solver._revisits(lvl - 1)):  # W-cycle revisits (depth-capped)
            ec = fold_descend(ec, rc, lvl - 1)
        return pms.mixed_prolong_smooth_msplit(ec, er, eb, rr, rb, packs, sgn_c, h, ns)

    def residual(u_hi, u_lo, f_hi, f_lo):
        r_r, r_b, nrm2 = pms.residual_df_norm_msplit(*u_hi, *u_lo, *f_hi, *f_lo, h)
        return (r_r, r_b), torch.sqrt(nrm2)

    def update(u_hi, u_lo, e):
        (hr, lr), (hb, lb) = (pk.df_add(u_hi[c], u_lo[c], e[c]) for c in (0, 1))
        return (pms.apply_bcs_split_pair(hr, hb, packs, vals_hi),
                pms.apply_bcs_split_pair(lr, lb, packs, vals_lo))

    loop = _outer_loop(cycle, level, residual, update, rel_tol, max_cycles, inner_cycles)

    def run(u_hr, u_hb, u_lr, u_lb, f_hr, f_hb, f_lr, f_lb):
        (hr, hb), (lr, lb), nrm, it = loop((u_hr, u_hb), (u_lr, u_lb), (f_hr, f_hb), (f_lr, f_lb))
        return hr, hb, lr, lb, nrm, it

    return run


def setup_mixed_split_df_problem(solver: MixedBCSolver):
    """``setup_mixed_df_problem`` packed into pairs: (u_hr, u_hb, u_lr,
    u_lb, f_hr, f_hb, f_lr, f_lb)."""
    return tuple(t for x in setup_mixed_df_problem(solver) for t in ps.pack_split(x))


def unpack_mixed_split_solution(u_hr, u_hb, u_lr, u_lb, solver: MixedBCSolver):
    """The double-float pair solution as an (n, n, n) f64 tensor, after
    one f64 BC pass (``MixedBCSolver._apply_bcs``, as JAX does): it
    restores the k faces, which the pair does not store, and the
    Dirichlet patch values on the x faces' k edges."""
    u = pk.df_to_f64(ps.unpack_split(u_hr, u_hb), ps.unpack_split(u_lr, u_lb))
    return solver._apply_bcs(u, solver.hier.num_levels - 1, zero_dirichlet=False)
