"""Sharded mixed-BC (electrospray) multigrid on torch.distributed: the
reference-shaped cycle with the i axis split over the ranks
(counterpart of ``multigrid_parallel_tpu.parallel.sharded_mixed``).

The i axis is sharded as in ``parallel.sharded`` (halo exchange, the
norm's ``all_reduce``, the gather into a replicated coarse tail), and the
mixed-BC enforcement is local to each block:

  * the y / z face Neumann copies are whole-face copies within a block;
  * the x face copies touch planes (0, 1) and (n - 2, n - 1), selected by
    global plane index; their source can live on the neighbouring rank
    (global plane n - 1 at local row 0 when L divides n - 1), so the
    shifted planes come from a one-plane exchange;
  * the Dirichlet patches sit on the x faces only, pinned by the same
    global-index select;
  * the replicated tail is ``MixedBCSolver``'s own f64 cycle
    (``_descend``, its mixed LU from ``_lu_host`` / ``_piv_host``).

Every stage mirrors ``MixedBCSolver``'s cycle (a BC pass after every
half-sweep, zero-pinned corrections below the top level, the boundary
band and the capped W-cycle), so the sharded cycle reproduces the
single-device cycle to roundoff. SPMD: ``step`` is what every rank calls
on its own (L, n, n) blocks.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch

from multigrid_parallel_tpu_torch.mixed_bc import MixedBCSolver
from multigrid_parallel_tpu_torch.ops import stencils_3d as ops3
from multigrid_parallel_tpu_torch.parallel.sharded import (
    Mesh,
    ShardPlan,
    _all_gather,
    _exchange,
    _global_row,
    _halo_extend,
    _masks,
    _neighbor_sum_local,
    _rank_slice,
    half_sweep_local,
    norm_sq_local,
    plan_sharding,
    prolong_correct_local,
    residual_local,
    restrict_local,
)


def apply_bcs_local(u, n: int, mesh: Mesh, pin0, pin1, vals0=None, vals1=None):
    """Mixed-BC enforcement on a local (L, n, n) block: whole-face Neumann
    copies in x, y, z order, then the Dirichlet patch pin. pin0 / pin1:
    (n, n) 0/1 masks of the x = 0 / x = n - 1 patches; vals*: the patch
    values (None: the zero pin of a correction). Returns a new tensor."""
    g = _global_row(mesh, u.shape[0])
    # the x-face copy source can live on the neighbouring rank: shifted
    # views from a one-plane exchange (a local shift would read a pad plane)
    from_left, from_right = _exchange(mesh, u[-1:], u[:1])
    dn = torch.cat([from_left, u[:-1]])
    up = torch.cat([u[1:], from_right])
    u = torch.where(g == 0, up, u)
    u = torch.where(g == n - 1, dn, u)
    u[:, 0] = u[:, 1]
    u[:, n - 1] = u[:, n - 2]
    u[:, :, 0] = u[:, :, 1]  # z faces last: they win at the edges
    u[:, :, n - 1] = u[:, :, n - 2]
    v0 = torch.zeros_like(u[0]) if vals0 is None else vals0
    v1 = torch.zeros_like(u[0]) if vals1 is None else vals1
    u = torch.where((g == 0) & (pin0 > 0.5), v0, u)
    return torch.where((g == n - 1) & (pin1 > 0.5), v1, u)


def _band_mask_local(mesh: Mesh, L: int, n: int, w: int):
    """Within-w-of-any-face mask of a local (L, n, n) block, on global i."""
    g = _global_row(mesh, L)
    idx = torch.arange(n, device=mesh.device)
    jj, kk = idx.reshape(1, -1, 1), idx.reshape(1, 1, -1)
    return ((g <= w) | (g >= n - 1 - w) | (jj <= w) | (jj >= n - 1 - w)
            | (kk <= w) | (kk >= n - 1 - w))


def _band_half_sweep_local(u, f, h: float, color: int, n: int, mesh: Mesh, w: int):
    """half_sweep_local restricted to the boundary band of width w."""
    ext = _halo_extend(u, mesh)
    upd = (_neighbor_sum_local(ext, u) - (h * h) * f) * (1.0 / 6.0)
    mask = _masks(mesh, u.shape[0], n, color) & _band_mask_local(mesh, u.shape[0], n, w)
    return torch.where(mask, upd, u)


def _mixed_smooth_local(u, f, h: float, n_iter: int, n: int, mesh: Mesh, pin0, pin1,
                        red_first: bool = True, vals0=None, vals1=None, band_width: int = 0,
                        band_iters: int = 0):
    """n_iter RB iterations, each half-sweep followed by the BC pass, then
    ``band_iters`` band-restricted ones (``MixedBCSolver._smooth``)."""
    colors = (ops3.RED, ops3.BLACK) if red_first else (ops3.BLACK, ops3.RED)
    for _ in range(n_iter):
        for c in colors:
            u = half_sweep_local(u, f, h, c, n, mesh)
            u = apply_bcs_local(u, n, mesh, pin0, pin1, vals0, vals1)
    for _ in range(band_iters):
        for c in colors:
            u = _band_half_sweep_local(u, f, h, c, n, mesh, band_width)
            u = apply_bcs_local(u, n, mesh, pin0, pin1, vals0, vals1)
    return u


def make_sharded_mixed_bc_cycle(solver: MixedBCSolver, mesh: Mesh,
                                plan: Optional[ShardPlan] = None) -> Tuple[Callable, ShardPlan]:
    """(step, plan): step(u_local, f_local) -> (u_local', norm), the
    rank's part of one mixed-BC V-cycle (W-cycle via solver.gamma, capped
    by solver.gamma_min_n, with solver.boundary_band_*) in hier.dtype on
    i-sharded blocks; norm is the residual's 2-norm, equal on every rank.
    Matches ``MixedBCSolver``'s single-device cycle to roundoff.
    ``solver.device`` must be the rank's device."""
    hier = solver.hier
    if plan is None:
        plan = plan_sharding(hier, mesh.n_dev)
    problem, n_smooth = solver.problem, solver.n_smooth
    bw, bits = solver.boundary_band_width, solver.boundary_band_iters
    coarse_solve = solver._coarse_solver(hier.dtype)

    pins = []
    for lvl in range(hier.num_levels):
        nl = hier.sizes[lvl]
        mask, vals = problem.boundary_masks(nl)
        pins.append(tuple(torch.as_tensor(x, dtype=dt, device=mesh.device)
                          for x, dt in ((mask[0], torch.float32), (mask[nl - 1], torch.float32),
                                        (vals[0], hier.dtype), (vals[nl - 1], hier.dtype))))

    def smooth(u, f, level, red_first, vals=False):
        pin0, pin1, vals0, vals1 = pins[level]
        return _mixed_smooth_local(u, f, hier.spacing(level), n_smooth, hier.sizes[level], mesh,
                                   pin0, pin1, red_first, *((vals0, vals1) if vals else ()),
                                   band_width=bw, band_iters=bits)

    def coarse_correction(fc, level, depth):
        ec = correction(fc, level, depth)
        for _ in range(solver._revisits(level)):  # W-cycle revisits (depth-capped)
            ec = correction(fc, level, depth, e_init=ec)
        return ec

    def correction(f_local, level, depth, e_init=None):
        nl = hier.sizes[level]
        if depth == plan.n_sharded:
            # gather to replicated and run MixedBCSolver's own cycle there
            f_rep = _all_gather(mesh, f_local)[:nl]
            e0 = (torch.zeros_like(f_rep) if e_init is None
                  else _all_gather(mesh, e_init)[:nl])
            e_rep = solver._descend(e0, f_rep, level, True, coarse_solve)
            return _rank_slice(e_rep, mesh, plan.local_planes(depth))
        h = hier.spacing(level)
        pin0, pin1, _, _ = pins[level]
        u = torch.zeros_like(f_local) if e_init is None else e_init
        u = smooth(u, f_local, level, True)
        fc = restrict_local(residual_local(u, f_local, h, nl, mesh), nl, mesh)
        ec = coarse_correction(fc, level - 1, depth + 1)
        u = prolong_correct_local(ec, u, hier.sizes[level - 1], mesh)
        u = apply_bcs_local(u, nl, mesh, pin0, pin1)
        return smooth(u, f_local, level, False)

    level = hier.num_levels - 1
    n = hier.sizes[level]
    h = hier.spacing(level)
    pin0, pin1, vals0, vals1 = pins[level]

    def step(u, f):
        u = smooth(u, f, level, True, vals=True)
        fc = restrict_local(residual_local(u, f, h, n, mesh), n, mesh)
        ec = coarse_correction(fc, level - 1, 1)
        u = prolong_correct_local(ec, u, hier.sizes[level - 1], mesh)
        u = apply_bcs_local(u, n, mesh, pin0, pin1, vals0, vals1)
        u = smooth(u, f, level, False, vals=True)
        r = residual_local(u, f, h, n, mesh)
        return u, torch.sqrt(norm_sq_local(r, mesh))

    return step, plan


def setup_mixed_problem_sharded(solver: MixedBCSolver, mesh: Mesh, plan: ShardPlan):
    """This rank's (u0, f) blocks: ``solver.initial_state()`` padded to
    the plan (solver.device must be the rank's device)."""
    u0, f = solver.initial_state()
    L = plan.local_planes(0)
    return _rank_slice(u0, mesh, L), _rank_slice(f, mesh, L)
