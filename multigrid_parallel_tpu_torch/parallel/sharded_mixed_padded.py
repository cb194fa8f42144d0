"""Distributed electrospray solve on the kernel tier: the double-float
mixed-BC defect correction on i-sharded blocks (counterpart of
``multigrid_parallel_tpu.parallel.sharded_mixed_padded``).

``parallel.sharded_mixed`` shards the reference-shaped f64 cycle on plain
tensor ops; this module is its performance twin, the mixed-BC twin of
``parallel.sharded_padded``: every stage of a sharded level runs on one
halo exchange, the smoothing stages on the sharded mixed kernels of
``ops.pallas_mixed`` (K35 / K34 pre-smoothing, K36 prolongation +
post-smoothing, the copy-BC folded and one BC pass a stage), residual +
restriction on the Dirichlet K30 verbatim (the interior residual reads the
boundary values the BC pass maintained, as on one card), and the outer
step's EFT residual on K32 with its partial norm all-reduced. Below the
sharded depths the levels gather to replicated and run the single-device
full tier (``mixed_padded._make_mixed_descend``: K14 / K13, K3, K15, the
mixed LU) on every rank.

The JAX module's name is kept; the port's fields have no lane padding
(``parallel.sharded_padded`` says how a level is laid out). Not carried
over: the VMEM ladder (``mixed_block_i``, ``_halo_bi``): a sharded level
runs the kernels, or the plain ops where ``_use_pallas_mixed`` says no.

One geometry needs more halo than the JAX kernels take: where L divides
n - 1, global plane n - 1 is some rank's first row, and the stage's BC
copy there reads plane n - 2 from the left halo. At such a level the
fine segments travel with 2 n_smooth + 1 left planes (the coarse ones of
K36 with n_smooth + 1), so the stage's last BC pass reads a fresh plane.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Tuple

import torch

from multigrid_parallel_tpu_torch import mixed_padded as mp
from multigrid_parallel_tpu_torch.hierarchy import Hierarchy
from multigrid_parallel_tpu_torch.mixed_bc import MixedBCSolver
from multigrid_parallel_tpu_torch.ops import pallas3d as pk
from multigrid_parallel_tpu_torch.ops import pallas_mixed as pm
from multigrid_parallel_tpu_torch.ops import pallas_sharded as px
from multigrid_parallel_tpu_torch.parallel.sharded import (
    Mesh,
    ShardPlan,
    _all_gather,
    _rank_slice,
    plan_sharding,
)
from multigrid_parallel_tpu_torch.parallel.sharded_mixed import (
    _mixed_smooth_local,
    apply_bcs_local,
)
from multigrid_parallel_tpu_torch.parallel.sharded_padded import (
    _gi0,
    _halo_parts,
    _make_residual_norm,
    _use_pallas,
    prolong_correct_local_padded,
    residual_local_padded,
    restrict_local_padded,
)

# the kernels' halo rule is the Dirichlet tier's (JAX keeps two copies)
_use_pallas_mixed = _use_pallas


def apply_bcs_local_padded(u, n: int, mesh: Mesh, pin, vals=None):
    """``sharded_mixed.apply_bcs_local`` with (2, n, n) pin planes and
    (optionally) (2, n, n) patch values, as the kernel tier keeps them."""
    return apply_bcs_local(u, n, mesh, pin[0], pin[1],
                           *((None, None) if vals is None else (vals[0], vals[1])))


def _mixed_smooth_local_padded(e, r, h: float, n_iter: int, n: int, mesh: Mesh, pin,
                               red_first: bool = True):
    """The plain-ops stage of a level the kernels do not take: masked
    half-sweeps, each followed by the zero-pin BC pass."""
    return _mixed_smooth_local(e, r, h, n_iter, n, mesh, pin[0], pin[1], red_first)


def _build_local_mixed_cycle(solver: MixedBCSolver, hier32: Hierarchy, plan: ShardPlan,
                             mesh: Mesh, jnp_level_max: int):
    """cycle(e, r, level, from_zero) -> e' on this rank's blocks of the
    mixed correction equation (``level`` is the finest of hier32, as
    ``mixed_padded._outer_loop`` passes it); a given e is left as it is:
    each stage returns a fresh block."""
    n_smooth = solver.n_smooth
    H = 2 * n_smooth
    rep_level = hier32.num_levels - 1 - plan.n_sharded
    # the replicated tail: the single-device full tier; a one-level sub is
    # the bare mixed LU with its x-face pin
    rep_descend = mp._make_mixed_descend(solver, dataclasses.replace(hier32,
                                                                     num_levels=rep_level + 1))
    assert plan.padded_planes(plan.n_sharded) >= hier32.sizes[rep_level], plan
    pins = [pm.dirichlet_pin_planes(solver.problem, n, mesh.device) for n in hier32.sizes]

    def descend(e, r, level, depth, from_zero=False):
        n = hier32.sizes[level]
        if depth == plan.n_sharded:
            # gather to replicated; every rank runs the same kernels on the
            # same data, so each computes the same e; a revisit gathers e too
            r_rep = _all_gather(mesh, r)[:n]
            if from_zero:
                e_rep = rep_descend(None, r_rep, level, from_zero=True)
            else:
                e_rep = rep_descend(_all_gather(mesh, e)[:n], r_rep, level)
            return _rank_slice(e_rep, mesh, plan.local_planes(depth))

        L = plan.local_planes(depth)
        h = hier32.spacing(level)
        pin = pins[level]
        pal = _use_pallas_mixed(n, L, H, jnp_level_max)
        if pal:
            # one more left plane where global plane n - 1 starts a block
            kl = H + int((n - 1) % L == 0)
            g = _gi0(mesh, L, H)
            r3 = _halo_parts(r, mesh, kl, H)  # read by the stages and the restriction
            if from_zero:
                e = pm.mixed_rb_smooth_from_zero_halo(r3, pin, g, h, n_smooth, n, L)
            else:
                e = pm.mixed_rb_smooth_halo(_halo_parts(e, mesh, kl, H), r3, pin, g, h,
                                            n_smooth, n, L)
            rc = px.residual_restrict_halo(_halo_parts(e, mesh, 2, 1), r3, _gi0(mesh, L, 2), h,
                                           n, L // 2)
        else:
            if from_zero:
                e = torch.zeros_like(r)
            e = _mixed_smooth_local_padded(e, r, h, n_smooth, n, mesh, pin, True)
            rc = restrict_local_padded(residual_local_padded(e, r, h, n, mesh), n, mesh)

        ec = descend(None, rc, level - 1, depth + 1, from_zero=True)
        for _ in range(solver._revisits(level - 1)):  # W-cycle revisits (depth-capped)
            ec = descend(ec, rc, level - 1, depth + 1)

        if pal:
            return pm.mixed_prolong_smooth_halo(
                _halo_parts(ec, mesh, kl - n_smooth, n_smooth + 1), _halo_parts(e, mesh, kl, H),
                r3, pin, g, h, n_smooth, n, L)
        e = prolong_correct_local_padded(ec, e, hier32.sizes[level - 1], mesh)
        e = apply_bcs_local_padded(e, n, mesh, pin)
        return _mixed_smooth_local_padded(e, r, h, n_smooth, n, mesh, pin, False)

    def cycle(e, r, level, from_zero=False):
        return descend(e, r, level, 0, from_zero=from_zero)

    return cycle


def make_sharded_mixed_padded_df_solver(
    solver: MixedBCSolver,
    mesh: Mesh,
    plan: Optional[ShardPlan] = None,
    rel_tol: float = 1e-8,
    max_cycles: int = 100,
    inner_cycles: int = 2,
    jnp_level_max: int = 0,
    block_i: int = 8,
) -> Tuple[Callable, ShardPlan]:
    """(run, plan): run(u_hi, u_lo, f_hi, f_lo) -> (u_hi, u_lo, norm,
    n_outer) on this rank's blocks, the sharded twin of
    ``mixed_padded.make_mixed_padded_df_solver`` (honours solver.gamma and
    gamma_min_n; the boundary band stays a host-path feature, as there).

    Each outer step runs ``inner_cycles`` f32 correction cycles on the
    defect, then df_add, the BCs on u_hi and u_lo (the f64 patch values
    split hi / lo) and K32's residual with its partial norm all-reduced,
    in ``mixed_padded._outer_loop``'s host loop (one scalar readback a
    step, stop at f32(rel_tol) * ||r0||). ``jnp_level_max``: levels of at
    most that size run the plain ops (0, the default, runs the kernels
    wherever the halos fit; the JAX default is 33, a TPU launch-overhead
    crossover); ``block_i`` is accepted and ignored. ``solver.device``
    must be the rank's device."""
    del block_i
    hier = solver.hier
    if plan is None:
        plan = plan_sharding(hier, mesh.n_dev)
    inner = _build_local_mixed_cycle(solver, dataclasses.replace(hier, dtype=torch.float32),
                                     plan, mesh, jnp_level_max)
    level = hier.num_levels - 1
    n = hier.sizes[level]
    pin_top = pm.dirichlet_pin_planes(solver.problem, n, mesh.device)
    vals_hi, vals_lo = mp._patch_values(solver, n)
    residual = _make_residual_norm(mesh, n, hier.spacing(level), plan.local_planes(0),
                                   jnp_level_max)

    def update(u_hi, u_lo, e):
        u_hi, u_lo = pk.df_add(u_hi, u_lo, e)
        return (apply_bcs_local_padded(u_hi, n, mesh, pin_top, vals_hi),
                apply_bcs_local_padded(u_lo, n, mesh, pin_top, vals_lo))

    return mp._outer_loop(inner, level, residual, update, rel_tol, max_cycles,
                          inner_cycles), plan


def setup_mixed_df_problem_sharded(solver: MixedBCSolver, mesh: Mesh, plan: ShardPlan):
    """This rank's (u_hi, u_lo, f_hi, f_lo) blocks: the double-float
    electrospray state of ``mixed_padded.setup_mixed_df_problem``, i-padded
    to the plan."""
    L = plan.local_planes(0)
    return tuple(_rank_slice(x, mesh, L) for x in mp.setup_mixed_df_problem(solver))


def unpack_mixed_solution_sharded(u_hi, u_lo, hier: Hierarchy):
    """Gathered (n_dev * L, n, n) df pair (``sharded.gather_global``) ->
    the (n, n, n) f64 solution."""
    n = hier.finest_n
    return pk.df_to_f64(u_hi[:n], u_lo[:n])
