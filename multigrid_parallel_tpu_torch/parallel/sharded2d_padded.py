"""Distributed performance path on an (i, j) mesh: the double-float solve
on blocks sharded over i and j, every hot stage on the 2D kernels
(counterpart of ``multigrid_parallel_tpu.parallel.sharded2d_padded``).

The 2D twin of parallel/sharded_padded.py: i is split over mesh axis 0
and j over mesh axis 1; k stays whole. At each sharded level one halo
exchange feeds a whole stage on the kernels of ``ops.pallas_sharded2d``
(K37-K41): all half-sweeps of a smoothing stage, residual + restriction,
prolongation + correction + post-smoothing. The coarse levels gather to
replicated and reuse the single-device cycle (``cycles_padded``, its
kernels K1-K4) on every rank. This is the tier that constant-volume weak
scaling needs past the 1D plan's plane budget (docs/SCALING.md: >16
chips at 1025^3).

The JAX module's name is kept; the port's fields have no lane padding: a
level with n valid points a side is an (nx * Li, ny * Lj, n) global
array, of which each rank holds its (Li, Lj, n) block; pad rows and
columns are zero and masked everywhere. Li and Lj are multiples of
2**n_sharded (the plan), so block origins stay even across coarsenings.

Halos: the kernels read the five copy-free parts of ``_halo_parts2dj``:
the body in place, the j halos, and j-extended i-edge rows, sent over i
AFTER the j exchange, so the corner (diagonal neighbour) values that a
stage recomputing its halo reads are there. The j halo is the stage's, as
deep as in i: the JAX package's fixed HJ = 8 (the TPU's sublane tile)
has no counterpart.

Tiers at a sharded level (``_build_local_cycle2d``), by the structural
rule of ``_use_pallas2d`` (every halo from one neighbour's block, the
prolongation's coarse one included; JAX's TPU rules, Lj % 8 and the
fixed HJ, do not carry over, so the port's tier map differs from JAX's):
the 2D kernels; where only Lj is too narrow, the j-replicated 1D tier
(gather j, run the i-sharded kernels K28-K31 of ``ops.pallas_sharded``
on i-segments, slice j back); else the plain local ops. Every tier
computes K1-K4's bits on the owned points.

The whole solve (make_sharded2d_padded_df_solver) is the 2D twin of
sharded_padded.make_sharded_df_solver: a double-float solution, the EFT
outer residual (K41 + all_reduce), ``inner_cycles`` V-cycles per defect
step, and a host loop with one scalar readback per outer step.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Tuple

import numpy as np
import torch

from multigrid_parallel_tpu_torch import cycles_padded as cp
from multigrid_parallel_tpu_torch.cycles import CycleConfig, setup_problem
from multigrid_parallel_tpu_torch.hierarchy import Hierarchy
from multigrid_parallel_tpu_torch.ops import pallas3d as pk
from multigrid_parallel_tpu_torch.ops import pallas_sharded as px1
from multigrid_parallel_tpu_torch.ops import pallas_sharded2d as px2
from multigrid_parallel_tpu_torch.parallel.sharded import _all_reduce_sum
from multigrid_parallel_tpu_torch.parallel.sharded2d import (
    Mesh2D,
    ShardPlan2D,
    _exchange_i,
    _exchange_j,
    _plan,
    _rank_block,
    gather_global2d,
    make_mesh_2d,  # noqa: F401 - re-exported, as the JAX module does
    prolong_correct_local2d,
    rb_smooth_local2d,
    residual_df_local2d,
    residual_local2d,
    restrict_local2d,
)


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def plan_sharding_2d_padded(
    hier: Hierarchy, nx: int, ny: int, axes=("x", "y"), min_local: int = 4,
    j_align: int = 16, max_j_pad: float = 0.07,
) -> ShardPlan2D:
    """ShardPlan2D for the padded tier: fine_local_j is additionally
    rounded to ``j_align`` (the JAX plan's sublane alignment, kept so the
    two packages' plans and blocks agree).

    Deep sharding forces 2**n_sharded alignment, which can inflate the
    local j extent by up to ~50% (1025^3 on a 4x4 mesh: 257 -> 384
    columns at n_sharded=7). n_sharded is therefore reduced while that
    strictly shrinks the aligned extent and the j padding still exceeds
    ``max_j_pad`` (the forgone depth only moves small replicated-tail
    levels, which every rank recomputes cheaply)."""
    n_sharded = 1
    while n_sharded < hier.num_levels - 1 and (
        min(
            hier.sizes[hier.num_levels - 1 - n_sharded] // nx,
            hier.sizes[hier.num_levels - 1 - n_sharded] // ny,
        )
        >= min_local
    ):
        n_sharded += 1

    fj0 = -(-hier.finest_n // ny)

    def fj_of(ns):
        return _round_up(fj0, max(j_align, 1 << ns))

    while (n_sharded > 1 and fj_of(n_sharded) - fj0 > max_j_pad * fj0
           and fj_of(n_sharded - 1) < fj_of(n_sharded)):
        n_sharded -= 1
    align = 1 << n_sharded
    fi = _round_up(-(-hier.finest_n // nx), align)
    fj = _round_up(fj0, max(j_align, align))
    return ShardPlan2D(
        nx=nx, ny=ny, axes=tuple(axes), n_sharded=n_sharded,
        fine_local_i=fi, fine_local_j=fj,
    )


# ------------------------------------------------------------------ halos


def _halo_ext_i(x, mesh: Mesh2D, k: int):
    left, right = _exchange_i(mesh, x[-k:], x[:k])
    return torch.cat([left, x, right], dim=0)


def _halo_ext_j(x, mesh: Mesh2D, k: int):
    left, right = _exchange_j(mesh, x[:, -k:], x[:, :k])
    return torch.cat([left, x, right], dim=1)


def _halo_parts2d(x, mesh: Mesh2D, kl: int, kr: int, tail_local: int = 0):
    """(B, lh, rhc) for the 2D kernels' triple form: B the j-extended
    block (a max(kl, kr)-column halo on each side), lh / rhc its edge rows
    from the ranks above and below, sent AFTER the j extension (so the
    corners are right); ``tail_local`` prepends that many local tail rows
    of B to rhc (the JAX composite layout)."""
    B = _halo_ext_j(x, mesh, max(kl, kr))
    lh, rh = _exchange_i(mesh, B[-kl:], B[:kr])
    if tail_local:
        rh = torch.cat([B[B.shape[0] - tail_local:], rh])
    return (B, lh, rh)


def _halo_parts2dj(x, mesh: Mesh2D, kl: int, kr: int, tail_local: int = 0):
    """(x, jl, jr, lh, rhc) for the 2D kernels, with no copy of the block:
    the j halos (kl columns from the left rank, kr from the right; the
    stage's halo is as deep in j as in i) and the j-extended i-edge rows
    (kl from the rank above, kr from the rank below, two hops, so they
    carry the diagonal neighbours' corner values); ``tail_local``
    prepends that many j-extended local tail rows to rhc."""
    jl, jr = _exchange_j(mesh, x[:, -kl:], x[:, :kr])

    def jrows(sl):
        return torch.cat([jl[sl], x[sl], jr[sl]], dim=1)

    lh, rh = _exchange_i(mesh, jrows(slice(-kl, None)), jrows(slice(None, kr)))
    if tail_local:
        rh = torch.cat([jrows(slice(x.shape[0] - tail_local, None)), rh])
    return (x, jl, jr, lh, rh)


def _halo_parts_i(x, mesh: Mesh2D, kl: int, kr: int):
    """(x, lh, rh) for the i-sharded kernels (the j-replicated tier): only
    the kl / kr edge rows travel, over mesh axis 0."""
    lh, rh = _exchange_i(mesh, x[-kl:], x[:kr])
    return (x, lh, rh)


def _gij0(mesh: Mesh2D, Li: int, Lj: int, halo: int):
    """[global i, global j] of the first row and column of a stage with a
    ``halo``-deep halo around this rank's (Li, Lj) block."""
    return (mesh.ix * Li - halo, mesh.iy * Lj - halo)


# ------------------------------- plain local ops (the small-level path)
# The JAX module's padded local ops differ from parallel.sharded2d's only
# by the TPU's lane padding; without it they are the same functions.

rb_smooth_local2dp = rb_smooth_local2d
residual_local2dp = residual_local2d
restrict_local2dp = restrict_local2d
prolong_correct_local2dp = prolong_correct_local2d


def _residual_df_norm_local2dp_plain(u_hi, u_lo, f_hi, f_lo, h, n, mesh: Mesh2D):
    """The plain tier's EFT residual + this rank's partial norm (the JAX
    package's ``_residual_df_norm_local2dp_jnp``)."""
    r = residual_df_local2d(u_hi, u_lo, f_hi, f_lo, h, n, mesh)
    r64 = r.to(torch.float64)
    return r, torch.sum(r64 * r64).to(r.dtype)


# ----------------------------------------------------- cycle + solver


def _use_pallas2d(n: int, Li: int, Lj: int, H: int, jnp_level_max: int) -> bool:
    """The 2D kernels at a sharded level need the level above jnp_level_max
    AND every halo of its stages from one neighbour's block, in i and in
    j: the fine halo H, and the prolongation's coarse halo n_iter + 1 =
    H / 2 + 1 from (Li / 2, Lj / 2) coarse blocks, so Li, Lj >= H + 2 (the
    1D rule, sharded_padded._use_pallas, on both axes). The JAX gate's TPU
    rules (Lj % 8 == 0, Lj >= 2 HJ with the fixed HJ = 8) have no
    counterpart; a halo is never clamped."""
    need = max(H + 2, 4)
    return n > jnp_level_max and Li >= need and Lj >= need


def _tier(n: int, Li: int, Lj: int, H: int, jnp_level_max: int) -> str:
    """The tier of a sharded level: "2d" (K37-K40), "j-replicated" (the
    i-sharded K28-K31 on j-gathered rows, where only Lj is too narrow for
    the 2D halos) or "plain"."""
    if _use_pallas2d(n, Li, Lj, H, jnp_level_max):
        return "2d"
    if n > jnp_level_max and Li >= max(H + 2, 4):
        return "j-replicated"
    return "plain"


def _build_local_cycle2d(hier32: Hierarchy, cfg: CycleConfig, plan: ShardPlan2D, mesh: Mesh2D,
                         jnp_level_max: int):
    """cycle_local(e, r, from_zero) -> e' on this rank's (Li, Lj, n)
    blocks (finest level of hier32)."""
    n_smooth = cfg.n_smooth
    H = 2 * n_smooth
    rep_level = hier32.num_levels - 1 - plan.n_sharded
    sub = dataclasses.replace(hier32, num_levels=rep_level + 1)
    rep_cycle = cp.make_padded_correction_cycle(sub, cfg, mesh.device)
    n_rep = hier32.sizes[rep_level]
    assert plan.padded_i(plan.n_sharded) >= n_rep, (plan, n_rep)
    assert plan.padded_j(plan.n_sharded) >= n_rep, (plan, n_rep)

    def rep(x, n):
        """Gather both axes to replicated, cut to the n valid points."""
        return gather_global2d(x, mesh)[:n, :n].contiguous()

    def jrep(x, n):
        """Gather j within this rank's i row, cut to the n valid columns."""
        li = x.shape[0]
        return gather_global2d(x, mesh)[mesh.ix * li:(mesh.ix + 1) * li, :n].contiguous()

    def jslice(x, lj):
        """This rank's lj columns of a j-replicated block."""
        x = torch.nn.functional.pad(x, (0, 0, 0, max(mesh.ny * lj - x.shape[1], 0)))
        return x[:, mesh.iy * lj:(mesh.iy + 1) * lj].contiguous()

    def descend(e, r, level, depth, from_zero=False):
        n = hier32.sizes[level]
        if depth == plan.n_sharded:
            # Gather both axes; run the single-device cycle (the same
            # kernels on every rank, deterministic, so every rank computes
            # the same e); take this rank's block.
            r_rep = rep(r, n)
            e_rep = (rep_cycle(None, r_rep, from_zero=True) if from_zero
                     else rep_cycle(rep(e, n), r_rep))
            return _rank_block(e_rep, mesh, plan.local_i(depth), plan.local_j(depth))

        Li, Lj = plan.local_i(depth), plan.local_j(depth)
        h = hier32.spacing(level)
        nc = hier32.sizes[level - 1]

        def coarse(rc):
            ec = descend(None, rc, level - 1, depth + 1, from_zero=True)
            if level - 1 > 0 and nc >= cfg.gamma_min_n:
                for _ in range(cfg.gamma - 1):  # W-cycle revisits
                    ec = descend(ec, rc, level - 1, depth + 1)
            return ec

        tier = _tier(n, Li, Lj, H, jnp_level_max)
        if tier == "2d":
            # r's halo travels once per level visit: the smoothing stages,
            # the restriction and the prolongation read the same parts
            r5 = _halo_parts2dj(r, mesh, H, H)
            g = _gij0(mesh, Li, Lj, H)
            if from_zero:
                e = px2.rb_smooth_from_zero_halo2d(r5, g, h, n_smooth, n, Li, Lj)
            else:
                e = px2.rb_smooth_halo2d(_halo_parts2dj(e, mesh, H, H), r5, g, h, n_smooth, n,
                                         Li, Lj)
            rc = px2.residual_restrict_halo2d(_halo_parts2dj(e, mesh, 2, 1), r5,
                                              _gij0(mesh, Li, Lj, 2), h, n, Li // 2, Lj // 2)
            ec = coarse(rc)
            return px2.prolong_smooth_halo2d(_halo_parts2dj(ec, mesh, n_smooth, n_smooth + 1),
                                             _halo_parts2dj(e, mesh, H, H), r5, g, h, n_smooth,
                                             n, Li, Lj)

        if tier == "j-replicated":
            # The j-REPLICATED 1D tier: the local j extent is too narrow for
            # the 2D kernels' halos, so gather j to full width and run the
            # level on the i-sharded kernels (i stays sharded). Every rank
            # of an i row computes the same values and keeps its columns.
            r3 = _halo_parts_i(jrep(r, n), mesh, H, H)
            gi = mesh.ix * Li
            if from_zero:
                e_rep = px1.rb_smooth_from_zero_halo(r3, gi - H, h, n_smooth, n, Li)
            else:
                e_rep = px1.rb_smooth_halo(_halo_parts_i(jrep(e, n), mesh, H, H), r3, gi - H, h,
                                           n_smooth, n, Li)
            rc_rep = px1.residual_restrict_halo(_halo_parts_i(e_rep, mesh, 2, 1), r3, gi - 2, h,
                                                n, Li // 2)
            ec = coarse(jslice(rc_rep, plan.local_j(depth + 1)))
            e_rep = px1.prolong_smooth_halo(
                _halo_parts_i(jrep(ec, nc), mesh, n_smooth, n_smooth + 1),
                _halo_parts_i(e_rep, mesh, H, H), r3, gi - H, h, n_smooth, n, Li)
            return jslice(e_rep, Lj)

        # the plain local ops
        if from_zero:
            e = torch.zeros_like(r)
        e = rb_smooth_local2dp(e, r, h, n_smooth, n, mesh, True)
        ec = coarse(restrict_local2dp(residual_local2dp(e, r, h, n, mesh), n, mesh))
        e = prolong_correct_local2dp(ec, e, nc, mesh)
        return rb_smooth_local2dp(e, r, h, n_smooth, n, mesh, False)

    top = hier32.num_levels - 1

    def cycle(e, r, from_zero=False):
        return descend(e, r, top, 0, from_zero=from_zero)

    return cycle


def tier_map(hier: Hierarchy, cfg: CycleConfig, plan: ShardPlan2D,
             jnp_level_max: int = 0) -> dict:
    """{level size: tier} of _build_local_cycle2d under this plan: the
    sharded levels' _tier, and "replicated" (the gathered single-device
    cycle, K1-K4) from depth n_sharded down."""
    top = hier.num_levels - 1
    out = {n: _tier(n, plan.local_i(d), plan.local_j(d), 2 * cfg.n_smooth, jnp_level_max)
           for d, n in enumerate(hier.sizes[top - plan.n_sharded + 1:][::-1])}
    out[hier.sizes[top - plan.n_sharded]] = "replicated"
    return out


def make_sharded2d_padded_cycle(hier: Hierarchy, cfg: CycleConfig, mesh: Mesh2D,
                                plan: Optional[ShardPlan2D] = None, jnp_level_max: int = 0,
                                block_i: int = 8) -> Tuple[Callable, ShardPlan2D]:
    """(step, plan): step(e_local, r_local) -> e_local', the rank's part
    of one correction V-cycle on (i, j)-sharded f32 blocks (pass e = zeros
    for a from-zero cycle; e is updated in place at a kernel level).
    ``jnp_level_max``: levels of at most that size run the plain ops (0,
    the default, runs the kernels wherever the geometry lets them; 10**9
    runs no kernel). ``block_i`` is accepted and ignored (a VMEM tile)."""
    del block_i
    plan = _plan_padded(hier, mesh, plan)
    hier32 = dataclasses.replace(hier, dtype=torch.float32)
    cycle_local = _build_local_cycle2d(hier32, cfg, plan, mesh, jnp_level_max)

    def step(e, r):
        return cycle_local(e, r, from_zero=False)

    return step, plan


def _plan_padded(hier, mesh, plan):
    if plan is None:
        return plan_sharding_2d_padded(hier, mesh.nx, mesh.ny)
    return _plan(hier, mesh, plan)


def make_sharded2d_padded_df_solver(
    hier: Hierarchy,
    cfg: CycleConfig = CycleConfig(),
    mesh: Optional[Mesh2D] = None,
    plan: Optional[ShardPlan2D] = None,
    rel_tol: float = 1e-8,
    max_cycles: int = 40,
    inner_cycles: int = 4,
    jnp_level_max: int = 0,
    block_i: int = 8,
    trim: bool = False,
    init_norm: float = None,
) -> Tuple[Callable, ShardPlan2D]:
    """(run, plan): run(u_hi, u_lo, f_hi, f_lo) -> (u_hi, u_lo, norm,
    n_outer) on this rank's blocks, the 2D-mesh twin of
    sharded_padded.make_sharded_df_solver: a double-float solution, the EFT
    residual + partial norm kernel (K41, the partials all-reduced over
    both mesh axes), ``inner_cycles`` V-cycles per outer defect step.

    Host loop with one scalar readback per outer step and the JAX stop
    rule: ``init`` (``init_norm``, else ||f_hi|| over the whole cube) and
    ``tol = f32(rel_tol) * init`` in f32, ``while nrm > tol and it <
    max_cycles``. ``trim`` (the k-trim layout) is not ported; ``block_i``
    is accepted and ignored."""
    del block_i
    if trim:
        raise NotImplementedError("the k-trim layout is not ported (full layout only)")
    if mesh is None:
        raise ValueError("mesh is required")
    plan = _plan_padded(hier, mesh, plan)
    hier32 = dataclasses.replace(hier, dtype=torch.float32)
    inner = _build_local_cycle2d(hier32, cfg, plan, mesh, jnp_level_max)
    n = hier.finest_n
    h = hier.spacing(hier.num_levels - 1)
    Li0, Lj0 = plan.local_i(0), plan.local_j(0)

    def residual_norm(u_hi, u_lo, f_hi, f_lo):
        if n > jnp_level_max:  # K41 needs only one-deep halos
            uh, ul = (_halo_parts2dj(a, mesh, 1, 1) for a in (u_hi, u_lo))
            # f's halos are not read: only its owned points
            r, part = px2.residual_df_norm_halo2d(uh, ul, (f_hi, None, None, None, None),
                                                  (f_lo, None, None, None, None),
                                                  _gij0(mesh, Li0, Lj0, 1), h, n, Li0, Lj0)
        else:
            r, part = _residual_df_norm_local2dp_plain(u_hi, u_lo, f_hi, f_lo, h, n, mesh)
        return r, torch.sqrt(_all_reduce_sum(mesh, part))

    def run(u_hi, u_lo, f_hi, f_lo):
        if init_norm is not None:
            init = np.float32(init_norm)
        else:
            init = np.float32(torch.sqrt(_all_reduce_sum(mesh, torch.sum(f_hi * f_hi))).item())
        tol = float(np.float32(rel_tol) * init)
        r, nrm = residual_norm(u_hi, u_lo, f_hi, f_lo)
        it = 0
        while it < max_cycles and nrm.item() > tol:
            e = inner(None, r, from_zero=True)
            for _ in range(inner_cycles - 1):
                e = inner(e, r)
            u_hi, u_lo = pk.df_add(u_hi, u_lo, e)
            r, nrm = residual_norm(u_hi, u_lo, f_hi, f_lo)
            it += 1
        return u_hi, u_lo, nrm, it

    return run, plan


# ------------------------------------------------------------------ setup


def setup_df_problem_sharded2d_padded(problem, hier: Hierarchy, mesh: Mesh2D,
                                      plan: ShardPlan2D, trim: bool = False):
    """This rank's (u_hi, u_lo, f_hi, f_lo) blocks: the double-float setup
    of cycles_padded.setup_df_problem, (i, j)-padded to (nx Li, ny Lj), on
    mesh.device. ``trim`` (the k-trim layout) is not ported."""
    if trim:
        raise NotImplementedError("the k-trim layout is not ported (full layout only)")
    u64, f64 = setup_problem(problem, hier, mesh.device)
    Li, Lj = plan.local_i(0), plan.local_j(0)
    return tuple(_rank_block(x, mesh, Li, Lj) for x64 in (u64, f64) for x in pk.df_split(x64))


def unpad_solution2d(u_hi, u_lo, hier: Hierarchy):
    """Gathered (nx Li, ny Lj, n) df pair (``sharded2d.gather_global2d``)
    -> the (n, n, n) f64 cube."""
    n = hier.finest_n
    return pk.df_to_f64(u_hi, u_lo)[:n, :n]


def untrim_solution2d(u_hi, u_lo, problem, hier: Hierarchy):
    """The k-trim layout is not ported (full layout only)."""
    raise NotImplementedError("the k-trim layout is not ported (full layout only)")
