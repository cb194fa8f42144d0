"""Distributed performance path: the double-float solve on i-sharded
blocks, every hot stage on the sharded kernels (counterpart of
``multigrid_parallel_tpu.parallel.sharded_padded``).

The plain sharded cycles (parallel/sharded.py) use masked-roll tensor
ops with a one-plane exchange per half-sweep. Here every stage of the
correction V-cycle at a sharded level runs the sharded kernels of
``ops.pallas_sharded``: one halo exchange feeds a whole stage (all
half-sweeps of a smoothing stage; residual + restriction; prolongation +
correction + post-smoothing), the reference's worksharing inside the
kernels (mg_3d.h:658, 681, 807). The coarse levels gather to replicated
and reuse the single-device cycle (``cycles_padded``, its kernels K1-K4)
on every rank, the analogue of the reference's ``omp single`` coarse
section (mg_3d.h:1262-1277).

The JAX module's name is kept; the port's fields have no lane padding:
a level with n valid planes is an (n_dev * L, n, n) global array, of
which each rank holds its (L, n, n) block; pad planes (global i >= n)
are zero and masked everywhere. L is a multiple of 2**n_sharded
(ShardPlan), so rank offsets stay even across sharded coarsenings.

Halos: the kernels read (local, lh, rh) segments (the JAX halo tier,
``_halo_parts``): only the edge planes travel, the body is read in place.
The JAX package's ext tier, which materialises an (L + 2 halo) copy, is
the same kernel here (``pallas_sharded.*_ext``) and no stage needs it.

The whole solve (make_sharded_df_solver) is the distributed twin
of cycles_padded.make_on_device_df_solver: a double-float solution, the
EFT outer residual (K32 + all_reduce), ``inner_cycles`` V-cycles per
defect step, and a host loop with one scalar readback per outer step
(the norm is all-reduced, so every rank takes the same branch).
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
from multigrid_parallel_tpu_torch.ops import pallas_sharded as px
from multigrid_parallel_tpu_torch.parallel.sharded import (
    Mesh,
    ShardPlan,
    _all_gather,
    _all_reduce_sum,
    _exchange,
    _rank_slice,
    plan_sharding,
    prolong_correct_local,
    rb_smooth_local,
    residual_df_local,
    residual_local,
    restrict_local,
)


def _gi0(mesh: Mesh, L: int, halo: int) -> int:
    """Global plane index of this rank's first halo row."""
    return mesh.rank * L - halo


def _halo_parts(x, mesh: Mesh, kl: int, kr: int, tail_local: int = 0):
    """(x, lh, rhc) for the sharded kernels: ONLY the kl / kr edge planes
    travel; the body is read in place. ``tail_local`` prepends that many
    local tail planes to the right halo (the JAX composite layout); the
    kernels read its length off the shape, and the cycle passes 0."""
    lh, rh = _exchange(mesh, x[-kl:], x[:kr])
    if tail_local:
        rh = torch.cat([x[x.shape[0] - tail_local:], rh])
    return (x, lh, rh)


# ------------------------------- plain local ops (the small-level path)
# Levels where the kernels' halos do not fit run masked-roll tensor ops,
# as the JAX package's jnp fallback does; masks use GLOBAL indices. The
# JAX module's four local ops here differ from parallel.sharded's only by
# the TPU's lane padding and k-trim widths; without them they are the
# same functions.

rb_smooth_local_padded = rb_smooth_local
residual_local_padded = residual_local
restrict_local_padded = restrict_local
prolong_correct_local_padded = prolong_correct_local


def _residual_df_norm_local_plain(u_hi, u_lo, f_hi, f_lo, h, n, mesh: Mesh):
    """The plain tier's EFT residual + this rank's partial norm (the JAX
    package's ``_residual_df_norm_local_jnp``)."""
    r = residual_df_local(u_hi, u_lo, f_hi, f_lo, h, n, mesh)
    r64 = r.to(torch.float64)
    return r, torch.sum(r64 * r64).to(r.dtype)


def _make_residual_norm(mesh: Mesh, n: int, h: float, L0: int, jnp_level_max: int):
    """residual_norm(u_hi, u_lo, f_hi, f_lo) -> (r, ||r||) of the finest
    level: K32 on 1-plane halos of u (the plain tier at or below
    jnp_level_max), its partial ||r||^2 all-reduced over the ranks."""

    def residual_norm(u_hi, u_lo, f_hi, f_lo):
        if n > jnp_level_max:
            uh, ul = (_halo_parts(a, mesh, 1, 1) for a in (u_hi, u_lo))
            # f's halos are not read: only its owned rows
            r, part = px.residual_df_norm_halo(uh, ul, (f_hi, None, None), (f_lo, None, None),
                                               _gi0(mesh, L0, 1), h, n, L0)
        else:
            r, part = _residual_df_norm_local_plain(u_hi, u_lo, f_hi, f_lo, h, n, mesh)
        return r, torch.sqrt(_all_reduce_sum(mesh, part))

    return residual_norm


# ----------------------------------------------------- cycle + solver


def _use_pallas(n: int, L: int, H: int, jnp_level_max: int) -> bool:
    """The kernels at a sharded level need the level above jnp_level_max
    AND the halo of a stage within one neighbour's block (L >= H; the
    prolongation's coarse halo n_iter + 1 needs L >= H + 2)."""
    return n > jnp_level_max and L >= max(H + 2, 4)


def _build_local_cycle(hier32: Hierarchy, cfg: CycleConfig, plan: ShardPlan, mesh: Mesh,
                       jnp_level_max: int):
    """Returns cycle_local(e, r, from_zero) -> e' on this rank's blocks
    (finest level of hier32), with ``cycle_local.fmg(r)``."""
    n_smooth = cfg.n_smooth
    H = 2 * n_smooth
    rep_level = hier32.num_levels - 1 - plan.n_sharded
    sub = dataclasses.replace(hier32, num_levels=rep_level + 1)
    # the replicated tail: the single-device cycle; a one-level sub is the
    # bare coarse LU (cycles_padded's descend at level 0)
    rep_cycle = cp.make_padded_correction_cycle(sub, cfg, mesh.device)
    n_rep = hier32.sizes[rep_level]
    assert plan.padded_planes(plan.n_sharded) >= n_rep, (plan, n_rep)

    def descend(e, r, level, depth, from_zero=False):
        n = hier32.sizes[level]
        if depth == plan.n_sharded:
            # Gather to replicated; run the single-device cycle (the same
            # kernels on every rank, deterministic, so every rank computes
            # the same e); take this rank's planes. A revisit (not
            # from_zero) gathers e too.
            r_rep = _all_gather(mesh, r)[:n]
            if from_zero:
                e_rep = rep_cycle(None, r_rep, from_zero=True)
            else:
                e_rep = rep_cycle(_all_gather(mesh, e)[:n], r_rep)
            return _rank_slice(e_rep, mesh, plan.local_planes(depth))

        L = plan.local_planes(depth)
        h = hier32.spacing(level)
        pal = _use_pallas(n, L, H, jnp_level_max)
        nc = hier32.sizes[level - 1]
        # r's halo planes travel once per level visit: the smoothing
        # stages and the restriction read them from the same segments
        r3 = _halo_parts(r, mesh, H, H) if pal else None

        def smooth_stage(e, red_first, from_zero=False):
            # The JAX stage has a ladder of VMEM-driven tiers: the full
            # fusion window, or n_it single-iteration passes where only a
            # small block fits VMEM (sharded_padded.py:319-335), or the
            # ext copy. They run the same half-sweep sequence, and VMEM
            # planning has no counterpart on the card, so here a level
            # runs the kernels (all 2 n_smooth half-sweeps on one H-plane
            # halo) or the plain ops.
            if pal:
                g = _gi0(mesh, L, H)
                if from_zero:
                    return px.rb_smooth_from_zero_halo(r3, g, h, n_smooth, n, L,
                                                       red_first=red_first)
                return px.rb_smooth_halo(_halo_parts(e, mesh, H, H), r3, g, h, n_smooth, n,
                                         L, red_first=red_first)
            if from_zero:
                e = torch.zeros_like(r)
            return rb_smooth_local_padded(e, r, h, n_smooth, n, mesh, red_first)

        # --- pre-smooth (red-first)
        e = smooth_stage(e, red_first=True, from_zero=from_zero)

        # --- residual + restrict
        if pal:
            rc = px.residual_restrict_halo(_halo_parts(e, mesh, 2, 1), r3, _gi0(mesh, L, 2),
                                           h, n, L // 2)
        else:
            rc = restrict_local_padded(residual_local_padded(e, r, h, n, mesh), n, mesh)

        ec = descend(None, rc, level - 1, depth + 1, from_zero=True)
        if level - 1 > 0 and nc >= cfg.gamma_min_n:
            # gamma > 1 revisits the coarse correction (W-cycle), exactly
            # as cycles._descend / cycles_padded._make_descend do. The
            # replicated sub-cycle honors gamma internally.
            for _ in range(cfg.gamma - 1):
                ec = descend(ec, rc, level - 1, depth + 1)

        # --- prolong + correct + post-smooth (black-first). The JAX
        # package splits this stage where VMEM holds only a tiny block
        # (bi_p < 4, sharded_padded.py:401-431: one fused iteration, then
        # n_smooth - 1 single-iteration smoother passes): the same
        # half-sweep sequence, for VMEM only, so it is not carried over.
        if pal:
            return px.prolong_smooth_halo(
                _halo_parts(ec, mesh, n_smooth, n_smooth + 1), _halo_parts(e, mesh, H, H), r3,
                _gi0(mesh, L, H), h, n_smooth, n, L)
        e = prolong_correct_local_padded(ec, e, nc, mesh)
        return smooth_stage(e, red_first=False)

    top = hier32.num_levels - 1

    def cycle(e, r, from_zero=False):
        return descend(e, r, top, 0, from_zero=from_zero)

    rep_fmg = []

    def fmg(r):
        """Full-multigrid bootstrap on the correction equation A e = r,
        distributed: restrict the defect down the sharded ladder, run the
        replicated single-device FMG bootstrap on the gathered coarse
        defect, then per sharded level prolongate up and run one
        distributed V-cycle — the sharded twin of
        cycles_padded.make_padded_fmg_bootstrap (the reference's main program:
        mg_dirichlet_analytic.c:771-806)."""
        if not rep_fmg:
            rep_fmg.append(cp.make_padded_fmg_bootstrap(sub, cfg, mesh.device))
        rs = [r]  # depth 0 (finest) first
        for depth in range(plan.n_sharded):
            rs.append(restrict_local_padded(rs[-1], hier32.sizes[top - depth], mesh))
        r_rep = _all_gather(mesh, rs[-1])[:n_rep]
        e = _rank_slice(rep_fmg[0](r_rep), mesh, plan.local_planes(plan.n_sharded))
        for depth in range(plan.n_sharded - 1, -1, -1):
            lvl = top - depth
            ef = prolong_correct_local_padded(e, torch.zeros_like(rs[depth]),
                                              hier32.sizes[lvl - 1], mesh)
            e = descend(ef, rs[depth], lvl, depth)
        return e

    cycle.fmg = fmg
    return cycle


def make_sharded_padded_cycle(hier: Hierarchy, cfg: CycleConfig, mesh: Mesh,
                              plan: Optional[ShardPlan] = None, jnp_level_max: int = 0,
                              block_i: int = 8) -> Tuple[Callable, ShardPlan]:
    """(step, plan): step(e_local, r_local) -> e_local', the rank's part
    of one correction V-cycle on i-sharded f32 blocks (pass e = zeros for
    a from-zero cycle; e is updated in place at a kernel level).
    ``jnp_level_max``: levels of at most that size run the plain ops (0,
    the default, runs the kernels wherever the geometry lets them;
    10**9 runs no kernel). ``block_i`` is accepted and ignored (a VMEM
    tile)."""
    del block_i
    if plan is None:
        plan = plan_sharding(hier, mesh.n_dev)
    hier32 = dataclasses.replace(hier, dtype=torch.float32)
    cycle_local = _build_local_cycle(hier32, cfg, plan, mesh, jnp_level_max)

    def step(e, r):
        return cycle_local(e, r, from_zero=False)

    return step, plan


def make_sharded_df_solver(
    hier: Hierarchy,
    cfg: CycleConfig = CycleConfig(),
    mesh: Optional[Mesh] = None,
    plan: Optional[ShardPlan] = None,
    rel_tol: float = 1e-8,
    max_cycles: int = 40,
    inner_cycles: int = 4,
    jnp_level_max: int = 0,
    block_i: int = 8,
    use_fmg: bool = False,
    trim: bool = False,
    init_norm: float = None,
) -> Tuple[Callable, ShardPlan]:
    """(run, plan): run(u_hi, u_lo, f_hi, f_lo) -> (u_hi, u_lo, norm,
    n_outer) on this rank's blocks, the distributed twin of
    cycles_padded.make_on_device_df_solver: a double-float solution, the
    EFT residual + partial norm kernel (K32, the partials all-reduced over
    the ranks), ``inner_cycles`` V-cycles per outer defect step. ``use_fmg``
    bootstraps with a distributed full-multigrid pass on the initial
    defect (not counted in n_outer).

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
    if plan is None:
        plan = plan_sharding(hier, mesh.n_dev)
    hier32 = dataclasses.replace(hier, dtype=torch.float32)
    inner = _build_local_cycle(hier32, cfg, plan, mesh, jnp_level_max)
    n = hier.finest_n
    h = hier.spacing(hier.num_levels - 1)
    L0 = plan.local_planes(0)

    residual_norm = _make_residual_norm(mesh, n, h, L0, jnp_level_max)

    def run(u_hi, u_lo, f_hi, f_lo):
        if init_norm is not None:
            init = np.float32(init_norm)
        else:
            init = np.float32(torch.sqrt(_all_reduce_sum(mesh, torch.sum(f_hi * f_hi))).item())
        tol = float(np.float32(rel_tol) * init)
        r, nrm = residual_norm(u_hi, u_lo, f_hi, f_lo)
        if use_fmg:
            u_hi, u_lo = pk.df_add(u_hi, u_lo, inner.fmg(r))
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


def setup_df_problem_sharded_padded(problem, hier: Hierarchy, mesh: Mesh, plan: ShardPlan,
                                    trim: bool = False):
    """This rank's (u_hi, u_lo, f_hi, f_lo) blocks: the double-float
    setup of cycles_padded.setup_df_problem, i-padded to n_dev * L, on
    mesh.device. ``trim`` (the k-trim layout) is not ported."""
    if trim:
        raise NotImplementedError("the k-trim layout is not ported (full layout only)")
    u64, f64 = setup_problem(problem, hier, mesh.device)
    L = plan.local_planes(0)
    return tuple(_rank_slice(x, mesh, L) for x64 in (u64, f64) for x in pk.df_split(x64))


def unpad_solution(u_hi, u_lo, hier: Hierarchy):
    """Gathered (n_dev * L, n, n) df pair (``sharded.gather_global``) ->
    the (n, n, n) f64 cube."""
    return pk.df_to_f64(u_hi, u_lo)[: hier.finest_n]
