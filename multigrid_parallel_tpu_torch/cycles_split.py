"""The split-colour double-float solver: the finest level runs on
red / black pairs (``ops.pallas_split``, K7-K12) while every coarser level
runs the rect fused correction cycle of ``cycles_padded`` (counterpart of
``multigrid_parallel_tpu.cycles_split``).

The layout boundary is where the JAX package puts it: the fused residual
+ restriction (K9) writes the coarse RHS in the rect layout of the levels
below, and the fused prolongation + post-smoothing (K10) reads the rect
coarse correction, so the cycle never packs or unpacks a field. The outer
defect iteration also runs on pairs: df_add is per colour and the
compensated residual (K11, K12) uses the split neighbour addressing,
handing the V-cycle its RHS pair directly.

Not carried over, because it is TPU planning with the same half-sweep
sequence: the lane gate ``split_supported`` and the ``force`` flag (on the
TPU the pair pays only where it halves the 128-lane tiles, n >= 257; the
port has no lane padding, so a pair always holds the rect field's values
in two halves), ``split_plan`` and the ``*_block_i`` VMEM planners, the
split ladder (single-iteration passes where the full stage fits VMEM
only in small blocks) and ``jnp_level_max``.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from multigrid_parallel_tpu_torch import cycles_padded as cp
from multigrid_parallel_tpu_torch.cycles import CycleConfig, setup_problem
from multigrid_parallel_tpu_torch.hierarchy import Hierarchy, evaluate_on_grid
from multigrid_parallel_tpu_torch.ops import pallas3d as pk
from multigrid_parallel_tpu_torch.ops import pallas_split as ps


def split_available(hier: Hierarchy) -> bool:
    """True when the finest level has a coarser one, which the split
    cycle's restriction and prolongation need. The JAX package also asks
    that the pair halve the TPU's lane tiles and that every kernel fit
    VMEM; neither has a counterpart here (module docstring)."""
    return hier.ndim == 3 and hier.num_levels >= 2


def make_split_df_solver(
    hier: Hierarchy,
    cfg: CycleConfig = CycleConfig(),
    rel_tol: float = 1e-8,
    max_cycles: int = 40,
    inner_cycles: int = 4,
    init_norm: float = None,
    device="cuda",
):
    """run(u_hr, u_hb, u_lr, u_lb, f_hr, f_hb, f_lr, f_lb) ->
    (u_hr', u_hb', u_lr', u_lb', norm, n_outer): the split-colour twin of
    ``cycles_padded.make_on_device_df_solver``. Inputs come from
    ``setup_split_df_problem``. ``init_norm`` is REQUIRED: the reference's
    whole-cube ||f|| (``cycles_padded.ref_init_norm``), which the folded,
    split f does not carry.

    Each outer step runs ``inner_cycles`` f32 correction V-cycles on the
    defect pair: K8 / K7 pre-smoothing, K9 to the rect coarse RHS, the
    rect fused cycle on the (levels - 1) sub-hierarchy (revisited
    ``cfg.gamma - 1`` times when the coarse size is at least
    ``cfg.gamma_min_n``), K10; then K11. The initial residual is K12's.
    Host loop with one scalar readback per outer step and the JAX stop
    rule: ``init`` and ``tol = f32(rel_tol) * init`` in f32, the initial
    residual before the loop, ``while nrm > tol and it < max_cycles``.
    """
    if init_norm is None:
        raise ValueError("the split solver needs the reference-convention init_norm "
                         "(cycles_padded.ref_init_norm(problem, hier))")
    if not split_available(hier):
        raise ValueError(f"the split tier needs a 3D hierarchy of >= 2 levels, got {hier}")
    sub = dataclasses.replace(hier, dtype=torch.float32, num_levels=hier.num_levels - 1)
    sub_cycle = cp.make_padded_correction_cycle(sub, cfg, device, fused=True)
    h = hier.spacing(hier.num_levels - 1)
    ns = cfg.n_smooth
    revisits = cfg.gamma - 1 if sub.finest_n >= cfg.gamma_min_n else 0

    def cycle(e2, r2):
        """One V-cycle on the correction pair; e2=None is a zero initial
        pair. A given e2 is left as it is (K7 returns a fresh pair)."""
        rr, rb = r2
        if e2 is None:
            er, eb = ps.rb_smooth_split_from_zero(rr, rb, h, ns, red_first=True)
        else:
            er, eb = ps.rb_smooth_split(*e2, rr, rb, h, ns, red_first=True)
        rc = ps.residual_restrict_split(er, eb, rr, rb, h)
        ec = sub_cycle(None, rc, from_zero=True)
        for _ in range(revisits):
            ec = sub_cycle(ec, rc)
        return ps.prolong_smooth_split(ec, er, eb, rr, rb, h, ns)

    def run(u_hr, u_hb, u_lr, u_lb, f_hr, f_hb, f_lr, f_lb):
        init = np.float32(init_norm)
        tol = float(np.float32(rel_tol) * init)
        u4, f4 = (u_hr, u_hb, u_lr, u_lb), (f_hr, f_hb, f_lr, f_lb)
        r_r, r_b, nrm2 = ps.residual_df_norm_split(*u4, *f4, h)
        nrm = torch.sqrt(nrm2)
        it = 0
        while it < max_cycles and nrm.item() > tol:
            e2 = cycle(None, (r_r, r_b))
            for _ in range(inner_cycles - 1):
                e2 = cycle(e2, (r_r, r_b))
            *u4, r_r, r_b, nrm2 = ps.df_step_split(*u4, *e2, *f4, h)
            nrm = torch.sqrt(nrm2)
            it += 1
        return (*u4, nrm, it)

    return run


def setup_split_df_problem(problem, hier: Hierarchy, device="cuda"):
    """(u_hr, u_hb, u_lr, u_lb, f_hr, f_hb, f_lr, f_lb): the double-float
    setup of ``cycles_padded.setup_df_problem`` with the k-face Dirichlet
    values folded into the RHS in ``hier.dtype`` (f64) before the split,
    as the JAX k-trim setup does (the standard boundary elimination,
    f[1:-1, 1:-1, 1] -= u[1:-1, 1:-1, 0] / h^2 and f[1:-1, 1:-1, n-2] -=
    u[1:-1, 1:-1, n-1] / h^2), then packed into pairs. The residuals and
    the converged interior are those of the full layout; recover the cube
    with ``unsplit_solution``."""
    u64, f64 = setup_problem(problem, hier, device)
    n = hier.finest_n
    h = hier.spacing(hier.num_levels - 1)
    inv_h2 = 1.0 / (h * h)
    f64 = f64.clone()
    f64[1:-1, 1:-1, 1] += -inv_h2 * u64[1:-1, 1:-1, 0]
    f64[1:-1, 1:-1, n - 2] += -inv_h2 * u64[1:-1, 1:-1, n - 1]
    u_hi, u_lo = pk.df_split(u64)
    f_hi, f_lo = pk.df_split(f64)
    return tuple(t for x in (u_hi, u_lo, f_hi, f_lo) for t in ps.pack_split(x))


def unsplit_solution(u_hr, u_hb, u_lr, u_lb, problem, hier: Hierarchy):
    """Split double-float solution -> the full (n, n, n) f64 cube with
    the k-face Dirichlet values re-attached from ``problem.bc``
    (the JAX ``cycles_padded.untrim_solution``)."""
    u = pk.df_to_f64(ps.unpack_split(u_hr, u_hb), ps.unpack_split(u_lr, u_lb))
    bc = evaluate_on_grid(problem.bc, hier, hier.num_levels - 1, u.device)
    u[:, :, 0] = bc[:, :, 0]
    u[:, :, -1] = bc[:, :, -1]
    return u
