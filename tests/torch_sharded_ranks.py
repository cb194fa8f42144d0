"""Torch-only helpers of the i-sharded port's tests: simulated ranks'
segments of a global field, and the SPMD functions that the gloo ranks of
``parallel.launch`` run (a spawned rank imports this module by name, so it
imports torch and the port, never jax).

A global field here is an (n_dev * L, n, n) array: the n valid planes,
then zero pad planes, of which rank r owns rows [r L, (r + 1) L).
"""

import numpy as np
import torch

import multigrid_parallel_tpu_torch as mg
from multigrid_parallel_tpu_torch.hierarchy import evaluate_on_grid
from multigrid_parallel_tpu_torch.ops import pallas3d as pk
from multigrid_parallel_tpu_torch.parallel import sharded as sh
from multigrid_parallel_tpu_torch.parallel import sharded_padded as spp

# ----------------------------------------------------- simulated ranks


def global_field(rng, n: int, rows: int, zero_boundary: bool = False) -> np.ndarray:
    """(rows, n, n) f32: a standard normal cube in the first n planes
    (its boundary zero if asked), zero pad planes after them."""
    x = np.zeros((rows, n, n), np.float32)
    cube = rng.standard_normal((n, n, n)).astype(np.float32)
    if zero_boundary:
        inner = np.zeros_like(cube)
        inner[1:-1, 1:-1, 1:-1] = cube[1:-1, 1:-1, 1:-1]
        cube = inner
    x[:n] = cube
    return x


def rank_parts(x: torch.Tensor, rank: int, L: int, kl: int, kr: int, tail: int = 0):
    """Rank ``rank``'s (local, lh, rhc) triple of the global field x, each
    its own copy: lh the left neighbour's last kl planes, rhc ``tail``
    local tail planes and then the right neighbour's first kr planes; a
    chain end receives zeros (the halo exchange's rule)."""
    n_dev = x.shape[0] // L
    m = x.shape[1:]
    body = x[rank * L:(rank + 1) * L].clone()
    lh = x[rank * L - kl:rank * L].clone() if rank > 0 else x.new_zeros((kl,) + m)
    rh = (x[(rank + 1) * L:(rank + 1) * L + kr].clone() if rank < n_dev - 1
          else x.new_zeros((kr,) + m))
    if tail:
        rh = torch.cat([body[L - tail:], rh])
    return body, lh, rh


def rank_ext(x: torch.Tensor, rank: int, L: int, k: int) -> torch.Tensor:
    """Rank ``rank``'s (L + 2k, n, n) ext copy of x."""
    body, lh, rh = rank_parts(x, rank, L, k, k)
    return torch.cat([lh, body, rh])


# --------------------------------------------------- SPMD rank functions


def _blocks(x_global: np.ndarray, mesh, L: int) -> torch.Tensor:
    return torch.from_numpy(x_global[mesh.rank * L:(mesh.rank + 1) * L].copy()).to(mesh.device)


def f64_cycles(mesh, n_cycles: int = 3):
    """The f64 sharded V-cycle (parallel.sharded.make_sharded_cycle) at
    17^3, n_cycles times: (norms, the gathered valid planes of u)."""
    hier = mg.Hierarchy(ndim=3, coarse_n=5, num_levels=3)
    step, plan = sh.make_sharded_cycle(hier, mg.CycleConfig(n_smooth=2), mesh)
    u, f = sh.setup_problem_sharded(mg.poisson_3d_quadratic(), hier, mesh, plan)
    norms = []
    for _ in range(n_cycles):
        u, nrm = step(u, f)
        norms.append(float(nrm))
    return norms, sh.unpad(sh.gather_global(u, mesh), hier)


def mixed_cycles(mesh, n_cycles: int = 2):
    """The f64-outer mixed sharded cycle (make_sharded_mixed_cycle) at
    17^3, n_cycles times: (norms, the gathered valid planes of u)."""
    hier = mg.Hierarchy(ndim=3, coarse_n=5, num_levels=3)
    step, plan = sh.make_sharded_mixed_cycle(hier, mg.CycleConfig(n_smooth=2), mesh)
    u, f = sh.setup_problem_sharded(mg.poisson_3d_quadratic(), hier, mesh, plan)
    norms = []
    for _ in range(n_cycles):
        u, nrm = step(u, f)
        norms.append(float(nrm))
    return norms, sh.unpad(sh.gather_global(u, mesh), hier)


def df_cycle_steps(mesh, inner_cycles: int, n: int = 17, max_steps: int = 25):
    """The sharded double-float cycle to 1e-8 of ||f_hi||: (steps, final
    norm, init, L2 error of the f64 solution against the analytic one)."""
    hier = mg.Hierarchy(ndim=3, coarse_n=5, num_levels={17: 3, 33: 4}[n])
    prob = mg.poisson_3d_quadratic()
    step, plan = sh.make_sharded_df_cycle(hier, mg.CycleConfig(n_smooth=2), mesh,
                                          inner_cycles=inner_cycles)
    u_hi, u_lo, f_hi, f_lo = sh.setup_df_problem_sharded(prob, hier, mesh, plan)
    init = float(torch.sqrt(sh._all_reduce_sum(mesh, torch.sum(f_hi.double() ** 2))))
    for it in range(max_steps):
        u_hi, u_lo, nrm = step(u_hi, u_lo, f_hi, f_lo)
        if float(nrm) <= 1e-8 * init:
            break
    u = spp.unpad_solution(sh.gather_global(u_hi, mesh), sh.gather_global(u_lo, mesh), hier)
    exact = evaluate_on_grid(prob.analytic, hier, hier.num_levels - 1, mesh.device)
    return it + 1, float(nrm), init, float(torch.sqrt(torch.sum((u - exact) ** 2)))


def padded_cycles(mesh, r_global: np.ndarray, L: int, configs, jnp_level_maxes):
    """make_sharded_padded_cycle at 33^3 from a zero correction on the
    global RHS r_global, for each (n_sharded, gamma, gamma_min_n) of
    configs and each jnp_level_max: {(config, jnp_level_max): (the
    gathered (n_dev * L, n, n) correction, this rank's calls of each
    sharded kernel wrapper)}. (LAUNCHES counts launches on the card only;
    on the CPU the calls are counted here.)"""
    import collections

    from multigrid_parallel_tpu_torch.ops import pallas_sharded as px

    calls = collections.Counter()

    def counted(name, fn):
        def wrapper(*args, **kwargs):
            calls[name] += 1
            return fn(*args, **kwargs)
        return wrapper

    for name in ("rb_smooth_halo", "rb_smooth_from_zero_halo", "residual_restrict_halo",
                 "prolong_smooth_halo"):
        setattr(px, name, counted(name, getattr(px, name)))
    hier = mg.Hierarchy(ndim=3, coarse_n=5, num_levels=4)
    r = _blocks(r_global, mesh, L)
    out = {}
    for n_sharded, gamma, gamma_min_n in configs:
        cfg = mg.CycleConfig(n_smooth=2, gamma=gamma, gamma_min_n=gamma_min_n)
        plan = sh.ShardPlan(n_dev=mesh.n_dev, axis="x", n_sharded=n_sharded, fine_local=L)
        for jl in jnp_level_maxes:
            step, _ = spp.make_sharded_padded_cycle(hier, cfg, mesh, plan, jnp_level_max=jl)
            calls.clear()
            e = step(torch.zeros_like(r), r)
            out[(n_sharded, gamma, gamma_min_n, jl)] = (sh.gather_global(e, mesh), dict(calls))
    return out


def df_solver(mesh, n: int, inner_cycles: int = 2, use_fmg: bool = False,
              jnp_level_max: int = 0, init_norm: float = None):
    """make_sharded_df_solver to 1e-8 (of ``init_norm``, else of ||f_hi||):
    (outer steps, final norm, ||f_hi||, L2 error against the analytic
    solution, the gathered f64 solution's valid planes, plan, this rank's
    kernel launches in the solve)."""
    from multigrid_parallel_tpu_torch.ops import pallas_sharded as px

    hier = mg.Hierarchy(ndim=3, coarse_n=5, num_levels={17: 3, 33: 4, 65: 5}[n])
    prob = mg.poisson_3d_quadratic()
    run, plan = spp.make_sharded_df_solver(hier, mg.CycleConfig(n_smooth=2), mesh,
                                           rel_tol=1e-8, inner_cycles=inner_cycles,
                                           use_fmg=use_fmg, jnp_level_max=jnp_level_max,
                                           init_norm=init_norm)
    st = spp.setup_df_problem_sharded_padded(prob, hier, mesh, plan)
    init = float(torch.sqrt(sh._all_reduce_sum(mesh, torch.sum(st[2] ** 2))))
    px.reset_launches()
    pk.reset_launches()
    u_hi, u_lo, nrm, steps = run(*st)
    launches = {**pk.LAUNCHES, **px.LAUNCHES}
    u = spp.unpad_solution(sh.gather_global(u_hi, mesh), sh.gather_global(u_lo, mesh), hier)
    exact = evaluate_on_grid(prob.analytic, hier, hier.num_levels - 1, mesh.device)
    err = float(torch.sqrt(torch.sum((u - exact) ** 2)))
    return steps, float(nrm), init, err, u, plan, launches


def solve_checks(mesh, r33: np.ndarray, L33: int, configs):
    """Every solve check of one world size, in one launch."""
    out = {"f64": f64_cycles(mesh), "df17": df_solver(mesh, 17)}
    if r33 is not None:
        out["mixed"] = mixed_cycles(mesh)
        out["df_cycle"] = {ic: df_cycle_steps(mesh, ic) for ic in (1, 2)}
        out["padded"] = padded_cycles(mesh, r33, L33, configs, (0, 10**9))
        out["df33"] = {fmg: df_solver(mesh, 33, use_fmg=fmg) for fmg in (False, True)}
    return out if mesh.rank == 0 else None


def never_returns(mesh):
    """A rank that hangs (the launcher's time limit must end it)."""
    import time

    time.sleep(3600)
