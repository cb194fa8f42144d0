"""Torch-only helpers of the i-sharded port's tests: simulated ranks'
segments of a global field, and the SPMD functions that the gloo ranks of
``parallel.launch`` run (a spawned rank imports this module by name, so it
imports torch and the port, never jax).

A global field here is an (n_dev * L, n, n) array: the n valid planes,
then zero pad planes, of which rank r owns rows [r L, (r + 1) L). The
electrospray checks take the problem's own cube (its length, its
patches) at each size.
"""

import collections
import contextlib

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


@contextlib.contextmanager
def _counted_calls(module, names):
    """Count this rank's calls of ``module``'s functions ``names`` inside
    the block (LAUNCHES counts launches on the card only)."""
    calls = collections.Counter()
    saved = {name: getattr(module, name) for name in names}

    def counted(name, fn):
        def wrapper(*args, **kwargs):
            calls[name] += 1
            return fn(*args, **kwargs)
        return wrapper

    for name, fn in saved.items():
        setattr(module, name, counted(name, fn))
    try:
        yield calls
    finally:
        for name, fn in saved.items():
            setattr(module, name, fn)


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
    from multigrid_parallel_tpu_torch.ops import pallas_sharded as px

    names = ("rb_smooth_halo", "rb_smooth_from_zero_halo", "residual_restrict_halo",
             "prolong_smooth_halo")
    hier = mg.Hierarchy(ndim=3, coarse_n=5, num_levels=4)
    r = _blocks(r_global, mesh, L)
    out = {}
    for n_sharded, gamma, gamma_min_n in configs:
        cfg = mg.CycleConfig(n_smooth=2, gamma=gamma, gamma_min_n=gamma_min_n)
        plan = sh.ShardPlan(n_dev=mesh.n_dev, axis="x", n_sharded=n_sharded, fine_local=L)
        for jl in jnp_level_maxes:
            step, _ = spp.make_sharded_padded_cycle(hier, cfg, mesh, plan, jnp_level_max=jl)
            with _counted_calls(px, names) as calls:
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


# ------------------------------------------ the sharded electrospray solve


def _es_solver(mesh, gamma=2, gamma_min_n=0, band_width=0, band_iters=0):
    from multigrid_parallel_tpu_torch.mixed_bc import MixedBCSolver

    es = mg.electrospray_problem()
    hier = mg.Hierarchy(ndim=3, coarse_n=5, num_levels=4, length=es.length)  # 33^3
    return MixedBCSolver(es, hier, n_smooth=2, gamma=gamma, gamma_min_n=gamma_min_n,
                         boundary_band_width=band_width, boundary_band_iters=band_iters,
                         device=mesh.device)


def mixed_bcs(mesh, u_global: np.ndarray, n: int, L: int):
    """sharded_mixed.apply_bcs_local (zero pin; the electrospray patch
    values) and sharded_mixed_padded.apply_bcs_local_padded on this rank's
    block of u_global: {label: the gathered result} on rank 0."""
    from multigrid_parallel_tpu_torch.ops import pallas_mixed as pm
    from multigrid_parallel_tpu_torch.parallel import sharded_mixed as sm
    from multigrid_parallel_tpu_torch.parallel import sharded_mixed_padded as smp

    es = mg.electrospray_problem()
    pin = pm.dirichlet_pin_planes(es, n, mesh.device)
    vals = es.boundary_masks(n)[1]
    vals = torch.from_numpy(np.stack([vals[0], vals[n - 1]])).to(mesh.device, torch.float32)
    u = _blocks(u_global, mesh, L)
    zero = torch.zeros_like(pin[0])
    out = {"zero": sm.apply_bcs_local(u, n, mesh, zero, zero),
           "patches": sm.apply_bcs_local(u, n, mesh, pin[0], pin[1], vals[0], vals[1]),
           "padded": smp.apply_bcs_local_padded(u, n, mesh, pin, vals)}
    out = {k: sh.gather_global(v, mesh) for k, v in out.items()}
    return out if mesh.rank == 0 else None


def mixed_bc_cycles(mesh, gamma: int, gamma_min_n: int, band_width: int, band_iters: int,
                    n_cycles: int = 3):
    """The f64 sharded mixed-BC cycle (sharded_mixed.make_sharded_mixed_bc_cycle)
    at 33^3, n_cycles times: (norms, the gathered valid planes of u)."""
    from multigrid_parallel_tpu_torch.parallel import sharded_mixed as sm

    solver = _es_solver(mesh, gamma, gamma_min_n, band_width, band_iters)
    step, plan = sm.make_sharded_mixed_bc_cycle(solver, mesh)
    u, f = sm.setup_mixed_problem_sharded(solver, mesh, plan)
    norms = []
    for _ in range(n_cycles):
        u, nrm = step(u, f)
        norms.append(float(nrm))
    return norms, sh.gather_global(u, mesh)[:solver.hier.finest_n]


def mixed_df_solver(mesh, fine_local: int, n_sharded: int, jnp_level_max: int):
    """make_sharded_mixed_padded_df_solver at 33^3 (W-cycles, two inner
    cycles, to 1e-6 of the initial residual) under the plan (the default
    plan where fine_local is 0): (the gathered f64 solution, final norm,
    outer steps, plan, this rank's calls of the sharded kernel wrappers)."""
    from multigrid_parallel_tpu_torch.ops import pallas_mixed as pm
    from multigrid_parallel_tpu_torch.ops import pallas_sharded as px
    from multigrid_parallel_tpu_torch.parallel import sharded_mixed_padded as smp

    solver = _es_solver(mesh)
    plan = (sh.ShardPlan(n_dev=mesh.n_dev, axis="x", n_sharded=n_sharded, fine_local=fine_local)
            if fine_local else None)
    run, plan = smp.make_sharded_mixed_padded_df_solver(solver, mesh, plan, rel_tol=1e-6,
                                                        inner_cycles=2,
                                                        jnp_level_max=jnp_level_max)
    state = smp.setup_mixed_df_problem_sharded(solver, mesh, plan)
    with _counted_calls(pm, ("mixed_rb_smooth_halo", "mixed_rb_smooth_from_zero_halo",
                             "mixed_prolong_smooth_halo")) as calls, \
            _counted_calls(px, ("residual_restrict_halo", "residual_df_norm_halo")) as calls_d:
        u_hi, u_lo, nrm, steps = run(*state)
    u = smp.unpack_mixed_solution_sharded(sh.gather_global(u_hi, mesh),
                                          sh.gather_global(u_lo, mesh), solver.hier)
    return u, float(nrm), steps, plan, {**calls, **calls_d}


def mixed_solve_checks(mesh, cycle_configs, solver_configs):
    """Every electrospray check of one world size, in one launch: the f64
    cycles of each (gamma, gamma_min_n, band width, band iterations), the solver under each
    (fine_local, n_sharded, jnp_level_max), and this rank's blocks of the
    double-float setup (gathered)."""
    from multigrid_parallel_tpu_torch.parallel import sharded_mixed_padded as smp

    out = {"cycles": {cfg: mixed_bc_cycles(mesh, *cfg) for cfg in cycle_configs},
           "solver": {cfg: mixed_df_solver(mesh, *cfg) for cfg in solver_configs}}
    solver = _es_solver(mesh)
    plan = sh.plan_sharding(solver.hier, mesh.n_dev)
    out["setup"] = [sh.gather_global(x, mesh)
                    for x in smp.setup_mixed_df_problem_sharded(solver, mesh, plan)]
    return out if mesh.rank == 0 else None


# ------------------------------------------ the (i, j)-sharded solve


def rank_ext2d(x: torch.Tensor, ix: int, iy: int, Li: int, Lj: int, kl: int, kr: int,
               hjl: int, hjr: int) -> torch.Tensor:
    """Simulated rank (ix, iy)'s own (kl + Li + kr, hjl + Lj + hjr, m) copy
    of the global field x (nx Li, ny Lj, m) around its block: the halo
    exchanges' values, corners included, and zeros past the array's edges
    (the chain ends)."""
    rows, cols, m = x.shape
    g = x.new_zeros((rows + kl + kr, cols + hjl + hjr, m))
    g[kl:kl + rows, hjl:hjl + cols] = x
    return g[ix * Li:ix * Li + kl + Li + kr, iy * Lj:iy * Lj + hjl + Lj + hjr].clone()


def rank_parts2d(x, ix, iy, Li, Lj, kl, kr, hjl=None, hjr=None, tail: int = 0):
    """Rank (ix, iy)'s five parts (body, jl, jr, lh, rhc) of x, each its own
    copy (the port's _halo_parts2dj layout; the j halo defaults to the i
    halo); ``tail`` j-extended local tail rows start rhc."""
    hjl, hjr = kl if hjl is None else hjl, kr if hjr is None else hjr
    e = rank_ext2d(x, ix, iy, Li, Lj, kl, kr, hjl, hjr)
    mid = e[kl:kl + Li]
    rh = e[kl + Li:]
    if tail:
        rh = torch.cat([mid[Li - tail:], rh])
    return (mid[:, hjl:hjl + Lj].clone(), mid[:, :hjl].clone(), mid[:, hjl + Lj:].clone(),
            e[:kl].clone(), rh.clone())


def rank_triple2d(x, ix, iy, Li, Lj, kl, kr, hj, tail: int = 0):
    """Rank (ix, iy)'s (B, lh, rhc) of x: B its j-extended block (an hj
    column halo), lh / rhc j-extended edge rows (the JAX _halo_parts2d
    layout)."""
    e = rank_ext2d(x, ix, iy, Li, Lj, kl, kr, hj, hj)
    b, rh = e[kl:kl + Li], e[kl + Li:]
    if tail:
        rh = torch.cat([b[Li - tail:], rh])
    return b.clone(), e[:kl].clone(), rh.clone()


_PX2_NAMES = ("rb_smooth_halo2d", "rb_smooth_from_zero_halo2d", "residual_restrict_halo2d",
              "prolong_smooth_halo2d", "residual_df_norm_halo2d")
_PX1_NAMES = ("rb_smooth_halo", "rb_smooth_from_zero_halo", "residual_restrict_halo",
              "prolong_smooth_halo")


def f64_cycles2d(mesh2, n_cycles: int = 3):
    """The f64 (i, j)-sharded V-cycle (sharded2d.make_sharded2d_cycle) at
    17^3, n_cycles times: (norms, the gathered valid points of u, plan)."""
    from multigrid_parallel_tpu_torch.parallel import sharded2d as s2

    hier = mg.Hierarchy(ndim=3, coarse_n=5, num_levels=3)
    step, plan = s2.make_sharded2d_cycle(hier, mg.CycleConfig(n_smooth=2), mesh2)
    u, f = s2.setup_problem_sharded2d(mg.poisson_3d_quadratic(), hier, mesh2, plan)
    norms = []
    for _ in range(n_cycles):
        u, nrm = step(u, f)
        norms.append(float(nrm))
    return norms, s2.unpad2d(s2.gather_global2d(u, mesh2), hier), plan


def df_solver2d(mesh2, inner_cycles: int = 2):
    """sharded2d.make_sharded2d_df_solver at 17^3 to 1e-8: (outer steps,
    final norm, the gathered f64 solution's valid points)."""
    from multigrid_parallel_tpu_torch.parallel import sharded2d as s2

    hier = mg.Hierarchy(ndim=3, coarse_n=5, num_levels=3)
    run, plan = s2.make_sharded2d_df_solver(hier, mg.CycleConfig(n_smooth=2), mesh2,
                                            rel_tol=1e-8, inner_cycles=inner_cycles)
    u_hi, u_lo, nrm, steps = run(*s2.setup_df_problem_sharded2d(mg.poisson_3d_quadratic(),
                                                                 hier, mesh2, plan))
    u = pk.df_to_f64(s2.gather_global2d(u_hi, mesh2), s2.gather_global2d(u_lo, mesh2))
    return steps, float(nrm), s2.unpad2d(u, hier)


def padded_solver2d(mesh2, plan_spec, jnp_level_max: int, inner_cycles: int = 2, n: int = 33,
                    init_norm: float = None):
    """sharded2d_padded.make_sharded2d_padded_df_solver at n^3 to 1e-8 (of
    ``init_norm``, else of ||f_hi||) under the plan (n_sharded,
    fine_local_i, fine_local_j), or the default plan where plan_spec is
    None: (the gathered f64 solution, outer steps, final norm, plan, tier
    map, this rank's calls of the kernel wrappers, and its kernel launches
    (on the card; LAUNCHES counts launches only))."""
    from multigrid_parallel_tpu_torch.ops import pallas_sharded as px1
    from multigrid_parallel_tpu_torch.ops import pallas_sharded2d as px2
    from multigrid_parallel_tpu_torch.parallel import sharded2d as s2
    from multigrid_parallel_tpu_torch.parallel import sharded2d_padded as s2p

    hier = mg.Hierarchy(ndim=3, coarse_n=5, num_levels={33: 4, 65: 5}[n])
    cfg = mg.CycleConfig(n_smooth=2)
    plan = (s2.ShardPlan2D(mesh2.nx, mesh2.ny, ("x", "y"), *plan_spec) if plan_spec
            else None)
    run, plan = s2p.make_sharded2d_padded_df_solver(hier, cfg, mesh2, plan, rel_tol=1e-8,
                                                    inner_cycles=inner_cycles,
                                                    jnp_level_max=jnp_level_max,
                                                    init_norm=init_norm)
    state = s2p.setup_df_problem_sharded2d_padded(mg.poisson_3d_quadratic(), hier, mesh2, plan)
    for mod in (pk, px1, px2):
        mod.reset_launches()
    with _counted_calls(px2, _PX2_NAMES) as calls2, _counted_calls(px1, _PX1_NAMES) as calls1:
        u_hi, u_lo, nrm, steps = run(*state)
    launches = {**pk.LAUNCHES, **px1.LAUNCHES, **px2.LAUNCHES}
    u = s2p.unpad_solution2d(s2.gather_global2d(u_hi, mesh2), s2.gather_global2d(u_lo, mesh2),
                             hier)
    return (u, steps, float(nrm), plan, s2p.tier_map(hier, cfg, plan, jnp_level_max),
            {**calls1, **calls2}, launches)


def padded_solver2d_on(mesh, shape, plan_spec, jnp_level_max: int, inner_cycles: int, n: int,
                       init_norm: float = None):
    """padded_solver2d on this group seen as a ``shape`` mesh (rank 0's
    result)."""
    from multigrid_parallel_tpu_torch.parallel import sharded2d as s2

    out = padded_solver2d(s2.make_mesh_2d(*shape, device=mesh.device), plan_spec, jnp_level_max,
                          inner_cycles, n, init_norm)
    return out if mesh.rank == 0 else None


def sharded2d_checks(mesh, shapes, padded_configs):
    """Every (i, j)-sharded check of one launch, on (nx, ny) meshes of the
    same ranks: the f64 cycles and the plain double-float solver on each
    mesh of ``shapes``, the padded solver under each (shape, plan spec,
    jnp_level_max) of ``padded_configs``, and every rank's blocks of the
    padded setup on the first shape (gathered)."""
    from multigrid_parallel_tpu_torch.parallel import sharded2d as s2
    from multigrid_parallel_tpu_torch.parallel import sharded2d_padded as s2p

    out = {}
    for shape in shapes:
        mesh2 = s2.make_mesh_2d(*shape, device=mesh.device)
        out[("f64", shape)] = f64_cycles2d(mesh2)
        out[("df17", shape)] = df_solver2d(mesh2)
    for shape, plan_spec, jnp_level_max in padded_configs:
        mesh2 = s2.make_mesh_2d(*shape, device=mesh.device)
        out[("padded", shape, plan_spec, jnp_level_max)] = padded_solver2d(mesh2, plan_spec,
                                                                          jnp_level_max)
    mesh2 = s2.make_mesh_2d(*shapes[0], device=mesh.device)
    hier = mg.Hierarchy(ndim=3, coarse_n=5, num_levels=4)
    plan = s2p.plan_sharding_2d_padded(hier, mesh2.nx, mesh2.ny)
    setup = s2p.setup_df_problem_sharded2d_padded(mg.poisson_3d_quadratic(), hier, mesh2, plan)
    out["setup"] = (plan, [sh._all_gather(mesh2, x) for x in setup])
    out["halos"] = halo_helpers(mesh2)
    return out if mesh.rank == 0 else {"halos": out["halos"]}


HALO_FIELD = (20, 12, 14, 5)  # (seed, Li, Lj, k points) of halo_helpers' global field


def halo_field(nx: int, ny: int) -> torch.Tensor:
    seed, li, lj, m = HALO_FIELD
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.standard_normal((nx * li, ny * lj, m)).astype(np.float32))


def halo_helpers(mesh2):
    """This rank's halo parts of halo_field through the exchanges of
    sharded2d_padded: the five copy-free parts (4-deep halo, a 2-row tail),
    the j-extended triple (2 rows before, 1 after) and the ext block (3
    deep, i then j)."""
    from multigrid_parallel_tpu_torch.parallel import sharded2d_padded as s2p

    _, li, lj, _ = HALO_FIELD
    x = halo_field(mesh2.nx, mesh2.ny)
    block = x[mesh2.ix * li:(mesh2.ix + 1) * li, mesh2.iy * lj:(mesh2.iy + 1) * lj].contiguous()
    block = block.to(mesh2.device)
    return {"five": s2p._halo_parts2dj(block, mesh2, 4, 4, tail_local=2),
            "triple": s2p._halo_parts2d(block, mesh2, 2, 1),
            "ext": s2p._halo_ext_j(s2p._halo_ext_i(block, mesh2, 3), mesh2, 3)}
