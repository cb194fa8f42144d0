"""The port's i-sharded electrospray solve (parallel.sharded_mixed,
parallel.sharded_mixed_padded) on 4 gloo ranks of CPU processes
(parallel.launch), against the JAX package's sharded functions on the
4-device CPU mesh and against the port's single-device electrospray solver,
on the 33^3 electrospray problem.

The ranks are spawned once for the module (tests/torch_sharded_ranks.py
holds what they run; it imports torch only), in a thread while the JAX
references are computed, since both take ~20 s. The JAX solver runs its
plain tier (``jnp_level_max=10**9``): its Pallas tier in interpret mode
takes ~50 s here and agrees with it to f32 rounding
(tests/test_sharded_mixed_padded.py); the port's kernel tier and plain
tier are both held against it.

Tolerances: the f64 cycles' norms rel 1e-10 and u 1e-8 absolute (as
tests/test_sharded_mixed.py); the double-float solver the same outer steps
and u within 1e-6 max|u| (tests/test_sharded_mixed_padded.py); the setup
converted between the packages, bit for bit.
"""

import concurrent.futures

import numpy as np
import pytest
import torch

import torch_sharded_ranks as rk
from multigrid_parallel_tpu.hierarchy import Hierarchy as JHierarchy
from multigrid_parallel_tpu.mixed_bc import MixedBCSolver as JMixedBCSolver
from multigrid_parallel_tpu.models.electrospray import electrospray_problem as jelectrospray
from multigrid_parallel_tpu.parallel import sharded as jsh
from multigrid_parallel_tpu.parallel import sharded_mixed as jsm
from multigrid_parallel_tpu.parallel import sharded_mixed_padded as jsmp
import multigrid_parallel_tpu_torch as mg
from multigrid_parallel_tpu_torch import mixed_padded as tmp
from multigrid_parallel_tpu_torch.mixed_bc import MixedBCSolver
from multigrid_parallel_tpu_torch.ops import stencils_3d as ops3
from multigrid_parallel_tpu_torch.parallel import sharded as sh
from multigrid_parallel_tpu_torch.parallel.launch import launch
from multigrid_parallel_tpu_torch.utils import convert

torch.set_num_threads(1)

N, D = 33, 4
# (gamma, gamma_min_n, band width, band iterations): V, W, W capped at 17,
# and the band W-cycle (capped: its uncapped JAX cycle takes ~14 s to compile)
CYCLES = [(1, 0, 0, 0), (2, 0, 0, 0), (2, 17, 0, 0), (2, 17, 2, 1)]
# (fine_local, n_sharded, jnp_level_max): the default plan (4, 2, 12) with
# the kernels forced on from 17^3 and off, and the trigger plan (plane 32
# is rank 2's row 0, plane 16 at depth 1) with the kernels on
SOLVERS = [(0, 0, 9), (0, 0, 10**9), (16, 2, 9)]
TIMEOUT = 180.0


def _jax_refs():
    """The JAX sharded f64 cycles (3 of each of CYCLES: norms, u), its
    sharded double-float solver at 33^3 (steps, u, plan) and its setup."""
    prob = jelectrospray()
    hier = JHierarchy(ndim=3, coarse_n=5, num_levels=4, length=prob.length)
    mesh = jsh.make_mesh(D)
    cycles = {}
    for gamma, gamma_min_n, band_width, band_iters in CYCLES:
        s = JMixedBCSolver(prob, hier, n_smooth=2, gamma=gamma, gamma_min_n=gamma_min_n,
                           boundary_band_width=band_width, boundary_band_iters=band_iters)
        cycle, plan = jsm.make_sharded_mixed_bc_cycle(s, mesh)
        u, f = jsm.setup_mixed_problem_sharded(s, mesh, plan)
        norms = []
        for _ in range(3):
            u, nrm = cycle(u, f)
            norms.append(float(nrm))
        cycles[(gamma, gamma_min_n, band_width, band_iters)] = norms, np.asarray(u[:N])
    s = JMixedBCSolver(prob, hier, n_smooth=2, gamma=2)
    run, plan = jsmp.make_sharded_mixed_padded_df_solver(s, mesh, rel_tol=1e-6, inner_cycles=2,
                                                         jnp_level_max=10**9)
    state = jsmp.setup_mixed_df_problem_sharded(s, mesh, plan)
    u_hi, u_lo, _, steps = run(*state)
    u = np.asarray(jsmp.unpack_mixed_solution_sharded(u_hi, u_lo, hier))
    return cycles, (int(steps), u, plan), [np.asarray(x) for x in state]


@pytest.fixture(scope="module")
def refs():
    """(the 4 ranks' results, the JAX references), computed side by side."""
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        ranks = pool.submit(launch, rk.mixed_solve_checks, D, CYCLES, SOLVERS, backend="gloo",
                            device="cpu", timeout=TIMEOUT)
        jax_refs = _jax_refs()
        return ranks.result()[0], jax_refs


def _single_device(gamma=2, gamma_min_n=0, band_width=0, band_iters=0):
    es = mg.electrospray_problem()
    hier = mg.Hierarchy(ndim=3, coarse_n=5, num_levels=4, length=es.length)
    return MixedBCSolver(es, hier, n_smooth=2, gamma=gamma, gamma_min_n=gamma_min_n,
                         boundary_band_width=band_width, boundary_band_iters=band_iters,
                         device="cpu")


@pytest.mark.parametrize("config", CYCLES)
def test_f64_cycle_matches_jax_and_single_device(refs, config):
    norms, u = refs[0]["cycles"][config]
    j_norms, j_u = refs[1][0][config]
    s = _single_device(*config)
    level = s.hier.num_levels - 1
    coarse = s._coarse_solver(s.hier.dtype)
    u1, f1 = s.initial_state()
    for it in range(3):
        u1 = s._descend(u1, f1, level, False, coarse)
        n1 = float(ops3.residual_norm(u1, f1, s.hier.spacing(level)))
        assert norms[it] == pytest.approx(n1, rel=1e-10), it
        assert norms[it] == pytest.approx(j_norms[it], rel=1e-10), it
    np.testing.assert_allclose(u.numpy(), u1.numpy(), rtol=0, atol=1e-8)
    np.testing.assert_allclose(u.numpy(), j_u, rtol=0, atol=1e-8)


@pytest.fixture(scope="module")
def single_solve():
    """The port's single-device full tier at 33^3 (W-cycles, two inner
    cycles, 1e-6): (u, outer steps)."""
    s = _single_device()
    out = tmp.make_mixed_padded_df_solver(s, rel_tol=1e-6, inner_cycles=2)(
        *tmp.setup_mixed_df_problem(s))
    return tmp.unpack_mixed_solution(out[0], out[1], s.hier), out[3]


@pytest.mark.parametrize("config", SOLVERS)
def test_df_solver_matches_jax_and_single_device(refs, single_solve, config):
    u, nrm, steps, plan, calls = refs[0]["solver"][config]
    j_steps, j_u, j_plan = refs[1][1]
    u1, steps1 = single_solve
    scale = float(u1.abs().max())
    assert steps == steps1 == j_steps, (steps, steps1, j_steps)
    np.testing.assert_allclose(u.numpy(), u1.numpy(), rtol=0, atol=1e-6 * scale)
    if config[0] == 0:  # JAX's plan
        assert (plan.n_sharded, plan.fine_local) == (j_plan.n_sharded, j_plan.fine_local)
        np.testing.assert_allclose(u.numpy(), j_u, rtol=0, atol=1e-6 * scale)
    # the kernel wrappers ran at both sharded levels (33^3, 17^3), or not at all
    kernels = ("mixed_rb_smooth_halo", "mixed_rb_smooth_from_zero_halo",
               "mixed_prolong_smooth_halo", "residual_restrict_halo")
    if config[2] == 9:
        assert all(calls.get(name, 0) > 0 for name in kernels), calls
        assert calls["residual_df_norm_halo"] == steps + 1, calls
    else:
        assert not calls, calls


def test_trigger_plan_kernel_tier_equals_single_device(refs, single_solve):
    """Plane n - 1 at a rank's row 0, at both sharded levels: the sharded
    kernel tier keeps the single-device full tier's arithmetic, so the
    solutions agree bit for bit."""
    u = refs[0]["solver"][(16, 2, 9)][0]
    assert torch.equal(u, single_solve[0]), float((u - single_solve[0]).abs().max())


def test_convert_sharded_mixed_state_round_trip(refs):
    """The port's per-rank double-float setup is the JAX package's sharded
    setup (same plan), converted either way."""
    blocks_global = refs[0]["setup"]
    j_state = refs[1][2]
    plan = refs[1][1][2]
    L = plan.local_planes(0)
    for rank in range(D):
        got = convert.from_jax_sharded_state(j_state, N, plan, rank, "cpu")
        for x, want in zip(got, blocks_global):
            assert torch.equal(x, want[rank * L:(rank + 1) * L])
    rank_states = [tuple(x[r * L:(r + 1) * L] for x in blocks_global) for r in range(D)]
    for got, want in zip(convert.to_jax_sharded_state(rank_states, N), j_state):
        np.testing.assert_array_equal(got, want)
    with pytest.raises(ValueError):
        convert.from_jax_sharded_state([x[:-1] for x in j_state], N, plan, 0, "cpu")

