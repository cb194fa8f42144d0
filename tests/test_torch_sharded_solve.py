"""The i-sharded solve of the port (parallel.sharded, parallel.sharded_padded)
on gloo ranks of CPU processes (parallel.launch), against the JAX
package's sharded functions on the 4- and 2-device CPU mesh and against
the port's single-device cycles, on the same numpy-seeded inputs.

Each world size is spawned once for the module (tests/torch_sharded_ranks.py
holds what the ranks run; it imports torch only) and every check of that
size reads its result; each launch has its own time limit. The JAX
references are computed once in module fixtures, their padded cycles and
solver on the plain tier (``jnp_level_max=10**9``): its Pallas tier in
interpret mode takes ~10 s a solve here and agrees with it to f32 rounding
(tests/test_sharded_padded.py), and the port's kernel tier is held
against its own plain tier below.

Tolerances: the f64 cycles 1e-11 (as tests/test_sharded.py), norms
rel 1e-10; the mixed cycle (f32 inside) 1e-6 max|u|, norms rel 1e-5;
the f32 correction cycles 2e-6 max|want| (as
tests/test_sharded_padded.py: matrix-product against 3-tap rounding of
the transfers, one ulp of the coarse solve amplified).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_sharded_ranks as rk
from multigrid_parallel_tpu import CycleConfig as JCycleConfig
from multigrid_parallel_tpu import Hierarchy as JHierarchy
from multigrid_parallel_tpu import poisson_3d_quadratic as jprob
from multigrid_parallel_tpu.ops import pallas3d as jpk
from multigrid_parallel_tpu.parallel import sharded as jsh
from multigrid_parallel_tpu.parallel import sharded_padded as jsp
import multigrid_parallel_tpu_torch as mg
from multigrid_parallel_tpu_torch import cycles_padded as tcp
from multigrid_parallel_tpu_torch.cycles import make_cycle_fn, setup_problem
from multigrid_parallel_tpu_torch.ops import pallas3d as tpk
from multigrid_parallel_tpu_torch.parallel import sharded as sh
from multigrid_parallel_tpu_torch.parallel.launch import launch
from multigrid_parallel_tpu_torch.utils import convert

torch.set_num_threads(1)

N33, L33, N_DEV = 33, 12, 4
CONFIGS = [(1, 1, 0), (2, 2, 0), (2, 2, 17)]  # (n_sharded, gamma, gamma_min_n)
TIMEOUT = 120.0


def _r33():
    return rk.global_field(np.random.default_rng(12), N33, N_DEV * L33, zero_boundary=True)


@pytest.fixture(scope="module")
def ranks():
    """Every world size's results, each from one gloo launch."""
    return {
        4: launch(rk.solve_checks, 4, _r33(), L33, CONFIGS, backend="gloo", device="cpu",
                  timeout=TIMEOUT)[0],
        2: launch(rk.solve_checks, 2, None, 0, (), backend="gloo", device="cpu",
                  timeout=TIMEOUT)[0],
        1: launch(rk.solve_checks, 1, None, 0, (), backend="gloo", device="cpu",
                  timeout=TIMEOUT)[0],
    }


@pytest.fixture(scope="module")
def jax_f64():
    """The JAX f64 sharded cycle at 17^3 on 4 and 2 devices: {n_dev:
    (norms, u)} after 3 cycles."""
    hier = JHierarchy(ndim=3, coarse_n=5, num_levels=3)
    out = {}
    for n_dev in (4, 2):
        mesh = jsh.make_mesh(n_dev)
        cycle, plan = jsh.make_sharded_cycle(hier, JCycleConfig(n_smooth=2), mesh)
        u, f = jsh.setup_problem_sharded(jprob(), hier, mesh, plan)
        norms = []
        for _ in range(3):
            u, nrm = cycle(u, f)
            norms.append(float(nrm))
        out[n_dev] = norms, np.asarray(jsh.unpad(u, hier))
    return out


@pytest.fixture(scope="module")
def jax_mixed():
    """The JAX mixed sharded cycle at 17^3 on 4 devices: (norms, u) after 2."""
    hier = JHierarchy(ndim=3, coarse_n=5, num_levels=3)
    mesh = jsh.make_mesh(N_DEV)
    cycle, plan = jsh.make_sharded_mixed_cycle(hier, JCycleConfig(n_smooth=2), mesh)
    u, f = jsh.setup_problem_sharded(jprob(), hier, mesh, plan)
    norms = []
    for _ in range(2):
        u, nrm = cycle(u, f)
        norms.append(float(nrm))
    return norms, np.asarray(jsh.unpad(u, hier))


@pytest.fixture(scope="module")
def jax_33():
    """The JAX sharded padded cycle (each config) and df solver (with and
    without FMG) at 33^3 on the 4-device mesh, plain tier."""
    mesh = jsh.make_mesh(N_DEV)
    hier32 = JHierarchy(ndim=3, coarse_n=5, num_levels=4, dtype=jnp.float32)
    rg = jnp.asarray(convert.to_jax_sharded([torch.from_numpy(_r33())], N33))
    cycles = {}
    for ns, gamma, gmin in CONFIGS:
        plan = jsh.ShardPlan(n_dev=N_DEV, axis="x", n_sharded=ns, fine_local=L33)
        cyc, _ = jsp.make_sharded_padded_cycle(
            hier32, JCycleConfig(n_smooth=2, gamma=gamma, gamma_min_n=gmin), mesh, plan,
            jnp_level_max=10**9)
        cycles[(ns, gamma, gmin)] = np.asarray(cyc(jnp.zeros_like(rg), rg))[:N33, :N33, :N33]
    hier = JHierarchy(ndim=3, coarse_n=5, num_levels=4)
    steps = {}
    for fmg in (False, True):
        run, plan = jsp.make_sharded_df_solver(hier, JCycleConfig(n_smooth=2), mesh,
                                               rel_tol=1e-8, inner_cycles=2,
                                               jnp_level_max=10**9, use_fmg=fmg)
        st = jsp.setup_df_problem_sharded_padded(jprob(), hier, mesh, plan)
        steps[fmg] = int(run(*st)[3])
    return cycles, steps, plan


@pytest.mark.parametrize("n_dev", [2, 4])
def test_f64_cycle_matches_jax_and_single_device(ranks, jax_f64, n_dev):
    norms, u = ranks[n_dev]["f64"]
    j_norms, j_u = jax_f64[n_dev]
    hier = mg.Hierarchy(ndim=3, coarse_n=5, num_levels=3)
    cycle = make_cycle_fn(hier, mg.CycleConfig(n_smooth=2), device="cpu")
    u1, f1 = setup_problem(mg.poisson_3d_quadratic(), hier, "cpu")
    for it in range(3):
        u1, n1 = cycle(u1, f1)
        assert norms[it] == pytest.approx(float(n1), rel=1e-10), it
        assert norms[it] == pytest.approx(j_norms[it], rel=1e-10), it
    np.testing.assert_allclose(u.numpy(), u1.numpy(), rtol=0, atol=1e-11)
    np.testing.assert_allclose(u.numpy(), j_u, rtol=0, atol=1e-11)


def test_mixed_cycle_matches_jax(ranks, jax_mixed):
    norms, u = ranks[4]["mixed"]
    j_norms, j_u = jax_mixed
    # the f32 inner cycle rounds differently under XLA and torch (~1e-7
    # relative of the correction; measured 6.5e-8 in u, 2e-7 in the norms)
    assert norms == pytest.approx(j_norms, rel=1e-5)
    np.testing.assert_allclose(u.numpy(), j_u, rtol=0, atol=1e-6 * np.abs(j_u).max())


def test_df_cycle_converges_and_inner_cycles_amortize(ranks):
    steps = {}
    for ic, (n_steps, nrm, init, err) in ranks[4]["df_cycle"].items():
        assert nrm <= 1e-8 * init, (ic, nrm, init)
        assert err < 5e-8, (ic, err)
        steps[ic] = n_steps
    assert steps[2] < steps[1], steps


@pytest.mark.parametrize("config", CONFIGS)
def test_padded_cycle_matches_single_device_and_jax(ranks, jax_33, config):
    got = ranks[4]["padded"][config + (0,)][0][:N33].numpy()
    ns, gamma, gmin = config
    hier32 = mg.Hierarchy(ndim=3, coarse_n=5, num_levels=4, dtype=torch.float32)
    cfg = mg.CycleConfig(n_smooth=2, gamma=gamma, gamma_min_n=gmin)
    r = torch.from_numpy(_r33()[:N33])
    want = tcp.make_padded_correction_cycle(hier32, cfg, "cpu")(None, r, from_zero=True).numpy()
    scale = np.abs(want).max()
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-6 * scale)
    np.testing.assert_allclose(got, jax_33[0][config], rtol=0, atol=2e-6 * scale)


@pytest.mark.parametrize("config", CONFIGS)
def test_kernel_tier_matches_plain_tier(ranks, config):
    kern, k_calls = ranks[4]["padded"][config + (0,)]
    plain, p_calls = ranks[4]["padded"][config + (10**9,)]
    assert not p_calls, p_calls
    # rank 0's kernel wrappers per level visit: the pre-smooth (from the
    # given correction at the top and on a gamma revisit, from zero on a
    # first visit below it), residual + restriction, prolongation +
    # post-smooth; the 17^3 level (depth 1) is revisited gamma - 1 times
    ns, gamma, _ = config
    revisits = (ns - 1) * (gamma - 1)
    want = {"rb_smooth_halo": 1 + revisits, "rb_smooth_from_zero_halo": ns - 1,
            "residual_restrict_halo": ns + revisits, "prolong_smooth_halo": ns + revisits}
    assert k_calls == {k: v for k, v in want.items() if v}, k_calls
    a, b = plain[:N33].numpy(), kern[:N33].numpy()
    np.testing.assert_allclose(b, a, rtol=0, atol=2e-6 * np.abs(a).max())
    assert not kern[N33:].any() and not plain[N33:].any()  # pad planes stay zero


def test_df_solver_converges_in_jax_outer_steps(ranks, jax_33):
    steps, nrm, init, err, _, plan, _ = ranks[4]["df33"][False]
    assert (plan.n_sharded, plan.fine_local) == (jax_33[2].n_sharded, jax_33[2].fine_local)
    assert nrm <= 1e-8 * init, (nrm, init)
    assert steps <= 10 and steps == jax_33[1][False], (steps, jax_33[1])
    assert err < 2e-8, err


def test_df_solver_fmg_takes_fewer_steps(ranks, jax_33):
    steps_fmg, nrm, init, err, *_ = ranks[4]["df33"][True]
    assert nrm <= 1e-8 * init and err < 2e-8, (nrm, init, err)
    assert steps_fmg < ranks[4]["df33"][False][0], steps_fmg
    assert steps_fmg == jax_33[1][True], (steps_fmg, jax_33[1])


def test_df_solver_rank_count_invariance(ranks):
    """1, 2 and 4 ranks at 17^3: the same outer steps and solution (each
    world size plans its own sharded depth; the kernels' owned rows do not
    depend on the decomposition, the norm's sum order does)."""
    results = {n_dev: ranks[n_dev]["df17"] for n_dev in (1, 2, 4)}
    assert len({r[0] for r in results.values()}) == 1, {k: r[0] for k, r in results.items()}
    for n_dev, (_, nrm, init, err, u, plan, _) in results.items():
        assert nrm <= 1e-8 * init and err < 2e-8, (n_dev, nrm, err)
        np.testing.assert_allclose(u.numpy(), results[1][4].numpy(), rtol=0, atol=1e-9)
    assert [results[d][5].n_sharded for d in (1, 2, 4)] == [2, 2, 1]


def test_convert_sharded_round_trip():
    rng = np.random.default_rng(5)
    plan = sh.ShardPlan(n_dev=N_DEV, axis="x", n_sharded=2, fine_local=L33)
    g = rk.global_field(rng, N33, N_DEV * L33)
    lane = convert.to_jax_sharded([torch.from_numpy(g)], N33)
    assert lane.shape == (N_DEV * L33,) + jpk.padded_shape(N33)[1:]
    blocks = [convert.from_jax_sharded(lane, N33, plan, r, "cpu") for r in range(N_DEV)]
    np.testing.assert_array_equal(torch.cat(blocks).numpy(), g)
    np.testing.assert_array_equal(convert.to_jax_sharded(blocks, N33), lane)
    plain = convert.to_jax_sharded(blocks, N33, lanes=False)
    np.testing.assert_array_equal(plain, g)
    np.testing.assert_array_equal(convert.from_jax_sharded(plain, N33, plan, 1, "cpu").numpy(),
                                  g[L33:2 * L33])
    lo = (rng.standard_normal(g.shape) * 1e-8).astype(np.float32)
    hi_l, lo_l = convert.to_jax_sharded_df(blocks, [torch.from_numpy(lo)], N33)
    hi2, lo2 = convert.from_jax_sharded_df(hi_l, lo_l, N33, plan, 3, "cpu")
    np.testing.assert_array_equal(hi2.numpy(), g[3 * L33:])
    np.testing.assert_array_equal(lo2.numpy(), lo[3 * L33:])
    with pytest.raises(ValueError):
        convert.from_jax_sharded(lane[:-1], N33, plan, 0, "cpu")


def test_convert_sharded_state_feeds_the_jax_solver():
    """The port's per-rank setup, carried over to the JAX package's sharded
    global arrays, is the JAX package's own setup (same plan)."""
    hier = JHierarchy(ndim=3, coarse_n=5, num_levels=4)
    mesh = jsh.make_mesh(N_DEV)
    plan = jsh.plan_sharding(hier, N_DEV)
    j_state = jsp.setup_df_problem_sharded_padded(jprob(), hier, mesh, plan)
    t_hier = mg.Hierarchy(ndim=3, coarse_n=5, num_levels=4)
    t_plan = sh.plan_sharding(t_hier, N_DEV)
    assert dataclasses.astuple(t_plan) == dataclasses.astuple(plan)
    u64, f64 = setup_problem(mg.poisson_3d_quadratic(), t_hier, "cpu")
    L = t_plan.local_planes(0)
    for x64, j_hi, j_lo in ((u64, j_state[0], j_state[1]), (f64, j_state[2], j_state[3])):
        hi, lo = (torch.nn.functional.pad(x, (0, 0, 0, 0, 0, N_DEV * L - N33))
                  for x in tpk.df_split(x64))
        got_hi, got_lo = convert.to_jax_sharded_df([hi], [lo], N33)
        np.testing.assert_array_equal(got_hi, np.asarray(j_hi))
        np.testing.assert_array_equal(got_lo, np.asarray(j_lo))


def test_launch_time_limit_kills_a_hung_rank():
    with pytest.raises(TimeoutError):
        launch(rk.never_returns, 2, backend="gloo", device="cpu", timeout=3.0)


def test_nccl_refuses_two_ranks_on_one_device():
    n_cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    with pytest.raises(ValueError, match="NCCL refuses"):
        launch(rk.never_returns, n_cards + 1, backend="nccl", device="cuda")
