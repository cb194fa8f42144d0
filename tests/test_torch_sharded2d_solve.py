"""The (i, j)-sharded solve of the port (parallel.sharded2d,
parallel.sharded2d_padded) on 4 gloo ranks of CPU processes
(parallel.launch), seen as 2x2, 4x1 and 1x4 meshes, against the JAX
package's sharded2d functions on the same mesh shapes of the CPU devices
and against the port's single-device solves, on the Poisson problem.

The ranks are spawned once for the module (tests/torch_sharded_ranks.py
holds what they run; it imports torch only), in a thread while the JAX
references are computed. The JAX padded solver runs its plain tier
(``jnp_level_max=10**9``): its Pallas tier in interpret mode agrees with
it to f32 rounding (tests/test_sharded2d_padded.py); the port's kernel
tier (K37-K41, and K28-K31 in the j-replicated tier) is held against it
and, bit for bit, against the port's fused single-device solve.

Tolerances: the f64 cycles' norms rel 1e-10 and u 1e-11 absolute (as
tests/test_sharded2d.py); the double-float solvers the same outer steps
and u within 1e-6 max|u| (tests/test_sharded2d_padded.py); the setup
converted between the packages, bit for bit.
"""

import concurrent.futures

import numpy as np
import pytest
import torch

import torch_sharded_ranks as rk
from multigrid_parallel_tpu import CycleConfig as JCycleConfig
from multigrid_parallel_tpu import Hierarchy as JHierarchy
from multigrid_parallel_tpu import poisson_3d_quadratic as jpoisson
from multigrid_parallel_tpu.parallel import sharded2d as js2
from multigrid_parallel_tpu.parallel import sharded2d_padded as js2p
import multigrid_parallel_tpu_torch as mg
from multigrid_parallel_tpu_torch import cycles_padded as cp
from multigrid_parallel_tpu_torch.cycles import make_cycle_fn, setup_problem
from multigrid_parallel_tpu_torch.ops import pallas3d as pk
from multigrid_parallel_tpu_torch.parallel.launch import launch
from multigrid_parallel_tpu_torch.utils import convert

torch.set_num_threads(1)

D = 4
SHAPES = [(2, 2), (4, 1), (1, 4)]
# the 1x4 plan whose 9^3 level has Lj = 4 columns, too narrow for the 2D
# kernels' halos: the port's gate runs its j-replicated tier there
NARROW = (3, 40, 16)  # (n_sharded, fine_local_i, fine_local_j)
# the 2x2 plan whose four blocks meet at an interior point on every sharded
# level, (24, 24) at 33^3: the stages there read the diagonal neighbour's
# corner values (the default plan, Lj = 32, meets on the boundary column)
BALANCED = (3, 24, 24)
# (mesh shape, plan spec or None for the default plan, jnp_level_max)
PADDED = [((2, 2), None, 0), ((2, 2), None, 10**9), ((2, 2), BALANCED, 0), ((4, 1), None, 0),
          ((1, 4), None, 0), ((1, 4), NARROW, 0)]
TIMEOUT = 180.0


def _jax_refs():
    """The JAX sharded2d references on each mesh shape: the f64 cycles at
    17^3 (norms, u), the plain df solver at 17^3 (steps, u), the padded
    solver's plain tier at 33^3 under each plan (steps, u, plan) and the
    padded setup on the first shape."""
    cfg = JCycleConfig(n_smooth=2)
    prob = jpoisson()
    h17 = JHierarchy(ndim=3, coarse_n=5, num_levels=3)
    h33 = JHierarchy(ndim=3, coarse_n=5, num_levels=4)
    out = {}
    for shape in SHAPES:
        mesh = js2.make_mesh_2d(*shape)
        cycle, plan = js2.make_sharded2d_cycle(h17, cfg, mesh)
        u, f = js2.setup_problem_sharded2d(prob, h17, mesh, plan)
        norms = []
        for _ in range(3):
            u, nrm = cycle(u, f)
            norms.append(float(nrm))
        out[("f64", shape)] = norms, np.asarray(js2.unpad2d(u, h17))
        run, plan = js2.make_sharded2d_df_solver(h17, cfg, mesh, rel_tol=1e-8, inner_cycles=2)
        u_hi, u_lo, _, steps = run(*js2.setup_df_problem_sharded2d(prob, h17, mesh, plan))
        u = np.asarray(js2.unpad2d(u_hi, h17), np.float64) + np.asarray(js2.unpad2d(u_lo, h17))
        out[("df17", shape)] = int(steps), u
    for shape, spec, _ in PADDED:
        key = ("padded", shape, spec)
        if key in out:
            continue
        mesh = js2.make_mesh_2d(*shape)
        plan = js2.ShardPlan2D(shape[0], shape[1], ("x", "y"), *spec) if spec else None
        run, plan = js2p.make_sharded2d_padded_df_solver(h33, cfg, mesh, plan, rel_tol=1e-8,
                                                         inner_cycles=2, jnp_level_max=10**9)
        state = js2p.setup_df_problem_sharded2d_padded(prob, h33, mesh, plan)
        u_hi, u_lo, _, steps = run(*state)
        out[key] = int(steps), np.asarray(js2p.unpad_solution2d(u_hi, u_lo, h33)), plan
        if shape == SHAPES[0] and spec is None:
            out["setup"] = [np.asarray(x) for x in state], plan
    return out


@pytest.fixture(scope="module")
def refs():
    """(rank 0's results of the 4 ranks, the JAX references), side by side."""
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        ranks = pool.submit(launch, rk.sharded2d_checks, D, SHAPES, PADDED, backend="gloo",
                            device="cpu", timeout=TIMEOUT)
        jax_refs = _jax_refs()
        results = ranks.result()
        return results[0], jax_refs, [r["halos"] for r in results]


@pytest.mark.parametrize("shape", SHAPES)
def test_f64_cycle_matches_jax_and_single_device(refs, shape):
    norms, u, plan = refs[0][("f64", shape)]
    j_norms, j_u = refs[1][("f64", shape)]
    hier = mg.Hierarchy(ndim=3, coarse_n=5, num_levels=3)
    cycle = make_cycle_fn(hier, mg.CycleConfig(n_smooth=2), device="cpu")
    u1, f1 = setup_problem(mg.poisson_3d_quadratic(), hier, "cpu")
    for it in range(3):
        u1, n1 = cycle(u1, f1)
        assert norms[it] == pytest.approx(float(n1), rel=1e-10), it
        assert norms[it] == pytest.approx(j_norms[it], rel=1e-10), it
    np.testing.assert_allclose(u.numpy(), u1.numpy(), rtol=0, atol=1e-11)
    np.testing.assert_allclose(u.numpy(), j_u, rtol=0, atol=1e-11)


@pytest.mark.parametrize("shape", SHAPES)
def test_df_solver_matches_jax(refs, shape):
    steps, nrm, u = refs[0][("df17", shape)]
    j_steps, j_u = refs[1][("df17", shape)]
    assert steps == j_steps, (steps, j_steps)
    np.testing.assert_allclose(u.numpy(), j_u, rtol=0, atol=1e-6 * np.abs(j_u).max())


@pytest.fixture(scope="module")
def fused():
    """The port's fused single-device solve at 33^3 (two inner cycles):
    (u, outer steps)."""
    hier = mg.Hierarchy(ndim=3, coarse_n=5, num_levels=4)
    run = cp.make_on_device_df_solver(hier, mg.CycleConfig(n_smooth=2), rel_tol=1e-8,
                                      inner_cycles=2, device="cpu")
    out = run(*cp.setup_df_problem(mg.poisson_3d_quadratic(), hier, "cpu"))
    return pk.df_to_f64(out[0], out[1]), out[3]


@pytest.mark.parametrize("config", PADDED)
def test_padded_df_solver_matches_jax_and_fused(refs, fused, config):
    shape, spec, jnp_level_max = config
    u, steps, nrm, plan, tiers, calls, _ = refs[0][("padded",) + config]
    j_steps, j_u, j_plan = refs[1][("padded", shape, spec)]
    u1, steps1 = fused
    scale = float(u1.abs().max())
    assert steps == j_steps == steps1, (steps, j_steps, steps1)
    assert (plan.n_sharded, plan.fine_local_i, plan.fine_local_j) == \
        (j_plan.n_sharded, j_plan.fine_local_i, j_plan.fine_local_j)
    np.testing.assert_allclose(u.numpy(), j_u, rtol=0, atol=1e-6 * scale)
    if jnp_level_max:  # the plain tier, no kernel wrapper
        assert set(tiers.values()) == {"plain", "replicated"}, tiers
        assert not calls, calls
        np.testing.assert_allclose(u.numpy(), u1.numpy(), rtol=0, atol=1e-6 * scale)
        return
    # the kernel tiers keep K1-K5's arithmetic on the owned points
    assert torch.equal(u, u1), float((u - u1).abs().max())
    assert calls["residual_df_norm_halo2d"] == steps + 1, calls
    for name in ("rb_smooth_halo2d", "rb_smooth_from_zero_halo2d", "residual_restrict_halo2d",
                 "prolong_smooth_halo2d"):
        assert calls.get(name, 0) > 0, calls
    jrep = spec == NARROW
    assert (tiers[9] == "j-replicated") == jrep, tiers
    for name in ("rb_smooth_from_zero_halo", "residual_restrict_halo", "prolong_smooth_halo"):
        assert (calls.get(name, 0) > 0) == jrep, calls


def test_halo_exchanges_deliver_the_neighbours_corners_included(refs):
    """Each rank's halo parts from the real exchanges on the 2x2 mesh equal
    the simulated ranks' copies of the global field: the j halos, and the
    j-extended i-halo rows whose corner blocks come from the diagonal
    neighbour (two hops: j, then i), with zeros past the chain ends."""
    _, li, lj, _ = rk.HALO_FIELD
    x = rk.halo_field(*SHAPES[0])
    for rank, halos in enumerate(refs[2]):
        ix, iy = divmod(rank, SHAPES[0][1])
        want = {"five": rk.rank_parts2d(x, ix, iy, li, lj, 4, 4, tail=2),
                "triple": rk.rank_triple2d(x, ix, iy, li, lj, 2, 1, 2),
                "ext": (rk.rank_ext2d(x, ix, iy, li, lj, 3, 3, 3, 3),)}
        for form, parts in want.items():
            got = halos[form] if form != "ext" else (halos[form],)
            assert len(got) == len(parts), form
            for g, w in zip(got, parts):
                assert torch.equal(g, w), (rank, form)


def test_convert_sharded2d_state_round_trip(refs):
    """The port's per-rank double-float setup is the JAX package's padded
    2D setup (same plan), converted either way."""
    plan, gathered = refs[0]["setup"]
    j_state, j_plan = refs[1]["setup"]
    n = 33
    li = plan.local_i(0)
    blocks = [[x[r * li:(r + 1) * li] for x in gathered] for r in range(D)]
    for rank in range(D):
        got = convert.from_jax_sharded2d_state(j_state, n, j_plan, rank, "cpu")
        for x, want in zip(got, blocks[rank]):
            assert torch.equal(x, want)
    for got, want in zip(convert.to_jax_sharded2d_state(blocks, n, j_plan), j_state):
        np.testing.assert_array_equal(got, want)
    with pytest.raises(ValueError):
        convert.from_jax_sharded2d(j_state[0][:-1], n, j_plan, 0, "cpu")
