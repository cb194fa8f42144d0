"""The port's driver surface against the JAX package's: the
``MultigridSolver`` facade method by method, checkpoints written by one
package and resumed in the other, the timing table and stage profilers,
the smoother studies, the cascadic 1D driver, the VTK writer and the
debug printers, at 9^3-17^3 (the studies' 50^3 fingerprint aside).

Tolerances (f64): fields to 1e-12 relative (the two sides differ only
in the order of the transfers' matrix-product sums); per-cycle residual
norms, a resumed checkpoint's over 3 cycles included, to 1e-12 relative
plus 1e-12 of ||f|| (the residual scales a field's last-bit differences
by 1/h^2 = 256 at 17^3, a roundoff floor of ~1e-13 ||f|| that no
relative bound holds near convergence); text outputs (timing table, VTK
file, debug printers) are equal byte for byte."""

import dataclasses

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import multigrid_parallel_tpu as jmg
import multigrid_parallel_tpu_torch as tmg
from golden1d_cascade import cascade_golden
from multigrid_parallel_tpu import cascade as jcascade
from multigrid_parallel_tpu import studies as jstudies
from multigrid_parallel_tpu.utils import debug as jdebug
from multigrid_parallel_tpu.utils import timing as jtiming
from multigrid_parallel_tpu.utils import write_vtk as jwrite_vtk
from multigrid_parallel_tpu_torch import cascade as tcascade
from multigrid_parallel_tpu_torch import studies as tstudies
from multigrid_parallel_tpu_torch.ops import pallas3d as tpk
from multigrid_parallel_tpu_torch.utils import debug as tdebug
from multigrid_parallel_tpu_torch.utils import timing as ttiming
from multigrid_parallel_tpu_torch.utils import write_vtk as twrite_vtk
from multigrid_parallel_tpu_torch.utils.checkpoint import load_state

torch.set_num_threads(1)


def _solvers(**kw):
    t = tmg.MultigridSolver(5, 3, 2, device="cpu", **kw)
    j = jmg.MultigridSolver(5, 3, 2, dtype=jnp.float64, **kw)
    return t, j


def _norms_close(got, want, init):
    got, want = np.atleast_1d(got), np.atleast_1d(want)
    assert got.shape == want.shape
    assert np.all(np.abs(got - want) <= 1e-12 * want + 1e-12 * init), (got, want)


def _close(got, want, rtol=1e-12):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= rtol * max(np.abs(want).max(), 1e-300)


# ------------------------------------------------------- MultigridSolver


def test_solver_surface_matches_jax():
    t, j = _solvers()
    tu, tf, th = t.get_details()
    ju, jf, jh = j.get_details()
    assert th == jh and tu.shape == (17, 17, 17) and float(tu.abs().max()) == 0.0
    assert t.u.dtype == torch.float64 and t.u.device.type == "cpu"
    t.setup_boundary_conditions()
    j.setup_boundary_conditions()
    _close(t.u, j.u, 0)
    _close(t.f, j.f, 0)
    init = j.get_initial_residual()
    assert t.get_initial_residual() == pytest.approx(init, rel=1e-15)
    for _ in range(3):
        _norms_close(t.lin_solve(), j.lin_solve(), init)
    _close(t.u, j.u)
    _norms_close(t.get_residual(), j.get_residual(), init)
    assert t.error_vs_analytic() == pytest.approx(j.error_vs_analytic(), rel=1e-10)
    t.smoothen_edge_values()
    j.smoothen_edge_values()
    _close(t.u, j.u)
    t.finalize()
    assert t.u is None and t.f is None


def test_solver_solve_and_fmg_match_jax():
    t, j = _solvers()
    got, want = t.solve(rel_tol=1e-8), j.solve(rel_tol=1e-8)
    _norms_close(got, want, j.get_initial_residual())
    t, j = _solvers(smoother="jacobi", coarse_method="inverse")
    t.setup_boundary_conditions()
    j.setup_boundary_conditions()
    t.fmg_initialize()
    j.fmg_initialize()
    _close(t.u, j.u)
    _norms_close(t.lin_solve(), j.lin_solve(), j.get_initial_residual())


def test_solver_profiled_cycle_and_timing_table(capsys):
    t, j = _solvers()
    for s in (t, j):
        s.setup_boundary_conditions()
    _norms_close(t.lin_solve_profiled(), j.lin_solve_profiled(), j.get_initial_residual())
    _close(t.u, j.u)
    # one call per stage a level; the coarsest level records its direct
    # solve only; the finest its norm (CalcResidual2) too
    assert [ti.num_calls for ti in t.timing] == [ti.num_calls for ti in j.timing]
    assert all(x >= 0 for ti in t.timing for x in ti.time_taken)
    t.print_timing_info()
    out = capsys.readouterr().out
    assert out.count("-- level") == 3 and "Recurse, Direct Solve" in out
    t.reset_timing_info()
    assert all(c == 0 for ti in t.timing for c in ti.num_calls)


def test_timing_table_text_matches_jax():
    assert ttiming.STAGE_NAMES == jtiming.STAGE_NAMES
    a, b = ttiming.TimingInfo(), jtiming.TimingInfo()
    for stage, secs in [(0, 0.25), (3, 1.5e-4), (0, 0.125), (6, 2.0)]:
        a.record(stage, secs)
        b.record(stage, secs)
    assert a.table() == b.table()
    assert repr(a) == repr(b)


def test_timed_call_records_one_call():
    info = ttiming.TimingInfo()
    out = ttiming.timed_call(info, 2, lambda x: x + 1, torch.ones(3))
    assert float(out.sum()) == 6.0
    assert info.num_calls == [0, 0, 1, 0, 0, 0, 0] and info.time_taken[2] >= 0


def test_profile_padded_stages_rows():
    # the rows, labelled as the JAX function labels them: K2, K1, K3, K4
    # at every level above the coarsest, then K5 and K6
    hier = tmg.Hierarchy(ndim=3, coarse_n=5, num_levels=3)
    tpk.reset_launches()
    rows, lat = ttiming.profile_padded_stages(hier, tmg.CycleConfig(), reps=2, device="cpu")
    labels = [label for label, _ in rows]
    assert labels == [
        "L2 (17³) smoother (from-zero, 4 half)",
        "L2 (17³) smoother (pipelined, 4 half)",
        "L2 (17³) residual+restrict fused",
        "L2 (17³) prolong+correct+post-smooth fused",
        "L1 (9³) smoother (from-zero, 4 half)",
        "L1 (9³) smoother (pipelined, 4 half)",
        "L1 (9³) residual+restrict fused",
        "L1 (9³) prolong+correct+post-smooth fused",
        "outer (17³) EFT residual+norm fused",
        "outer (17³) df-add+EFT residual+norm fused",
    ]
    assert all(s > 0 for _, s in rows) and lat > 0
    assert all(v == 0 for v in tpk.LAUNCHES.values())  # plain versions on the CPU


# ----------------------------------------------------------- checkpoints


def test_checkpoint_jax_to_port(tmp_path):
    j = jmg.MultigridSolver(5, 3, 2, dtype=jnp.float64)
    j.setup_boundary_conditions()
    for _ in range(3):
        j.lin_solve()
    path = str(tmp_path / "jax.npz")
    j.save(path)
    r = tmg.MultigridSolver.restore(path, device="cpu")
    assert (r.hier.coarse_n, r.hier.num_levels, r.hier.dtype) == (5, 3, torch.float64)
    assert r.cfg == tmg.CycleConfig(n_smooth=2)
    _close(r.u, j.u, 0)
    _norms_close([r.lin_solve() for _ in range(3)], [j.lin_solve() for _ in range(3)],
                 j.get_initial_residual())
    _close(r.u, j.u)


def test_checkpoint_port_to_jax(tmp_path):
    t = tmg.MultigridSolver(5, 3, 2, smoother="jacobi", device="cpu")
    t.setup_boundary_conditions()
    for _ in range(3):
        t.lin_solve()
    path = str(tmp_path / "port.npz")
    t.save(path)
    r = jmg.MultigridSolver.restore(path)
    assert r.cfg == jmg.CycleConfig(n_smooth=2, smoother="jacobi")
    assert np.dtype(r.hier.dtype) == np.float64
    _close(r.u, t.u, 0)
    _norms_close([r.lin_solve() for _ in range(3)], [t.lin_solve() for _ in range(3)],
                 t.get_initial_residual())
    _close(r.u, t.u)


def test_checkpoint_port_resumes_bit_exactly(tmp_path):
    t = tmg.MultigridSolver(5, 3, 2, device="cpu")
    t.setup_boundary_conditions()
    t.lin_solve()
    path = str(tmp_path / "s.npz")
    t.save(path)
    cont = [t.lin_solve() for _ in range(3)]
    r = tmg.MultigridSolver.restore(path, device="cpu")
    assert [r.lin_solve() for _ in range(3)] == cont
    assert torch.equal(r.u, t.u)
    u, f, hier, cfg, extra = load_state(path, device="cpu")
    assert hier == dataclasses.replace(t.hier) and cfg == t.cfg and extra == {}


# --------------------------------------------------------------- studies


@pytest.mark.parametrize("smoother,levels", [("rb", 2), ("rb", 3), ("jacobi", 2), ("lex", 2)])
def test_smoother_study_matches_jax(smoother, levels):
    got = tstudies.smoother_study(num_levels=levels, smoother=smoother, rel_tol=0.0,
                                  max_iters=8, device="cpu")
    want = jstudies.smoother_study(num_levels=levels, smoother=smoother, rel_tol=0.0,
                                   max_iters=8)
    assert got.n_iters == want.n_iters == 8 and not got.converged
    assert got.initial_residual == pytest.approx(want.initial_residual, rel=1e-15)
    _norms_close(got.residual_norms, want.residual_norms, want.initial_residual)


def test_smoother_study_50cubed_reference_fingerprint():
    # red_black_gs_scalability.txt: 0.983675 per reference iteration,
    # which is two of the study's red-first + black-first pairs (see
    # tests/test_checkpoint_and_studies.py); settled by 600 iterations
    res = tstudies.smoother_study(n=50, rel_tol=1e-8, max_iters=600, device="cpu")
    assert res.n_iters == 600
    assert res.final_ratio ** 2 == pytest.approx(0.983675, abs=1e-5)


def test_smoother_study_kernel_branch_matches_jax_pallas():
    # use_pallas=True: on the CPU the wrapper of K1 takes its plain
    # version in the caller's dtype; JAX runs its Pallas kernel in
    # interpret mode (f64 under x64), as
    # tests/test_checkpoint_and_studies.py does
    tpk.reset_launches()
    got = tstudies.smoother_study(num_levels=2, rel_tol=0.0, max_iters=6, use_pallas=True,
                                  device="cpu")
    want = jstudies.smoother_study(num_levels=2, rel_tol=0.0, max_iters=6, use_pallas=True)
    assert got.n_iters == want.n_iters == 6
    for a, b in zip(got.residual_norms, want.residual_norms):
        assert a == pytest.approx(b, rel=1e-5)
    assert tpk.LAUNCHES["rb_smooth_fused"] == 0  # no kernel on the CPU
    plain = tstudies.smoother_study(num_levels=2, rel_tol=0.0, max_iters=6, device="cpu")
    assert got.residual_norms == plain.residual_norms


def test_smoother_study_kernel_branch_keeps_the_plain_f32_trajectory():
    # K1 returns a fresh field: the study must carry it from step to step
    # (a caller that dropped it would stall on its first field)
    kw = dict(n=17, rel_tol=0.0, max_iters=20, dtype=torch.float32, device="cpu")
    got = tstudies.smoother_study(use_pallas=True, **kw)
    plain = tstudies.smoother_study(**kw)
    assert got.n_iters == 20 and got.residual_norms == plain.residual_norms
    assert got.residual_norms[-1] < got.residual_norms[0]


def test_smoother_study_rejects_unknown_smoother():
    with pytest.raises(ValueError, match="unknown smoother"):
        tstudies.smoother_study(num_levels=2, smoother="sor", device="cpu")


# --------------------------------------------------------------- cascade


@pytest.mark.parametrize("coarse_n,num_levels,gs_iters", [(5, 3, 4), (3, 4, 2), (5, 4, 10)])
def test_cascade_matches_golden(coarse_n, num_levels, gs_iters):
    res = tcascade.cascade_solve_1d(coarse_n, num_levels, gs_iters, device="cpu")
    v_g, err_g = cascade_golden(coarse_n, num_levels, gs_iters)
    # the golden runs the same f64 operations in the same order
    np.testing.assert_array_equal(res.v.numpy(), v_g)
    assert res.error_sq == pytest.approx(err_g, rel=1e-12, abs=1e-15)
    assert res.finest_n == len(v_g)


def test_cascade_nonzero_rhs_matches_golden():
    # rhs = cos(x): the up-leg's level-spacing coordinate quirk
    res = tcascade.cascade_solve_1d(5, 3, 4, rhs_func=torch.cos, device="cpu")
    v_g, _ = cascade_golden(5, 3, 4, rhs_func=np.cos)
    np.testing.assert_allclose(res.v.numpy(), v_g, rtol=0, atol=1e-13)


@pytest.mark.parametrize("levels", [2, 4])
def test_cascade_filled_coarse_rhs_matches_jax(levels):
    # faithful=False, which the golden does not model, against JAX's
    got = tcascade.cascade_solve_1d(5, levels, 4, faithful=False, rhs_func=torch.cos,
                                    device="cpu")
    want = jcascade.cascade_solve_1d(5, levels, 4, faithful=False,
                                     rhs_func=lambda x: jnp.cos(x))
    np.testing.assert_allclose(got.v.numpy(), np.asarray(want.v), rtol=0, atol=1e-13)
    assert got.error_sq == pytest.approx(want.error_sq, rel=1e-10, abs=1e-15)


def test_cascade_rejects_bad_sizes():
    with pytest.raises(ValueError):
        tcascade.cascade_solve_1d(2, 3, 4, device="cpu")
    with pytest.raises(ValueError):
        tcascade.cascade_solve_1d(5, 0, 4, device="cpu")


# ------------------------------------------------------- VTK and debug


def test_write_vtk_equals_jax_file(tmp_path):
    rng = np.random.default_rng(0)
    field = rng.standard_normal((5, 5, 5)) * 1e-3
    a, b = tmp_path / "port.vtk", tmp_path / "jax.vtk"
    twrite_vtk(str(a), torch.from_numpy(field), 0.25)
    jwrite_vtk(str(b), field, 0.25)
    assert a.read_bytes() == b.read_bytes()
    assert a.read_text().startswith("# vtk DataFile Version 2.0\n")
    with pytest.raises(ValueError, match="expected cube"):
        twrite_vtk(str(a), field[:, :, :4], 0.25)


def test_write_vtk_python_writer_equals_jax_file(tmp_path, monkeypatch):
    # the writer the port falls through to without the native library
    from multigrid_parallel_tpu_torch.utils import vtk as tvtk

    monkeypatch.setattr(tvtk, "_load_native", lambda: None)
    field = np.linspace(-1.0, 1.0, 27).reshape(3, 3, 3)
    a, b = tmp_path / "port.vtk", tmp_path / "jax.vtk"
    tvtk.write_vtk(str(a), torch.from_numpy(field), 0.5)
    jwrite_vtk(str(b), field, 0.5)
    assert a.read_bytes() == b.read_bytes()


def test_debug_printers_match_jax(capsys):
    rng = np.random.default_rng(1)
    grid, mat = rng.standard_normal((3, 3, 3)), rng.standard_normal((4, 4))
    assert tdebug.format_grid_3d(torch.from_numpy(grid)) == jdebug.format_grid_3d(grid)
    assert tdebug.format_matrix(torch.from_numpy(mat)) == jdebug.format_matrix(mat)
    tdebug.print_grid_3d(grid)
    tdebug.print_matrix(mat)
    out = capsys.readouterr().out
    assert out == jdebug.format_grid_3d(grid) + "\n" + jdebug.format_matrix(mat) + "\n"
    with pytest.raises(ValueError):
        tdebug.format_grid_3d(mat)
    with pytest.raises(ValueError):
        tdebug.format_matrix(grid)


def test_package_exports_match_jax():
    for name in ("solve", "solve_mixed", "solve_on_device", "solve_on_device_mixed",
                 "v_cycle", "fmg_initialize", "SolveResult", "MultigridSolver",
                 "level_sizes", "poisson_1d_cos", "Hierarchy", "CycleConfig", "Problem",
                 "poisson_3d_quadratic", "poisson_3d_trig"):
        assert name in tmg.__all__ and name in jmg.__all__, name
        assert callable(getattr(tmg, name))
    assert tmg.level_sizes(5, 4) == jmg.level_sizes(5, 4)
    assert "MultigridSolver" in tmg.__all__
