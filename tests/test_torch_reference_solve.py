"""The port's f64 reference solve (``cycles``: ``solve``, ``solve_mixed``,
``solve_on_device``, ``solve_on_device_mixed``, ``v_cycle``,
``fmg_initialize``) and its CLI (``python -m
multigrid_parallel_tpu_torch``, run in-process with ``--device cpu``)
against the JAX package's library calls on the same problem, at 33^3 (9^3
for the lexicographic smoother) and 129 points in 1D.

Each JAX result is computed once per test process (``_jax_solve``) and
shared by the library and CLI tests that compare with it. The JAX CLI is
not run here: it turns x64 off in-process under --f32, and its own
subprocess tests are in tests/test_cli.py.

Tolerances (f64): cycle counts are equal; u agrees to 1e-12 absolute
(|u| <= 1; the two sides differ only in the order of the matrix-product
sums of the transfers, ~1e-15 per cycle); each cycle's residual norm
agrees to 1e-10 relative plus 1e-12 of ||f|| (near convergence a norm
approaches its roundoff floor, ~1e-13 ||f|| at 33^3 with 1/h^2 = 1024,
where no relative bound holds); the L2 error agrees to 1e-6 relative.
The mixed-precision solves run their V-cycle in f32, whose transfers
sum in another order on the two sides: a correction that differs by a
few f32 ulps (~1e-7 of the previous residual) leaves a residual that
differs by ~1e-7 / 0.15 of the new one, the cycle's contraction being
~0.15, so their norms agree to 1e-5 relative plus the same floor."""

F32_INNER_RTOL = 1e-5

import contextlib
import dataclasses
import functools
import io
import re

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import multigrid_parallel_tpu as jmg
import multigrid_parallel_tpu_torch as tmg
from multigrid_parallel_tpu.ops import coarse as jcoarse
from multigrid_parallel_tpu_torch import cycles as tcycles
from multigrid_parallel_tpu_torch.__main__ import main as port_main
from multigrid_parallel_tpu_torch.ops import coarse as tcoarse

torch.set_num_threads(1)

PROBLEMS = {"quadratic": "poisson_3d_quadratic", "trig": "poisson_3d_trig",
            "cos1d": "poisson_1d_cos"}


@functools.lru_cache(maxsize=None)
def _jax_solve(fn="solve", problem="quadratic", levels=4, f32=False, use_fmg=False,
               rel_tol=1e-8, **cfg):
    prob = getattr(jmg, PROBLEMS[problem])()
    hier = jmg.Hierarchy(ndim=prob.ndim, coarse_n=5, num_levels=levels,
                         length=prob.length, dtype=jnp.float32 if f32 else jnp.float64)
    out = getattr(jmg, fn)(prob, hier, jmg.CycleConfig(**cfg), rel_tol=rel_tol,
                           **({"use_fmg": use_fmg} if fn in ("solve", "solve_mixed") else {}))
    if fn.startswith("solve_on_device"):
        u, norm, n_cycles, init = out
        return np.asarray(u), norm, n_cycles, init
    return out


def _port_solve(fn="solve", problem="quadratic", levels=4, use_fmg=False, rel_tol=1e-8,
                **cfg):
    prob = getattr(tmg, PROBLEMS[problem])()
    hier = tmg.Hierarchy(ndim=prob.ndim, coarse_n=5, num_levels=levels, length=prob.length)
    kw = {"use_fmg": use_fmg} if fn in ("solve", "solve_mixed") else {}
    return getattr(tmg, fn)(prob, hier, tmg.CycleConfig(**cfg), rel_tol=rel_tol,
                            device="cpu", **kw)


def _assert_norms(got, want, init, rtol=1e-10):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert abs(g - w) <= rtol * w + 1e-12 * init, (g, w)


def _assert_results(got, want, rtol=1e-10):
    assert got.n_cycles == want.n_cycles
    assert got.converged == want.converged
    assert got.initial_residual == pytest.approx(want.initial_residual, rel=1e-15)
    _assert_norms(got.residual_norms, want.residual_norms, want.initial_residual, rtol)
    assert np.abs(got.u.numpy() - np.asarray(want.u)).max() <= 1e-12
    assert got.error_norm == pytest.approx(want.error_norm, rel=1e-6)
    assert got.u.dtype == torch.float64 and got.u.device.type == "cpu"


# ---------------------------------------------------------------- library

SOLVES = {
    "rb": dict(),
    "jacobi": dict(smoother="jacobi"),
    "lex_9": dict(smoother="lex", levels=2),
    "W": dict(gamma=2),
    "W_min17": dict(gamma=2, gamma_min_n=17),
    "fmg": dict(use_fmg=True),
    "inverse": dict(coarse_method="inverse"),
    "mixed": dict(fn="solve_mixed"),
    "1d_rb": dict(problem="cos1d", levels=6),
    "1d_jacobi": dict(problem="cos1d", levels=6, smoother="jacobi"),
    "1d_lex": dict(problem="cos1d", levels=6, smoother="lex"),
}


@pytest.mark.parametrize("name", sorted(SOLVES))
def test_solve_matches_jax(name):
    kw = SOLVES[name]
    got, want = _port_solve(**kw), _jax_solve(**kw)
    _assert_results(got, want, F32_INNER_RTOL if name == "mixed" else 1e-10)
    assert got.converged


def test_33_solve_reference_fingerprint():
    # the reference's 33^3 fingerprint: 14 V-cycles, error ~2.5e-9
    res = _port_solve()
    assert res.converged and res.n_cycles == 14
    assert 2.4e-9 < res.error_norm < 2.6e-9
    assert all(0.1 < r < 0.2 for r in res.residual_ratios[1:])


@pytest.mark.parametrize("fn", ["solve_on_device", "solve_on_device_mixed"])
def test_solve_on_device_matches_jax(fn):
    u, norm, n_cycles, init = _port_solve(fn)
    ju, jnorm, jn_cycles, jinit = _jax_solve(fn)
    assert n_cycles == jn_cycles == 14
    assert isinstance(norm, float) and isinstance(n_cycles, int)
    assert init == pytest.approx(jinit, rel=1e-15)
    rtol = F32_INNER_RTOL if fn == "solve_on_device_mixed" else 1e-10
    assert abs(norm - jnorm) <= rtol * jnorm + 1e-12 * jinit
    assert norm <= 1e-8 * init
    assert np.abs(u.numpy() - ju).max() <= 1e-12


def test_v_cycle_and_fmg_initialize_match_jax():
    tprob, jprob = tmg.poisson_3d_quadratic(), jmg.poisson_3d_quadratic()
    th = tmg.Hierarchy(ndim=3, coarse_n=5, num_levels=3)
    jh = jmg.Hierarchy(ndim=3, coarse_n=5, num_levels=3, dtype=jnp.float64)
    u0, f = tcycles.setup_problem(tprob, th, device="cpu")
    ju0, jf = jmg.cycles.setup_problem(jprob, jh)
    tcs = tcoarse.make_coarse_solver(5, th.spacing(0), torch.float64, "cpu")
    jcs = jcoarse.make_coarse_solver(5, jh.spacing(0), 3, jnp.float64)
    for cfg in (dict(), dict(gamma=2)):
        u, nrm = tmg.v_cycle(u0, f, th, tcs, tmg.CycleConfig(**cfg))
        ju, jnrm = jmg.v_cycle(ju0, jf, jh, jcs, jmg.CycleConfig(**cfg))
        assert np.abs(u.numpy() - np.asarray(ju)).max() <= 1e-13
        assert float(nrm) == pytest.approx(float(jnrm), rel=1e-10)
        assert nrm.shape == ()
    # FMG: the coarse RHS injected from the finest, one V-cycle a level on
    # dataclasses.replace(hier, num_levels=lvl + 1)
    bc = lambda lvl: tmg.hierarchy.evaluate_on_grid(tprob.bc, th, lvl, "cpu")  # noqa: E731
    jbc = lambda lvl: jmg.hierarchy.evaluate_on_grid(jprob.bc, jh, lvl)  # noqa: E731
    got = tmg.fmg_initialize(f, th, tcs, tmg.CycleConfig(), bc)
    want = jmg.fmg_initialize(jf, jh, jcs, jmg.CycleConfig(), jbc)
    assert np.abs(got.numpy() - np.asarray(want)).max() <= 1e-13
    assert dataclasses.replace(th, num_levels=2).sizes == (5, 9)


def test_make_cycle_fn_and_f32_hierarchy():
    # the dtype is threaded explicitly: an f32 hierarchy cycles in f32,
    # within f32 roundoff (|u| <= 1, 1/h^2 = 256) of the f64 cycle
    out = {}
    for dtype in (torch.float32, torch.float64):
        hier = tmg.Hierarchy(ndim=3, coarse_n=5, num_levels=3, dtype=dtype)
        cycle = tcycles.make_cycle_fn(hier, tmg.CycleConfig(), device="cpu")
        u, f = tcycles.setup_problem(tmg.poisson_3d_quadratic(), hier, device="cpu")
        out[dtype] = cycle(u, f)
    u32, nrm32 = out[torch.float32]
    u64, nrm64 = out[torch.float64]
    assert u32.dtype == torch.float32 and nrm32.dtype == torch.float32
    assert float((u32.double() - u64).abs().max()) < 1e-5
    assert float(nrm32) == pytest.approx(float(nrm64), rel=1e-4)


def test_entry_points_default_to_the_card():
    import inspect

    for fn in (tmg.solve, tmg.solve_mixed, tmg.solve_on_device, tmg.solve_on_device_mixed,
               tcycles.make_cycle_fn, tcycles.make_mixed_cycle,
               tcycles.make_on_device_mixed_solver):
        assert inspect.signature(fn).parameters["device"].default == "cuda", fn
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device, where the default runs")
    hier = tmg.Hierarchy(ndim=3, coarse_n=5, num_levels=2)
    with pytest.raises((AssertionError, RuntimeError)):
        tmg.solve(tmg.poisson_3d_quadratic(), hier)


# -------------------------------------------------------------------- CLI


def _cli(*args):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        port_main([*args, "--quiet", "--device", "cpu"])
    out = buf.getvalue()
    m = re.search(r"^cycles: (\d+)   wall time: [0-9.]+ s$", out, re.M)
    assert m, out
    e = re.search(r"^error vs analytic \(L2\): (\S+)$", out, re.M)
    return int(m.group(1)), (float(e.group(1)) if e else None), out


CLI_CASES = {
    "V": ((), dict()),
    "mixed": (("--mixed",), dict(fn="solve_mixed")),
    "fmg": (("--fmg",), dict(use_fmg=True)),
    # at 33^3 a cap of 9 keeps every revisit (the 5^3 level is the direct
    # solve): the same computation as JAX's full W-cycle
    "W_min9": (("--gamma", "2", "--gamma-min", "9"), dict(gamma=2)),
    "jacobi": (("--smoother", "jacobi"), dict(smoother="jacobi")),
    "lex": (("--smoother", "lex"), dict(smoother="lex")),
    "trig": (("--problem", "trig"), dict(problem="trig")),
    "profile": (("--profile",), dict()),
}


@pytest.mark.parametrize("name", sorted(CLI_CASES))
def test_cli_matches_jax_library(name):
    flags, kw = CLI_CASES[name]
    cycles, err, _ = _cli("5", "4", "2", *flags)
    want = _jax_solve(**kw)
    assert cycles == want.n_cycles
    # the printed error has 7 significant digits
    assert err == pytest.approx(want.error_norm, rel=1e-6)


def test_cli_f32_matches_jax_library():
    cycles, err, _ = _cli("5", "4", "2", "--f32", "--tol", "1e-3")
    want = _jax_solve(f32=True, rel_tol=1e-3)
    assert cycles == want.n_cycles
    # at the f32 floor the error is roundoff (the f64 solve's is 2.5e-9):
    # ~6e-8 per point of |u| <= 1, amplified by 1/h^2 = 1024 in the
    # residual, in another summation order on each side; both stay below
    # 1e-4 over the 33^3 points
    assert 1e-6 < err < 1e-4 and 1e-6 < want.error_norm < 1e-4


def test_cli_1d_matches_jax_library():
    cycles, err, _ = _cli("5", "9", "2", "--ndim", "1")
    want = _jax_solve(problem="cos1d", levels=9)
    assert cycles == want.n_cycles
    assert err == pytest.approx(want.error_norm, rel=1e-6)


def test_cli_study_matches_jax_library():
    from multigrid_parallel_tpu.studies import smoother_study

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        port_main(["5", "2", "2", "--study", "--quiet", "--device", "cpu"])
    m = re.search(r"^iters: (\d+)  converged: (\w+)  final ResidRatio: (\S+)  wall: ",
                  buf.getvalue(), re.M)
    assert m, buf.getvalue()
    want = smoother_study(num_levels=2, coarse_n=5, max_iters=5000)
    assert int(m.group(1)) == want.n_iters and m.group(2) == "True"
    assert float(m.group(3)) == pytest.approx(want.final_ratio, abs=1e-6)


def test_cli_vtk_writes_the_error_field(tmp_path):
    from multigrid_parallel_tpu.utils import write_vtk as jwrite_vtk

    out = tmp_path / "port.vtk"
    _cli("5", "3", "2", "--vtk", str(out))
    want = _jax_solve(levels=3)
    jh = jmg.Hierarchy(ndim=3, coarse_n=5, num_levels=3, dtype=jnp.float64)
    exact = jmg.hierarchy.evaluate_on_grid(jmg.poisson_3d_quadratic().analytic, jh, 2)
    ref = tmp_path / "jax.vtk"
    jwrite_vtk(str(ref), np.asarray(want.u) - np.asarray(exact), jh.finest_spacing)
    got_lines, want_lines = out.read_text().splitlines(), ref.read_text().splitlines()
    assert len(got_lines) == len(want_lines)
    # the header and the coordinates are equal text; the error values are
    # printed to 10 digits of fields that agree to ~1e-15 (values ~1e-9)
    n_pts = 17 ** 3
    assert got_lines[:6 + n_pts + 3] == want_lines[:6 + n_pts + 3]
    got_v = np.array(got_lines[6 + n_pts + 3:], dtype=float)
    want_v = np.array(want_lines[6 + n_pts + 3:], dtype=float)
    assert np.abs(got_v - want_v).max() <= 1e-13


ELECTROSPRAY = {
    "V": ((), dict(gamma=1)),
    "mixed": (("--mixed",), dict(gamma=1, on_device=True)),
    "fold_W": (("--fold", "--gamma", "2"), dict(gamma=2, on_device=True)),
    "split_W": (("--split", "--gamma", "2"), dict(gamma=2, on_device=True)),
}


@functools.lru_cache(maxsize=None)
def _jax_electrospray(gamma, on_device=False):
    from multigrid_parallel_tpu.mixed_bc import MixedBCSolver
    from multigrid_parallel_tpu.models.electrospray import electrospray_problem

    prob = electrospray_problem()
    hier = jmg.Hierarchy(ndim=3, coarse_n=5, num_levels=3, length=prob.length,
                         dtype=jnp.float64)
    ms = MixedBCSolver(prob, hier, n_smooth=2, gamma=gamma)
    if on_device:
        return ms.solve_on_device(rel_tol=1e-8, max_cycles=100)[2]
    return len(ms.solve(rel_tol=1e-8, max_cycles=100)[1])


@pytest.mark.parametrize("name", sorted(ELECTROSPRAY))
def test_cli_electrospray_matches_jax_library(name):
    # 17^3: the tiers (full, fold, split) take as many outer steps as
    # JAX's f64-outer solve of the same configuration
    flags, kw = ELECTROSPRAY[name]
    cycles, err, _ = _cli("5", "3", "2", "--electrospray", *flags)
    assert err is None
    assert cycles == _jax_electrospray(**kw)


def test_cli_refuses_what_it_cannot_run(capsys):
    with pytest.raises(SystemExit):
        port_main(["5", "2", "2", "--electrospray", "--fmg", "--device", "cpu"])
    assert "--fmg is not supported" in capsys.readouterr().err
    with pytest.raises(ValueError, match="power of two"):
        port_main(["6", "2", "2", "--quiet", "--device", "cpu"])
    if not torch.cuda.is_available():
        with pytest.raises(SystemExit):
            port_main(["5", "2", "2"])  # --device cuda is the default
        assert "no CUDA device" in capsys.readouterr().err
