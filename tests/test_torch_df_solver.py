"""The port's double-float solver (multigrid_parallel_tpu_torch.
cycles_padded.make_on_device_df_solver) against the JAX package's, from
the same state, and on its own; plus the package's independence from
jax. CPU tensors take the kernels' plain versions."""

import subprocess
import sys
from pathlib import Path

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import multigrid_parallel_tpu as jmg
import multigrid_parallel_tpu_torch as tmg
from multigrid_parallel_tpu import cycles_padded as jcp
from multigrid_parallel_tpu.ops import pallas3d as jpk
from multigrid_parallel_tpu_torch import cycles_padded as tcp
from multigrid_parallel_tpu_torch.hierarchy import evaluate_on_grid
from multigrid_parallel_tpu_torch.ops import pallas3d as tpk
from multigrid_parallel_tpu_torch.utils import convert

torch.set_num_threads(1)


def _error_vs_analytic(u_hi, u_lo, prob, hier):
    u = tpk.df_to_f64(u_hi, u_lo)
    exact = evaluate_on_grid(prob.analytic, hier, hier.num_levels - 1, device="cpu")
    return float(torch.sqrt(torch.sum((u - exact) ** 2)))


def test_df_solve_33_matches_jax():
    n, inner = 33, 4
    jhier = jmg.Hierarchy(ndim=3, coarse_n=5, num_levels=4, dtype=jnp.float64)
    thier = tmg.Hierarchy(ndim=3, coarse_n=5, num_levels=4)
    jprob, tprob = jmg.poisson_3d_quadratic(), tmg.poisson_3d_quadratic()
    init = jcp.ref_init_norm(jprob, jhier)
    assert tcp.ref_init_norm(tprob, thier, device="cpu") == pytest.approx(init, rel=1e-14)

    state = jcp.setup_df_problem(jprob, jhier)
    run_j = jcp.make_on_device_df_solver(jhier, jmg.CycleConfig(n_smooth=2),
                                         rel_tol=1e-8, inner_cycles=inner,
                                         init_norm=init)
    jhi, jlo, jnrm, jit = run_j(*state)
    run_t = tcp.make_on_device_df_solver(thier, tmg.CycleConfig(n_smooth=2),
                                         rel_tol=1e-8, inner_cycles=inner,
                                         init_norm=init, device="cpu")
    thi, tlo, tnrm, tit = run_t(*convert.from_jax_state(*state, n, device="cpu"))

    assert tit == int(jit)
    assert float(tnrm) <= 1e-8 * init and float(jnrm) <= 1e-8 * init
    assert _error_vs_analytic(thi, tlo, tprob, thier) < 5e-8
    u_j = np.asarray(jpk.df_to_f64(jpk.unpad3(jhi, n), jpk.unpad3(jlo, n)))
    u_t = tpk.df_to_f64(thi, tlo).numpy()
    assert np.abs(u_t - u_j).max() <= 1e-8


@pytest.mark.parametrize("cfg", [
    tmg.CycleConfig(n_smooth=2),
    tmg.CycleConfig(n_smooth=2, coarse_method="inverse", gamma=2, gamma_min_n=17),
], ids=["v_cycle_lu", "w_cycle_inverse"])
def test_df_solve_65_reaches_tolerance(cfg):
    hier = tmg.Hierarchy(ndim=3, coarse_n=5, num_levels=5)  # 65^3
    prob = tmg.poisson_3d_quadratic()
    init = tcp.ref_init_norm(prob, hier, device="cpu")
    run = tcp.make_on_device_df_solver(hier, cfg, rel_tol=1e-8, inner_cycles=4,
                                       init_norm=init, device="cpu")
    u_hi, u_lo, nrm, it = run(*tcp.setup_df_problem(prob, hier, device="cpu"))
    assert float(nrm) <= 1e-8 * init and 1 <= it <= 10
    assert u_hi.dtype == torch.float32 and u_hi.shape == (65, 65, 65)
    assert _error_vs_analytic(u_hi, u_lo, prob, hier) < 5e-8


def test_df_solver_stops_at_max_cycles():
    hier = tmg.Hierarchy(ndim=3, coarse_n=5, num_levels=3)
    prob = tmg.poisson_3d_quadratic()
    run = tcp.make_on_device_df_solver(hier, tmg.CycleConfig(), rel_tol=1e-30,
                                       max_cycles=2, inner_cycles=1, device="cpu")
    *_, it = run(*tcp.setup_df_problem(prob, hier, device="cpu"))
    assert it == 2


def test_df_solver_rejects_other_smoothers():
    hier = tmg.Hierarchy(ndim=3, coarse_n=5, num_levels=3)
    with pytest.raises(ValueError, match="rb"):
        tcp.make_on_device_df_solver(hier, tmg.CycleConfig(smoother="jacobi"), device="cpu")


def test_convert_round_trip():
    n = 9
    x = torch.from_numpy(np.random.default_rng(0).standard_normal((n, n, n)))
    padded = convert.to_jax_layout(x, n)
    assert padded.shape == (9, 16, 128) and padded.dtype == np.float64
    assert not padded[:, n:].any() and not padded[:, :, n:].any()
    assert torch.equal(convert.from_jax_layout(padded, n, device="cpu"), x)
    with pytest.raises(ValueError):
        convert.from_jax_layout(padded[:, :n], n, device="cpu")


def test_package_does_not_import_jax():
    code = (
        "import sys\n"
        "import multigrid_parallel_tpu_torch\n"
        "import multigrid_parallel_tpu_torch.cycles_padded as cp\n"
        "import multigrid_parallel_tpu_torch.ops._build\n"
        "import multigrid_parallel_tpu_torch.ops.pallas3d as pk\n"
        "assert cp.make_padded_fmg_bootstrap and cp.make_on_device_mixed_solver_pallas\n"
        "assert pk.residual_restrict_fused and pk.prolong_smooth_fused\n"
        "assert pk.df_step_residual_norm_fused\n"
        "import multigrid_parallel_tpu_torch.cycles_split as cs\n"
        "import multigrid_parallel_tpu_torch.ops.pallas_split as ps\n"
        "assert cs.make_split_df_solver and ps.df_step_split\n"
        "import multigrid_parallel_tpu_torch.mixed_bc as mb\n"
        "import multigrid_parallel_tpu_torch.mixed_padded as mp\n"
        "import multigrid_parallel_tpu_torch.ops.pallas_mixed as pm\n"
        "assert mb.MixedBCSolver and mp.make_mixed_padded_df_solver\n"
        "assert pm.mixed_prolong_smooth_fused\n"
        "import multigrid_parallel_tpu_torch.ops.pallas_mixed_fold as pmf\n"
        "assert mp.make_mixed_fold_df_solver and pmf.mixed_prolong_smooth_fold\n"
        "import multigrid_parallel_tpu_torch.utils.convert\n"
        "assert 'jax' not in sys.modules, 'jax imported'\n"
        "assert 'multigrid_parallel_tpu' not in sys.modules\n"
    )
    subprocess.run([sys.executable, "-c", code], check=True, timeout=120,
                   cwd=Path(__file__).resolve().parent.parent)
