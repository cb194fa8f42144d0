"""The fused configuration of the port's double-float solve against the
JAX package: the kernel functions K3 (residual + restriction), K4
(prolongation + correction + black-first RB stage) and K6 (df_add + EFT
residual + norm) against their Pallas kernels in interpret mode at 17³
f32, the fused correction cycle, and at 33³ the unfused and
full-multigrid double-float solves and the f64-outer mixed solver
against the JAX solvers' default paths.

On CPU tensors the wrappers take their plain PyTorch versions; the CUDA
kernels are held against those on the card (tests/test_torch_cuda.py,
chip_smoke.py).

Tolerances: fields within 4 f32 ulp of the field's max, as in
tests/test_torch_kernels.py. K3 sums its 3-taps left to right where the
Pallas kernel's band matrix products sum in the compiler's order, so it
agrees with the Pallas kernel, and with R followed by the matrix-product
restriction (which taps j, k, then i), to that rounding only. K4's
interpolation steps have at most two non-zero taps each, so they round
once in any order: its plain version equals the matrix-product
prolongation followed by the RB stage bit for bit. Solves agree with the
JAX solver in outer-step count and to 1e-8 in the solution, as
tests/test_torch_df_solver.py holds the default (fused) solve.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import multigrid_parallel_tpu as jmg
import multigrid_parallel_tpu_torch as tmg
from multigrid_parallel_tpu import cycles_padded as jcp
from multigrid_parallel_tpu.cycles import setup_problem as jsetup_problem
from multigrid_parallel_tpu.ops import pallas3d as jpk
from multigrid_parallel_tpu_torch import cycles_padded as tcp
from multigrid_parallel_tpu_torch.cycles import setup_problem as tsetup_problem
from multigrid_parallel_tpu_torch.hierarchy import evaluate_on_grid
from multigrid_parallel_tpu_torch.ops import pallas3d as tpk
from multigrid_parallel_tpu_torch.utils import convert

torch.set_num_threads(1)

N = 17
NC = 9
H = 1.0 / (N - 1)


def _zero_boundary_cube(rng, n):
    x = np.zeros((n, n, n), np.float32)
    x[1:-1, 1:-1, 1:-1] = rng.standard_normal((n - 2,) * 3).astype(np.float32)
    return x


def _corrections(seed):
    """(ec, e, r): a coarse correction, a fine one and its RHS, zero
    boundaries, as the V-cycle hands them to K3 and K4."""
    rng = np.random.default_rng(seed)
    return (_zero_boundary_cube(rng, NC), _zero_boundary_cube(rng, N),
            _zero_boundary_cube(rng, N))


def _pad(x):
    return jnp.asarray(convert.to_jax_layout(torch.from_numpy(x), x.shape[0]))


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _assert_ulps(got, want, ulps=4):
    got = np.asarray(got, dtype=np.float32)
    want = np.asarray(want, dtype=np.float32)
    assert got.shape == want.shape, (got.shape, want.shape)
    tol = ulps * np.spacing(np.abs(want).max())
    err = np.abs(got.astype(np.float64) - want.astype(np.float64)).max()
    assert err <= tol, (err, tol)


def _df_state(seed, n=N):
    """A smooth double-float state near a solution, plus a small f32
    correction: the K6 regime."""
    h = 1.0 / (n - 1)
    c = np.arange(n) * h
    x, y, z = np.meshgrid(c, c, c, indexing="ij")
    rng = np.random.default_rng(seed)
    u64 = x * x - 2 * y * y + z * z + 1e-9 * rng.standard_normal((n, n, n))
    f64 = np.sin(x + y + z)
    e = np.zeros((n, n, n), np.float32)
    e[1:-1, 1:-1, 1:-1] = 1e-6 * rng.standard_normal((n - 2,) * 3)
    return u64, f64, e


# ------------------------------------------------------------ K3, K4, K6


def test_residual_restrict_fused_matches_pallas():
    _, e, r = _corrections(30)
    want = jpk.residual_restrict_fused_padded(_pad(e), _pad(r), H, N, block_i=4)
    got = tpk.residual_restrict_fused(_t(e), _t(r), H)
    assert got.shape == (NC, NC, NC)
    _assert_ulps(got, np.asarray(want)[:NC, :NC, :NC])
    # the coarse boundary is exactly zero
    inner = torch.zeros_like(got, dtype=torch.bool)
    inner[1:-1, 1:-1, 1:-1] = True
    assert not got[~inner].any()


def test_residual_restrict_matches_residual_then_restrict():
    # the unfused path (R, then j/k/i matrix products) sums the 27 taps in
    # another order: equal to f32 rounding of the 27-term sum, within
    # 4 ulp of the max
    _, e, r = _corrections(31)
    got = tpk.residual_restrict_fused(_t(e), _t(r), H)
    want = tcp.restrict_padded(tpk.residual_fused(_t(e), _t(r), H), N)
    _assert_ulps(got, want)


@pytest.mark.parametrize("n_iter", [1, 2])
def test_prolong_smooth_fused_matches_pallas(n_iter):
    ec, e, r = _corrections(32)
    want = jpk.prolong_smooth_fused_padded(_pad(ec), _pad(e), _pad(r), H, n_iter, N,
                                           block_i=4)
    et = _t(e)
    got = tpk.prolong_smooth_fused(_t(ec), et, _t(r), H, n_iter)
    assert got is not et and torch.equal(et, _t(e))  # a fresh field, e untouched
    _assert_ulps(got, np.asarray(want)[:, :N, :N])


@pytest.mark.parametrize("n_iter", [1, 2])
def test_prolong_smooth_plain_equals_unfused(n_iter):
    ec, e, r = map(_t, _corrections(33))
    want = tpk.rb_smooth_fused(tcp.prolong_correct_padded(ec, e.clone(), NC), r, H,
                               n_iter, red_first=False)
    assert torch.equal(tpk.prolong_smooth_plain(ec, e, r, H, n_iter), want)


def test_df_step_residual_norm_fused_matches_pallas():
    u64, f64, e = _df_state(34)
    u_hi, u_lo = jpk.df_split(jnp.asarray(u64), pad=True)
    f_hi, f_lo = jpk.df_split(jnp.asarray(f64), pad=True)
    want = jpk.df_step_residual_norm_fused(u_hi, u_lo, _pad(e), f_hi, f_lo, H, N,
                                           block_i=4)
    port = convert.from_jax_state(u_hi, u_lo, f_hi, f_lo, N, device="cpu")
    got = tpk.df_step_residual_norm_fused(port[0], port[1], _t(e), port[2], port[3], H)
    for g, w in zip(got[:3], want[:3]):
        _assert_ulps(g, np.asarray(w)[:, :N, :N])
    # the norms differ only in the order (and, on the JAX side, the f32
    # precision) of the sum of squares
    assert float(got[3]) == pytest.approx(float(want[3]), rel=1e-5)
    assert got[3].dtype == torch.float32 and got[3].shape == ()


def test_df_step_equals_df_add_then_residual():
    u64, f64, e = _df_state(35)
    u_hi, u_lo = tpk.df_split(torch.from_numpy(u64))
    f_hi, f_lo = tpk.df_split(torch.from_numpy(f64))
    o_hi, o_lo, r, nrm2 = tpk.df_step_residual_norm_fused(u_hi, u_lo, _t(e), f_hi, f_lo, H)
    w_hi, w_lo = tpk.df_add(u_hi, u_lo, _t(e))
    w_r, w_nrm2 = tpk.residual_df_norm_fused(w_hi, w_lo, f_hi, f_lo, H)
    for g, w in ((o_hi, w_hi), (o_lo, w_lo), (r, w_r)):
        assert torch.equal(g, w)
    assert float(nrm2) == float(w_nrm2)


def test_fused_wrappers_reject_bad_shapes():
    ec, e, r = map(_t, _corrections(36))
    with pytest.raises(ValueError, match="odd"):
        tpk.residual_restrict_fused(e[:16, :16, :16].contiguous(),
                                    r[:16, :16, :16].contiguous(), H)
    with pytest.raises(ValueError, match="n_iter"):
        tpk.prolong_smooth_fused(ec, e, r, H, 0)
    with pytest.raises(ValueError, match="different devices"):
        tpk.prolong_smooth_fused(ec.to("meta"), e, r, H, 1)


# ------------------------------------------------------- cycle and solves


def test_fused_correction_cycle_matches_jax():
    """17³ with jnp_level_max=5: the JAX cycle runs its fused Pallas
    kernels at 17 and 9 (K2, K3, K4, K1), as the port's fused cycle does."""
    jhier = jmg.Hierarchy(ndim=3, coarse_n=5, num_levels=3, dtype=jnp.float32)
    thier = tmg.Hierarchy(ndim=3, coarse_n=5, num_levels=3, dtype=torch.float32)
    cfg_j, cfg_t = jmg.CycleConfig(n_smooth=2), tmg.CycleConfig(n_smooth=2)
    _, _, r = _corrections(37)
    jcyc = jcp.make_padded_correction_cycle(jhier, cfg_j, jnp_level_max=5)
    want = jcyc(None, _pad(r), from_zero=True)
    want = jcyc(want, _pad(r))
    tcyc = tcp.make_padded_correction_cycle(thier, cfg_t, device="cpu")
    got = tcyc(None, _t(r), from_zero=True)
    got = tcyc(got, _t(r))
    np.testing.assert_allclose(got.numpy(), np.asarray(want)[:, :N, :N],
                               rtol=5e-5, atol=5e-5)


@pytest.fixture(scope="module")
def jax_33():
    """The JAX solvers' default paths at 33³: the double-float solver
    without and with the FMG bootstrap, and the mixed solver."""
    hier = jmg.Hierarchy(ndim=3, coarse_n=5, num_levels=4, dtype=jnp.float64)
    prob = jmg.poisson_3d_quadratic()
    init = jcp.ref_init_norm(prob, hier)
    state = jcp.setup_df_problem(prob, hier)
    out = {"init": init, "state": state}
    for fmg in (False, True):
        run = jcp.make_on_device_df_solver(hier, jmg.CycleConfig(n_smooth=2),
                                           rel_tol=1e-8, inner_cycles=4,
                                           init_norm=init, use_fmg=fmg)
        hi, lo, _, it = run(*state)
        out["fmg" if fmg else "df"] = (
            np.asarray(jpk.df_to_f64(jpk.unpad3(hi, 33), jpk.unpad3(lo, 33))), int(it))
    run = jcp.make_on_device_mixed_solver_pallas(hier, jmg.CycleConfig(n_smooth=2),
                                                 rel_tol=1e-8, inner_cycles=2)
    u, _, it = run(*jsetup_problem(prob, hier))
    out["mixed"] = (np.asarray(u), int(it))
    return out


def _error_vs_analytic(u, prob, hier):
    exact = evaluate_on_grid(prob.analytic, hier, hier.num_levels - 1, device="cpu")
    return float(torch.sqrt(torch.sum((u - exact) ** 2)))


@pytest.mark.parametrize("fused,use_fmg", [(False, False), (True, True)],
                         ids=["unfused", "fmg_fused"])
def test_df_solve_33_matches_jax_default_path(jax_33, fused, use_fmg):
    # the fused default is tests/test_torch_df_solver.py::test_df_solve_33_matches_jax
    hier = tmg.Hierarchy(ndim=3, coarse_n=5, num_levels=4)
    prob = tmg.poisson_3d_quadratic()
    init = jax_33["init"]
    run = tcp.make_on_device_df_solver(hier, tmg.CycleConfig(n_smooth=2), rel_tol=1e-8,
                                       inner_cycles=4, init_norm=init, fused=fused,
                                       use_fmg=use_fmg, device="cpu")
    hi, lo, nrm, it = run(*convert.from_jax_state(*jax_33["state"], 33, device="cpu"))
    u_j, it_j = jax_33["fmg" if use_fmg else "df"]
    assert it == it_j
    assert float(nrm) <= 1e-8 * init
    u = tpk.df_to_f64(hi, lo)
    assert np.abs(u.numpy() - u_j).max() <= 1e-8
    assert _error_vs_analytic(u, prob, hier) < 5e-8


def test_mixed_solver_pallas_33_matches_jax(jax_33):
    hier = tmg.Hierarchy(ndim=3, coarse_n=5, num_levels=4)
    prob = tmg.poisson_3d_quadratic()
    run = tcp.make_on_device_mixed_solver_pallas(hier, tmg.CycleConfig(n_smooth=2),
                                                 rel_tol=1e-8, inner_cycles=2, device="cpu")
    u0, f = tsetup_problem(prob, hier, device="cpu")
    u, nrm, it = run(u0, f)
    u_j, it_j = jax_33["mixed"]
    assert it == it_j
    assert float(nrm) <= 1e-8 * float(torch.sqrt(torch.sum(f * f)))
    assert u.dtype == torch.float64
    assert np.abs(u.numpy() - u_j).max() <= 1e-8
    assert _error_vs_analytic(u, prob, hier) < 2e-8


def test_fmg_df_solver_reduces_outer_steps():
    """Port twin of tests/test_fused_kernels.py's test of the same name:
    the FMG bootstrap saves outer steps at equal accuracy."""
    hier = tmg.Hierarchy(ndim=3, coarse_n=5, num_levels=4)  # 33^3
    prob = tmg.poisson_3d_quadratic()
    state = tcp.setup_df_problem(prob, hier, device="cpu")
    outs = {}
    for fmg in (False, True):
        run = tcp.make_on_device_df_solver(hier, tmg.CycleConfig(n_smooth=2),
                                           rel_tol=1e-8, inner_cycles=1, use_fmg=fmg, device="cpu")
        u_hi, u_lo, _, n_outer = run(*state)
        err = _error_vs_analytic(tpk.df_to_f64(u_hi, u_lo), prob, hier)
        assert err < 2e-8, (fmg, err)
        outs[fmg] = n_outer
    assert outs[True] < outs[False], outs
