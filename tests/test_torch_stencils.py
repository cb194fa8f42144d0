"""The port's f64 stencil oracles, transfers, coarse solve and hierarchy
against the JAX package's (multigrid_parallel_tpu.ops.stencils_3d,
ops.coarse, cycles_padded transfers, hierarchy) on the same
numpy-seeded inputs, at 9^3 and 17^3.

Tolerance: max |port - jax| <= 1e-13 * max |jax| (f64; the two differ
only in the order of the matrix-product sums)."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from multigrid_parallel_tpu import cycles as jcycles
from multigrid_parallel_tpu import cycles_padded as jcp
from multigrid_parallel_tpu import hierarchy as jhier
from multigrid_parallel_tpu import models as jmodels
from multigrid_parallel_tpu.ops import coarse as jcoarse
from multigrid_parallel_tpu.ops import pallas3d as jpk
from multigrid_parallel_tpu.ops import stencils_3d as jops
from multigrid_parallel_tpu_torch import cycles as tcycles
from multigrid_parallel_tpu_torch import cycles_padded as tcp
from multigrid_parallel_tpu_torch import hierarchy as thier
from multigrid_parallel_tpu_torch import models as tmodels
from multigrid_parallel_tpu_torch.ops import coarse as tcoarse
from multigrid_parallel_tpu_torch.ops import stencils_3d as tops

torch.set_num_threads(1)

RTOL = 1e-13
SIZES = [9, 17]


def _fields(n, seed=0):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((n, n, n)), rng.standard_normal((n, n, n))


def _assert_close(got, want, rtol=RTOL):
    got = np.asarray(got, dtype=np.float64)
    want = np.asarray(want, dtype=np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    err = np.abs(got - want).max()
    assert err <= rtol * np.abs(want).max(), (err, np.abs(want).max())


def _t(x):
    return torch.from_numpy(np.array(x))


def test_color_convention_matches():
    assert (tops.RED, tops.BLACK) == (jops.RED, jops.BLACK) == (1, 0)


@pytest.mark.parametrize("n", SIZES)
def test_neighbor_sum_and_zero_boundary(n):
    u, _ = _fields(n)
    _assert_close(tops.neighbor_sum(_t(u)), jops.neighbor_sum(jnp.asarray(u)), 0.0)
    _assert_close(tops.zero_boundary(_t(u)), jops.zero_boundary(jnp.asarray(u)), 0.0)


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("red_first", [True, False])
def test_rb_smooth(n, red_first):
    u, f = _fields(n, 1)
    h = 1.0 / (n - 1)
    got = tops.rb_smooth(_t(u), _t(f), h, 2, red_first=red_first)
    want = jops.rb_smooth(jnp.asarray(u), jnp.asarray(f), h, 2, red_first=red_first)
    _assert_close(got, want)


@pytest.mark.parametrize("n", SIZES)
def test_residual_and_norm(n):
    u, f = _fields(n, 2)
    h = 1.0 / (n - 1)
    _assert_close(tops.residual(_t(u), _t(f), h),
                  jops.residual(jnp.asarray(u), jnp.asarray(f), h))
    _assert_close(tops.residual_norm(_t(u), _t(f), h),
                  jops.residual_norm(jnp.asarray(u), jnp.asarray(f), h))


@pytest.mark.parametrize("n", SIZES)
def test_restrict_full_weighting(n):
    r, _ = _fields(n, 3)
    _assert_close(tops.restrict_full_weighting(_t(r)),
                  jops.restrict_full_weighting(jnp.asarray(r)))


@pytest.mark.parametrize("n", SIZES)
def test_prolong_correct(n):
    nc = (n + 1) // 2
    rng = np.random.default_rng(4)
    ec, ef = rng.standard_normal((nc,) * 3), rng.standard_normal((n,) * 3)
    _assert_close(tops.prolong_correct(_t(ec), _t(ef)),
                  jops.prolong_correct(jnp.asarray(ec), jnp.asarray(ef)))


@pytest.mark.parametrize("n", SIZES)
def test_restrict_padded(n):
    # correction semantics: the input is a residual (zero boundary)
    r = np.asarray(jops.zero_boundary(jnp.asarray(_fields(n, 5)[0])))
    nc = (n + 1) // 2
    want = jpk.unpad3(jcp.restrict_padded(jpk.pad3(jnp.asarray(r)), n), nc)
    _assert_close(tcp.restrict_padded(_t(r), n), want)


@pytest.mark.parametrize("n", SIZES)
def test_prolong_correct_padded(n):
    nc = (n + 1) // 2
    rng = np.random.default_rng(6)
    ec = np.asarray(jops.zero_boundary(jnp.asarray(rng.standard_normal((nc,) * 3))))
    ef = np.asarray(jops.zero_boundary(jnp.asarray(rng.standard_normal((n,) * 3))))
    want = jpk.unpad3(jcp.prolong_correct_padded(
        jpk.pad3(jnp.asarray(ec)), jpk.pad3(jnp.asarray(ef)), nc), n)
    _assert_close(tcp.prolong_correct_padded(_t(ec), _t(ef), nc), want)


@pytest.mark.parametrize("method", ["lu", "inverse"])
def test_coarse_solve(method):
    n, h = 5, 0.25
    np.testing.assert_array_equal(tcoarse.build_coarse_matrix_3d(n, h),
                                  jcoarse.build_coarse_matrix_3d(n, h))
    f = np.asarray(jops.zero_boundary(jnp.asarray(_fields(n, 7)[0])))
    want = jcoarse.make_coarse_solver(n, h, 3, jnp.float64, method)(jnp.asarray(f))
    got = tcoarse.make_coarse_solver(n, h, torch.float64, "cpu", method)(_t(f))
    _assert_close(got, want, 1e-12)  # two LAPACK solves of a cond~1e2 system


def test_coarse_solve_rejects_unknown_method():
    with pytest.raises(ValueError):
        tcoarse.make_coarse_solver(5, 0.25, torch.float64, "cpu", "qr")


def test_hierarchy_matches():
    th = thier.Hierarchy(ndim=3, coarse_n=5, num_levels=4)
    jh = jhier.Hierarchy(ndim=3, coarse_n=5, num_levels=4, dtype=jnp.float64)
    assert th.sizes == jh.sizes == (5, 9, 17, 33)
    assert th.finest_n == jh.finest_n and th.finest_spacing == jh.finest_spacing
    assert [th.spacing(l) for l in range(4)] == [jh.spacing(l) for l in range(4)]
    assert th.dtype == torch.float64
    np.testing.assert_array_equal(thier.boundary_mask(9, 3), jhier.boundary_mask(9, 3))
    with pytest.raises(ValueError):
        thier.Hierarchy(ndim=3, coarse_n=6, num_levels=2)


@pytest.mark.parametrize("name", ["poisson_3d_quadratic", "poisson_3d_trig"])
def test_setup_problem_and_init_norm(name):
    th = thier.Hierarchy(ndim=3, coarse_n=5, num_levels=3)
    jh = jhier.Hierarchy(ndim=3, coarse_n=5, num_levels=3, dtype=jnp.float64)
    tprob, jprob = getattr(tmodels, name)(), getattr(jmodels, name)()
    for got, want in zip(tcycles.setup_problem(tprob, th, device="cpu"),
                         jcycles.setup_problem(jprob, jh)):
        _assert_close(got, want)
    _assert_close(thier.evaluate_on_grid(tprob.analytic, th, 1, device="cpu"),
                  jhier.evaluate_on_grid(jprob.analytic, jh, 1))
    assert tcp.ref_init_norm(tprob, th, device="cpu") == pytest.approx(
        jcp.ref_init_norm(jprob, jh), rel=RTOL)
