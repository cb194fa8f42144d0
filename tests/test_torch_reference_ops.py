"""The rest of the port's reference stencils against the JAX package's on
the same numpy-seeded inputs: the 3D Jacobi and lexicographic smoothers,
the edge smoothing and the strided-slice oracles (9^3 and 17^3), the
whole 1D stencil module (129 points), and the 1D coarse solve and the
one-shot direct solve in 1D and 3D.

Tolerances: the smoothers, the edge smoothing and the 1D stencils run
the same IEEE f64 operations in the same order on both sides, so they
are held bit for bit; where a side sums in another order (the matrix
forms, LAPACK solves) the bound is stated at the assert."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from multigrid_parallel_tpu.ops import coarse as jcoarse
from multigrid_parallel_tpu.ops import stencils_1d as jops1
from multigrid_parallel_tpu.ops import stencils_3d as jops
from multigrid_parallel_tpu_torch.ops import coarse as tcoarse
from multigrid_parallel_tpu_torch.ops import stencils_1d as tops1
from multigrid_parallel_tpu_torch.ops import stencils_3d as tops

torch.set_num_threads(1)

SIZES = [9, 17]


def _fields(shape, seed):
    rng = np.random.default_rng(seed)
    return rng.standard_normal(shape), rng.standard_normal(shape)


def _t(x):
    return torch.from_numpy(np.array(x))


def _equal(got, want):
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


def _close(got, want, rtol):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    err = np.abs(got - want).max()
    assert err <= rtol * np.abs(want).max(), (err, np.abs(want).max())


# ------------------------------------------------------------------ 3D


@pytest.mark.parametrize("n", SIZES)
def test_jacobi_smooth(n):
    u, f = _fields((n,) * 3, 1)
    h = 1.0 / (n - 1)
    got = tops.jacobi_smooth(_t(u), _t(f), h, 3)
    _equal(got, jops.jacobi_smooth(jnp.asarray(u), jnp.asarray(f), h, 3))


@pytest.mark.parametrize("n", SIZES)
def test_gauss_seidel_lex_bitwise(n):
    # the hyperplane sweep reads what the sequential point loop reads, in
    # the same neighbour order: equal bit for bit
    u, f = _fields((n,) * 3, 2)
    h = 1.0 / (n - 1)
    got = tops.gauss_seidel_lex(_t(u), _t(f), h, 2)
    _equal(got, jops.gauss_seidel_lex(jnp.asarray(u), jnp.asarray(f), h, 2))


def test_gauss_seidel_lex_leaves_input_and_boundary():
    u, f = _fields((9,) * 3, 3)
    ut = _t(u)
    got = tops.gauss_seidel_lex(ut, _t(f), 0.125, 1)
    _equal(ut, u)  # a new tensor, u untouched
    interior = tops._masks(9, torch.device("cpu"))[2]
    _equal(got[~interior], u[~interior.numpy()])


@pytest.mark.parametrize("n", SIZES)
def test_update_edge_values(n):
    u, _ = _fields((n,) * 3, 4)
    _equal(tops.update_edge_values(_t(u)), jops.update_edge_values(jnp.asarray(u)))


@pytest.mark.parametrize("n", SIZES)
def test_slice_oracles_match_jax_and_matrix_forms(n):
    r, ef = _fields((n,) * 3, 5)
    nc = (n + 1) // 2
    ec = np.random.default_rng(6).standard_normal((nc,) * 3)
    _equal(tops.restrict_full_weighting_slices(_t(r)),
           jax.jit(jops.restrict_full_weighting_slices)(jnp.asarray(r)))
    _equal(tops.prolong_correct_slices(_t(ec), _t(ef)),
           jax.jit(jops.prolong_correct_slices)(jnp.asarray(ec), jnp.asarray(ef)))
    # the oracles against the port's matrix forms: the sums run in
    # another order, f64 roundoff of O(10) terms
    _close(tops.restrict_full_weighting_slices(_t(r)), tops.restrict_full_weighting(_t(r)),
           1e-14)
    _close(tops.prolong_correct_slices(_t(ec), _t(ef)),
           tops.prolong_correct(_t(ec), _t(ef)), 1e-14)


def test_masks_are_built_once_per_size_and_device():
    dev = torch.device("cpu")
    assert tops._masks(9, dev) is tops._masks(9, dev)
    assert tops._masks(9, dev) is not tops._masks(17, dev)
    assert tops1._masks(33, dev) is tops1._masks(33, dev)


# ------------------------------------------------------------------ 1D

N1 = 129
H1 = 1.0 / (N1 - 1)


@pytest.mark.parametrize("red_first", [True, False])
def test_1d_rb_smooth(red_first):
    u, f = _fields(N1, 7)
    _equal(tops1.rb_smooth(_t(u), _t(f), H1, 3, red_first=red_first),
           jops1.rb_smooth(jnp.asarray(u), jnp.asarray(f), H1, 3, red_first=red_first))


def test_1d_jacobi_and_lex():
    u, f = _fields(N1, 8)
    _equal(tops1.jacobi_smooth(_t(u), _t(f), H1, 3),
           jops1.jacobi_smooth(jnp.asarray(u), jnp.asarray(f), H1, 3))
    _equal(tops1.gauss_seidel_lex(_t(u), _t(f), H1, 3),
           jops1.gauss_seidel_lex(jnp.asarray(u), jnp.asarray(f), H1, 3))


def test_1d_residual_transfers_and_boundary():
    u, f = _fields(N1, 9)
    ju, jf = jnp.asarray(u), jnp.asarray(f)
    _equal(tops1.residual(_t(u), _t(f), H1), jops1.residual(ju, jf, H1))
    _equal(tops1.residual_norm(_t(u), _t(f), H1), jops1.residual_norm(ju, jf, H1))
    _equal(tops1.restrict_full_weighting(_t(u)), jops1.restrict_full_weighting(ju))
    ec = u[::2]
    _equal(tops1.prolong_correct(_t(ec), _t(f)), jops1.prolong_correct(jnp.asarray(ec), jf))
    _equal(tops1.zero_boundary(_t(u)), jops1.zero_boundary(ju))
    assert tops1.neighbor_sum(_t(u))[5] == u[4] + u[6]


# ------------------------------------------------------- coarse and direct


@pytest.mark.parametrize("method", ["lu", "inverse"])
def test_coarse_solve_1d(method):
    n, h = 17, 1.0 / 16
    _equal(tcoarse.build_coarse_matrix_1d(n, h), jcoarse.build_coarse_matrix_1d(n, h))
    f = np.asarray(jops1.zero_boundary(jnp.asarray(_fields(n, 10)[0])))
    want = jcoarse.make_coarse_solver(n, h, 1, jnp.float64, method)(jnp.asarray(f))
    got = tcoarse.make_coarse_solver(n, h, torch.float64, "cpu", method, ndim=1)(_t(f))
    assert got.shape == (n,)
    _close(got, want, 1e-12)  # two LAPACK solves of a cond~1e2 system


def test_coarse_solver_3d_keeps_its_positional_signature():
    # the 3D callers (cycles_padded, cycles_split, mixed_bc) pass
    # (n, h, dtype, device, method) positionally; ndim defaults to 3
    f = np.asarray(jops.zero_boundary(jnp.asarray(_fields((5,) * 3, 11)[0])))
    a = tcoarse.make_coarse_solver(5, 0.25, torch.float64, "cpu", "lu")(_t(f))
    b = tcoarse.make_coarse_solver(5, 0.25, torch.float64, "cpu", "lu", ndim=3)(_t(f))
    _equal(a, b)
    assert a.shape == (5, 5, 5)


@pytest.mark.parametrize("shape", [(33,), (9, 9, 9)], ids=["1d", "3d"])
def test_direct_solve_poisson(shape):
    f, _ = _fields(shape, 12)
    h = 1.0 / (shape[0] - 1)
    want = jcoarse.direct_solve_poisson(jnp.asarray(f), h)
    got = tcoarse.direct_solve_poisson(_t(f), h)
    assert got.dtype == torch.float64 and got.shape == shape
    # the same LAPACK factorization (getrf) on both sides; the solves may
    # block their sums differently
    _close(got, want, 1e-12)
