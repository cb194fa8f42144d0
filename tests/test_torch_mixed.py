"""The port's electrospray (mixed-BC) slice against the JAX package: the
model and coarse matrix, the Neumann copy, the mixed smoothing kernels
K13-K15 (``ops.pallas_mixed``) against their Pallas kernels in
interpret mode at 17³ f32, their plain (copy-form) versions against the
fold form the kernels compute, ``mixed_bc.MixedBCSolver`` at 17³ and the
fused-kernel tier ``mixed_padded.make_mixed_padded_df_solver`` at 33³;
plus the reused Dirichlet kernels K3, K4 and K5 at the electrospray's
non-dyadic spacing, and the port's entry points defaulting to the card.

On CPU tensors the wrappers take their plain PyTorch versions; the CUDA
kernels are held against those on the card (tests/test_torch_cuda.py,
chip_smoke.py).

Tolerances:
- ``build_mixed_coarse_matrix``, ``apply_neumann_copy``, the pin planes:
  equal exactly.
- Kernel fields against the Pallas kernels: within 4 f32 ulp of the
  field's max (tests/test_torch_kernels.py's rule). The plain versions
  against the fold form: bit for bit, on BC-consistent inputs (random
  inputs go through a BC pass first).
- ``MixedBCSolver.solve`` (f64) against JAX's: the same cycle count,
  solutions within 1e-10 relative to the largest |u|. ``solve_on_device``
  (f32 inner cycles): the same outer count, within 1e-7 V absolute, as
  tests/test_mixed_bc.py holds it against the host solve.
- The tier against JAX's all-jnp tier (``jnp_level_max=10**9``): the
  same outer count, solutions within 1e-7 V, as tests/test_mixed_bc.py:282
  holds JAX's kernel tier against its reference path.
"""

import inspect

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import multigrid_parallel_tpu as jmg
import multigrid_parallel_tpu_torch as tmg
from multigrid_parallel_tpu import mixed_bc as jmb
from multigrid_parallel_tpu import mixed_padded as jmp
from multigrid_parallel_tpu.models.electrospray import electrospray_problem as jelectrospray
from multigrid_parallel_tpu.ops import pallas3d as jpk
from multigrid_parallel_tpu.ops import pallas_mixed as jpm
from multigrid_parallel_tpu.ops import stencils_3d as jops
from multigrid_parallel_tpu_torch import cycles as tcycles
from multigrid_parallel_tpu_torch import cycles_padded as tcp
from multigrid_parallel_tpu_torch import cycles_split as tcs
from multigrid_parallel_tpu_torch import hierarchy as thier
from multigrid_parallel_tpu_torch import mixed_bc as tmb
from multigrid_parallel_tpu_torch import mixed_padded as tmp
from multigrid_parallel_tpu_torch.ops import pallas3d as tpk
from multigrid_parallel_tpu_torch.ops import pallas_mixed as tpm
from multigrid_parallel_tpu_torch.ops import stencils_3d as tops
from multigrid_parallel_tpu_torch.utils import convert

torch.set_num_threads(1)

N = 17
NC = 9
H = 3e-4 / (N - 1)  # the electrospray spacing at 17^3: not a power of two


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _pad(x):
    return jnp.asarray(convert.to_jax_layout(_t(x), x.shape[0]))


def _pad_pin(pin):
    out = np.zeros((2,) + convert.jax_padded_shape(pin.shape[1])[1:], np.float32)
    out[:, :pin.shape[1], :pin.shape[2]] = pin
    return jnp.asarray(out)


def _assert_ulps(got, want, ulps=4):
    got = np.asarray(got, dtype=np.float32)
    want = np.asarray(want, dtype=np.float32)
    assert got.shape == want.shape, (got.shape, want.shape)
    tol = ulps * np.spacing(np.abs(want).max())
    err = np.abs(got.astype(np.float64) - want.astype(np.float64)).max()
    assert err <= tol, (err, tol)


def _pins(kind, n=N, seed=0):
    """(2, n, n) f32 pin planes: the electrospray patches at size n, or a
    random x-face mask."""
    if kind == "electrospray":
        return tpm.dirichlet_pin_planes(tmg.electrospray_problem(), n, device="cpu").numpy()
    rng = np.random.default_rng(seed)
    return (rng.random((2, n, n)) < 0.3).astype(np.float32)


def _cube(rng, n, boundary=True):
    x = rng.standard_normal((n, n, n)).astype(np.float32)
    if not boundary:
        y = np.zeros_like(x)
        y[1:-1, 1:-1, 1:-1] = x[1:-1, 1:-1, 1:-1]
        x = y
    return x


def _consistent(x, pin):
    """x after one BC pass: the cycle hands the kernels such fields."""
    return tpm.apply_bcs_padded(_t(x), _t(pin)).numpy()


def _fold_stage(e, r, pin, h, n_iter, red_first):
    """Reference of what the kernels compute: RB half-sweeps with the
    copy-BC folded into the stencil (a face-adjacent read returns the
    reader's own value, or 0 at a pinned x-face node; the Pallas
    _mixed_rb_body), then one BC pass."""
    n = e.shape[0]
    red, black, _ = tops._masks(n, e.device)
    idx = torch.arange(n)
    ii, jj, kk = idx[:, None, None], idx[None, :, None], idx[None, None, :]
    p0, p1 = (pin[0] > 0.5)[None], (pin[1] > 0.5)[None]
    zero = torch.zeros((), dtype=e.dtype)
    for _ in range(n_iter):
        for cmask in ((red, black) if red_first else (black, red)):
            im = torch.where(ii == 1, torch.where(p0, zero, e), torch.roll(e, 1, 0))
            ip = torch.where(ii == n - 2, torch.where(p1, zero, e), torch.roll(e, -1, 0))
            jm = torch.where(jj == 1, e, torch.roll(e, 1, 1))
            jp = torch.where(jj == n - 2, e, torch.roll(e, -1, 1))
            km = torch.where(kk == 1, e, torch.roll(e, 1, 2))
            kp = torch.where(kk == n - 2, e, torch.roll(e, -1, 2))
            upd = (im + ip + jm + jp + km + kp - (h * h) * r) * (1.0 / 6.0)
            e = torch.where(cmask, upd, e)
    return tpm.apply_bcs_padded(e, pin)


# ------------------------------------------------ model, matrix, BC pieces


def test_electrospray_masks_match_jax():
    for n in (5, 17):
        tm, tv = tmg.electrospray_problem().boundary_masks(n)
        jm, jv = jelectrospray().boundary_masks(n)
        assert np.array_equal(tm, jm) and np.array_equal(tv, jv)


@pytest.mark.parametrize("kind", ["electrospray", "random"])
def test_build_mixed_coarse_matrix_equals_jax(kind):
    n = 5
    if kind == "electrospray":
        mask, _ = tmg.electrospray_problem().boundary_masks(n)
    else:
        mask = np.random.default_rng(1).random((n, n, n)) < 0.4
    h = 3e-4 / (n - 1)
    assert np.array_equal(tmb.build_mixed_coarse_matrix(n, h, mask),
                          jmb.build_mixed_coarse_matrix(n, h, mask))


def test_apply_neumann_copy_equals_jax():
    u = np.random.default_rng(2).standard_normal((9, 9, 9))
    got = tops.apply_neumann_copy(_t(u))
    assert np.array_equal(got.numpy(), np.asarray(jops.apply_neumann_copy(jnp.asarray(u))))
    # a boundary node holds the interior value at (c(i), c(j), c(k))
    c = np.clip(np.arange(9), 1, 7)
    assert np.array_equal(got.numpy(), u[np.ix_(c, c, c)])


def test_dirichlet_pin_planes_match_jax():
    for n in (5, 17, 33):
        _, sj, sk = convert.jax_padded_shape(n)
        want = jpm.dirichlet_pin_planes(jelectrospray(), n, sj, sk)
        got = tpm.dirichlet_pin_planes(tmg.electrospray_problem(), n, device="cpu")
        assert got.dtype == torch.float32 and got.shape == (2, n, n)
        assert torch.equal(got, convert.from_jax_pin_planes(want, n, device="cpu"))
    with pytest.raises(ValueError, match="shape"):
        convert.from_jax_pin_planes(np.zeros((2, 5, 5)), 5, device="cpu")


def test_dirichlet_pin_planes_reject_other_faces():
    class YFacePatch:
        def boundary_masks(self, n):
            mask = np.zeros((n, n, n), bool)
            mask[n // 2, 0, n // 2] = True
            return mask, np.zeros((n, n, n))

    with pytest.raises(ValueError, match="i=0/i=n-1"):
        tpm.dirichlet_pin_planes(YFacePatch(), 9, device="cpu")


def test_apply_bcs_padded_equals_jax():
    rng = np.random.default_rng(3)
    e = rng.standard_normal((N, N, N)).astype(np.float32)
    pin = _pins("random", seed=3)
    vals = rng.standard_normal((2, N, N)).astype(np.float32)
    for v in (None, vals):
        want = jmp.apply_bcs_padded(_pad(e), N, _pad_pin(pin),
                                    None if v is None else _pad_pin(v))
        got = tpm.apply_bcs_padded(_t(e), _t(pin), None if v is None else _t(v))
        assert np.array_equal(got.numpy(), np.asarray(want)[:, :N, :N])


# ------------------------------------------------------------- K13 - K15


@pytest.mark.parametrize("pins", ["electrospray", "random"])
@pytest.mark.parametrize("n_iter", [1, 2])
def test_mixed_rb_smooth_fused_matches_pallas(pins, n_iter):
    rng = np.random.default_rng(10 + n_iter)
    pin = _pins(pins, seed=n_iter)
    e, r = _consistent(_cube(rng, N), pin), _cube(rng, N, boundary=False)
    for red_first in (True, False):
        want = jpm.mixed_rb_smooth_fused(_pad(e), _pad(r), _pad_pin(pin), H, n_iter, N,
                                         red_first=red_first, block_i=4)
        et = _t(e.copy())
        got = tpm.mixed_rb_smooth_fused(et, _t(r), _t(pin), H, n_iter, red_first)
        assert got is not et and np.array_equal(et.numpy(), e)  # a fresh field, as on the card
        _assert_ulps(got, np.asarray(want)[:, :N, :N])


@pytest.mark.parametrize("pins", ["electrospray", "random"])
@pytest.mark.parametrize("n_iter", [1, 2])
def test_mixed_rb_smooth_from_zero_fused_matches_pallas(pins, n_iter):
    rng = np.random.default_rng(20 + n_iter)
    pin = _pins(pins, seed=5 + n_iter)
    r = _cube(rng, N, boundary=False)
    want = jpm.mixed_rb_smooth_from_zero_fused(_pad(r), _pad_pin(pin), H, n_iter, N,
                                               red_first=True, block_i=4)
    got = tpm.mixed_rb_smooth_from_zero_fused(_t(r), _t(pin), H, n_iter)
    _assert_ulps(got, np.asarray(want)[:, :N, :N])


@pytest.mark.parametrize("pins", ["electrospray", "random"])
@pytest.mark.parametrize("n_iter", [1, 2])
def test_mixed_prolong_smooth_fused_matches_pallas(pins, n_iter):
    # the coarse correction's boundary is live in the mixed case
    rng = np.random.default_rng(30 + n_iter)
    pin = _pins(pins, seed=7 + n_iter)
    ec, e, r = _cube(rng, NC), _cube(rng, N), _cube(rng, N, boundary=False)
    want = jpm.mixed_prolong_smooth_fused(_pad(ec), _pad(e), _pad(r), _pad_pin(pin), H,
                                          n_iter, N, block_i=4)
    et = _t(e.copy())
    got = tpm.mixed_prolong_smooth_fused(_t(ec), et, _t(r), _t(pin), H, n_iter)
    assert got is not et and np.array_equal(et.numpy(), e)  # fresh, e untouched
    _assert_ulps(got, np.asarray(want)[:, :N, :N])


@pytest.mark.parametrize("pins", ["electrospray", "random"])
@pytest.mark.parametrize("n_iter", [1, 2])
def test_mixed_plain_versions_equal_fold_form(pins, n_iter):
    rng = np.random.default_rng(40 + n_iter)
    pin = _t(_pins(pins, seed=9 + n_iter))
    e = _t(_consistent(_cube(rng, N), pin.numpy()))
    ec, r = _t(_cube(rng, NC)), _t(_cube(rng, N, boundary=False))
    for red_first in (True, False):
        assert torch.equal(tpm.mixed_rb_smooth_plain(e, r, pin, H, n_iter, red_first),
                           _fold_stage(e, r, pin, H, n_iter, red_first))
        assert torch.equal(tpm.mixed_rb_smooth_from_zero_plain(r, pin, H, n_iter, red_first),
                           _fold_stage(torch.zeros_like(r), r, pin, H, n_iter, red_first))
    # K15: the fold never reads the boundary, so e + P ec needs no BC pass
    p_ec = tcp.prolong_correct_padded(ec, torch.zeros_like(e), NC)
    e_raw = _t(_cube(rng, N))
    assert torch.equal(tpm.mixed_prolong_smooth_plain(ec, e_raw, r, pin, H, n_iter),
                       _fold_stage(e_raw + p_ec, r, pin, H, n_iter, red_first=False))


def test_mixed_wrappers_reject_bad_pins():
    e, r = torch.zeros((9, 9, 9)), torch.zeros((9, 9, 9))
    with pytest.raises(ValueError, match="pin planes"):
        tpm.mixed_rb_smooth_fused(e, r, torch.zeros((2, 8, 9)), 0.125, 1)
    with pytest.raises(ValueError, match="pin planes on"):
        tpm.mixed_rb_smooth_from_zero_fused(r, torch.zeros((2, 9, 9), device="meta"), 0.125, 1)
    with pytest.raises(ValueError, match="n_iter"):
        tpm.mixed_prolong_smooth_fused(torch.zeros((5, 5, 5)), e, r, torch.zeros((2, 9, 9)),
                                       0.125, 0)


# -------------------------------- K3, K4, K5 at a non-dyadic h (satellite)


def test_residual_restrict_plain_non_dyadic_h_matches_pallas():
    rng = np.random.default_rng(50)
    e, r = _cube(rng, N), _cube(rng, N, boundary=False)  # e: live boundary
    want = jpk.residual_restrict_fused_padded(_pad(e), _pad(r), H, N, block_i=4)
    _assert_ulps(tpk.residual_restrict_fused(_t(e), _t(r), H), np.asarray(want)[:NC, :NC, :NC])


@pytest.mark.parametrize("n_iter", [1, 2])
def test_prolong_smooth_plain_non_dyadic_h_live_coarse_boundary_matches_pallas(n_iter):
    rng = np.random.default_rng(51)
    ec, e, r = _cube(rng, NC), _cube(rng, N), _cube(rng, N, boundary=False)
    want = jpk.prolong_smooth_fused_padded(_pad(ec), _pad(e), _pad(r), H, n_iter, N,
                                           block_i=4)
    got = tpk.prolong_smooth_fused(_t(ec), _t(e), _t(r), H, n_iter)
    _assert_ulps(got, np.asarray(want)[:, :N, :N])


def test_residual_df_norm_plain_non_dyadic_h_matches_pallas():
    # an electrospray-like double-float state: volts near -1350 on the
    # extractor side, a small f, every boundary node live
    rng = np.random.default_rng(52)
    x = np.linspace(0.0, 1.0, N)[:, None, None]
    u64 = -1350.0 * x * x + 1e-3 * rng.standard_normal((N, N, N))
    f64 = 1e3 * rng.standard_normal((N, N, N))
    jstate = [t for a in (u64, f64) for t in jpk.df_split(jnp.asarray(a), pad=True)]
    want_r, want_n = jpk.residual_df_norm_fused_padded(*jstate, H, N, block_i=4)
    tstate = convert.from_jax_state(*jstate, N, device="cpu")
    got_r, got_n = tpk.residual_df_norm_fused(*tstate, H)
    _assert_ulps(got_r, np.asarray(want_r)[:, :N, :N])
    assert float(got_n) == pytest.approx(float(np.asarray(want_n).reshape(-1)[0]), rel=1e-5)


# ----------------------------------------------------------- MixedBCSolver


def _hiers(num_levels):
    jh = jmg.Hierarchy(ndim=3, coarse_n=5, num_levels=num_levels, length=3e-4)
    th = tmg.Hierarchy(ndim=3, coarse_n=5, num_levels=num_levels, length=3e-4)
    return jh, th


BAND = dict(boundary_band_width=2, boundary_band_iters=2)


@pytest.fixture(scope="module")
def jax_17():
    """JAX's MixedBCSolver at 17^3: the host solve, and the on-device
    solve without and with the boundary band."""
    jh, _ = _hiers(3)
    js = jmb.MixedBCSolver(jelectrospray(), jh, n_smooth=2)
    u, norms, init = js.solve(rel_tol=1e-8, max_cycles=60)
    out = {"solver": js, "solve": (np.asarray(u), len(norms), init)}
    for band in (False, True):
        s = jmb.MixedBCSolver(jelectrospray(), jh, n_smooth=2, **(BAND if band else {}))
        u, nrm, it, _ = s.solve_on_device(rel_tol=1e-8, max_cycles=60)
        out[band] = (np.asarray(u), it)
    return out


def _port_solver(num_levels, **kw):
    return tmb.MixedBCSolver(tmg.electrospray_problem(), _hiers(num_levels)[1], n_smooth=2,
                             device="cpu", **kw)


def _assert_solve_matches(got, want):
    u, norms, init = got
    u_j, count_j, init_j = want
    assert len(norms) == count_j
    assert norms[-1] <= 1e-8 * init and init == pytest.approx(init_j, rel=1e-12)
    assert np.abs(u.numpy() - u_j).max() <= 1e-10 * np.abs(u_j).max()


def test_mixed_solver_solve_matches_jax(jax_17):
    s = _port_solver(3)
    u, norms, init = s.solve(rel_tol=1e-8, max_cycles=60)
    assert u.dtype == torch.float64 and u.device.type == "cpu"
    _assert_solve_matches((u, norms, init), jax_17["solve"])


def test_mixed_solver_fed_jax_coarse_factor_matches_jax(jax_17):
    js = jax_17["solver"]
    s = _port_solver(3)
    lu, piv = convert.from_jax_coarse_lu(js._lu_host, js._piv_host)
    # the converted factor solves the port's own matrix
    b = torch.from_numpy(np.random.default_rng(60).standard_normal((125, 1)))
    a = tmb.build_mixed_coarse_matrix(5, 3e-4 / 4, s.problem.boundary_masks(5)[0])
    x = torch.linalg.lu_solve(lu, piv, b).numpy()
    x_ref = np.linalg.solve(a, b.numpy())
    assert np.abs(x - x_ref).max() <= 1e-10 * np.abs(x_ref).max()
    s._lu_host, s._piv_host = lu, piv
    _assert_solve_matches(s.solve(rel_tol=1e-8, max_cycles=60), jax_17["solve"])
    with pytest.raises(ValueError, match="factor"):
        convert.from_jax_coarse_lu(js._lu_host[:, :3], js._piv_host)


@pytest.mark.parametrize("band", [False, True], ids=["no_band", "band"])
def test_mixed_solver_solve_on_device_matches_jax(jax_17, band):
    s = _port_solver(3, **(BAND if band else {}))
    u, nrm, it, init = s.solve_on_device(rel_tol=1e-8, max_cycles=60)
    u_j, it_j = jax_17[band]
    assert it == it_j and nrm <= 1e-8 * init
    assert u.dtype == torch.float64
    assert np.abs(u.numpy() - u_j).max() <= 1e-7


# ------------------------------------------------ the fused-kernel tier


@pytest.mark.parametrize("gamma,gamma_min_n", [(1, 0), (2, 0), (2, 17)],
                         ids=["V", "W", "W_cap17"])
def test_mixed_padded_df_solver_33_matches_jax(gamma, gamma_min_n):
    jh, _ = _hiers(4)
    js = jmb.MixedBCSolver(jelectrospray(), jh, n_smooth=2, gamma=gamma,
                           gamma_min_n=gamma_min_n)
    run = jmp.make_mixed_padded_df_solver(js, rel_tol=1e-8, inner_cycles=1,
                                          jnp_level_max=10**9)
    hi, lo, _, it_j = run(*jmp.setup_mixed_df_problem(js))
    u_j = np.asarray(jmp.unpack_mixed_solution(hi, lo, jh))

    s = _port_solver(4, gamma=gamma, gamma_min_n=gamma_min_n)
    state = tmp.setup_mixed_df_problem(s)
    r0 = float(torch.sqrt(tpk.residual_df_norm_fused(*state, s.hier.spacing(3))[1]))
    hi, lo, nrm, it = tmp.make_mixed_padded_df_solver(s, rel_tol=1e-8, inner_cycles=1)(*state)
    assert it == int(it_j)
    assert float(nrm) <= np.float32(1e-8) * np.float32(r0)
    u = tmp.unpack_mixed_solution(hi, lo, s.hier)
    assert u.shape == (33, 33, 33) and u.dtype == torch.float64
    assert np.abs(u.numpy() - u_j).max() <= 1e-7


def test_mixed_padded_df_solver_warns_on_band():
    s = _port_solver(2, **BAND)
    with pytest.warns(UserWarning, match="boundary_band"):
        tmp.make_mixed_padded_df_solver(s)


# ----------------------------------------------- device defaults (repair)

ENTRY_POINTS = {
    "setup_problem": tcycles.setup_problem,
    "evaluate_on_grid": thier.evaluate_on_grid,
    "make_padded_correction_cycle": tcp.make_padded_correction_cycle,
    "make_padded_fmg_bootstrap": tcp.make_padded_fmg_bootstrap,
    "make_on_device_df_solver": tcp.make_on_device_df_solver,
    "setup_df_problem": tcp.setup_df_problem,
    "ref_init_norm": tcp.ref_init_norm,
    "make_on_device_mixed_solver_pallas": tcp.make_on_device_mixed_solver_pallas,
    "make_split_df_solver": tcs.make_split_df_solver,
    "setup_split_df_problem": tcs.setup_split_df_problem,
    "from_jax_layout": convert.from_jax_layout,
    "from_jax_state": convert.from_jax_state,
    "from_jax_split": convert.from_jax_split,
    "from_jax_pin_planes": convert.from_jax_pin_planes,
    "MixedBCSolver": tmb.MixedBCSolver,
    "dirichlet_pin_planes": tpm.dirichlet_pin_planes,
}


@pytest.mark.parametrize("name", sorted(ENTRY_POINTS))
def test_entry_point_defaults_to_the_card(name):
    assert inspect.signature(ENTRY_POINTS[name]).parameters["device"].default == "cuda"


def test_entry_point_default_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device, where the default runs")
    hier = tmg.Hierarchy(ndim=3, coarse_n=5, num_levels=2, length=3e-4)
    with pytest.raises((AssertionError, RuntimeError)):
        tcp.setup_df_problem(tmg.poisson_3d_quadratic(), hier)
    with pytest.raises((AssertionError, RuntimeError)):
        tmb.MixedBCSolver(tmg.electrospray_problem(), hier)
