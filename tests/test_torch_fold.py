"""The port's electrospray k-fold tier against the JAX package: the fold
layout helpers, pin and sign planes, the fold kernels K16-K20
(``ops.pallas_mixed_fold``, plain versions on the CPU) against their
Pallas kernels in interpret mode at 17³ f32, the fold plain versions
against the full-layout ones they wrap, and the fold tier
``mixed_padded.make_mixed_fold_df_solver`` at 33³ against JAX's fold
solver and the port's own full tier.

On CPU tensors the wrappers take their plain PyTorch versions; the CUDA
kernels are held against those on the card (tests/test_torch_cuda.py,
chip_smoke.py).

Tolerances:
- Layout helpers, pin and sign planes, the setup state: equal exactly.
- Kernel fields against the Pallas kernels: within 4 f32 ulp of the
  field's max (tests/test_torch_mixed.py's rule), K16-K20 alike. Pallas
  sums K18's j and k taps and K19's pin-edge delta band as MXU products
  in the compiler's order, where JAX allows its fold kernels 2e-6 of the
  max against its full ones (tests/test_mixed_fold.py:121,154); here they
  land within 2 ulp (K18) and bit for bit (K19 with the delta).
- The fold plain versions against the pack of the full-layout plain
  versions on BC-consistent input: bit for bit.
- The 33³ fold tier against JAX's fold solver (``jnp_level_max=9``,
  ``block_i=4``): the same outer count, solutions within 1e-7 V (as
  tests/test_torch_mixed.py holds the full tier); against the port's
  full tier: the same count, within 1e-7 of max|u|
  (tests/test_mixed_fold.py:199-201).
"""

import dataclasses
import inspect

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import multigrid_parallel_tpu as jmg
import multigrid_parallel_tpu_torch as tmg
from multigrid_parallel_tpu import mixed_bc as jmb
from multigrid_parallel_tpu import mixed_padded as jmp
from multigrid_parallel_tpu.models.electrospray import electrospray_problem as jelectrospray
from multigrid_parallel_tpu.ops import pallas_mixed_fold as jpmf
from multigrid_parallel_tpu_torch import mixed_bc as tmb
from multigrid_parallel_tpu_torch import mixed_padded as tmp
from multigrid_parallel_tpu_torch.ops import pallas3d as tpk
from multigrid_parallel_tpu_torch.ops import pallas_mixed as tpm
from multigrid_parallel_tpu_torch.ops import pallas_mixed_fold as tpmf
from multigrid_parallel_tpu_torch.utils import convert

torch.set_num_threads(1)

N = 17
NC = 9
H = 3e-4 / (N - 1)  # the electrospray spacing at 17^3: not a power of two


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _jfold(x):
    """A port fold tensor in the JAX package's padded fold layout."""
    return jnp.asarray(convert.to_jax_fold(x, x.shape[0]))


def _jplanes(p):
    """Port (2, n, n - 2) planes in the JAX package's fold plane layout."""
    n = p.shape[1]
    out = np.zeros((2,) + convert.jax_fold_shape(n)[1:], np.float32)
    out[:, :n, : n - 2] = p.numpy()
    return jnp.asarray(out)


def _from_jfold(x, n=N):
    return convert.from_jax_fold(x, n, device="cpu")


def _assert_ulps(got, want, ulps=4):
    got = np.asarray(got, dtype=np.float32)
    want = np.asarray(want, dtype=np.float32)
    assert got.shape == want.shape, (got.shape, want.shape)
    tol = ulps * np.spacing(np.abs(want).max())
    err = np.abs(got.astype(np.float64) - want.astype(np.float64)).max()
    assert err <= tol, (err, tol)


def _full_pins(kind, n=N, seed=0):
    """(2, n, n) f32 full pin planes: the electrospray patches at size n,
    or a random x-face mask."""
    if kind == "electrospray":
        return tpm.dirichlet_pin_planes(tmg.electrospray_problem(), n, device="cpu")
    rng = np.random.default_rng(seed)
    return _t((rng.random((2, n, n)) < 0.3).astype(np.float32))


def _sign_planes(pin_full):
    """fold_edge_sign_planes' rule from full (2, n, n) pin planes."""
    n = pin_full.shape[1]
    sgn = torch.zeros((2, n, n - 2))
    sgn[:, :, 0] = pin_full[:, :, 1] - pin_full[:, :, 0]
    sgn[:, :, n - 3] = pin_full[:, :, n - 2] - pin_full[:, :, n - 1]
    return sgn


def _bc_cube(rng, n, pin_full, scale=1.0):
    """A random (n, n, n) f32 field after one BC pass (BC-consistent)."""
    x = _t((scale * rng.standard_normal((n, n, n))).astype(np.float32))
    return tpm.apply_bcs_padded(x, pin_full)


def _rhs(rng, n):
    x = np.zeros((n, n, n), np.float32)
    x[1:-1, 1:-1, 1:-1] = rng.standard_normal((n - 2,) * 3)
    return _t(x)


# ------------------------------------------------------------ the layout


@pytest.mark.parametrize("n", [17, 33])
def test_fold_helpers_equal_jax(n):
    prob, jprob = tmg.electrospray_problem(), jelectrospray()
    _, sj, skf = convert.jax_fold_shape(n)
    assert tpmf.fold_shape(n) == (n, n, n - 2)
    pin = tpmf.fold_pin_planes(prob, n, device="cpu")
    sgn = tpmf.fold_edge_sign_planes(prob, n, device="cpu")
    assert pin.dtype == sgn.dtype == torch.float32
    assert torch.equal(pin, convert.from_jax_fold_planes(
        jpmf.fold_pin_planes(jprob, n, sj, skf), n, device="cpu"))
    assert torch.equal(sgn, convert.from_jax_fold_planes(
        jpmf.fold_edge_sign_planes(jprob, n, sj, skf), n, device="cpu"))
    # the delta is live only on the coarse levels of this geometry
    assert bool(sgn.any()) == (n <= 17)
    x = _t(np.random.default_rng(n).standard_normal((n, n, n)).astype(np.float32))
    xj = jnp.asarray(convert.to_jax_layout(x, n))
    xf = tpmf.pack_fold(x)
    assert xf.is_contiguous()
    assert torch.equal(xf, _from_jfold(jpmf.pack_fold(xj, n), n))
    assert torch.equal(tpmf.full_to_fold(x), xf)
    assert torch.equal(tpmf.unpack_fold(xf),
                       convert.from_jax_layout(jpmf.unpack_fold(_jfold(xf), n), n, device="cpu"))
    assert torch.equal(tpmf.fold_to_full_rhs(xf),
                       convert.from_jax_layout(jpmf.fold_to_full_rhs(_jfold(xf), n), n,
                                               device="cpu"))


def test_fold_converters_round_trip_and_reject():
    x = _t(np.random.default_rng(1).standard_normal((9, 9, 7)).astype(np.float32))
    padded = convert.to_jax_fold(x, 9)
    assert padded.shape == convert.jax_fold_shape(9) == (9, 16, 128)
    assert not padded[:, 9:].any() and not padded[:, :, 7:].any()
    assert torch.equal(convert.from_jax_fold(padded, 9, device="cpu"), x)
    with pytest.raises(ValueError, match="shape"):
        convert.from_jax_fold(padded[:, :9], 9, device="cpu")
    with pytest.raises(ValueError, match="fold field"):
        convert.to_jax_fold(x[:, :, :5], 9)
    with pytest.raises(ValueError, match="shape"):
        convert.from_jax_fold_planes(np.zeros((2, 9, 7)), 9, device="cpu")


def test_setup_and_unpack_fold_equal_jax():
    jh = jmg.Hierarchy(ndim=3, coarse_n=5, num_levels=3, length=3e-4)
    js = jmb.MixedBCSolver(jelectrospray(), jh, n_smooth=2)
    s = _port_solver(3)
    jstate = jmp.setup_mixed_fold_df_problem(js)
    state = tmp.setup_mixed_fold_df_problem(s)
    for got, want in zip(state, jstate):
        assert torch.equal(got, _from_jfold(want))
    # a double-float fold pair with live k-edge values to re-pin
    rng = np.random.default_rng(2)
    u64 = -1350.0 * rng.random((N, N, N))
    hi, lo = tpk.df_split(_t(u64))
    hi, lo = tpmf.pack_fold(hi), tpmf.pack_fold(lo)
    want = np.asarray(jmp.unpack_mixed_fold_solution(_jfold(hi), _jfold(lo), js))
    got = tmp.unpack_mixed_fold_solution(hi, lo, s)
    assert got.dtype == torch.float64 and got.shape == (N, N, N)
    assert np.array_equal(got.numpy(), want)


def test_apply_bcs_fold_equals_jax():
    rng = np.random.default_rng(3)
    e = _t(rng.standard_normal((N, N, N - 2)).astype(np.float32))
    pin = tpmf.pack_fold(_full_pins("random", seed=3))
    vals = _t(rng.standard_normal((2, N, N - 2)).astype(np.float32))
    for v in (None, vals):
        want = jmp.apply_bcs_fold(_jfold(e), N, _jplanes(pin),
                                  None if v is None else _jplanes(v))
        got = tmp.apply_bcs_fold(e, pin, v)
        assert torch.equal(got, _from_jfold(want))


# ------------------------------------------------------------- K16 - K20


@pytest.mark.parametrize("pins", ["electrospray", "random"])
@pytest.mark.parametrize("n_iter", [1, 2])
def test_mixed_rb_smooth_fold_matches_pallas(pins, n_iter):
    rng = np.random.default_rng(10 + n_iter)
    pin_full = _full_pins(pins, seed=n_iter)
    pin = tpmf.pack_fold(pin_full)
    e, r = tpmf.pack_fold(_bc_cube(rng, N, pin_full)), tpmf.pack_fold(_rhs(rng, N))
    for red_first in (True, False):
        want = jpmf.mixed_rb_smooth_fold(_jfold(e), _jfold(r), _jplanes(pin), H, n_iter, N,
                                         red_first=red_first, block_i=4)
        et = e.clone()
        got = tpmf.mixed_rb_smooth_fold(et, r, pin, H, n_iter, red_first)
        assert got is not et and torch.equal(et, e)  # a fresh field, e as it was, as on the card
        _assert_ulps(got, _from_jfold(want))


@pytest.mark.parametrize("pins", ["electrospray", "random"])
@pytest.mark.parametrize("n_iter", [1, 2])
def test_mixed_rb_smooth_from_zero_fold_matches_pallas(pins, n_iter):
    rng = np.random.default_rng(20 + n_iter)
    pin = tpmf.pack_fold(_full_pins(pins, seed=5 + n_iter))
    r = tpmf.pack_fold(_rhs(rng, N))
    want = jpmf.mixed_rb_smooth_from_zero_fold(_jfold(r), _jplanes(pin), H, n_iter, N,
                                               red_first=True, block_i=4)
    _assert_ulps(tpmf.mixed_rb_smooth_from_zero_fold(r, pin, H, n_iter), _from_jfold(want))


@pytest.mark.parametrize("pins", ["electrospray", "random"])
def test_residual_restrict_fold_matches_pallas(pins):
    rng = np.random.default_rng(30)
    pin_full = _full_pins(pins, seed=30)
    e, r = tpmf.pack_fold(_bc_cube(rng, N, pin_full)), tpmf.pack_fold(_rhs(rng, N))
    want = jpmf.residual_restrict_fold(_jfold(e), _jfold(r), H, N, block_i=4)
    got = tpmf.residual_restrict_fold(e, r, H)
    assert got.shape == (NC, NC, NC - 2)
    _assert_ulps(got, _from_jfold(want, NC))


@pytest.mark.parametrize("delta", ["electrospray", "zero"])
@pytest.mark.parametrize("n_iter", [1, 2])
def test_mixed_prolong_smooth_fold_matches_pallas(delta, n_iter):
    """K19 with the electrospray's coarse-9 sign planes (the pin-edge
    delta live) and with zero ones (random fine pins)."""
    rng = np.random.default_rng(40 + n_iter)
    pin_full = _full_pins("electrospray" if delta == "electrospray" else "random",
                          seed=40 + n_iter)
    pin = tpmf.pack_fold(pin_full)
    pin_c = _full_pins("electrospray", n=NC)
    if delta == "electrospray":
        sgn_c = tpmf.fold_edge_sign_planes(tmg.electrospray_problem(), NC, device="cpu")
        assert bool(sgn_c.any())  # the case the fix covers
    else:
        sgn_c = torch.zeros((2, NC, NC - 2))
    ec = tpmf.pack_fold(_bc_cube(rng, NC, pin_c, scale=0.1))
    e, r = tpmf.pack_fold(_bc_cube(rng, N, pin_full)), tpmf.pack_fold(_rhs(rng, N))
    want = jpmf.mixed_prolong_smooth_fold(_jfold(ec), _jfold(e), _jfold(r), _jplanes(pin),
                                          _jplanes(sgn_c), H, n_iter, N, block_i=4,
                                          with_delta=delta == "electrospray")
    e0 = e.clone()
    got = tpmf.mixed_prolong_smooth_fold(ec, e, r, pin, sgn_c, H, n_iter)
    assert torch.equal(e, e0)  # fresh output, e untouched
    _assert_ulps(got, _from_jfold(want))


def test_residual_df_norm_fold_matches_pallas():
    # an electrospray-like double-float state: volts near -1350 on the
    # extractor side, a small f, the x and y faces live
    rng = np.random.default_rng(50)
    x = np.linspace(0.0, 1.0, N)[:, None, None]
    u64 = -1350.0 * x * x + 1e-3 * rng.standard_normal((N, N, N))
    f64 = 1e3 * rng.standard_normal((N, N, N))
    state = [tpmf.pack_fold(t) for a in (u64, f64) for t in tpk.df_split(_t(a))]
    want_r, want_n = jpmf.residual_df_norm_fold(*(_jfold(t) for t in state), H, N, block_i=4)
    got_r, got_n = tpmf.residual_df_norm_fold(*state, H)
    _assert_ulps(got_r, _from_jfold(want_r))
    assert float(got_n) == pytest.approx(float(np.asarray(want_n)), rel=1e-5)


# ------------------------------- the fold plain versions wrap the full ones


@pytest.mark.parametrize("pins", ["electrospray", "random"])
@pytest.mark.parametrize("n_iter", [1, 2])
def test_fold_plain_versions_equal_full_layout(pins, n_iter):
    """On BC-consistent input each fold plain version is the pack of the
    full-layout one, bit for bit: the fold ties the fold tier to the full
    tier (pallas_mixed, pallas3d)."""
    rng = np.random.default_rng(60 + n_iter)
    pin_full, pin_c = _full_pins(pins, seed=60 + n_iter), _full_pins(pins, n=NC, seed=70)
    pin, sgn_c = tpmf.pack_fold(pin_full), _sign_planes(pin_c)
    e, r = _bc_cube(rng, N, pin_full), _rhs(rng, N)
    ec = _bc_cube(rng, NC, pin_c)
    fe, fr, fec = tpmf.pack_fold(e), tpmf.pack_fold(r), tpmf.pack_fold(ec)
    for red_first in (True, False):
        assert torch.equal(tpmf.mixed_rb_smooth_fold_plain(fe, fr, pin, H, n_iter, red_first),
                           tpmf.pack_fold(tpm.mixed_rb_smooth_plain(e, r, pin_full, H, n_iter,
                                                                    red_first)))
        assert torch.equal(
            tpmf.mixed_rb_smooth_from_zero_fold_plain(fr, pin, H, n_iter, red_first),
            tpmf.pack_fold(tpm.mixed_rb_smooth_from_zero_plain(r, pin_full, H, n_iter,
                                                               red_first)))
    # the sign planes rebuild the coarse k-face edges exactly
    assert torch.equal(tpmf.unpack_coarse(fec, sgn_c), ec)
    assert torch.equal(tpmf.mixed_prolong_smooth_fold_plain(fec, fe, fr, pin, sgn_c, H, n_iter),
                       tpmf.pack_fold(tpm.mixed_prolong_smooth_plain(ec, e, r, pin_full, H,
                                                                     n_iter)))
    assert torch.equal(tpmf.residual_restrict_fold_plain(fe, fr, H),
                       tpmf.pack_fold(tpk.residual_restrict_plain(e, r, H)))
    hi, lo = tpk.df_split(tpm.apply_bcs_padded(e, pin_full).to(torch.float64) * 1e3)
    got = tpmf.residual_df_norm_fold_plain(*(tpmf.pack_fold(x) for x in (hi, lo, r, 0 * r)), H)
    want = tpk.residual_df_norm_plain(hi, lo, r, 0 * r, H)
    assert torch.equal(got[0], tpmf.pack_fold(want[0])) and torch.equal(got[1], want[1])


def test_fold_wrappers_reject_what_the_kernels_do_not_take():
    e, r = torch.zeros((9, 9, 7)), torch.zeros((9, 9, 7))
    pin = torch.zeros((2, 9, 7))
    with pytest.raises(ValueError, match="shape"):
        tpmf.mixed_rb_smooth_fold(e, r, torch.zeros((2, 9, 9)), 0.125, 1)
    with pytest.raises(ValueError, match="shape"):
        tpmf.residual_restrict_fold(torch.zeros((9, 9, 9)), torch.zeros((9, 9, 9)), 0.125)
    with pytest.raises(ValueError, match="different devices"):
        tpmf.mixed_rb_smooth_from_zero_fold(r, torch.zeros((2, 9, 7), device="meta"), 0.125, 1)
    with pytest.raises(ValueError, match="shape"):  # sign planes of the wrong level
        tpmf.mixed_prolong_smooth_fold(torch.zeros((5, 5, 3)), e, r, pin,
                                       torch.zeros((2, 9, 7)), 0.125, 1)
    with pytest.raises(ValueError, match="n_iter"):
        tpmf.mixed_prolong_smooth_fold(torch.zeros((5, 5, 3)), e, r, pin,
                                       torch.zeros((2, 5, 3)), 0.125, 0)


# ------------------------------------------------------- the fold tier


def _port_solver(num_levels, **kw):
    hier = tmg.Hierarchy(ndim=3, coarse_n=5, num_levels=num_levels, length=3e-4)
    return tmb.MixedBCSolver(tmg.electrospray_problem(), hier, n_smooth=2, device="cpu", **kw)


CONFIGS = {"V": dict(gamma=1), "W": dict(gamma=2), "W_cap17": dict(gamma=2, gamma_min_n=17)}


@pytest.fixture(scope="module")
def jax_fold_33():
    """JAX's fold solver at 33^3 (fold kernels at 33 and 17 in interpret
    mode, the full layout at 9 and 5) for each configuration: (u, count)."""
    out = {}
    jh = jmg.Hierarchy(ndim=3, coarse_n=5, num_levels=4, length=3e-4)
    for name, kw in CONFIGS.items():
        js = jmb.MixedBCSolver(jelectrospray(), jh, n_smooth=2, **kw)
        run = jmp.make_mixed_fold_df_solver(js, rel_tol=1e-8, inner_cycles=1, jnp_level_max=9,
                                            block_i=4)
        hi, lo, _, it = run(*jmp.setup_mixed_fold_df_problem(js))
        out[name] = (np.asarray(jmp.unpack_mixed_fold_solution(hi, lo, js)), int(it))
    return out


@pytest.mark.parametrize("config", sorted(CONFIGS))
def test_mixed_fold_df_solver_33_matches_jax_and_full_tier(jax_fold_33, config):
    s = _port_solver(4, **CONFIGS[config])
    state = tmp.setup_mixed_fold_df_problem(s)
    assert all(x.shape == (33, 33, 31) for x in state)
    r0 = float(torch.sqrt(tpmf.residual_df_norm_fold(*state, s.hier.spacing(3))[1]))
    hi, lo, nrm, it = tmp.make_mixed_fold_df_solver(s, rel_tol=1e-8, inner_cycles=1)(*state)
    assert float(nrm) <= np.float32(1e-8) * np.float32(r0)
    u = tmp.unpack_mixed_fold_solution(hi, lo, s)
    assert u.shape == (33, 33, 33) and u.dtype == torch.float64
    u_j, it_j = jax_fold_33[config]
    assert it == it_j
    assert np.abs(u.numpy() - u_j).max() <= 1e-7
    hi, lo, _, it_full = tmp.make_mixed_padded_df_solver(s, rel_tol=1e-8, inner_cycles=1)(
        *tmp.setup_mixed_df_problem(s))
    u_full = tmp.unpack_mixed_solution(hi, lo, s.hier)
    assert it == it_full
    assert float((u - u_full).abs().max()) <= 1e-7 * float(u_full.abs().max())


def test_fold_coarsest_level_takes_the_lu_edge_rule():
    """The coarsest correction comes from the LU solve, whose Neumann rows
    copy a k-face node from its k-edge neighbour pinned or not: the fold
    tier rebuilds its k-face edges by that rule (its sign planes keep
    only the -1 entries), and so takes the full tier's 29 outer steps at
    33^3 (V); the BC-pass rule there would take 27."""
    s = _port_solver(4)
    sgn5 = tpmf.fold_edge_sign_planes(s.problem, 5, device="cpu")
    assert float(sgn5.max()) == 1.0 and not bool((sgn5 < 0).any())
    # the LU output's k-face edge nodes equal the stored copies where the
    # BC-pass rule would add the interior value
    hier32 = dataclasses.replace(s.hier, dtype=torch.float32)
    rhs = tpmf.pack_fold(_rhs(np.random.default_rng(80), 5))
    x = tmp._mixed_coarse32(s, hier32)(tpmf.fold_to_full_rhs(rhs))
    scale = float(x.abs().max())
    edge = sgn5[1, :, 0] > 0  # x = 4, k = 0: the k = 1 neighbour pinned, the node not
    assert bool(edge.any())
    for sgn, close in ((torch.clamp(sgn5, max=0.0), True), (sgn5, False)):
        rebuilt = tpmf.unpack_coarse(tpmf.full_to_fold(x), sgn)
        err = float((rebuilt[4, edge, 0] - x[4, edge, 0]).abs().max())
        assert (err <= 1e-6 * scale) == close, (err, scale)
    _, _, _, it = tmp.make_mixed_fold_df_solver(s, inner_cycles=1)(
        *tmp.setup_mixed_fold_df_problem(s))
    assert it == 29


def test_mixed_fold_df_solver_warns_on_band():
    s = _port_solver(2, boundary_band_width=2, boundary_band_iters=2)
    with pytest.warns(UserWarning, match="boundary_band"):
        tmp.make_mixed_fold_df_solver(s)


FOLD_ENTRY_POINTS = {
    "fold_pin_planes": tpmf.fold_pin_planes,
    "fold_edge_sign_planes": tpmf.fold_edge_sign_planes,
    "from_jax_fold": convert.from_jax_fold,
    "from_jax_fold_planes": convert.from_jax_fold_planes,
}


@pytest.mark.parametrize("name", sorted(FOLD_ENTRY_POINTS))
def test_fold_entry_point_defaults_to_the_card(name):
    assert inspect.signature(FOLD_ENTRY_POINTS[name]).parameters["device"].default == "cuda"


def test_fold_tier_default_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device, where the default runs")
    with pytest.raises((AssertionError, RuntimeError)):
        tpmf.fold_pin_planes(tmg.electrospray_problem(), 9)
