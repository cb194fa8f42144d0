"""The port's electrospray split-colour tier against the JAX package: the
pair layout helpers, pin and value packs, the outer step's BC pass and
the setup state; the msplit kernels K21-K25 (``ops.pallas_mixed_split``,
plain versions on the CPU) against their Pallas kernels in interpret mode
at 17³ f32 and against the port's fold kernels K16-K20; and the tier
``mixed_padded.make_mixed_split_df_solver`` at 33³ against JAX's split
solver and the port's fold tier, and on a 2-level hierarchy, where the
coarse correction comes from the LU solve.

On CPU tensors the wrappers take their plain PyTorch versions; the CUDA
kernels are held against those on the card (tests/test_torch_cuda.py,
chip_smoke.py).

Tolerances:
- Layout helpers, packs, the BC pass, the setup state: equal exactly.
- Kernel fields against the Pallas kernels: within 4 f32 ulp of the
  field's max (tests/test_torch_fold.py's rule). Pallas sums K23's j taps
  and K24's j interpolation as MXU products in the compiler's order.
- K21 / K22 against K16 / K17 through ``split_to_fold``: bit for bit
  (JAX holds its own to that, tests/test_mixed_split.py:82-126); K23 and
  K24 against K18 and K19 within 2e-6 of the max, K25 against K20 within
  1e-6 of the max and its norm to 1e-5 (tests/test_mixed_split.py:146,
  :184, :203-205): the taps and the interpolation go in other orders.
- The 33³ tier against JAX's split solver (configured as
  tests/test_mixed_split.py:248-250): the same outer count, within 1e-7
  V; against the port's fold tier: the same count, within 1e-7 of max|u|
  (tests/test_mixed_split.py:255-257).
"""

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
from multigrid_parallel_tpu.ops import pallas_mixed_split as jpms
from multigrid_parallel_tpu.ops import pallas_split as jpsp
from multigrid_parallel_tpu_torch import mixed_bc as tmb
from multigrid_parallel_tpu_torch import mixed_padded as tmp
from multigrid_parallel_tpu_torch.ops import pallas3d as tpk
from multigrid_parallel_tpu_torch.ops import pallas_mixed as tpm
from multigrid_parallel_tpu_torch.ops import pallas_mixed_fold as tpmf
from multigrid_parallel_tpu_torch.ops import pallas_mixed_split as tpms
from multigrid_parallel_tpu_torch.ops import pallas_split as tps
from multigrid_parallel_tpu_torch.utils import convert

torch.set_num_threads(1)

N = 17
NC = 9
H = 3e-4 / (N - 1)  # the electrospray spacing at 17^3: not a power of two


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _jpair(xr, xb):
    """A port pair in the JAX package's padded split layout."""
    return tuple(jnp.asarray(a) for a in convert.to_jax_split(xr, xb, xr.shape[0]))


def _jpacks(p):
    return jnp.asarray(convert.to_jax_msplit_packs(p, p.shape[2]))


def _jfold(x):
    return jnp.asarray(convert.to_jax_fold(x, x.shape[0]))


def _jplanes(p):
    """Port (2, n, n - 2) sign planes in the JAX package's fold plane layout."""
    n = p.shape[1]
    out = np.zeros((2,) + convert.jax_fold_shape(n)[1:], np.float32)
    out[:, :n, : n - 2] = p.numpy()
    return jnp.asarray(out)


def _from_jpair(pair, n=N):
    return convert.from_jax_split(*pair, n, device="cpu")


def _assert_ulps(got, want, ulps=4):
    got = np.asarray(got, dtype=np.float32)
    want = np.asarray(want, dtype=np.float32)
    assert got.shape == want.shape, (got.shape, want.shape)
    tol = ulps * np.spacing(np.abs(want).max())
    err = np.abs(got.astype(np.float64) - want.astype(np.float64)).max()
    assert err <= tol, (err, tol)


def _assert_pair_ulps(got, want, ulps=4):
    for g, w in zip(got, want):
        _assert_ulps(g, w, ulps)


def _assert_close(got, want, atol_of_max):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= atol_of_max * np.abs(want).max()


def _full_pins(kind, n=N, seed=0):
    """(2, n, n) f32 full pin planes: the electrospray patches at size n,
    or a random x-face mask."""
    if kind == "electrospray":
        return tpm.dirichlet_pin_planes(tmg.electrospray_problem(), n, device="cpu")
    rng = np.random.default_rng(seed)
    return _t((rng.random((2, n, n)) < 0.3).astype(np.float32))


def _bc_pair(rng, n, pin_full, scale=1.0):
    """A random pair packed from an (n, n, n) f32 cube after one BC pass
    (BC-consistent boundary rows, dead slots 0)."""
    x = _t((scale * rng.standard_normal((n, n, n))).astype(np.float32))
    return tps.pack_split(tpm.apply_bcs_padded(x, pin_full))


def _rhs_pair(rng, n):
    x = np.zeros((n, n, n), np.float32)
    x[1:-1, 1:-1, 1:-1] = rng.standard_normal((n - 2,) * 3)
    return tps.pack_split(_t(x))


def _df_pairs(rng, n):
    """An electrospray-like double-float state packed into pairs: volts
    near -1350 on the extractor side, a small f, the x and y faces live."""
    x = np.linspace(0.0, 1.0, n)[:, None, None]
    u64 = -1350.0 * x * x + 1e-3 * rng.standard_normal((n, n, n))
    f64 = 1e3 * rng.standard_normal((n, n, n))
    return [t for a in (u64, f64) for half in tpk.df_split(_t(a)) for t in tps.pack_split(half)]


# ------------------------------------------------------------ the layout


@pytest.mark.parametrize("n", [17, 33])
def test_msplit_helpers_equal_jax(n):
    prob, jprob = tmg.electrospray_problem(), jelectrospray()
    _, sj, skh = jpsp.split_shape(n)
    packs = tpms.msplit_pin_packs(prob, n, device="cpu")
    assert packs.dtype == torch.float32 and bool(packs.any())
    assert torch.equal(packs, convert.from_jax_msplit_packs(
        jpms.msplit_pin_packs(jprob, n, sj, skh), n, device="cpu"))
    rng = np.random.default_rng(n)
    planes = _t(rng.standard_normal((2, n, n)).astype(np.float32))
    assert torch.equal(tpms.msplit_plane_packs(planes), convert.from_jax_msplit_packs(
        jpms.msplit_plane_packs(jnp.asarray(planes.numpy()), n, sj, skh), n, device="cpu"))
    x = _t(rng.standard_normal((n, n, n)).astype(np.float32))
    xf = tpmf.pack_fold(x)
    xr, xb = tpms.fold_to_split(xf)
    assert xr.shape == xb.shape == tps.split_shape(n)
    want = convert.from_jax_split(*jpms.fold_to_split(_jfold(xf), n), n, device="cpu")
    assert torch.equal(xr, want[0]) and torch.equal(xb, want[1])
    # the fold route and pack_split of the cube give the same pair
    pr, pb = tps.pack_split(x)
    assert torch.equal(pr, xr) and torch.equal(pb, xb)
    back = tpms.split_to_fold(xr, xb)
    assert torch.equal(back, xf)
    jback = np.asarray(jpms.split_to_fold(*_jpair(xr, xb), n))
    assert torch.equal(back, convert.from_jax_fold(jback, n, device="cpu"))


def test_msplit_packs_converters_round_trip_and_reject():
    p = _t((np.random.default_rng(1).random((2, 2, 9, 4)) < 0.5).astype(np.float32))
    padded = convert.to_jax_msplit_packs(p, 9)
    assert padded.shape == convert.jax_msplit_packs_shape(9) == (2, 2, 16, 128)
    assert not padded[:, :, 9:].any() and not padded[:, :, :, 4:].any()
    assert torch.equal(convert.from_jax_msplit_packs(padded, 9, device="cpu"), p)
    with pytest.raises(ValueError, match="shape"):
        convert.from_jax_msplit_packs(padded[:, :, :9], 9, device="cpu")
    with pytest.raises(ValueError, match="packs"):
        convert.to_jax_msplit_packs(p[..., :3], 9)
    with pytest.raises(ValueError, match="face planes"):
        tpms.msplit_plane_packs(torch.zeros((2, 9, 7)))


class _PatchOffTheXFaces:
    """A problem whose Dirichlet patch reaches a y face."""

    def boundary_masks(self, n):
        mask = np.zeros((n, n, n), bool)
        mask[n // 2, 0, n // 2] = True
        return mask, np.zeros((n, n, n))


def test_msplit_pin_packs_take_x_face_patches_only():
    with pytest.raises(ValueError, match="i=0/i=n-1"):
        tpms.msplit_pin_packs(_PatchOffTheXFaces(), 9, device="cpu")


def test_apply_bcs_split_pair_equals_jax():
    rng = np.random.default_rng(3)
    ar, ab = tps.pack_split(_t(rng.standard_normal((N, N, N)).astype(np.float32)))
    packs = tpms.msplit_plane_packs(_full_pins("random", seed=3))
    vals = tpms.msplit_plane_packs(_t(rng.standard_normal((2, N, N)).astype(np.float32)))
    for v in (None, vals):
        want = jpms.apply_bcs_split_pair(*_jpair(ar, ab), N, _jpacks(packs),
                                         None if v is None else _jpacks(v))
        got = tpms.apply_bcs_split_pair(ar, ab, packs, v)
        assert all(torch.equal(g, w) for g, w in zip(got, _from_jpair(want)))
    # on the fold field it is the fold tier's BC pass
    fold_vals = tpms._fold_pins(vals)
    got = tpms.split_to_fold(*tpms.apply_bcs_split_pair(ar, ab, packs, vals))
    assert torch.equal(got, tmp.apply_bcs_fold(tpms.split_to_fold(ar, ab),
                                               tpms._fold_pins(packs), fold_vals))


def test_setup_and_unpack_msplit_equal_jax():
    jh = jmg.Hierarchy(ndim=3, coarse_n=5, num_levels=3, length=3e-4)
    js = jmb.MixedBCSolver(jelectrospray(), jh, n_smooth=2)
    s = _port_solver(3)
    jstate = jmp.setup_mixed_split_df_problem(js)
    state = tmp.setup_mixed_split_df_problem(s)
    assert len(state) == 8
    for c in range(4):
        got = state[2 * c : 2 * c + 2]
        want = _from_jpair(jstate[2 * c : 2 * c + 2])
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    # a double-float pair with live values everywhere to re-pin and copy
    rng = np.random.default_rng(2)
    hi, lo = tpk.df_split(_t(-1350.0 * rng.random((N, N, N))))
    pairs = (*tps.pack_split(hi), *tps.pack_split(lo))
    want = np.asarray(jmp.unpack_mixed_split_solution(*_jpair(*pairs[:2]),
                                                      *_jpair(*pairs[2:]), js))
    got = tmp.unpack_mixed_split_solution(*pairs, s)
    assert got.dtype == torch.float64 and got.shape == (N, N, N)
    assert np.array_equal(got.numpy(), want[:N, :N, :N])


# ------------------------------------------------------------- K21 - K25


@pytest.mark.parametrize("pins", ["electrospray", "random"])
@pytest.mark.parametrize("n_iter", [1, 2])
def test_mixed_rb_smooth_msplit_matches_pallas(pins, n_iter):
    rng = np.random.default_rng(10 + n_iter)
    pin_full = _full_pins(pins, seed=n_iter)
    packs = tpms.msplit_plane_packs(pin_full)
    e, r = _bc_pair(rng, N, pin_full), _rhs_pair(rng, N)
    for red_first in (True, False):
        want = jpms.mixed_rb_smooth_msplit(*_jpair(*e), *_jpair(*r), _jpacks(packs), H, n_iter,
                                           N, red_first=red_first, block_i=4)
        et = tuple(x.clone() for x in e)
        got = tpms.mixed_rb_smooth_msplit(*et, *r, packs, H, n_iter, red_first)
        # a fresh pair, the input pair as it was, as on the card
        assert all(g is not x for g in got for x in (*et, *r))
        assert all(torch.equal(a, b) for a, b in zip(et, e))
        _assert_pair_ulps(got, _from_jpair(want))


@pytest.mark.parametrize("pins", ["electrospray", "random"])
@pytest.mark.parametrize("n_iter", [1, 2])
def test_mixed_rb_smooth_from_zero_msplit_matches_pallas(pins, n_iter):
    rng = np.random.default_rng(20 + n_iter)
    packs = tpms.msplit_plane_packs(_full_pins(pins, seed=5 + n_iter))
    r = _rhs_pair(rng, N)
    want = jpms.mixed_rb_smooth_from_zero_msplit(*_jpair(*r), _jpacks(packs), H, n_iter, N,
                                                 red_first=True, block_i=4)
    _assert_pair_ulps(tpms.mixed_rb_smooth_from_zero_msplit(*r, packs, H, n_iter),
                      _from_jpair(want))


@pytest.mark.parametrize("pins", ["electrospray", "random"])
def test_residual_restrict_msplit_matches_pallas(pins):
    """Every coarse fold column (nc - 2 of them, one fewer than the pair's
    slots) against the Pallas kernel's."""
    rng = np.random.default_rng(30)
    e, r = _bc_pair(rng, N, _full_pins(pins, seed=30)), _rhs_pair(rng, N)
    want = jpms.residual_restrict_msplit(*_jpair(*e), *_jpair(*r), H, N, block_i=4)
    got = tpms.residual_restrict_msplit(*e, *r, H)
    assert got.shape == (NC, NC, NC - 2)
    assert not np.asarray(want)[:, :, NC - 2 :].any()  # nothing past the port's columns
    _assert_ulps(got, convert.from_jax_fold(want, NC, device="cpu"))


@pytest.mark.parametrize("delta", ["electrospray", "zero"])
@pytest.mark.parametrize("n_iter", [1, 2])
def test_mixed_prolong_smooth_msplit_matches_pallas(delta, n_iter):
    """K24 with the electrospray's coarse-9 sign planes (the pin-edge delta
    live) and with zero ones (random fine pins); every fine slot."""
    rng = np.random.default_rng(40 + n_iter)
    pin_full = _full_pins("electrospray" if delta == "electrospray" else "random",
                          seed=40 + n_iter)
    packs = tpms.msplit_plane_packs(pin_full)
    if delta == "electrospray":
        sgn_c = tpmf.fold_edge_sign_planes(tmg.electrospray_problem(), NC, device="cpu")
        assert bool(sgn_c.any())  # the case the fix covers
    else:
        sgn_c = torch.zeros((2, NC, NC - 2))
    ec = tpmf.pack_fold(tpm.apply_bcs_padded(
        _t((0.1 * rng.standard_normal((NC,) * 3)).astype(np.float32)), _full_pins("electrospray",
                                                                                   n=NC)))
    e, r = _bc_pair(rng, N, pin_full), _rhs_pair(rng, N)
    want = jpms.mixed_prolong_smooth_msplit(_jfold(ec), *_jpair(*e), *_jpair(*r), _jpacks(packs),
                                            _jplanes(sgn_c), H, n_iter, N, block_i=4,
                                            with_delta=delta == "electrospray")
    e0 = tuple(x.clone() for x in e)
    got = tpms.mixed_prolong_smooth_msplit(ec, *e, *r, packs, sgn_c, H, n_iter)
    assert all(torch.equal(a, b) for a, b in zip(e, e0))  # fresh pair, e untouched
    _assert_pair_ulps(got, _from_jpair(want))


def test_residual_df_norm_msplit_matches_pallas():
    state = _df_pairs(np.random.default_rng(50), N)
    want = jpms.residual_df_norm_msplit(*(a for c in range(4) for a in _jpair(*state[2 * c :
                                                                                 2 * c + 2])),
                                        H, N, block_i=4)
    got = tpms.residual_df_norm_msplit(*state, H)
    _assert_pair_ulps(got[:2], _from_jpair(want[:2]))
    assert float(got[2]) == pytest.approx(float(np.asarray(want[2])), rel=1e-5)


# ----------------------------------------- the msplit kernels against fold


@pytest.mark.parametrize("pins", ["electrospray", "random"])
@pytest.mark.parametrize("n_iter", [1, 2])
def test_msplit_plain_versions_against_fold(pins, n_iter):
    """K21 / K22 equal K16 / K17 bit for bit through split_to_fold; K23,
    K24 and K25 agree with K18, K19 and K20 to JAX's tolerances."""
    rng = np.random.default_rng(60 + n_iter)
    pin_full = _full_pins(pins, seed=60 + n_iter)
    packs, pin = tpms.msplit_plane_packs(pin_full), tpmf.pack_fold(pin_full)
    e, r = _bc_pair(rng, N, pin_full), _rhs_pair(rng, N)
    fe, fr = tpms.split_to_fold(*e), tpms.split_to_fold(*r)
    for red_first in (True, False):
        got = tpms.mixed_rb_smooth_msplit_plain(*e, *r, packs, H, n_iter, red_first)
        assert torch.equal(tpms.split_to_fold(*got),
                           tpmf.mixed_rb_smooth_fold_plain(fe, fr, pin, H, n_iter, red_first))
        got = tpms.mixed_rb_smooth_from_zero_msplit_plain(*r, packs, H, n_iter, red_first)
        assert torch.equal(tpms.split_to_fold(*got),
                           tpmf.mixed_rb_smooth_from_zero_fold_plain(fr, pin, H, n_iter,
                                                                     red_first))
    _assert_close(tpms.residual_restrict_msplit_plain(*e, *r, H),
                  tpmf.residual_restrict_fold_plain(fe, fr, H), 2e-6)
    pin_c = _full_pins("electrospray", n=NC)
    sgn_c = tpmf.fold_edge_sign_planes(tmg.electrospray_problem(), NC, device="cpu")
    ec = tpmf.pack_fold(tpm.apply_bcs_padded(
        _t((0.1 * rng.standard_normal((NC,) * 3)).astype(np.float32)), pin_c))
    got = tpms.mixed_prolong_smooth_msplit_plain(ec, *e, *r, packs, sgn_c, H, n_iter)
    _assert_close(tpms.split_to_fold(*got),
                  tpmf.mixed_prolong_smooth_fold_plain(ec, fe, fr, pin, sgn_c, H, n_iter), 2e-6)
    state = _df_pairs(rng, N)
    r_r, r_b, nrm2 = tpms.residual_df_norm_msplit_plain(*state, H)
    r_f, nrm2_f = tpmf.residual_df_norm_fold_plain(
        *(tpms.split_to_fold(*state[2 * c : 2 * c + 2]) for c in range(4)), H)
    _assert_close(tpms.split_to_fold(r_r, r_b), r_f, 1e-6)
    assert float(nrm2) == pytest.approx(float(nrm2_f), rel=1e-5)


def test_msplit_wrappers_reject_what_the_kernels_do_not_take():
    e = tps.split_shape(9)
    er, eb = torch.zeros(e), torch.zeros(e)
    packs = torch.zeros((2, 2, 9, 4))
    with pytest.raises(ValueError, match="shape"):
        tpms.mixed_rb_smooth_msplit(er, eb, er, eb, torch.zeros((2, 9, 7)), 0.125, 1)
    with pytest.raises(ValueError, match="odd size"):
        tpms.residual_restrict_msplit(*(torch.zeros((8, 8, 3)),) * 4, 0.125)
    with pytest.raises(ValueError, match="different devices"):
        tpms.mixed_rb_smooth_from_zero_msplit(er, eb, torch.zeros((2, 2, 9, 4), device="meta"),
                                              0.125, 1)
    with pytest.raises(ValueError, match="shape"):  # sign planes of the wrong level
        tpms.mixed_prolong_smooth_msplit(torch.zeros((5, 5, 3)), er, eb, er, eb, packs,
                                         torch.zeros((2, 9, 7)), 0.125, 1)
    with pytest.raises(ValueError, match="n_iter"):
        tpms.mixed_prolong_smooth_msplit(torch.zeros((5, 5, 3)), er, eb, er, eb, packs,
                                         torch.zeros((2, 5, 3)), 0.125, 0)
    with pytest.raises(ValueError, match="fold field"):
        tpms.fold_to_split(torch.zeros((9, 9, 9)))


# ------------------------------------------------------- the split tier


def _port_solver(num_levels, coarse_n=5, **kw):
    hier = tmg.Hierarchy(ndim=3, coarse_n=coarse_n, num_levels=num_levels, length=3e-4)
    return tmb.MixedBCSolver(tmg.electrospray_problem(), hier, n_smooth=2, device="cpu", **kw)


def _solve_split(s, inner_cycles=1):
    hr, hb, lr, lb, nrm, it = tmp.make_mixed_split_df_solver(s, rel_tol=1e-8,
                                                             inner_cycles=inner_cycles)(
        *tmp.setup_mixed_split_df_problem(s))
    return tmp.unpack_mixed_split_solution(hr, hb, lr, lb, s), nrm, it


def _solve_fold(s, inner_cycles=1):
    hi, lo, _, it = tmp.make_mixed_fold_df_solver(s, rel_tol=1e-8, inner_cycles=inner_cycles)(
        *tmp.setup_mixed_fold_df_problem(s))
    return tmp.unpack_mixed_fold_solution(hi, lo, s), it


@pytest.fixture(scope="module")
def jax_split_33():
    """JAX's split solver at 33^3 (V-cycles), as tests/test_mixed_split.py
    configures it: (u, count)."""
    jh = jmg.Hierarchy(ndim=3, coarse_n=5, num_levels=4, length=3e-4)
    js = jmb.MixedBCSolver(jelectrospray(), jh, n_smooth=2)
    run = jmp.make_mixed_split_df_solver(js, rel_tol=1e-8, inner_cycles=1, jnp_level_max=9,
                                         block_i=4, smooth_block_i=4, ps_block_i=4, force=True)
    hr, hb, lr, lb, _, it = run(*jmp.setup_mixed_split_df_problem(js))
    return np.asarray(jmp.unpack_mixed_split_solution(hr, hb, lr, lb, js)), int(it)


def test_mixed_split_df_solver_33_matches_jax(jax_split_33):
    s = _port_solver(4)
    state = tmp.setup_mixed_split_df_problem(s)
    assert all(x.shape == (33, 33, 16) for x in state)
    r0 = float(torch.sqrt(tpms.residual_df_norm_msplit(*state, s.hier.spacing(3))[2]))
    u, nrm, it = _solve_split(s)
    assert float(nrm) <= np.float32(1e-8) * np.float32(r0)
    assert u.shape == (33, 33, 33) and u.dtype == torch.float64
    u_j, it_j = jax_split_33
    assert it == it_j
    assert np.abs(u.numpy() - u_j[:33, :33, :33]).max() <= 1e-7


@pytest.mark.parametrize("config", ["V", "W", "V_inner2"])
def test_mixed_split_df_solver_33_matches_fold_tier(config):
    """V and W as the production configuration runs them (one inner
    cycle, every finest-level cycle from zero: K22), and two inner cycles,
    whose second cycle runs K21."""
    s = _port_solver(4, gamma=2 if config == "W" else 1)
    inner = 2 if config == "V_inner2" else 1
    u, _, it = _solve_split(s, inner)
    u_fold, it_fold = _solve_fold(s, inner)
    assert it == it_fold
    assert float((u - u_fold).abs().max()) <= 1e-7 * float(u_fold.abs().max())


def test_mixed_split_two_levels_takes_the_lu_edge_rule(monkeypatch):
    """On a 2-level hierarchy (17^3 over the 9^3 LU level) K24 reads the
    LU solve's correction: with level 0's LU-rule sign planes the tier
    takes the fold tier's 19 outer steps; with the BC-pass rule, 18."""
    s = _port_solver(2, coarse_n=9)
    u, _, it = _solve_split(s)
    u_fold, it_fold = _solve_fold(s)
    assert it == it_fold == 19
    assert float((u - u_fold).abs().max()) <= 1e-7 * float(u_fold.abs().max())
    monkeypatch.setattr(tmp, "_edge_sign_planes", lambda solver, level: tpmf.fold_edge_sign_planes(
        solver.problem, solver.hier.sizes[level], solver.device))
    assert _solve_split(s)[2] == 18


def test_mixed_split_gate_and_band_warning():
    assert tmp.mixed_split_available(_port_solver(2, coarse_n=9))
    one = _port_solver(1, coarse_n=9)
    assert not tmp.mixed_split_available(one)
    with pytest.raises(ValueError, match=">= 2 levels"):
        tmp.make_mixed_split_df_solver(one)
    s = _port_solver(2, coarse_n=9, boundary_band_width=2, boundary_band_iters=2)
    with pytest.warns(UserWarning, match="boundary_band"):
        tmp.make_mixed_split_df_solver(s)


MSPLIT_ENTRY_POINTS = {
    "msplit_pin_packs": tpms.msplit_pin_packs,
    "from_jax_msplit_packs": convert.from_jax_msplit_packs,
}


@pytest.mark.parametrize("name", sorted(MSPLIT_ENTRY_POINTS))
def test_msplit_entry_point_defaults_to_the_card(name):
    assert inspect.signature(MSPLIT_ENTRY_POINTS[name]).parameters["device"].default == "cuda"


def test_msplit_tier_default_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device, where the default runs")
    with pytest.raises((AssertionError, RuntimeError)):
        tpms.msplit_pin_packs(tmg.electrospray_problem(), 9)
