"""The split-colour finest level of the port's double-float solve
(multigrid_parallel_tpu_torch.ops.pallas_split, K7-K12, and
cycles_split) against the JAX package: each kernel's plain version
against its Pallas kernel in interpret mode at 17³ (f64), against the
port's rect twin through pack / unpack, the split setup, and the 33³
split solve against the JAX split solver and the port's fused rect one.

On CPU tensors the wrappers take their plain PyTorch versions; the CUDA
kernels are held against those on the card (tests/test_torch_cuda.py,
chip_smoke.py).

Tolerances. Against the Pallas kernels: 1e-12 relative to the field's
scale in f64, as tests/test_split.py holds the Pallas kernels against
their rect oracles; the plain versions take the Pallas split operation
order, so they agree to f64 rounding of the MXU band products at most.
Against the port's rect plain versions: the same 1e-12, because the
split neighbour order differs from the rect one (a few f64 ulp). df_add
is elementwise, so K11's updated pair is held bitwise. Solves: the JAX
split solver's outer-step count and its solution to 1e-8 (the rule of
tests/test_torch_df_solver.py), the port's fused rect solve's count and
its solution to 5e-9 (the rule of tests/test_split.py).
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import multigrid_parallel_tpu as jmg
import multigrid_parallel_tpu_torch as tmg
from multigrid_parallel_tpu import cycles_padded as jcp
from multigrid_parallel_tpu import cycles_split as jcs
from multigrid_parallel_tpu.ops import pallas3d as jpk
from multigrid_parallel_tpu.ops import pallas_split as jps
from multigrid_parallel_tpu_torch import cycles_padded as tcp
from multigrid_parallel_tpu_torch import cycles_split as tcs
from multigrid_parallel_tpu_torch.hierarchy import evaluate_on_grid
from multigrid_parallel_tpu_torch.ops import pallas3d as tpk
from multigrid_parallel_tpu_torch.ops import pallas_split as tps
from multigrid_parallel_tpu_torch.utils import convert

torch.set_num_threads(1)

N = 17
NC = 9
S = (N - 1) // 2
H = 1.0 / (N - 1)


def _cube(rng, n=N, boundary=False, scale=1.0):
    """Random f64 (n, n, n) field with zero k faces: interior only (a
    correction), or with the i / j boundary rows too (a solution)."""
    x = np.zeros((n, n, n))
    if boundary:
        x[:, :, 1:-1] = scale * rng.standard_normal((n, n, n - 2))
    else:
        x[1:-1, 1:-1, 1:-1] = scale * rng.standard_normal((n - 2,) * 3)
    return x


def _pair(x):
    return tps.pack_split(torch.from_numpy(x))


def _jpair(pair, n=N):
    return tuple(jnp.asarray(a) for a in convert.to_jax_split(*pair, n))


def _close(got, want, tol=1e-12):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol * max(1.0, np.abs(want).max()))


def _close_pair(got, want_jax):
    for g, w in zip(got, convert.from_jax_split(*want_jax, N, device="cpu")):
        _close(g, w)


def _coarse(rng):
    """A rect coarse correction, zero boundary, and its JAX k-trim form."""
    ec = np.zeros((NC, NC, NC))
    ec[1:-1, 1:-1, 1:-1] = rng.standard_normal((NC - 2,) * 3)
    _, sjc, skc = jpk.padded_shape_trim(NC)
    jec = np.zeros((NC, sjc, skc))
    jec[:, :NC, : NC - 1] = ec[:, :, : NC - 1]
    return torch.from_numpy(ec), jnp.asarray(jec)


# --------------------------------------------------------------- layout


def test_pack_unpack_round_trip_matches_jax():
    rng = np.random.default_rng(0)
    x = _cube(rng, boundary=True)
    xr, xb = _pair(x)
    assert xr.shape == xb.shape == tps.split_shape(N) == (N, N, S)
    assert torch.equal(tps.unpack_split(xr, xb), torch.from_numpy(x))
    # the dead slot of every row is exactly 0: the last slot of the colour
    # holding the row's even k's (black where i + j is even, red elsewhere)
    q = (np.arange(N)[:, None] + np.arange(N)[None, :]) % 2
    assert not xr[..., -1][torch.from_numpy(q == 1)].any()
    assert not xb[..., -1][torch.from_numpy(q == 0)].any()
    assert xr[..., -1][torch.from_numpy(q == 0)].all()
    # the same pair as the JAX package packs from its padded layout
    want = jps.pack_split(jnp.asarray(convert.to_jax_layout(torch.from_numpy(x), N)), N)
    for g, w in zip((xr, xb), convert.from_jax_split(*want, N, device="cpu")):
        assert torch.equal(g, w)


def test_convert_split_round_trip():
    rng = np.random.default_rng(1)
    pair = _pair(_cube(rng, boundary=True))
    jr, jb = convert.to_jax_split(*pair, N)
    assert jr.shape == convert.jax_split_shape(N) == (N, 24, 128)
    assert not jr[:, N:].any() and not jb[:, :, S:].any()
    back = convert.from_jax_split(jr, jb, N, device="cpu")
    assert all(torch.equal(a, b) for a, b in zip(back, pair))
    with pytest.raises(ValueError):
        convert.from_jax_split(jr[:, :N], jb, N, device="cpu")


# ------------------------------------------ K7-K12 against Pallas (f64)


@pytest.mark.parametrize("red_first", [True, False], ids=["red_first", "black_first"])
def test_rb_smooth_split_matches_pallas(red_first):
    rng = np.random.default_rng(2)
    e, r = _pair(_cube(rng)), _pair(_cube(rng))
    want = jps.rb_smooth_split(*_jpair(e), *_jpair(r), H, 2, N, red_first=red_first,
                               block_i=4)
    got = tps.rb_smooth_split(e[0].clone(), e[1].clone(), *r, H, 2, red_first)
    _close_pair(got, want)


def test_rb_smooth_split_from_zero_matches_pallas():
    rng = np.random.default_rng(3)
    r = _pair(_cube(rng))
    want = jps.rb_smooth_split_from_zero(*_jpair(r), H, 2, N, red_first=True, block_i=4)
    got = tps.rb_smooth_split_from_zero(*r, H, 2)
    _close_pair(got, want)


def test_residual_restrict_split_matches_pallas():
    rng = np.random.default_rng(4)
    e, r = _pair(_cube(rng)), _pair(_cube(rng))
    want = np.asarray(jps.residual_restrict_split(*_jpair(e), *_jpair(r), H, N, block_i=2))
    got = tps.residual_restrict_split(*e, *r, H)
    assert got.shape == (NC, NC, NC)
    # the JAX coarse RHS is k-trim: it stores k < NC - 1, the port's last
    # k plane is the (zero) coarse boundary
    _close(got[:, :, : NC - 1], want[:NC, :NC, : NC - 1])
    assert not got[:, :, NC - 1].any()


def test_prolong_smooth_split_matches_pallas():
    rng = np.random.default_rng(5)
    ec, jec = _coarse(rng)
    e, r = _pair(_cube(rng)), _pair(_cube(rng))
    want = jps.prolong_smooth_split(jec, *_jpair(e), *_jpair(r), H, 2, N, block_i=4)
    e0 = tuple(x.clone() for x in e)
    got = tps.prolong_smooth_split(ec, *e, *r, H, 2)
    assert all(torch.equal(a, b) for a, b in zip(e, e0))  # a fresh pair, e untouched
    _close_pair(got, want)


def _df_split_state(seed):
    """(u_hi, u_lo, e, f_hi, f_lo) pairs, f64: a solution with its i / j
    boundary rows, a correction, an RHS."""
    rng = np.random.default_rng(seed)
    return (_pair(_cube(rng, boundary=True)), _pair(_cube(rng, boundary=True, scale=1e-8)),
            _pair(_cube(rng, scale=1e-3)), _pair(_cube(rng, boundary=True)),
            _pair(_cube(rng, boundary=True, scale=1e-8)))


def test_df_step_split_matches_pallas():
    uh, ul, e, fh, fl = _df_split_state(6)
    want = jps.df_step_split(*_jpair(uh), *_jpair(ul), *_jpair(e), *_jpair(fh),
                             *_jpair(fl), H, N, block_i=4)
    got = tps.df_step_split(*uh, *ul, *e, *fh, *fl, H)
    for k in range(0, 6, 2):
        _close_pair(got[k:k + 2], want[k:k + 2])
    assert float(got[6]) == pytest.approx(float(want[6]), rel=1e-12)


def test_residual_df_norm_split_matches_pallas():
    uh, ul, _, fh, fl = _df_split_state(7)
    want = jps.residual_df_norm_split(*_jpair(uh), *_jpair(ul), *_jpair(fh), *_jpair(fl),
                                      H, N, block_i=4)
    got = tps.residual_df_norm_split(*uh, *ul, *fh, *fl, H)
    _close_pair(got[:2], want[:2])
    assert float(got[2]) == pytest.approx(float(want[2]), rel=1e-12)
    assert got[2].shape == () and got[2].dtype == torch.float64


def test_df_step_split_df_add_is_bitwise():
    # df_add is elementwise: K11's updated pair equals the JAX df_add (f32)
    uh, ul, e, fh, fl = (tuple(x.float() for x in p) for p in _df_split_state(8))
    got = tps.df_step_split(*uh, *ul, *e, *fh, *fl, H)
    for c in range(2):
        hi, lo = jpk.df_add(jnp.asarray(uh[c].numpy()), jnp.asarray(ul[c].numpy()),
                            jnp.asarray(e[c].numpy()))
        assert np.array_equal(got[c].numpy(), np.asarray(hi))
        assert np.array_equal(got[2 + c].numpy(), np.asarray(lo))


# ------------------------------------ plain versions against the rect ones


@pytest.mark.parametrize("red_first", [True, False], ids=["red_first", "black_first"])
def test_rb_smooth_split_matches_rect(red_first):
    rng = np.random.default_rng(9)
    e, r = _cube(rng), _cube(rng)
    want = tpk.rb_smooth_plain(torch.from_numpy(e), torch.from_numpy(r), H, 2, red_first)
    got = tps.unpack_split(*tps.rb_smooth_split_plain(*_pair(e), *_pair(r), H, 2, red_first))
    _close(got, want)


def test_rb_smooth_split_from_zero_matches_rect():
    r = _cube(np.random.default_rng(10))
    want = tpk.rb_smooth_from_zero_plain(torch.from_numpy(r), H, 2)
    _close(tps.unpack_split(*tps.rb_smooth_split_from_zero(*_pair(r), H, 2)), want)


def test_residual_restrict_split_matches_rect():
    rng = np.random.default_rng(11)
    e, r = _cube(rng), _cube(rng)
    want = tpk.residual_restrict_plain(torch.from_numpy(e), torch.from_numpy(r), H)
    _close(tps.residual_restrict_split(*_pair(e), *_pair(r), H), want)


@pytest.mark.parametrize("n_iter", [1, 2])
def test_prolong_smooth_split_matches_rect(n_iter):
    rng = np.random.default_rng(12)
    ec, _ = _coarse(rng)
    e, r = _cube(rng), _cube(rng)
    want = tpk.prolong_smooth_plain(ec, torch.from_numpy(e), torch.from_numpy(r), H, n_iter)
    got = tps.prolong_smooth_split(ec, *_pair(e), *_pair(r), H, n_iter)
    _close(tps.unpack_split(*got), want)


def test_residual_df_norm_split_matches_rect():
    uh, ul, _, fh, fl = _df_split_state(13)
    cubes = [tps.unpack_split(*p) for p in (uh, ul, fh, fl)]
    r, nrm2 = tpk.residual_df_norm_plain(*cubes, H)
    got = tps.residual_df_norm_split(*uh, *ul, *fh, *fl, H)
    _close(tps.unpack_split(*got[:2]), r)
    assert float(got[2]) == pytest.approx(float(nrm2), rel=1e-12)


def test_split_wrappers_reject_what_the_kernels_do_not_take():
    rng = np.random.default_rng(14)
    e, r = _pair(_cube(rng))
    with pytest.raises(ValueError, match="shape"):
        tps.rb_smooth_split(e, r[:, :, :-1].contiguous(), e, r, H, 1)
    with pytest.raises(ValueError, match="odd"):
        tps.residual_restrict_split(*(torch.zeros((16, 16, 7)),) * 4, H)
    with pytest.raises(ValueError, match="shape"):  # the coarse field
        tps.prolong_smooth_split(torch.zeros((NC, NC, NC - 1), dtype=e.dtype), e, r, e, r,
                                 H, 1)
    with pytest.raises(TypeError):
        tps.residual_df_norm_split(e, r, e, r, e, r, e.float(), r, H)
    with pytest.raises(ValueError, match="different devices"):
        tps.rb_smooth_split_from_zero(e.to("meta"), r, H, 1)
    with pytest.raises(ValueError, match="no kernel"):
        tps.rb_smooth_split_from_zero(e.to("meta"), r.to("meta"), H, 1)
    with pytest.raises(ValueError, match="n_iter"):
        tps.prolong_smooth_split(torch.zeros((NC,) * 3, dtype=e.dtype), e, r, e, r, H, 0)


# ------------------------------------------------------------------ solves


@pytest.fixture(scope="module")
def jax_split_33():
    """The JAX split solver at 33³ (force=True: the lane gate of the TPU
    would refuse 33), inner 4, from its own setup."""
    hier = jmg.Hierarchy(ndim=3, coarse_n=5, num_levels=4, dtype=jnp.float64)
    prob = jmg.poisson_3d_quadratic()
    init = jcp.ref_init_norm(prob, hier)
    state = jcs.setup_split_df_problem(prob, hier)
    run = jcs.make_split_df_solver(hier, jmg.CycleConfig(n_smooth=2), rel_tol=1e-8,
                                   inner_cycles=4, init_norm=init, force=True)
    hr, hb, lr, lb, _, it = run(*state)
    return {"init": init, "state": state, "it": int(it),
            "u": np.asarray(jcs.unsplit_solution(hr, hb, lr, lb, prob, hier))}


def _hier33():
    return tmg.Hierarchy(ndim=3, coarse_n=5, num_levels=4)


def _split_solve(hier, cfg, state=None):
    prob = tmg.poisson_3d_quadratic()
    init = tcp.ref_init_norm(prob, hier, device="cpu")
    run = tcs.make_split_df_solver(hier, cfg, rel_tol=1e-8, inner_cycles=4, init_norm=init,
                                   device="cpu")
    hr, hb, lr, lb, nrm, it = run(*(state or tcs.setup_split_df_problem(prob, hier, device="cpu")))
    assert float(nrm) <= 1e-8 * init
    return tcs.unsplit_solution(hr, hb, lr, lb, prob, hier), it


def _rect_solve(hier, cfg):
    prob = tmg.poisson_3d_quadratic()
    run = tcp.make_on_device_df_solver(hier, cfg, rel_tol=1e-8, inner_cycles=4,
                                       init_norm=tcp.ref_init_norm(prob, hier, device="cpu"),
                                       device="cpu")
    hi, lo, _, it = run(*tcp.setup_df_problem(prob, hier, device="cpu"))
    return tpk.df_to_f64(hi, lo), it


def test_setup_split_matches_jax(jax_split_33):
    got = tcs.setup_split_df_problem(tmg.poisson_3d_quadratic(), _hier33(), device="cpu")
    want = jax_split_33["state"]
    for c in range(0, 8, 2):
        for g, w in zip(got[c:c + 2], convert.from_jax_split(*want[c:c + 2], 33, device="cpu")):
            assert g.dtype == torch.float32 and torch.equal(g, w)


def test_split_solve_33_matches_jax(jax_split_33):
    state = [t for c in range(0, 8, 2)
             for t in convert.from_jax_split(*jax_split_33["state"][c:c + 2], 33, device="cpu")]
    u, it = _split_solve(_hier33(), tmg.CycleConfig(n_smooth=2), state)
    assert it == jax_split_33["it"]
    assert u.dtype == torch.float64 and u.shape == (33, 33, 33)
    assert np.abs(u.numpy() - jax_split_33["u"]).max() <= 1e-8
    exact = evaluate_on_grid(tmg.poisson_3d_quadratic().analytic, _hier33(), 3, device="cpu")
    assert float(torch.sqrt(torch.sum((u - exact) ** 2))) < 5e-8


@pytest.mark.parametrize("gamma,gamma_min_n", [(1, 0), (2, 0), (2, 17)],
                         ids=["v_cycle", "w_cycle", "w_cycle_min17"])
def test_split_solve_33_matches_fused_rect(gamma, gamma_min_n):
    """gamma = 2 exercises the revisits of the rect sub-cycle; with
    gamma_min_n = 17 the top revisit stays ((n + 1) / 2 = 17) and the
    sub-tree drops those below 17."""
    cfg = tmg.CycleConfig(n_smooth=2, gamma=gamma, gamma_min_n=gamma_min_n)
    u, it = _split_solve(_hier33(), cfg)
    u_rect, it_rect = _rect_solve(_hier33(), cfg)
    assert it == it_rect
    assert float((u - u_rect).abs().max()) <= 5e-9


def test_split_solver_guards():
    hier = tmg.Hierarchy(ndim=3, coarse_n=5, num_levels=3)
    assert tcs.split_available(hier)
    assert not tcs.split_available(tmg.Hierarchy(ndim=3, coarse_n=5, num_levels=1))
    with pytest.raises(ValueError, match="init_norm"):
        tcs.make_split_df_solver(hier, device="cpu")
    with pytest.raises(ValueError, match="levels"):
        tcs.make_split_df_solver(tmg.Hierarchy(ndim=3, coarse_n=5, num_levels=1),
                                 init_norm=1.0, device="cpu")


def test_split_solver_stops_at_max_cycles():
    hier = tmg.Hierarchy(ndim=3, coarse_n=5, num_levels=3)
    prob = tmg.poisson_3d_quadratic()
    run = tcs.make_split_df_solver(hier, tmg.CycleConfig(), rel_tol=1e-30, max_cycles=2,
                                   inner_cycles=1,
                                   init_norm=tcp.ref_init_norm(prob, hier, device="cpu"),
                                   device="cpu")
    *_, it = run(*tcs.setup_split_df_problem(prob, hier, device="cpu"))
    assert it == 2
