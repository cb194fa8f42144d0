"""The (i, j)-sharded kernels of the port (K37-K41 in
multigrid_parallel_tpu_torch.ops.pallas_sharded2d) on simulated ranks, in
one process: their plain versions, in the ext form, the j-extended triple
and the five copy-free parts, against the JAX package's Pallas kernels
(interpret mode, the five-part halo form; the JAX tests hold its ext and
triple forms to it bit for bit) under shard_map at 17^3 on a 2x2 mesh,
and their stitched owned points against the port's single-device plain
K1/K2/K3/K4/K5 on the whole field, on the same numpy-seeded inputs; plus
the plans against the JAX package's.

The ranks' parts are their own copies (tests/torch_sharded_ranks.py: the
values the halo exchanges deliver, the corner blocks included, and zeros
past the chain ends). The port's j halo is the stage's (as deep as in i);
the triple form takes the JAX package's HJ = 8 columns, which the
wrappers read as they come. On CPU tensors the wrappers take their plain
versions; the CUDA kernels are held against those on the card
(tests/test_torch_cuda.py and chip_smoke.py).

Tolerances: against Pallas, max |port - jax| <= 4 f32 ulp of the field's
max (the same IEEE operations, which XLA's CPU compiler may contract or
reorder a few of; the JAX restriction and interpolation are matrix
products), the partial norms' sum rel 1e-5; against the single-device
versions, bit for bit (a red-black half-sweep is Jacobi within a colour,
so a halo as deep as the number of half-sweeps leaves the owned points
exact), the norms rel 1e-6 (only the order of the sum differs).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

import torch_sharded_ranks as rk
from multigrid_parallel_tpu import Hierarchy as JHierarchy
from multigrid_parallel_tpu import cycles_padded as jcp
from multigrid_parallel_tpu.ops import pallas_sharded2d as jpx2
from multigrid_parallel_tpu.parallel import sharded2d as js2
from multigrid_parallel_tpu.parallel import sharded2d_padded as js2p
import multigrid_parallel_tpu_torch as mg
from multigrid_parallel_tpu_torch.ops import pallas3d as pk
from multigrid_parallel_tpu_torch.ops import pallas_sharded2d as px2
from multigrid_parallel_tpu_torch.parallel import sharded2d as s2
from multigrid_parallel_tpu_torch.parallel import sharded2d_padded as s2p
from multigrid_parallel_tpu_torch.utils import convert

torch.set_num_threads(1)

N, NX, NY = 17, 2, 2
LI, LJ = 12, 16  # the padded plan of 17^3 on 2x2 (plan_sharding_2d_padded)
NC, LIC, LJC = (N + 1) // 2, LI // 2, LJ // 2
H = 1.0 / (N - 1)
HJ = jpx2.HJ
RANKS = [(ix, iy) for ix in range(NX) for iy in range(NY)]
FORMS = ["ext", "triple", "five"]


@pytest.fixture(scope="module")
def jplan():
    plan = js2p.plan_sharding_2d_padded(JHierarchy(ndim=3, coarse_n=5, num_levels=3), NX, NY)
    assert (plan.fine_local_i, plan.fine_local_j) == (LI, LJ)
    return plan


@pytest.fixture(scope="module")
def jmesh():
    return js2.make_mesh_2d(NX, NY)


def _field(seed, n=N, li=LI, lj=LJ, zero_boundary=False, nx=NX, ny=NY):
    """(nx li, ny lj, n) f32: a standard normal cube in [:n, :n], zero pads."""
    cube = rk.global_field(np.random.default_rng(seed), n, n, zero_boundary)
    x = np.zeros((nx * li, ny * lj, n), np.float32)
    x[:n, :n] = cube
    return torch.from_numpy(x)


def _jax(x, n=N):
    """The port's global field as the JAX package's lane-padded sharded array."""
    out = np.zeros(x.shape[:2] + (convert.jax_padded_shape(n)[2],), np.float32)
    out[:, :, :n] = x.numpy()
    return jnp.asarray(out)


def _shmap(fn, jmesh, n_in, out_specs=P("x", "y")):
    return jax.jit(jax.shard_map(fn, mesh=jmesh, in_specs=(P("x", "y"),) * n_in,
                                 out_specs=out_specs, check_vma=False))


def _stitch(per_rank, li=LI, lj=LJ, nx=NX, ny=NY):
    """The global array of the ranks' outputs, rank (ix, iy) at its block."""
    rows = []
    for ix in range(nx):
        rows.append(torch.cat([per_rank(ix, iy) for iy in range(ny)], dim=1))
    return torch.cat(rows)


def _assert_ulps(got, want, ulps=4):
    got = np.asarray(got, dtype=np.float32)
    want = np.asarray(want, dtype=np.float32)
    assert got.shape == want.shape, (got.shape, want.shape)
    tol = ulps * np.spacing(np.abs(want).max())
    err = np.abs(got.astype(np.float64) - want.astype(np.float64)).max()
    assert err <= tol, (err, tol)


def _valid(x, n=N):
    return np.asarray(x)[:n, :n, :n]


def _form(form, x, ix, iy, li, lj, kl, kr, tail=0, k_ext=None):
    """Rank (ix, iy)'s input of x in ``form``: the port's ext copy (its
    stage halo in i and j, k_ext rows), the JAX-style j-extended triple
    (HJ columns) or the five parts (the stage halo)."""
    if form == "ext":
        k = max(kl, kr) if k_ext is None else k_ext
        return rk.rank_ext2d(x, ix, iy, li, lj, k, k, k, k)
    if form == "triple":
        return rk.rank_triple2d(x, ix, iy, li, lj, kl, kr, HJ, tail)
    return rk.rank_parts2d(x, ix, iy, li, lj, kl, kr, tail=tail)


def _g(ix, iy, halo, li=LI, lj=LJ):
    return (ix * li - halo, iy * lj - halo)


# -------------------------------------------------- against the Pallas kernels


BI = LI  # one Pallas grid step a rank (interpret mode runs each step in Python)


def _cached(cache, key, compute):
    if key not in cache:
        cache[key] = compute()
    return cache[key]


@pytest.fixture(scope="module")
def jax_refs():
    """The JAX references, each computed once for the module."""
    return {}


def _jax_rb_smooth(jplan, jmesh, u, f):
    hh = 4

    def local(ul, fl):
        return jpx2.rb_smooth_halo2d(js2p._halo_parts2dj(ul, jplan, hh, hh, BI),
                                     js2p._halo_parts2dj(fl, jplan, hh, hh, BI),
                                     js2p._gij0(jplan, 0, hh), H, 2, N, LI, LJ, True, block_i=BI)

    return _shmap(local, jmesh, 2)(_jax(u), _jax(f))


@pytest.mark.parametrize("form", FORMS)
def test_rb_smooth_matches_pallas(jplan, jmesh, jax_refs, form):
    u, f = _field(1), _field(2)
    want = _cached(jax_refs, "K37", lambda: _jax_rb_smooth(jplan, jmesh, u, f))
    fn = px2.rb_smooth_ext2d if form == "ext" else px2.rb_smooth_halo2d
    got = _stitch(lambda ix, iy: fn(_form(form, u, ix, iy, LI, LJ, 4, 4, BI),
                                    _form(form, f, ix, iy, LI, LJ, 4, 4), _g(ix, iy, 4), H, 2, N,
                                    LI, LJ, True))
    _assert_ulps(got[:N, :N], _valid(want))


def _jax_from_zero(jplan, jmesh, f):
    def local(fl):
        return jpx2.rb_smooth_from_zero_halo2d(js2p._halo_parts2dj(fl, jplan, 4, 4, BI),
                                               js2p._gij0(jplan, 0, 4), H, 2, N, LI, LJ,
                                               block_i=BI)

    return _shmap(local, jmesh, 1)(_jax(f))


@pytest.mark.parametrize("form", FORMS)
def test_rb_smooth_from_zero_matches_pallas(jplan, jmesh, jax_refs, form):
    f = _field(3)
    want = _cached(jax_refs, "K38", lambda: _jax_from_zero(jplan, jmesh, f))
    fn = px2.rb_smooth_from_zero_ext2d if form == "ext" else px2.rb_smooth_from_zero_halo2d
    got = _stitch(lambda ix, iy: fn(_form(form, f, ix, iy, LI, LJ, 4, 4, BI), _g(ix, iy, 4),
                                    H, 2, N, LI, LJ))
    _assert_ulps(got[:N, :N], _valid(want))


def _df_state(seed, n=N, li=LI, lj=LJ, nx=NX, ny=NY):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(2):
        x = np.zeros((nx * li, ny * lj, n))
        x[:n, :n] = rng.standard_normal((n, n, n))
        out += pk.df_split(torch.from_numpy(x))
    return out  # u_hi, u_lo, f_hi, f_lo


def _jax_df_norm(jplan, jmesh, state):
    def local(a, b, c, d):
        r, part = jpx2.residual_df_norm_halo2d(
            *(js2p._halo_parts2dj(x, jplan, 1, 1, BI) for x in (a, b, c, d)),
            js2p._gij0(jplan, 0, 1), H, N, LI, LJ, block_i=BI)
        return r, jax.lax.psum(part, ("x", "y"))

    return _shmap(local, jmesh, 4, (P("x", "y"), P()))(*(_jax(x) for x in state))


@pytest.mark.parametrize("form", FORMS)
def test_residual_df_norm_matches_pallas(jplan, jmesh, jax_refs, form):
    state = _df_state(6)
    want_r, want_n2 = _cached(jax_refs, "K41", lambda: _jax_df_norm(jplan, jmesh, state))
    fn = px2.residual_df_norm_ext2d if form == "ext" else px2.residual_df_norm_halo2d
    outs = {(ix, iy): fn(*(_form(form, x, ix, iy, LI, LJ, 1, 1, BI) for x in state),
                         _g(ix, iy, 1), H, N, LI, LJ) for ix, iy in RANKS}
    _assert_ulps(_stitch(lambda ix, iy: outs[ix, iy][0])[:N, :N], _valid(want_r))
    assert sum(float(o[1]) for o in outs.values()) == pytest.approx(float(want_n2), rel=1e-5)


def _jax_restrict(jplan, jmesh, e, f):
    skc = jcp._coarse_k_width(N, convert.jax_padded_shape(N)[2])

    def local(el, fl):
        return jpx2.residual_restrict_halo2d(js2p._halo_parts2dj(el, jplan, 2, 1),
                                             js2p._halo_parts2dj(fl, jplan, 2, 1),
                                             js2p._gij0(jplan, 0, 2), H, N, LIC, LJC, skc,
                                             block_i=LIC)

    return _shmap(local, jmesh, 2)(_jax(e), _jax(f))


@pytest.mark.parametrize("form", FORMS)
def test_residual_restrict_matches_pallas(jplan, jmesh, jax_refs, form):
    e, f = _field(7, zero_boundary=True), _field(8)
    want = _cached(jax_refs, "K39", lambda: _jax_restrict(jplan, jmesh, e, f))
    fn = px2.residual_restrict_ext2d if form == "ext" else px2.residual_restrict_halo2d
    got = _stitch(lambda ix, iy: fn(_form(form, e, ix, iy, LI, LJ, 2, 1, k_ext=2),
                                    _form(form, f, ix, iy, LI, LJ, 2, 1, k_ext=2),
                                    _g(ix, iy, 2), H, N, LIC, LJC), LIC, LJC)
    _assert_ulps(got[:NC, :NC], _valid(want, NC))
    assert not got[NC:].any() and not got[:, NC:].any()


def _jax_prolong(jplan, jmesh, ec, e, r):
    def local(ecl, el, rl):
        return jpx2.prolong_smooth_halo2d(js2p._halo_parts2dj(ecl, jplan, 2, 3, BI // 2),
                                          js2p._halo_parts2dj(el, jplan, 4, 4, BI),
                                          js2p._halo_parts2dj(rl, jplan, 4, 4, BI),
                                          js2p._gij0(jplan, 0, 4), H, 2, N, LI, LJ, block_i=BI)

    return _shmap(local, jmesh, 3)(_jax(ec, NC), _jax(e), _jax(r))


@pytest.mark.parametrize("form", FORMS)
def test_prolong_smooth_matches_pallas(jplan, jmesh, jax_refs, form):
    ec = _field(9, NC, LIC, LJC, zero_boundary=True)
    e, r_ = _field(10, zero_boundary=True), _field(11, zero_boundary=True)
    want = _cached(jax_refs, "K40", lambda: _jax_prolong(jplan, jmesh, ec, e, r_))
    fn = px2.prolong_smooth_ext2d if form == "ext" else px2.prolong_smooth_halo2d
    got = _stitch(lambda ix, iy: fn(
        _form(form, ec, ix, iy, LIC, LJC, 2, 3, BI // 2, k_ext=3),
        _form(form, e, ix, iy, LI, LJ, 4, 4, BI), _form(form, r_, ix, iy, LI, LJ, 4, 4),
        _g(ix, iy, 4), H, 2, N, LI, LJ))
    _assert_ulps(got[:N, :N], _valid(want))


# ------------------------------- stitched against the single-device kernels


# (n, nx, ny, Li, Lj): 2x2 at 17^3 (the padded plan) and at 33^3, where every
# rank holds interior points; 4x1 and 1x4 rows and columns of blocks
GEOMETRIES = [(17, 2, 2, 12, 16), (33, 2, 2, 18, 20), (33, 4, 1, 10, 34), (33, 1, 4, 34, 10)]


def _stitched_against_single(kernel, n, nx, ny, li, lj):
    """(stitched outputs of each form, want) of one kernel."""
    h = 1.0 / (n - 1)
    nc, lic, ljc = (n + 1) // 2, li // 2, lj // 2
    u = _field(20, n, li, lj, nx=nx, ny=ny)
    f = _field(21, n, li, lj, nx=nx, ny=ny)
    st = lambda fn, a=li, b=lj: _stitch(fn, a, b, nx, ny)  # noqa: E731
    forms = {}
    if kernel in ("K37", "K37-black", "K38"):
        hh = 4
        if kernel == "K38":
            want = pk.rb_smooth_from_zero_plain(f[:n, :n], h, 2, red_first=True)
            for form in FORMS:
                fn = (px2.rb_smooth_from_zero_ext2d if form == "ext"
                      else px2.rb_smooth_from_zero_halo2d)
                forms[form] = st(lambda ix, iy: fn(_form(form, f, ix, iy, li, lj, hh, hh, lj // 2),
                                                   _g(ix, iy, hh, li, lj), h, 2, n, li, lj))
        else:
            red = kernel == "K37"
            want = pk.rb_smooth_plain(u[:n, :n], f[:n, :n], h, 2, red_first=red)
            for form in FORMS:
                fn = px2.rb_smooth_ext2d if form == "ext" else px2.rb_smooth_halo2d
                forms[form] = st(lambda ix, iy: fn(_form(form, u, ix, iy, li, lj, hh, hh, 2),
                                                   _form(form, f, ix, iy, li, lj, hh, hh),
                                                   _g(ix, iy, hh, li, lj), h, 2, n, li, lj, red))
        return {k: v[:n, :n] for k, v in forms.items()}, want
    if kernel == "K39":
        want = pk.residual_restrict_plain(u[:n, :n], f[:n, :n], h)
        for form in FORMS:
            fn = px2.residual_restrict_ext2d if form == "ext" else px2.residual_restrict_halo2d
            out = st(lambda ix, iy: fn(_form(form, u, ix, iy, li, lj, 2, 1, k_ext=2),
                                       _form(form, f, ix, iy, li, lj, 2, 3, k_ext=2),
                                       _g(ix, iy, 2, li, lj), h, n, lic, ljc), lic, ljc)
            assert not out[nc:].any() and not out[:, nc:].any(), form
            forms[form] = out[:nc, :nc]
        return forms, want
    if kernel == "K40":
        ec = _field(22, nc, lic, ljc, nx=nx, ny=ny)
        outs, wants = {form: [] for form in FORMS}, []
        for n_iter in (1, 2):
            hh, hc = 2 * n_iter, n_iter + 1
            wants.append(pk.prolong_smooth_plain(ec[:nc, :nc], u[:n, :n], f[:n, :n], h, n_iter))
            for form in FORMS:
                fn = px2.prolong_smooth_ext2d if form == "ext" else px2.prolong_smooth_halo2d
                outs[form].append(st(lambda ix, iy: fn(
                    _form(form, ec, ix, iy, lic, ljc, n_iter, hc, 2, k_ext=hc),
                    _form(form, u, ix, iy, li, lj, hh, hh),
                    _form(form, f, ix, iy, li, lj, hh, hh, 4),
                    _g(ix, iy, hh, li, lj), h, n_iter, n, li, lj))[:n, :n])
        return {k: torch.cat(v) for k, v in outs.items()}, torch.cat(wants)
    assert kernel == "K41"
    state = _df_state(23, n, li, lj, nx, ny)
    want_r, want_n2 = pk.residual_df_norm_plain(*(x[:n, :n] for x in state), h)
    for form in FORMS:
        fn = px2.residual_df_norm_ext2d if form == "ext" else px2.residual_df_norm_halo2d
        outs = {(ix, iy): fn(*(_form(form, x, ix, iy, li, lj, 1, 1, 3) for x in state),
                             _g(ix, iy, 1, li, lj), h, n, li, lj)
                for ix in range(nx) for iy in range(ny)}
        forms[form] = st(lambda ix, iy: outs[ix, iy][0])[:n, :n]
        n2 = sum(float(o[1]) for o in outs.values())
        assert n2 == pytest.approx(float(want_n2), rel=1e-6), form
    return forms, want_r


@pytest.mark.parametrize("geometry", GEOMETRIES)
@pytest.mark.parametrize("kernel", ["K37", "K37-black", "K38", "K39", "K40", "K41"])
def test_stitched_points_equal_single_device(kernel, geometry):
    forms, want = _stitched_against_single(kernel, *geometry)
    for form, got in forms.items():
        assert torch.equal(got, want), (form, float((got - want).abs().max()))


def test_stage_reads_the_corner_blocks():
    """At H = 4 on 2x2 the smoothing stage's recomputed halo reads the
    diagonal neighbours' values, which come in the j-extended i-halo rows:
    with those corner blocks zeroed the stitched stage is no longer K1's."""
    u, f = _field(40), _field(41)
    want = pk.rb_smooth_plain(u[:N, :N], f[:N, :N], H, 2)

    def rank(ix, iy, zero_corners):
        u5 = rk.rank_parts2d(u, ix, iy, LI, LJ, 4, 4)
        if zero_corners:
            for part in u5[3:]:
                part[:, :4] = 0.0
                part[:, 4 + LJ:] = 0.0
        return px2.rb_smooth_halo2d(u5, rk.rank_parts2d(f, ix, iy, LI, LJ, 4, 4),
                                    _g(ix, iy, 4), H, 2, N, LI, LJ)

    assert torch.equal(_stitch(lambda ix, iy: rank(ix, iy, False))[:N, :N], want)
    assert not torch.equal(_stitch(lambda ix, iy: rank(ix, iy, True))[:N, :N], want)


def test_smoothing_wrapper_updates_the_segment_in_place():
    """The smoothing wrapper's contract: a fresh contiguous block, equal to
    the plain version, and u's five parts as they were."""
    u, f = _field(30), _field(31)
    u5 = rk.rank_parts2d(u, 1, 0, LI, LJ, 4, 4)
    before = [t.clone() for t in u5]
    want = px2.rb_smooth_halo2d_plain(u5, rk.rank_parts2d(f, 1, 0, LI, LJ, 4, 4), _g(1, 0, 4), H,
                                      2, N, LI, LJ)
    out = px2.rb_smooth_halo2d(u5, rk.rank_parts2d(f, 1, 0, LI, LJ, 4, 4),
                               torch.tensor(_g(1, 0, 4), dtype=torch.int32), H, 2, N, LI, LJ)
    assert all(out.data_ptr() != t.data_ptr() for t in u5) and out.is_contiguous()
    assert torch.equal(out, want)
    assert all(torch.equal(a, b) for a, b in zip(u5, before))


def test_descriptor_reads_each_part_of_an_ext_block():
    """The kernels' descriptor of an ext block's views: the five parts'
    addresses and row pitches in the buffer, the halo depths."""
    x = rk.rank_ext2d(_field(34), 1, 1, LI, LJ, 4, 4, 3, 3)
    seg = px2._seg2(x, LI, LJ, 4, 4, 3, 3, k_ext=4)
    d = list(seg.desc())
    base, item, pitch = x.data_ptr(), x.element_size(), (LJ + 6) * N
    assert d[:5] == [base + item * (4 * pitch + 3 * N), base + item * 4 * pitch,
                     base + item * (4 * pitch + (3 + LJ) * N), base,
                     base + item * (4 + LI) * pitch]
    assert d[5:] == [pitch] * 4 + [4, 0, 3]


def test_wrappers_reject_what_the_kernels_do_not_take():
    u, f = _field(32), _field(33)
    with pytest.raises(ValueError, match="halo"):  # a 2-deep halo for n_iter = 2
        px2.rb_smooth_halo2d(rk.rank_parts2d(u, 1, 1, LI, LJ, 2, 2),
                             rk.rank_parts2d(f, 1, 1, LI, LJ, 2, 2), _g(1, 1, 2), H, 2, N, LI, LJ)
    with pytest.raises(ValueError, match="ext block"):
        px2.rb_smooth_ext2d(rk.rank_ext2d(u, 1, 1, LI, LJ, 2, 2, 2, 2),
                            rk.rank_ext2d(f, 1, 1, LI, LJ, 2, 2, 2, 2), _g(1, 1, 2), H, 2, N,
                            LI, LJ)
    with pytest.raises(ValueError, match="body"):
        px2.residual_restrict_halo2d(rk.rank_parts2d(u, 1, 1, LI, LJ, 2, 1),
                                     rk.rank_parts2d(f, 1, 1, LI, LJ, 2, 1), _g(1, 1, 2), H, N,
                                     LIC, LJC + 1)
    meta = tuple(t.to("meta") for t in rk.rank_parts2d(u, 1, 1, LI, LJ, 1, 1))
    with pytest.raises(ValueError, match="no kernel"):
        px2.residual_df_norm_halo2d(meta, meta, meta, meta, _g(1, 1, 1), H, N, LI, LJ)


# ---------------------------------------------------- planning against JAX


@pytest.mark.parametrize("num_levels", [3, 4, 5, 7, 8, 10])
def test_plans_match_jax(num_levels):
    jh = JHierarchy(ndim=3, coarse_n=5, num_levels=num_levels)
    h = mg.Hierarchy(ndim=3, coarse_n=5, num_levels=num_levels)
    for nx, ny in [(1, 1), (2, 2), (4, 1), (1, 4), (2, 4), (4, 4), (8, 8), (3, 2)]:
        for jf, f in [(js2.plan_sharding_2d, s2.plan_sharding_2d),
                      (js2p.plan_sharding_2d_padded, s2p.plan_sharding_2d_padded)]:
            want, got = jf(jh, nx, ny), f(h, nx, ny)
            assert _plan_tuple(got) == _plan_tuple(want), (nx, ny, got, want)


def _plan_tuple(plan):
    return (plan.nx, plan.ny, tuple(plan.axes), plan.n_sharded, plan.fine_local_i,
            plan.fine_local_j)


def test_tier_map_turns_the_2d_kernels_down_on_narrow_columns():
    """The port's gate is structural: the 2D kernels wherever every halo
    comes from one neighbour (at 257^3 on 2x2 every sharded level,
    Lj = 144 .. 18, where the JAX gate sends Lj = 36 to its j-replicated
    tier), the j-replicated tier where only Lj is too narrow."""
    cfg = mg.CycleConfig(n_smooth=2)
    h257 = mg.Hierarchy(ndim=3, coarse_n=5, num_levels=7)
    plan = s2p.plan_sharding_2d_padded(h257, 2, 2)
    assert [plan.local_j(d) for d in range(plan.n_sharded)] == [144, 72, 36, 18]
    assert s2p.tier_map(h257, cfg, plan) == {257: "2d", 129: "2d", 65: "2d", 33: "2d",
                                             17: "replicated"}
    h33 = mg.Hierarchy(ndim=3, coarse_n=5, num_levels=4)
    narrow = s2.ShardPlan2D(1, 4, ("x", "y"), 3, 40, 16)
    assert s2p.tier_map(h33, cfg, narrow) == {33: "2d", 17: "2d", 9: "j-replicated",
                                              5: "replicated"}
    assert s2p.tier_map(h33, cfg, narrow, jnp_level_max=9)[9] == "plain"
