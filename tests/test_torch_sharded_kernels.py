"""The i-sharded kernels of the port (K28-K33 in
multigrid_parallel_tpu_torch.ops.pallas_sharded) on simulated ranks, in
one process: their plain versions, in the ext and the halo form, against
the JAX package's Pallas kernels (interpret mode) under shard_map at 17^3
on 4 devices, and their stitched owned rows against the port's
single-device plain K1/K2/R/K3/K4/K5 on the whole field, on the same
numpy-seeded inputs; plus halo_ok and plan_sharding against the JAX
package's.

The ranks' segments are their own copies (tests/torch_sharded_ranks.py):
the smoothing wrappers update them in place, as a rank's receive buffers.
On CPU tensors the wrappers take their plain versions; the CUDA kernels
are held against those on the card (tests/test_torch_cuda.py and
chip_smoke.py).

Tolerances: against Pallas, max |port - jax| <= 4 f32 ulp of the field's
max (as tests/test_torch_kernels.py: the same IEEE operations, which XLA's
CPU compiler may contract or reorder a few of), the partial norms' sum
rel 1e-5; against the single-device versions, bit for bit (a red-black
half-sweep is Jacobi within a colour, so a halo as deep as the number of
half-sweeps leaves the owned rows exact), the norms rel 1e-6 (only the
order of the sum differs).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

import torch_sharded_ranks as rk
from multigrid_parallel_tpu import Hierarchy as JHierarchy
from multigrid_parallel_tpu.ops import pallas_sharded as jpx
from multigrid_parallel_tpu.parallel import sharded as jsh
from multigrid_parallel_tpu.parallel import sharded_padded as jsp
import multigrid_parallel_tpu_torch as mg
from multigrid_parallel_tpu_torch.ops import pallas3d as pk
from multigrid_parallel_tpu_torch.ops import pallas_sharded as px
from multigrid_parallel_tpu_torch.parallel import sharded as sh
from multigrid_parallel_tpu_torch.utils import convert

torch.set_num_threads(1)

N, L, D = 17, 8, 4  # 4 ranks of 8 planes: ranks 0, 1 hold the interior, 2 and 3 pads
NC, LC = (N + 1) // 2, L // 2
H = 1.0 / (N - 1)


@pytest.fixture(scope="module")
def mesh():
    return jsh.make_mesh(D)


def _field(seed, n=N, rows=D * L, zero_boundary=False):
    return torch.from_numpy(rk.global_field(np.random.default_rng(seed), n, rows,
                                            zero_boundary))


def _jax(x):
    """The port's global field as the JAX package's lane-padded sharded array."""
    return jnp.asarray(convert.to_jax_sharded([x], x.shape[1]))


def _shmap(fn, mesh, n_in, out_specs=P("x")):
    return jax.jit(jax.shard_map(fn, mesh=mesh, in_specs=(P("x"),) * n_in,
                                 out_specs=out_specs, check_vma=False))


def _valid(x, n=N):
    return np.asarray(x)[:n, :n, :n]


def _assert_ulps(got, want, ulps=4):
    got = np.asarray(got, dtype=np.float32)
    want = np.asarray(want, dtype=np.float32)
    assert got.shape == want.shape, (got.shape, want.shape)
    tol = ulps * np.spacing(np.abs(want).max())
    err = np.abs(got.astype(np.float64) - want.astype(np.float64)).max()
    assert err <= tol, (err, tol)


def _stitch(per_rank, ranks=D):
    return torch.cat([per_rank(r) for r in range(ranks)])


def _parts(x, r, k, kr=None, tail=0, Lr=L):
    return rk.rank_parts(x, r, Lr, k, k if kr is None else kr, tail)


# -------------------------------------------------- against the Pallas kernels


@pytest.mark.parametrize("form", ["ext", "halo"])
@pytest.mark.parametrize("n_iter,red_first", [(2, True), (1, False)])
def test_rb_smooth_matches_pallas(mesh, form, n_iter, red_first):
    u, f = _field(1), _field(2)
    hh, bi = 2 * n_iter, 4

    def local(ul, fl):
        g = jsp._gi0("x", L, hh)
        if form == "ext":
            return jpx.rb_smooth_ext(jsp._halo_ext(ul, "x", D, hh), jsp._halo_ext(fl, "x", D, hh),
                                     g, H, n_iter, N, L, red_first, block_i=bi)
        return jpx.rb_smooth_halo(jsp._halo_parts(ul, "x", D, hh, hh, bi),
                                  jsp._halo_parts(fl, "x", D, hh, hh, bi),
                                  g, H, n_iter, N, L, red_first, block_i=bi)

    want = _shmap(local, mesh, 2)(_jax(u), _jax(f))
    if form == "ext":
        got = _stitch(lambda r: px.rb_smooth_ext(rk.rank_ext(u, r, L, hh), rk.rank_ext(f, r, L, hh),
                                                 r * L - hh, H, n_iter, N, L, red_first))
    else:
        got = _stitch(lambda r: px.rb_smooth_halo(_parts(u, r, hh, tail=bi),
                                                  _parts(f, r, hh, tail=bi),
                                                  r * L - hh, H, n_iter, N, L, red_first))
    _assert_ulps(got[:N], _valid(want))


@pytest.mark.parametrize("form", ["ext", "halo"])
def test_rb_smooth_from_zero_matches_pallas(mesh, form):
    f = _field(3)
    hh, bi = 4, 4

    def local(fl):
        g = jsp._gi0("x", L, hh)
        if form == "ext":
            return jpx.rb_smooth_from_zero_ext(jsp._halo_ext(fl, "x", D, hh), g, H, 2, N, L,
                                               block_i=bi)
        return jpx.rb_smooth_from_zero_halo(jsp._halo_parts(fl, "x", D, hh, hh, bi), g, H, 2,
                                            N, L, block_i=bi)

    want = _shmap(local, mesh, 1)(_jax(f))
    if form == "ext":
        got = _stitch(lambda r: px.rb_smooth_from_zero_ext(rk.rank_ext(f, r, L, hh),
                                                           r * L - hh, H, 2, N, L))
    else:
        got = _stitch(lambda r: px.rb_smooth_from_zero_halo(_parts(f, r, hh, tail=bi),
                                                            r * L - hh, H, 2, N, L))
    _assert_ulps(got[:N], _valid(want))


def test_residual_ext_matches_pallas(mesh):
    u, f = _field(4), _field(5)

    def local(ul, fl):
        return jpx.residual_ext(jsp._halo_ext(ul, "x", D, 1), jsp._halo_ext(fl, "x", D, 1),
                                jsp._gi0("x", L, 1), H, N, L, block_i=4)

    want = _shmap(local, mesh, 2)(_jax(u), _jax(f))
    got = _stitch(lambda r: px.residual_ext(rk.rank_ext(u, r, L, 1), rk.rank_ext(f, r, L, 1),
                                            r * L - 1, H, N, L))
    _assert_ulps(got[:N], _valid(want))


def _df_state(seed):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(2):
        x = np.zeros((D * L, N, N))
        x[:N] = rng.standard_normal((N, N, N))
        out += pk.df_split(torch.from_numpy(x))
    return out  # u_hi, u_lo, f_hi, f_lo


@pytest.mark.parametrize("form", ["ext", "halo"])
def test_residual_df_norm_matches_pallas(mesh, form):
    state = _df_state(6)
    bi = 4

    def local(a, b, c, d):
        g = jsp._gi0("x", L, 1)
        if form == "ext":
            r, part = jpx.residual_df_norm_ext(*(jsp._halo_ext(x, "x", D, 1) for x in (a, b, c, d)),
                                               g, H, N, L, block_i=bi)
        else:
            r, part = jpx.residual_df_norm_halo(
                *(jsp._halo_parts(x, "x", D, 1, 1, bi) for x in (a, b, c, d)), g, H, N, L,
                block_i=bi)
        return r, jax.lax.psum(part, "x")

    want_r, want_n2 = _shmap(local, mesh, 4, (P("x"), P()))(*(_jax(x) for x in state))
    if form == "ext":
        outs = [px.residual_df_norm_ext(*(rk.rank_ext(x, r, L, 1) for x in state), r * L - 1, H,
                                        N, L) for r in range(D)]
    else:
        outs = [px.residual_df_norm_halo(*(_parts(x, r, 1, tail=bi) for x in state), r * L - 1,
                                         H, N, L) for r in range(D)]
    _assert_ulps(torch.cat([o[0] for o in outs])[:N], _valid(want_r))
    assert sum(float(o[1]) for o in outs) == pytest.approx(float(want_n2), rel=1e-5)


@pytest.mark.parametrize("form", ["ext", "halo"])
def test_residual_restrict_matches_pallas(mesh, form):
    e, f = _field(7, zero_boundary=True), _field(8)
    bi = 2

    def local(el, fl):
        g = jsp._gi0("x", L, 2)
        if form == "ext":
            return jpx.residual_restrict_ext(jsp._halo_ext(el, "x", D, 2),
                                             jsp._halo_ext(fl, "x", D, 2), g, H, N, LC,
                                             block_i=bi)
        return jpx.residual_restrict_halo(jsp._halo_parts(el, "x", D, 2, 1),
                                          jsp._halo_parts(fl, "x", D, 2, 1), g, H, N, LC,
                                          block_i=bi)

    want = _shmap(local, mesh, 2)(_jax(e), _jax(f))
    if form == "ext":
        got = _stitch(lambda r: px.residual_restrict_ext(rk.rank_ext(e, r, L, 2),
                                                         rk.rank_ext(f, r, L, 2),
                                                         r * L - 2, H, N, LC))
    else:
        got = _stitch(lambda r: px.residual_restrict_halo(_parts(e, r, 2, 1), _parts(f, r, 2, 1),
                                                          r * L - 2, H, N, LC))
    _assert_ulps(got[:NC], _valid(want, NC))
    assert not got[NC:].any()


@pytest.mark.parametrize("form", ["ext", "halo"])
@pytest.mark.parametrize("n_iter", [1, 2])
def test_prolong_smooth_matches_pallas(mesh, form, n_iter):
    ec = _field(9, NC, D * LC, zero_boundary=True)
    e, r_ = _field(10, zero_boundary=True), _field(11, zero_boundary=True)
    hh, hc = 2 * n_iter, n_iter + 1
    bi = 4 if n_iter == 1 else 8  # the halo form needs halo_ok(L, bi, H) and bi >= H + 2

    def local(ecl, el, rl):
        g = jsp._gi0("x", L, hh)
        if form == "ext":
            return jpx.prolong_smooth_ext(jsp._halo_ext(ecl, "x", D, hc),
                                          jsp._halo_ext(el, "x", D, hh),
                                          jsp._halo_ext(rl, "x", D, hh), g, H, n_iter, N, L,
                                          block_i=4)
        return jpx.prolong_smooth_halo(jsp._halo_parts(ecl, "x", D, n_iter, hc, bi // 2),
                                       jsp._halo_parts(el, "x", D, hh, hh, bi),
                                       jsp._halo_parts(rl, "x", D, hh, hh, bi), g, H, n_iter,
                                       N, L, block_i=bi)

    want = _shmap(local, mesh, 3)(_jax(ec), _jax(e), _jax(r_))
    if form == "ext":
        got = _stitch(lambda r: px.prolong_smooth_ext(
            rk.rank_ext(ec, r, LC, hc), rk.rank_ext(e, r, L, hh), rk.rank_ext(r_, r, L, hh),
            r * L - hh, H, n_iter, N, L))
    else:
        got = _stitch(lambda r: px.prolong_smooth_halo(
            _parts(ec, r, n_iter, hc, bi // 2, LC), _parts(e, r, hh, tail=bi),
            _parts(r_, r, hh, tail=bi), r * L - hh, H, n_iter, N, L))
    _assert_ulps(got[:N], _valid(want))


# ------------------------------- stitched against the single-device kernels


GEOMETRIES = [(17, 8), (33, 10)]  # (n, L) on 4 ranks; 33 / 10: every rank has interior


def _stitched_against_single(kernel, n, Lr):
    """(stitched ext form, stitched halo form, want) of one kernel."""
    h = 1.0 / (n - 1)
    rows, nc, lc = D * Lr, (n + 1) // 2, Lr // 2
    u, f = _field(20, n, rows), _field(21, n, rows)
    if kernel in ("K28", "K29"):
        hh, red = 4, kernel == "K28"
        if kernel == "K28":
            want = pk.rb_smooth_plain(u[:n], f[:n], h, 2, red_first=True)
            ext = _stitch(lambda r: px.rb_smooth_ext(rk.rank_ext(u, r, Lr, hh),
                                                     rk.rank_ext(f, r, Lr, hh),
                                                     r * Lr - hh, h, 2, n, Lr, red))
            halo = _stitch(lambda r: px.rb_smooth_halo(_parts(u, r, hh, tail=2, Lr=Lr),
                                                       _parts(f, r, hh, Lr=Lr),
                                                       r * Lr - hh, h, 2, n, Lr, red))
        else:
            want = pk.rb_smooth_from_zero_plain(f[:n], h, 2, red_first=True)
            ext = _stitch(lambda r: px.rb_smooth_from_zero_ext(rk.rank_ext(f, r, Lr, hh),
                                                               r * Lr - hh, h, 2, n, Lr))
            halo = _stitch(lambda r: px.rb_smooth_from_zero_halo(
                _parts(f, r, hh, tail=Lr, Lr=Lr), torch.tensor([r * Lr - hh]), h, 2, n, Lr))
        return ext[:n], halo[:n], want
    if kernel == "K33":
        want = pk.residual_plain(u[:n], f[:n], h)
        ext = _stitch(lambda r: px.residual_ext(rk.rank_ext(u, r, Lr, 1), rk.rank_ext(f, r, Lr, 1),
                                                r * Lr - 1, h, n, Lr))
        return ext[:n], ext[:n], want
    if kernel == "K30":
        want = pk.residual_restrict_plain(u[:n], f[:n], h)
        ext = _stitch(lambda r: px.residual_restrict_ext(rk.rank_ext(u, r, Lr, 2),
                                                         rk.rank_ext(f, r, Lr, 2),
                                                         r * Lr - 2, h, n, lc))
        halo = _stitch(lambda r: px.residual_restrict_halo(_parts(u, r, 2, 1, Lr=Lr),
                                                           _parts(f, r, 2, 3, Lr=Lr),
                                                           r * Lr - 2, h, n, lc))
        assert not ext[nc:].any() and not halo[nc:].any()
        return ext[:nc], halo[:nc], want
    if kernel == "K31":
        ec = _field(22, nc, D * lc)
        outs = []
        for n_iter in (1, 2):
            hh, hc = 2 * n_iter, n_iter + 1
            want = pk.prolong_smooth_plain(ec[:nc], u[:n], f[:n], h, n_iter)
            ext = _stitch(lambda r: px.prolong_smooth_ext(
                rk.rank_ext(ec, r, lc, hc), rk.rank_ext(u, r, Lr, hh), rk.rank_ext(f, r, Lr, hh),
                r * Lr - hh, h, n_iter, n, Lr))
            halo = _stitch(lambda r: px.prolong_smooth_halo(
                _parts(ec, r, n_iter, hc, 2, lc), _parts(u, r, hh, Lr=Lr),
                _parts(f, r, hh, tail=4, Lr=Lr), r * Lr - hh, h, n_iter, n, Lr))
            outs.append((ext[:n], halo[:n], want))
        return tuple(torch.cat([o[i] for o in outs]) for i in range(3))
    assert kernel == "K32"
    state = [pk.df_split(torch.from_numpy(np.where(np.arange(rows)[:, None, None] < n,
                                                   np.random.default_rng(s).standard_normal(
                                                       (rows, n, n)), 0.0)))
             for s in (23, 24)]
    state = [t for pair in state for t in pair]
    want_r, want_n2 = pk.residual_df_norm_plain(*(x[:n] for x in state), h)
    res = {}
    for form in ("ext", "halo"):
        outs = [px.residual_df_norm_ext(*(rk.rank_ext(x, r, Lr, 1) for x in state), r * Lr - 1,
                                        h, n, Lr) if form == "ext" else
                px.residual_df_norm_halo(*(_parts(x, r, 1, tail=3, Lr=Lr) for x in state),
                                         r * Lr - 1, h, n, Lr) for r in range(D)]
        res[form] = torch.cat([o[0] for o in outs])[:n]
        n2 = sum(float(o[1]) for o in outs)
        assert n2 == pytest.approx(float(want_n2), rel=1e-6), form
    return res["ext"], res["halo"], want_r


@pytest.mark.parametrize("n,Lr", GEOMETRIES)
@pytest.mark.parametrize("kernel", ["K28", "K29", "K30", "K31", "K32", "K33"])
def test_stitched_rows_equal_single_device(kernel, n, Lr):
    ext, halo, want = _stitched_against_single(kernel, n, Lr)
    assert torch.equal(ext, want), float((ext - want).abs().max())
    assert torch.equal(halo, want), float((halo - want).abs().max())


def test_smoothing_wrappers_update_the_segment_in_place():
    u, f = _field(30), _field(31)
    u3 = _parts(u, 1, 4, tail=4)
    out = px.rb_smooth_halo(u3, _parts(f, 1, 4), torch.tensor(L - 4, dtype=torch.int32), H, 2,
                            N, L, True)
    assert out.data_ptr() == u3[0].data_ptr()
    want = px.rb_smooth_halo_plain(_parts(u, 1, 4), _parts(f, 1, 4), L - 4, H, 2, N, L, True)
    assert torch.equal(out, want)


def test_wrappers_reject_what_the_kernels_do_not_take():
    u, f = _field(32), _field(33)
    with pytest.raises(ValueError, match="halo"):  # a 2-plane halo for n_iter = 2
        px.rb_smooth_halo(_parts(u, 1, 2), _parts(f, 1, 2), L - 2, H, 2, N, L)
    with pytest.raises(ValueError, match="ext planes"):
        px.rb_smooth_ext(rk.rank_ext(u, 1, L, 2), rk.rank_ext(f, 1, L, 2), L - 2, H, 2, N, L)
    with pytest.raises(ValueError, match="local planes"):
        px.residual_restrict_halo(_parts(u, 1, 2, 1), _parts(f, 1, 2, 1), L - 2, H, N, LC + 1)
    meta = tuple(t.to("meta") for t in _parts(u, 1, 1))
    with pytest.raises(ValueError, match="no kernel"):
        px.residual_df_norm_halo(meta, meta, meta, meta, L - 1, H, N, L)


# ---------------------------------------------------- planning against JAX


def test_halo_ok_matches_jax():
    for Lr in range(0, 26):
        for bi in range(0, 18):
            for halo in (1, 2, 4, 6):
                assert px.halo_ok(Lr, bi, halo) == jpx.halo_ok(Lr, bi, halo), (Lr, bi, halo)


@pytest.mark.parametrize("num_levels", [3, 4, 5, 7, 8])
def test_plan_sharding_matches_jax(num_levels):
    for n_dev in (1, 2, 3, 4, 8):
        for min_local in (2, 4):
            want = jsh.plan_sharding(JHierarchy(ndim=3, coarse_n=5, num_levels=num_levels),
                                     n_dev, min_local=min_local)
            got = sh.plan_sharding(mg.Hierarchy(ndim=3, coarse_n=5, num_levels=num_levels),
                                   n_dev, min_local=min_local)
            assert (got.n_dev, got.n_sharded, got.fine_local) == \
                (want.n_dev, want.n_sharded, want.fine_local)
            assert [got.local_planes(d) for d in range(got.n_sharded + 1)] == \
                [want.local_planes(d) for d in range(want.n_sharded + 1)]
