"""The i-sharded electrospray kernels of the port (K34-K36 in
multigrid_parallel_tpu_torch.ops.pallas_mixed) on simulated ranks, in one
process: their plain versions, in the ext and the halo form, against the
JAX package's Pallas kernels (interpret mode) under shard_map at 17^3 on 4
devices, and their stitched owned rows against the port's single-device
plain K13-K15 on the whole field, on the same numpy-seeded inputs; plus
the x-face BC pass of both sharded tiers (``sharded_mixed.apply_bcs_local``
and ``sharded_mixed_padded.apply_bcs_local_padded``) on 4 gloo ranks.

The trigger geometry: where L divides n - 1, global plane n - 1 is the
first row of a rank, and the BC copy there reads plane n - 2 on its left
neighbour. The stitched checks include it (33^3 at L = 16: rank 2's row 0
is plane 32; 17^3 at L = 8: plane 16) and a rank of pad planes only. The
Pallas kernels read a stale plane n - 2 wherever plane n - 1 starts one
of their block_i tiles, a rank's block included (ROADMAP queue 3), so the
Pallas checks use L = 6, which does not divide 16, in one tile a rank
(block_i = L: plane 16 is rank 2's row 4).

The ranks' segments are their own copies (tests/torch_sharded_ranks.py),
their inputs BC-consistent as the cycle hands them over (the copy-form
plain versions equal the folded kernels there). On CPU tensors the
wrappers take their plain versions; the CUDA kernels are held against
those on the card (tests/test_torch_cuda.py and chip_smoke.py).

Tolerances: against Pallas, max |port - jax| <= 4 f32 ulp of the field's
max (tests/test_torch_sharded_kernels.py's rule); against the
single-device versions and the BC pass, bit for bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

import torch_sharded_ranks as rk
from multigrid_parallel_tpu.models.electrospray import electrospray_problem as jelectrospray
from multigrid_parallel_tpu.ops import pallas_mixed as jpm
from multigrid_parallel_tpu.parallel import sharded as jsh
from multigrid_parallel_tpu.parallel import sharded_padded as jsp
import multigrid_parallel_tpu_torch as mg
from multigrid_parallel_tpu_torch.ops import pallas_mixed as pm
from multigrid_parallel_tpu_torch.parallel.launch import launch
from multigrid_parallel_tpu_torch.utils import convert

torch.set_num_threads(1)

N, L, D = 17, 6, 4  # 4 ranks of 6 planes: rank 2 holds plane 16 at row 4, rank 3 pads only
NC, LC = (N + 1) // 2, L // 2
ES = mg.electrospray_problem()
H = ES.length / (N - 1)  # the electrospray spacing: not a power of two


@pytest.fixture(scope="module")
def mesh():
    return jsh.make_mesh(D)


def _pins(kind, n, seed=0):
    """(2, n, n) f32 pin planes: the electrospray patches, or a random
    x-face mask."""
    if kind == "electrospray":
        return pm.dirichlet_pin_planes(ES, n, "cpu")
    rng = np.random.default_rng(seed)
    return torch.from_numpy((rng.random((2, n, n)) < 0.3).astype(np.float32))


def _field(seed, n, rows, pin=None, zero_boundary=False):
    """A global field; BC-consistent (one BC pass) when ``pin`` is given."""
    x = torch.from_numpy(rk.global_field(np.random.default_rng(seed), n, rows, zero_boundary))
    if pin is not None:
        x[:n] = pm.apply_bcs_padded(x[:n], pin)
    return x


def _jax(x):
    return jnp.asarray(convert.to_jax_sharded([x], x.shape[1]))


def _jax_pin(pin):
    n = pin.shape[1]
    out = np.zeros((2,) + convert.jax_padded_shape(n)[1:], np.float32)
    out[:, :n, :n] = pin.numpy()
    return jnp.asarray(out)


def _shmap(fn, mesh, n_in):
    return jax.jit(jax.shard_map(fn, mesh=mesh, in_specs=(P("x"),) * n_in, out_specs=P("x"),
                                 check_vma=False))


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


# -------------------------------------------------- against the Pallas kernels


@pytest.mark.parametrize("form", ["ext", "halo"])
@pytest.mark.parametrize("n_iter,red_first", [(2, True), (1, False)])
def test_mixed_rb_smooth_matches_pallas(mesh, form, n_iter, red_first):
    pin = _pins("electrospray", N)
    u, f = _field(1, N, D * L, pin), _field(2, N, D * L)
    hh, jpin = 2 * n_iter, _jax_pin(pin)

    def local(ul, fl):
        g = jsp._gi0("x", L, hh)
        if form == "ext":
            return jpm.mixed_rb_smooth_ext(jsp._halo_ext(ul, "x", D, hh),
                                           jsp._halo_ext(fl, "x", D, hh), jpin, g, H, n_iter, N,
                                           L, red_first, block_i=L)
        return jpm.mixed_rb_smooth_halo(jsp._halo_parts(ul, "x", D, hh, hh, L),
                                        jsp._halo_parts(fl, "x", D, hh, hh, L), jpin, g, H,
                                        n_iter, N, L, red_first, block_i=L)

    want = _shmap(local, mesh, 2)(_jax(u), _jax(f))
    if form == "ext":
        got = _stitch(lambda r: pm.mixed_rb_smooth_ext(rk.rank_ext(u, r, L, hh),
                                                       rk.rank_ext(f, r, L, hh), pin,
                                                       r * L - hh, H, n_iter, N, L, red_first))
    else:
        got = _stitch(lambda r: pm.mixed_rb_smooth_halo(rk.rank_parts(u, r, L, hh, hh, L),
                                                        rk.rank_parts(f, r, L, hh, hh, L), pin,
                                                        r * L - hh, H, n_iter, N, L, red_first))
    _assert_ulps(got[:N], _valid(want))


@pytest.mark.parametrize("form", ["ext", "halo"])
def test_mixed_rb_smooth_from_zero_matches_pallas(mesh, form):
    pin = _pins("electrospray", N)
    f, hh, jpin = _field(3, N, D * L), 4, _jax_pin(pin)

    def local(fl):
        g = jsp._gi0("x", L, hh)
        if form == "ext":
            return jpm.mixed_rb_smooth_from_zero_ext(jsp._halo_ext(fl, "x", D, hh), jpin, g, H,
                                                     2, N, L, block_i=L)
        return jpm.mixed_rb_smooth_from_zero_halo(jsp._halo_parts(fl, "x", D, hh, hh, L), jpin,
                                                  g, H, 2, N, L, block_i=L)

    want = _shmap(local, mesh, 1)(_jax(f))
    if form == "ext":
        got = _stitch(lambda r: pm.mixed_rb_smooth_from_zero_ext(rk.rank_ext(f, r, L, hh), pin,
                                                                 r * L - hh, H, 2, N, L))
    else:
        got = _stitch(lambda r: pm.mixed_rb_smooth_from_zero_halo(
            rk.rank_parts(f, r, L, hh, hh, L), pin, r * L - hh, H, 2, N, L))
    _assert_ulps(got[:N], _valid(want))


@pytest.mark.parametrize("form", ["ext", "halo"])
@pytest.mark.parametrize("n_iter", [1, 2])
def test_mixed_prolong_smooth_matches_pallas(mesh, form, n_iter):
    # the coarse correction's boundary is live in the mixed case
    pin = _pins("electrospray", N)
    ec, e, r_ = _field(9, NC, D * LC), _field(10, N, D * L), _field(11, N, D * L)
    hh, hc, jpin = 2 * n_iter, n_iter + 1, _jax_pin(pin)

    def local(ecl, el, rl):
        g = jsp._gi0("x", L, hh)
        if form == "ext":
            return jpm.mixed_prolong_smooth_ext(jsp._halo_ext(ecl, "x", D, hc),
                                                jsp._halo_ext(el, "x", D, hh),
                                                jsp._halo_ext(rl, "x", D, hh), jpin, g, H, n_iter,
                                                N, L, block_i=L)
        return jpm.mixed_prolong_smooth_halo(jsp._halo_parts(ecl, "x", D, n_iter, hc, LC),
                                             jsp._halo_parts(el, "x", D, hh, hh, L),
                                             jsp._halo_parts(rl, "x", D, hh, hh, L), jpin, g, H,
                                             n_iter, N, L, block_i=L)

    want = _shmap(local, mesh, 3)(_jax(ec), _jax(e), _jax(r_))
    if form == "ext":
        got = _stitch(lambda r: pm.mixed_prolong_smooth_ext(
            rk.rank_ext(ec, r, LC, hc), rk.rank_ext(e, r, L, hh), rk.rank_ext(r_, r, L, hh), pin,
            r * L - hh, H, n_iter, N, L))
    else:
        got = _stitch(lambda r: pm.mixed_prolong_smooth_halo(
            rk.rank_parts(ec, r, LC, n_iter, hc, LC), rk.rank_parts(e, r, L, hh, hh, L),
            rk.rank_parts(r_, r, L, hh, hh, L), pin, r * L - hh, H, n_iter, N, L))
    _assert_ulps(got[:N], _valid(want))


def test_pallas_ext_kernel_reads_a_stale_plane_where_plane_n_minus_1_starts_a_tile(mesh):
    """The reference fault of ROADMAP queue 3, held so that its record stays
    true: the JAX ext kernel's final BC pass copies plane n - 2 into plane
    n - 1 from its VMEM slab, whose rows before the output tile went stale
    in the 2 n_iter in-place half-sweeps. With block_i = 2, plane 16 starts
    a tile of rank 2 (its row 4); the port's kernel has no tile there and
    equals K13."""
    pin = _pins("electrospray", N)
    u, f = _field(1, N, D * L, pin), _field(2, N, D * L)
    hh, jpin = 4, _jax_pin(pin)

    def local(ul, fl):
        return jpm.mixed_rb_smooth_ext(jsp._halo_ext(ul, "x", D, hh),
                                       jsp._halo_ext(fl, "x", D, hh), jpin, jsp._gi0("x", L, hh),
                                       H, 2, N, L, True, block_i=2)

    want = pm.mixed_rb_smooth_plain(u[:N], f[:N], pin, H, 2, True)
    jax_got = _valid(_shmap(local, mesh, 2)(_jax(u), _jax(f)))
    err = np.abs(jax_got - want.numpy()).max(axis=(1, 2))
    assert err[N - 1] > 1e-3 * float(want.abs().max()), err  # plane 16 only
    assert not err[:N - 1].any(), err
    got = _stitch(lambda r: pm.mixed_rb_smooth_ext(rk.rank_ext(u, r, L, hh),
                                                   rk.rank_ext(f, r, L, hh), pin, r * L - hh, H,
                                                   2, N, L, True))
    assert torch.equal(got[:N], want)


# ------------------------------- stitched against the single-device kernels

# (n, L) on 4 ranks, each with a rank of pad planes only: 17 / 6 plain;
# 17 / 8 and 33 / 16 the trigger geometry (plane n - 1 is rank 2's row 0)
GEOMETRIES = [(17, 6), (17, 8), (33, 16)]


def _stitched_against_single(kernel, n, Lr, pins):
    """[(stitched ext form or None, stitched halo form, want)] of one
    kernel over n_iter (and the order of K34); a rank's left halo is one
    plane deeper where plane n - 1 is its first row."""
    h, nc, lc = ES.length / (n - 1), (n + 1) // 2, Lr // 2
    rows = D * Lr
    pin = _pins(pins, n, seed=n + Lr)
    trigger = (n - 1) % Lr == 0
    u, f = _field(20, n, rows, pin), _field(21, n, rows)
    ec = _field(22, nc, D * lc)
    outs = []
    for n_iter in (1, 2):
        hh = 2 * n_iter

        def kl(r):
            return hh + (r * Lr == n - 1)

        def parts(x, r):
            return rk.rank_parts(x, r, Lr, kl(r), hh)

        def ext(fn):
            return None if trigger else _stitch(fn)[:n]

        g = [r * Lr - hh for r in range(D)]
        if kernel == "K34":
            for red in (True, False):
                want = pm.mixed_rb_smooth_plain(u[:n], f[:n], pin, h, n_iter, red)
                outs.append((
                    ext(lambda r: pm.mixed_rb_smooth_ext(rk.rank_ext(u, r, Lr, hh),
                                                         rk.rank_ext(f, r, Lr, hh), pin, g[r], h,
                                                         n_iter, n, Lr, red)),
                    _stitch(lambda r: pm.mixed_rb_smooth_halo(parts(u, r), parts(f, r), pin,
                                                              g[r], h, n_iter, n, Lr, red)),
                    want))
        elif kernel == "K35":
            want = pm.mixed_rb_smooth_from_zero_plain(f[:n], pin, h, n_iter)
            outs.append((
                ext(lambda r: pm.mixed_rb_smooth_from_zero_ext(rk.rank_ext(f, r, Lr, hh), pin,
                                                               g[r], h, n_iter, n, Lr)),
                _stitch(lambda r: pm.mixed_rb_smooth_from_zero_halo(
                    parts(f, r), pin, torch.tensor([g[r]]), h, n_iter, n, Lr)),
                want))
        else:
            want = pm.mixed_prolong_smooth_plain(ec[:nc], u[:n], f[:n], pin, h, n_iter)
            outs.append((
                ext(lambda r: pm.mixed_prolong_smooth_ext(
                    rk.rank_ext(ec, r, lc, n_iter + 1), rk.rank_ext(u, r, Lr, hh),
                    rk.rank_ext(f, r, Lr, hh), pin, g[r], h, n_iter, n, Lr)),
                _stitch(lambda r: pm.mixed_prolong_smooth_halo(
                    rk.rank_parts(ec, r, lc, kl(r) - n_iter, n_iter + 1, 2), parts(u, r),
                    rk.rank_parts(f, r, Lr, kl(r), hh, 3), pin, g[r], h, n_iter, n, Lr)),
                want))
    return outs


@pytest.mark.parametrize("n,Lr", GEOMETRIES)
@pytest.mark.parametrize("kernel", ["K34", "K35", "K36"])
def test_stitched_rows_equal_single_device(kernel, n, Lr):
    for pins in ("electrospray", "random"):
        for ext, halo, want in _stitched_against_single(kernel, n, Lr, pins):
            assert not halo[n:].any(), "a pad plane was written"
            halo = halo[:n]
            assert torch.equal(halo, want), (pins, float((halo - want).abs().max()))
            if ext is not None:
                assert torch.equal(ext, want), (pins, float((ext - want).abs().max()))


def test_trigger_geometry_needs_the_deeper_left_halo():
    """Plane n - 1 at rank 2's row 0 (33^3, L = 16): the ext form (2 n_iter
    planes a side, as the JAX kernel takes it) and a 2 n_iter left halo
    raise; the halo form with one more left plane is what the stitched
    test holds against K13."""
    n, Lr, hh = 33, 16, 4
    h, pin = ES.length / (n - 1), _pins("electrospray", n)
    u, f = _field(40, n, D * Lr, pin), _field(41, n, D * Lr)
    with pytest.raises(ValueError, match="halo"):
        pm.mixed_rb_smooth_ext(rk.rank_ext(u, 2, Lr, hh), rk.rank_ext(f, 2, Lr, hh), pin,
                               2 * Lr - hh, h, 2, n, Lr)
    with pytest.raises(ValueError, match="halo"):
        pm.mixed_rb_smooth_from_zero_halo(rk.rank_parts(f, 2, Lr, hh, hh), pin, 2 * Lr - hh, h,
                                          2, n, Lr)
    u3 = rk.rank_parts(u, 2, Lr, hh + 1, hh)
    before = [t.clone() for t in u3]
    out = pm.mixed_rb_smooth_halo(u3, rk.rank_parts(f, 2, Lr, hh + 1, hh), pin, 2 * Lr - hh, h,
                                  2, n, Lr)
    # a fresh body, u3 left as it is, as on the card
    assert all(out.data_ptr() != t.data_ptr() for t in u3)
    assert all(torch.equal(a, b) for a, b in zip(u3, before))


def test_sharded_mixed_wrappers_reject_what_the_kernels_do_not_take():
    pin = _pins("electrospray", N)
    u, f = _field(30, N, D * L, pin), _field(31, N, D * L)
    u3, f3 = rk.rank_parts(u, 1, L, 4, 4), rk.rank_parts(f, 1, L, 4, 4)
    with pytest.raises(ValueError, match="pin planes"):
        pm.mixed_rb_smooth_halo(u3, f3, pin[:, 1:], L - 4, H, 2, N, L)
    with pytest.raises(ValueError, match="pin planes on"):
        pm.mixed_rb_smooth_from_zero_halo(f3, pin.to("meta"), L - 4, H, 2, N, L)
    with pytest.raises(ValueError, match="n_iter"):
        pm.mixed_prolong_smooth_halo(rk.rank_parts(u[:D * LC, :NC, :NC], 1, LC, 1, 1), u3, f3,
                                     pin, L - 4, H, 0, N, L)
    meta = tuple(t.to("meta") for t in u3)
    with pytest.raises(ValueError, match="no kernel"):
        pm.mixed_rb_smooth_halo(meta, meta, pin.to("meta"), L - 4, H, 2, N, L)


# --------------------------------- the tiers' BC pass in the trigger geometry


@pytest.fixture(scope="module")
def bcs_17():
    """apply_bcs_local(_padded) on 4 gloo ranks at 17^3 with L = 8 (plane
    16 is rank 2's row 0), and the input field."""
    u = rk.global_field(np.random.default_rng(50), N, D * 8)
    return launch(rk.mixed_bcs, D, u, N, 8, backend="gloo", device="cpu", timeout=120.0)[0], u


@pytest.mark.parametrize("label", ["zero", "patches", "padded"])
def test_apply_bcs_local_shard_boundary(bcs_17, label):
    """The x-face copy's source lives on the previous rank where plane n - 1
    is a rank's row 0 (JAX: tests/test_sharded_mixed.py:85-110): bit for
    bit the single-device BC pass, pad planes untouched."""
    got, u = bcs_17
    got = got[label]
    pin = _pins("electrospray", N)
    vals = ES.boundary_masks(N)[1]
    vals = torch.from_numpy(np.stack([vals[0], vals[N - 1]])).float()
    cube = torch.from_numpy(u[:N])
    want = (pm.apply_bcs_padded(cube.clone(), torch.zeros_like(pin)) if label == "zero"
            else pm.apply_bcs_padded(cube.clone(), pin, vals))
    assert torch.equal(got[:N], want), float((got[:N] - want).abs().max())
    assert not got[N:].any()
