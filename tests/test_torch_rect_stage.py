"""The one-pass rect smoothing stages (K1 ``rb_smooth_fused``, K2
``rb_smooth_from_zero_fused`` and K4 ``prolong_smooth_fused``,
multigrid_parallel_tpu_torch.ops.pallas3d) on the CPU: their tile plan,
an emulation of the CUDA kernels' schedule held against the plain
versions, and the wrappers' CPU contract.

The CUDA stage kernel (ops/csrc/rect.cuh, ``stage_body``) cannot run here,
so its schedule is emulated in torch, block by block, as the kernel runs
it. A field row (i, j) is held as two colour rows of slots, slot kk of a
colour holding k = 2 kk + 1 + p (p = (i + j) mod 2 for red, 1 - that for
black), the colour with p = 1 also k = 0 at slot -1; the plan's boxes with
halos of 2 n_iter planes and rows (and k_halo slots where k is tiled);
tile planes filled with NaN outside the loaded box and at the slots that
hold no point of the field; a ring of tile planes for each colour as deep
as the kernel's (a plane gone from a ring raises); K4's correction e + P
ec of each plane as it arrives, K2's tile starting as zeros, K1's loaded
from its initial guess, boundary included; the skewed
wavefront (half-sweep s at plane p - 2 s once plane p has arrived, all
half-sweeps of a step reading before any writes, as the kernel runs them
at once), each half-sweep on its region, the loaded box shrunk by s,
updating its colour in place, the neighbours summed in the plain version's
order; and both colours of a plane written a step after its last
half-sweep. A halo too shallow reads NaN or a missing plane, so the
emulation must equal the plain versions bit for bit. The card tests hold
the kernels themselves against the plain versions (tests/test_torch_cuda.py).
"""

import numpy as np
import pytest
import torch

from multigrid_parallel_tpu_torch.ops import pallas3d as tpk
from multigrid_parallel_tpu_torch.ops import pallas_split as tps
from multigrid_parallel_tpu_torch.ops.stencils_3d import BLACK, RED

torch.set_num_threads(1)

PLAN_SIZES = [5, 9, 11, 16, 17, 33, 65, 129, 257, 513, 1025]
H100_SMS = 132
NAN = float("nan")


def _spans(extent, size):
    return [(a, min(a + size, extent)) for a in range(0, extent, size)]


@pytest.mark.parametrize("prolong", [False, True], ids=["k2", "k4"])
@pytest.mark.parametrize("n_iter", [1, 2])
@pytest.mark.parametrize("n", PLAN_SIZES)
def test_rect_plan_covers_the_field_once(n, n_iter, prolong):
    """The owned boxes tile every axis exactly (n planes, n rows, n // 2
    slots of each colour); halos of 2 n_iter (k_halo at least that, and a
    multiple of 4 like the k tile, where k is tiled); shared memory within
    a Hopper block's 232,448 B, the formula the launchers check; the box
    schedule up to RECT_BOX_MAX_N, the wavefront past it."""
    s = n // 2
    plan = tps._stage_plan(n, n_iter, H100_SMS, prolong=prolong, rect=True)
    assert plan.rect and plan.halo == 2 * n_iter
    width = plan.bk + 2 * plan.k_halo if plan.k_halo else -(-s // 4) * 4 + 4
    assert plan.box == (n <= tps.RECT_BOX_MAX_N)
    assert plan.smem == tps._stage_smem(n_iter, plan.bj, width, prolong, rect=True,
                                        box_bi=plan.bi if plan.box else 0)
    assert plan.smem <= tps.SMEM_MAX == 232_448
    assert (plan.k_halo == 0 and plan.bk == s
            or plan.k_halo >= plan.halo and plan.k_halo % 4 == 0 and plan.bk % 4 == 0
            and 4 <= plan.bk < s)
    assert 32 <= plan.threads <= tps.STAGE_MAX_THREADS and plan.threads % 32 == 0
    for extent, size, count in zip((n, n, s), (plan.bi, plan.bj, plan.bk), plan.tiles):
        spans = _spans(extent, size)
        assert len(spans) == count and all(a < b for a, b in spans)
        assert [a for a, _ in spans[1:]] == [b for _, b in spans[:-1]]
        assert spans[0][0] == 0 and spans[-1][1] == extent
    assert plan.blocks == np.prod(plan.tiles)


def test_rect_plan_at_257_fills_the_card():
    """The main path's plans (257^3, n_iter 2, K2 and K4): whole k rows, one
    wave on the H100's 132 SMs, a warp a tile row; K4's holds its coarse
    ring too. 129^3 takes whole rows as well."""
    for prolong in (False, True):
        plan = tps._stage_plan(257, 2, H100_SMS, prolong=prolong, rect=True)
        assert (plan.k_halo, plan.bk) == (0, 128)
        assert 120 <= plan.blocks <= 132 * (tps.SM_SMEM // (plan.smem + 1024))
        assert plan.threads == 32 * min(plan.bj + 2 * plan.halo, tps.RECT_MAX_THREADS // 32)
        assert plan.smem == tps._stage_smem(2, plan.bj, 132, prolong, rect=True) <= tps.SMEM_MAX
        assert tps._stage_plan(129, 2, H100_SMS, prolong=prolong, rect=True).k_halo == 0
    assert tps._stage_plan(513, 2, H100_SMS, rect=True).k_halo > 0


def test_rect_plan_rejects_what_the_kernel_does_not_run():
    with pytest.raises(ValueError, match="1 or 2"):
        tps._stage_plan(17, 3, H100_SMS, rect=True)


# ------------------------------------------------------ the layout, emulated


def _slot_k(n):
    """(k_red, k_black), each (n, n, n // 2 + 1): the k that slot kk - 1
    of the colour holds in row (i, j), k = 2 kk - 1 + p; outside [0, n)
    where the slot holds no point."""
    idx = torch.arange(n)
    q = (idx[:, None, None] + idx[None, :, None]) % 2
    kk = torch.arange(-1, n // 2)[None, None, :]
    return 2 * kk + 1 + q, 2 * kk + 2 - q


def _deinterleave(x):
    """(n, n, n) field -> its colours, each (n, n, n // 2 + 1), slot kk at
    index kk + 1; NaN where a slot holds no point."""
    n = x.shape[0]
    out = []
    for k in _slot_k(n):
        ok = (k >= 0) & (k < n)
        vals = torch.gather(x, 2, k.clamp(0, n - 1))
        out.append(torch.where(ok, vals, torch.full_like(vals, NAN)))
    return out


def _interleave(colours):
    n = colours[0].shape[0]
    out = torch.full((n, n, n), NAN, dtype=colours[0].dtype)
    for x, k in zip(colours, _slot_k(n)):
        ok = (k >= 0) & (k < n)
        out[ok.nonzero(as_tuple=True)[:2] + (k[ok],)] = x[ok]
    return out


def test_layout_round_trip_holds_every_point_once():
    for n in (5, 16, 17):
        x = torch.randn(n, n, n)
        red, black = _deinterleave(x)
        assert int(torch.isfinite(red).sum() + torch.isfinite(black).sum()) == n ** 3
        assert torch.equal(_interleave([red, black]), x)
        idx = torch.arange(n)
        ij = idx[:, None, None] + idx[None, :, None]
        for k, odd in zip(_slot_k(n), (1, 0)):  # red holds (i + j + k) odd
            assert bool(((ij + k) % 2 == odd).all())


def _emulate_launch(ins, fs, color0, h, plan, corr=None):
    """One rect stage launch as the kernel runs it: stage_body's wavefront
    or, for a box plan, box_body. ``ins``, ``fs`` and ``corr`` (K4's P ec,
    or None) are de-interleaved by stage colour ([0] the first
    half-sweep's colour, ``color0``); K2's zero tile is a zero ``ins``.
    Returns the outputs by stage colour and how many blocks wrote each
    slot."""
    n, _, s1 = ins[0].shape
    s = s1 - 1
    big_h, levels = plan.halo, 2 * plan.n_iter
    depth = 2 * levels + 3  # each colour's ring (the wavefront)
    outs = [torch.full_like(x, NAN) for x in ins]
    writes = torch.zeros((2,) + ins[0].shape, dtype=torch.int32)
    width = plan.bk + 2 * plan.k_halo if plan.k_halo else -(-s // 4) * 4 + 4
    ni, nj, nk = plan.tiles
    for ti in range(ni):
        for tj in range(nj):
            for tk in range(nk):
                i0, i1 = ti * plan.bi, min(ti * plan.bi + plan.bi, n)
                j0, j1 = tj * plan.bj, min(tj * plan.bj + plan.bj, n)
                k0, k1 = tk * plan.bk, min(tk * plan.bk + plan.bk, s)
                jb0, kb0 = j0 - big_h, (k0 - plan.k_halo if plan.k_halo else -4)
                ia, ib = max(i0 - big_h, 0), min(i1 + big_h, n)
                ja, jb = max(jb0, 0), min(j1 + big_h, n)
                ka, kb = max(kb0, -1), min(k1 + plan.k_halo, s)
                rows, cols = slice(ja - jb0, jb - jb0), slice(ka - kb0, kb - kb0)
                box = (slice(ja, jb), slice(ka + 1, kb + 1))
                tiles = [{}, {}]

                def load(q):
                    for c in (0, 1):
                        # one column past the tile: a slot's kk + 1 read at the last slot
                        t = torch.full((plan.bj + 2 * big_h, width + 1), NAN,
                                       dtype=ins[c].dtype)
                        t[rows, cols] = ins[c][q][box]
                        if corr is not None:  # e + P ec as the plane arrives
                            t[rows, cols] = t[rows, cols] + corr[c][q][box]
                        tiles[c][q] = t
                        if not plan.box:
                            tiles[c].pop(q - depth, None)  # the ring slot plane q takes

                def sweep(lvl, q):
                    """Half-sweep lvl's update of plane q: (tile, rows, cols,
                    value), or None outside its region."""
                    c = (lvl - 1) % 2
                    if not max(i0 - big_h + lvl, 1) <= q < min(i1 + big_h - lvl, n - 1):
                        return None
                    color = color0 if c == 0 else 1 - color0
                    jl, jh = max(jb0 + lvl, 1), min(j1 + big_h - lvl, n - 1)
                    kl = 0 if k0 == 0 else k0 - plan.k_halo + lvl
                    kh = s if k1 == s else k1 + plan.k_halo - lvl
                    if jh <= jl or kh <= kl:  # an empty region (a halo too short)
                        return None
                    lo, mid, hi = tiles[1 - c][q - 1], tiles[1 - c][q], tiles[1 - c][q + 1]
                    r = slice(jl - jb0, jh - jb0)
                    cl = slice(kl - kb0, kh - kb0)
                    kk = torch.arange(kl, kh)[None, :]
                    j = torch.arange(jl, jh)[:, None]
                    par = ((q + j) % 2) ^ color ^ 1
                    left = mid[r, kl - kb0 - 1:kh - kb0 - 1]
                    right = mid[r, kl - kb0 + 1:kh - kb0 + 1]
                    k_lo = torch.where(par == 0, left, mid[r, cl])
                    k_hi = torch.where(par == 0, mid[r, cl], right)
                    r_lo = slice(jl - jb0 - 1, jh - jb0 - 1)
                    r_hi = slice(jl - jb0 + 1, jh - jb0 + 1)
                    acc = lo[r, cl] + hi[r, cl] + mid[r_lo, cl] + mid[r_hi, cl] + k_lo + k_hi
                    upd = (acc - (h * h) * fs[c][q, jl:jh, kl + 1:kh + 1]) * (1.0 / 6.0)
                    live = 2 * kk + 1 + par <= n - 2
                    dst = tiles[c][q]
                    return dst, r, cl, torch.where(live, upd, dst[r, cl])

                def run(updates):  # all of a step (or half-sweep) reads before any writes
                    for dst, r, cl, value in [u for u in updates if u is not None]:
                        dst[r, cl] = value

                def store(q):
                    lo_slot = -1 if k0 == 0 else k0  # a block owns k = 0 with slot 0
                    for c in (0, 1):
                        outs[c][q, j0:j1, lo_slot + 1:k1 + 1] = tiles[c][q][
                            j0 - jb0:j1 - jb0, lo_slot - kb0:k1 - kb0]
                        writes[c, q, j0:j1, lo_slot + 1:k1 + 1] += 1

                if plan.box:  # every plane, then the half-sweeps one by one
                    for q in range(ia, ib):
                        load(q)
                    for lvl in range(1, levels + 1):
                        run([sweep(lvl, q) for q in range(ia, ib)])
                    for q in range(i0, i1):
                        store(q)
                    continue
                load(ia)
                for p in range(ia, i1 + 2 * levels + 1):
                    if p + 1 < ib:
                        load(p + 1)
                    run([sweep(lvl, p - 2 * lvl) for lvl in range(1, levels + 1)])
                    # both colours' last half-sweeps finished a step ago
                    if i0 <= p - 1 - 2 * levels < i1:
                        store(p - 1 - 2 * levels)
    return outs, writes


def _by_stage(colours, color0):
    """(red, black) by stage colour, and back (the same swap)."""
    return list(colours) if color0 == RED else [colours[1], colours[0]]


def _check_writes(writes, n):
    """Every point of the field written by exactly one block."""
    exists = torch.stack([torch.isfinite(x) for x in _deinterleave(torch.zeros(n, n, n))])
    assert torch.equal(writes[exists], torch.ones_like(writes[exists]))


def _emulate_k2(f, h, n_iter, red_first, plan_of):
    return _emulate_k1(torch.zeros_like(f), f, h, n_iter, red_first, plan_of)


def _emulate_k1(u, f, h, n_iter, red_first, plan_of):
    """K1 from the initial guess u (K2: a zero one), chunk after chunk."""
    n = f.shape[0]
    color0 = RED if red_first else BLACK
    fs = _by_stage(_deinterleave(f), color0)
    for chunk in tps._stage_chunks(n_iter):
        outs, writes = _emulate_launch(_by_stage(_deinterleave(u), color0), fs, color0, h,
                                       plan_of(chunk))
        _check_writes(writes, n)
        u = _interleave(_by_stage(outs, color0))
    return u


def _emulate_k4(ec, e, r, h, n_iter, plan_of):
    n = e.shape[0]
    t = ec
    for axis in (1, 2, 0):
        t = tpk._interp_axis(t, axis)
    fs = _by_stage(_deinterleave(r), BLACK)
    u, corr = e, _by_stage(_deinterleave(t), BLACK)
    for chunk in tps._stage_chunks(n_iter):
        outs, writes = _emulate_launch(_by_stage(_deinterleave(u), BLACK), fs, BLACK, h,
                                       plan_of(chunk), corr=corr)
        _check_writes(writes, n)
        u, corr = _interleave(_by_stage(outs, BLACK)), None
    return u


def _plans(kind, n):
    """The plan of each launch size (n_iter 1, 2), all with tiles smaller
    than the field: the planner's for 4 SMs (at 17^3 and 33^3 a box), its
    wavefront's, the planner's for the H100's 132 SMs, 8 whole rows by 7
    planes, 4-slot k tiles with the 4-slot k halo, 8 rows by 8 planes (both
    wavefronts), or a box of 5 planes by 4 rows."""
    s = n // 2

    def plan(n_iter):
        if kind == "default":
            return tps._stage_plan(n, n_iter, 4, rect=True)
        if kind == "wave":
            return tps._wave_plan(n, n_iter, 4, False, True)
        if kind == "h100":
            return tps._stage_plan(n, n_iter, H100_SMS, rect=True)
        if kind == "rows":
            return tps.StagePlan(n, n_iter, 2 * n_iter, 0, 7, 8, s, 256, 0, True)
        if kind == "box":
            return tps.StagePlan(n, n_iter, 2 * n_iter, 0, 5, 4, s, 256, 0, True, True)
        return tps.StagePlan(n, n_iter, 2 * n_iter, tps.STAGE_K_HALO, 8, 8, 4, 256, 0, True)

    return plan


def _field(rng, n):
    """Random at every point, the boundary too."""
    return torch.from_numpy(rng.standard_normal((n, n, n)).astype(np.float32))


@pytest.mark.parametrize("kind", ["default", "wave", "rows", "k_tiles", "box"])
@pytest.mark.parametrize("n_iter", [1, 2, 3])
@pytest.mark.parametrize("n", [17, 33])
def test_emulated_k2_schedule_matches_plain(n, n_iter, kind):
    h = 1.0 / (n - 1)
    f = _field(np.random.default_rng(n + n_iter), n)
    plan_of = _plans(kind, n)
    assert plan_of(2).blocks > 1
    for red_first in (True, False):
        got = _emulate_k2(f, h, n_iter, red_first, plan_of)
        want = tpk.rb_smooth_from_zero_plain(f, h, n_iter, red_first)
        assert torch.equal(got, want), (n, n_iter, kind, red_first)


@pytest.mark.parametrize("kind", ["default", "wave", "rows", "k_tiles", "box"])
@pytest.mark.parametrize("n_iter", [1, 2, 3])
@pytest.mark.parametrize("n", [17, 33])
def test_emulated_k4_schedule_matches_plain(n, n_iter, kind):
    h = 1.0 / (n - 1)
    rng = np.random.default_rng(2 * n + n_iter)
    e, r, ec = _field(rng, n), _field(rng, n), _field(rng, (n + 1) // 2)
    got = _emulate_k4(ec, e, r, h, n_iter, _plans(kind, n))
    assert torch.equal(got, tpk.prolong_smooth_plain(ec, e, r, h, n_iter)), (n, n_iter, kind)


@pytest.mark.parametrize("kind", ["wave", "box"])
@pytest.mark.parametrize("n_iter", [1, 2, 3])
@pytest.mark.parametrize("n", [17, 33])
def test_emulated_k1_schedule_matches_plain(n, n_iter, kind):
    """K1's schedule with its tile loaded from an initial guess random at
    every point, faces included: they come through to the output as they
    were."""
    h = 1.0 / (n - 1)
    rng = np.random.default_rng(3 * n + n_iter)
    u, f = _field(rng, n), _field(rng, n)
    plan_of = _plans(kind, n)
    assert plan_of(2).blocks > 1 and plan_of(2).box == (kind == "box")
    for red_first in (True, False):
        got = _emulate_k1(u, f, h, n_iter, red_first, plan_of)
        assert torch.equal(got, tpk.rb_smooth_plain(u, f, h, n_iter, red_first)), red_first


@pytest.mark.parametrize("kind", ["h100", "box"])
def test_emulated_k1_schedule_on_the_study_size(kind):
    """The smoother study's n = 50, an even size, on the box plan it takes
    on the H100 and on a hand box: the colour holding the even k's has no
    point at its last slot (k = n), the other holds k = n - 1 there."""
    n, h = 50, 1.0 / 49
    rng = np.random.default_rng(50)
    u, f = _field(rng, n), _field(rng, n)
    plan_of = _plans(kind, n)
    assert plan_of(1).box and plan_of(1).blocks > 1
    for n_iter, red_first in ((1, True), (1, False), (2, True), (3, False)):
        got = _emulate_k1(u, f, h, n_iter, red_first, plan_of)
        assert torch.equal(got, tpk.rb_smooth_plain(u, f, h, n_iter, red_first)), n_iter


def test_emulated_k2_schedule_on_an_even_size():
    """K2 takes any n: at an even one the colour holding the even k's has no
    point at its last slot (k = n)."""
    n, h = 16, 1.0 / 15
    f = _field(np.random.default_rng(16), n)
    for n_iter in (1, 2, 3):
        got = _emulate_k2(f, h, n_iter, True, _plans("default", n))
        assert torch.equal(got, tpk.rb_smooth_from_zero_plain(f, h, n_iter, True)), n_iter


@pytest.mark.parametrize("box", [False, True], ids=["wave", "box"])
def test_emulation_finds_a_shallow_halo(box):
    """The emulation is a check: the same schedule with halos one short
    leaves stale or NaN values in the owned box and no longer equals the
    plain version, for K1, K2 and K4, on the wavefront and on the box."""
    n, n_iter = 17, 2
    h = 1.0 / (n - 1)
    rng = np.random.default_rng(5)
    e, r, ec = _field(rng, n), _field(rng, n), _field(rng, (n + 1) // 2)
    plan = tps.StagePlan(n, n_iter, 2 * n_iter, 0, 8, 8, 8, 256, 0, True, box)
    short = plan._replace(halo=plan.halo - 1)
    want1 = tpk.rb_smooth_plain(e, r, h, n_iter, False)
    want2 = tpk.rb_smooth_from_zero_plain(r, h, n_iter, True)
    want4 = tpk.prolong_smooth_plain(ec, e, r, h, n_iter)
    assert torch.equal(_emulate_k1(e, r, h, n_iter, False, lambda _: plan), want1)
    assert torch.equal(_emulate_k2(r, h, n_iter, True, lambda _: plan), want2)
    assert torch.equal(_emulate_k4(ec, e, r, h, n_iter, lambda _: plan), want4)
    with pytest.raises(AssertionError):
        assert torch.equal(_emulate_k1(e, r, h, n_iter, False, lambda _: short), want1)
    with pytest.raises(AssertionError):  # NaN reaches an owned point, or the values differ
        assert torch.equal(_emulate_k2(r, h, n_iter, True, lambda _: short), want2)
    with pytest.raises(AssertionError):
        assert torch.equal(_emulate_k4(ec, e, r, h, n_iter, lambda _: short), want4)


# ------------------------------------------------- the wrappers on the CPU


def test_k2_k4_return_fresh_fields_and_leave_their_inputs():
    n, h = 17, 1.0 / 16
    rng = np.random.default_rng(7)
    e, r, ec = _field(rng, n), _field(rng, n), _field(rng, (n + 1) // 2)
    before = [x.clone() for x in (e, r, ec)]
    got4 = tpk.prolong_smooth_fused(ec, e, r, h, 2)
    got2 = tpk.rb_smooth_from_zero_fused(r, h, 2)
    assert all(torch.equal(a, b) for a, b in zip((e, r, ec), before))
    assert got4 is not e and got2 is not r
    assert torch.equal(got4, tpk.prolong_smooth_plain(ec, e, r, h, 2))
    assert torch.equal(got2, tpk.rb_smooth_from_zero_plain(r, h, 2))
    assert float(got2[0].abs().max()) == 0.0  # K2's boundary is zero
    with pytest.raises(ValueError, match="n_iter"):
        tpk.rb_smooth_from_zero_fused(r, h, 0)
    tpk.reset_launches()
    tpk.rb_smooth_from_zero_fused(r, h, 3)
    assert tpk.LAUNCHES["rb_smooth_from_zero_fused"] == 0  # no launch on the CPU


def test_k1_returns_a_fresh_field_and_leaves_its_input():
    """K1 returns a fresh field (its boundary u's), u untouched; its
    per-sweep form updates u in place; no launch on the CPU."""
    n, h = 17, 1.0 / 16
    rng = np.random.default_rng(8)
    u, f = _field(rng, n), _field(rng, n)
    u0 = u.clone()
    want = tpk.rb_smooth_plain(u, f, h, 3, True)
    tpk.reset_launches()
    got = tpk.rb_smooth_fused(u, f, h, 3, True)
    assert got is not u and torch.equal(u, u0) and torch.equal(got, want)
    assert torch.equal(got[0], u0[0]) and torch.equal(got[:, :, -1], u0[:, :, -1])
    assert tpk.rb_smooth_fused_per_sweep(u, f, h, 3, True) is u and torch.equal(u, want)
    assert tpk.LAUNCHES["rb_smooth_fused"] == 0
    assert tpk.PER_SWEEP_LAUNCHES == {"rb_smooth_fused_per_sweep": 0}
    with pytest.raises(ValueError, match="n_iter"):
        tpk.rb_smooth_fused(u, f, h, 0)


def test_stage_plans_candidates_fit():
    """The plan bench's candidates (utils/stage_plans.py): the planner's,
    the wavefront's and box and wavefront plans of other block sizes, each
    a plan the launchers take (shared memory within a block's, threads
    within the launch bound, the smem formula)."""
    from multigrid_parallel_tpu_torch.utils import stage_plans as sp

    for n in (9, 65, 129):
        for prolong in (False, True):
            plans = sp.candidates(n, prolong, H100_SMS)
            assert {"planner", "wave"} <= set(plans) and len(plans) > 4
            for plan in plans.values():
                width = tps._stage_width(n, plan.bk, plan.k_halo, rect=True)
                assert plan.rect and plan.smem <= tps.SMEM_MAX
                assert plan.smem == tps._stage_smem(2, plan.bj, width, prolong, True,
                                                    box_bi=plan.bi if plan.box else 0)
                assert 32 <= plan.threads <= tps.RECT_MAX_THREADS and plan.threads % 32 == 0
