"""The one-pass rect smoothing stages (K1 ``rb_smooth_fused``, K2
``rb_smooth_from_zero_fused`` and K4 ``prolong_smooth_fused``,
multigrid_parallel_tpu_torch.ops.pallas3d) on the CPU: their tile plan,
an emulation of the CUDA kernels' schedule held against the plain
versions, and the wrappers' CPU contract.

The CUDA stage kernel (ops/csrc/rect.cuh, ``stage_body``) cannot run here,
so its schedule is emulated in torch (tests/torch_stage_emulation.py,
emulate_dirichlet_launch, which K31's and K40's emulation shares), block
by block, as the kernel runs it. A field row (i, j) is held as two colour rows of slots, slot kk of a
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

import torch_stage_emulation as em
from multigrid_parallel_tpu_torch.ops import pallas3d as tpk
from multigrid_parallel_tpu_torch.ops import pallas_split as tps
from multigrid_parallel_tpu_torch.ops.stencils_3d import BLACK, RED

torch.set_num_threads(1)

PLAN_SIZES = [5, 9, 11, 16, 17, 33, 65, 129, 257, 513, 1025]
H100_SMS = 132


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


@pytest.mark.parametrize("n_iter", [1, 2])
@pytest.mark.parametrize("n", PLAN_SIZES)
def test_k26_plan_covers_the_field_once(n, n_iter):
    """K26's plan (K1's stage that also writes the residual): halos of 2
    n_iter + 1, a k tile's k_halo at least that and a multiple of 4; rings
    two planes deeper than K1's on the wavefront; shared memory within a
    block's, the formula the launcher checks; the owned boxes tile the
    field."""
    s = n // 2
    plan = tps._stage_plan(n, n_iter, H100_SMS, rect=True, resid=True)
    assert plan.rect and plan.halo == 2 * n_iter + 1 and plan.box == (n <= tps.RECT_BOX_MAX_N)
    width = plan.bk + 2 * plan.k_halo if plan.k_halo else -(-s // 4) * 4 + 4
    rows, planes = plan.bj + 2 * plan.halo, plan.bi + 2 * plan.halo if plan.box else 4 * n_iter + 5
    assert plan.smem == 2 * planes * rows * width * 4 == tps._stage_smem(
        n_iter, plan.bj, width, rect=True, box_bi=plan.bi if plan.box else 0, resid=True)
    assert plan.smem <= tps.SMEM_MAX
    assert (plan.k_halo == 0 and plan.bk == s
            or plan.k_halo >= plan.halo and plan.k_halo % 4 == 0 and plan.bk % 4 == 0
            and 4 <= plan.bk < s)
    assert 32 <= plan.threads <= tps.RECT_MAX_THREADS and plan.threads % 32 == 0
    for extent, size, count in zip((n, n, s), (plan.bi, plan.bj, plan.bk), plan.tiles):
        spans = _spans(extent, size)
        assert len(spans) == count and spans[0][0] == 0 and spans[-1][1] == extent
    with pytest.raises(ValueError, match="resid"):
        tps._stage_plan(n, n_iter, H100_SMS, resid=True)


# ------------------------------------------------------ the layout, emulated


def test_layout_round_trip_holds_every_point_once():
    for n in (5, 16, 17):
        x = torch.randn(n, n, n)
        red, black = em.deinterleave(x)
        assert int(torch.isfinite(red).sum() + torch.isfinite(black).sum()) == n ** 3
        assert torch.equal(em.interleave([red, black], n), x)
        idx = torch.arange(n)
        ij = idx[:, None, None] + idx[None, :, None]
        for k, odd in zip(em._slot_k(n), (1, 0)):  # red holds (i + j + k) odd
            assert bool(((ij + k) % 2 == odd).all())


def _check_writes(writes, n):
    """Every point of the field written by exactly one block."""
    exists = torch.stack([torch.isfinite(x) for x in em.deinterleave(torch.zeros(n, n, n))])
    assert torch.equal(writes[exists], torch.ones_like(writes[exists]))


def _emulate_k2(f, h, n_iter, red_first, plan_of):
    return _emulate_k1(torch.zeros_like(f), f, h, n_iter, red_first, plan_of)


def _emulate_k1(u, f, h, n_iter, red_first, plan_of):
    """K1 from the initial guess u (K2: a zero one), chunk after chunk."""
    n = f.shape[0]
    color0 = RED if red_first else BLACK
    fs = em.by_stage(em.deinterleave(f), color0)
    for chunk in tps._stage_chunks(n_iter):
        outs, writes = em.emulate_dirichlet_launch(em.by_stage(em.deinterleave(u), color0), fs,
                                                   color0, h, plan_of(chunk), n)
        _check_writes(writes, n)
        u = em.interleave(em.by_stage(outs, color0), n)
    return u


def _emulate_k4(ec, e, r, h, n_iter, plan_of):
    n = e.shape[0]
    t = ec
    for axis in (1, 2, 0):
        t = tpk._interp_axis(t, axis)
    fs = em.by_stage(em.deinterleave(r), BLACK)
    u, corr = e, em.by_stage(em.deinterleave(t), BLACK)
    for chunk in tps._stage_chunks(n_iter):
        outs, writes = em.emulate_dirichlet_launch(em.by_stage(em.deinterleave(u), BLACK), fs,
                                                   BLACK, h, plan_of(chunk), n, corr=corr)
        _check_writes(writes, n)
        u, corr = em.interleave(em.by_stage(outs, BLACK), n), None
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


# ---------------------------------- K26: K1's stage that writes the residual


def _resid_plans(kind, n):
    """K26's plan of each launch size, all with tiles smaller than the
    field: the planner's for 4 SMs, its wavefront's, 8 x 8 blocks of k
    tiles as wide as their k halo (2 n_iter + 1 rounded up to 4; whole rows
    where that is the row), or a box of 5 planes by 4 rows; halos of 2
    n_iter + 1."""
    s = n // 2

    def plan(n_iter):
        halo = 2 * n_iter + 1
        if kind == "default":
            return tps._stage_plan(n, n_iter, 4, rect=True, resid=True)
        if kind == "wave":
            return tps._wave_plan(n, n_iter, 4, False, True, resid=True)
        if kind == "box":
            return tps.StagePlan(n, n_iter, halo, 0, 5, 4, s, 256, 0, True, True)
        k_halo = -(-halo // 4) * 4
        if k_halo >= s:
            return tps.StagePlan(n, n_iter, halo, 0, 8, 8, s, 256, 0, True)
        return tps.StagePlan(n, n_iter, halo, k_halo, 8, 8, k_halo, 256, 0, True)

    return plan


def _emulate_k26(u, f, h, n_iter, red_first, resid_plan_of, fault=None):
    """K26: K1's stage for the leading chunks of n_iter (on K1's planner's
    plans for 4 SMs), then K1's stage that writes the residual for the
    last; (u', r)."""
    n = f.shape[0]
    color0 = RED if red_first else BLACK
    *lead, last = tps._stage_chunks(n_iter)
    for chunk in lead:
        u = _emulate_k1(u, f, h, chunk, red_first, _plans("default", n))
    ins = em.by_stage(em.deinterleave(u), color0)
    r_outs = [torch.full_like(x, em.NAN) for x in ins]
    outs, writes = em.emulate_dirichlet_launch(ins, em.by_stage(em.deinterleave(f), color0),
                                               color0, h, resid_plan_of(last), n, fault=fault,
                                               r_outs=r_outs)
    _check_writes(writes, n)
    return (em.interleave(em.by_stage(outs, color0), n),
            em.interleave(em.by_stage(r_outs, color0), n))


@pytest.mark.parametrize("kind", ["default", "wave", "tiles"])
@pytest.mark.parametrize("n_iter", [1, 2])
@pytest.mark.parametrize("n", [9, 17, 33])
def test_emulated_k26_schedule_matches_plain(n, n_iter, kind):
    """K26's schedule (the box up to 129^3 on the planner's plan, the
    wavefront with its deeper rings, k tiles) on u and f random at every
    point: u' and r bit for bit the plain version's (K1's, then R's), both
    orders."""
    h = 1.0 / (n - 1)
    rng = np.random.default_rng(5 * n + n_iter)
    u, f = _field(rng, n), _field(rng, n)
    plan_of = _resid_plans(kind, n)
    assert plan_of(n_iter).blocks > 1 or n == 9
    for red_first in (True, False):
        got = _emulate_k26(u, f, h, n_iter, red_first, plan_of)
        want = tpk.rb_smooth_residual_plain(u, f, h, n_iter, red_first)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]), red_first


@pytest.mark.parametrize("box", [False, True], ids=["wave", "box"])
def test_emulation_finds_k26_faults(box):
    """The emulation is a check: K26 with K1's halo of 2 n_iter, with a
    plane's residual taken before the next plane's last half-sweep, or with
    r's boundary left unwritten, no longer equals the plain version."""
    n, n_iter = 17, 2
    h = 1.0 / (n - 1)
    rng = np.random.default_rng(6)
    u, f = _field(rng, n), _field(rng, n)
    plan = tps.StagePlan(n, n_iter, 2 * n_iter + 1, 0, 5, 4, n // 2, 256, 0, True, box)
    want = tpk.rb_smooth_residual_plain(u, f, h, n_iter, True)

    def same(got):
        return torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])

    assert same(_emulate_k26(u, f, h, n_iter, True, lambda _: plan))
    assert not same(_emulate_k26(u, f, h, n_iter, True, lambda _: plan._replace(halo=2 * n_iter)))
    for fault in ("resid_early", "resid_boundary"):
        assert not same(_emulate_k26(u, f, h, n_iter, True, lambda _: plan, fault=fault)), fault


def test_k26_returns_fresh_fields_and_leaves_its_input():
    """K26 returns a fresh (u', r), u untouched, no launch on the CPU; at
    n_iter 3 the emulation's K1 chunk and K26 chunk give the same."""
    n, h = 17, 1.0 / 16
    rng = np.random.default_rng(9)
    u, f = _field(rng, n), _field(rng, n)
    u0 = u.clone()
    tpk.reset_launches()
    got = tpk.rb_smooth_residual_fused(u, f, h, 3, False)
    want = tpk.rb_smooth_residual_plain(u0, f, h, 3, False)
    assert got[0] is not u and torch.equal(u, u0)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    emulated = _emulate_k26(u, f, h, 3, False, _resid_plans("default", n))
    assert all(torch.equal(g, w) for g, w in zip(emulated, want))
    assert tpk.LAUNCHES["rb_smooth_residual_fused"] == 0


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


def test_k26_stage_plans_candidates_fit():
    """K26's candidates in the plan bench (utils/stage_plans.py): the
    planner's first, each a plan its launcher takes (halos 2 n_iter + 1, a
    k halo no wider than its tile, shared memory by the resid formula
    within a block's, threads within the launch bound)."""
    from multigrid_parallel_tpu_torch.utils import stage_plans as sp

    for n in (9, 65, 257):
        plans = sp.resid_candidates(n, H100_SMS)
        assert list(plans)[0] == "planner" and len(plans) > 4
        assert plans["planner"] == tps._stage_plan(n, 2, H100_SMS, rect=True, resid=True)
        for plan in plans.values():
            width = tps._stage_width(n, plan.bk, plan.k_halo, rect=True)
            assert plan.halo == 5 and plan.smem <= tps.SMEM_MAX
            assert plan.k_halo == 0 or plan.k_halo <= plan.bk < n // 2
            assert plan.smem == tps._stage_smem(2, plan.bj, width, rect=True, resid=True,
                                                box_bi=plan.bi if plan.box else 0)
            assert 32 <= plan.threads <= tps.RECT_MAX_THREADS and plan.threads % 32 == 0
