"""The one-pass split-colour smoothing stages (K7 ``rb_smooth_split``, K8
``rb_smooth_split_from_zero`` and K10 ``prolong_smooth_split``,
multigrid_parallel_tpu_torch.ops.pallas_split) on the CPU: their tile
plan, an emulation of the CUDA kernels' schedule held against the plain
versions, and the wrappers' CPU contract.

The CUDA stage kernel (ops/csrc/split.cuh, ``stage_body``) cannot run
here, so its schedule is emulated in torch, block by block, as the
kernel runs it: the plan's boxes with halos of 2 n_iter planes and rows
(and k_halo slots where k is tiled), tile planes filled with NaN outside
the loaded box and, for the first half-sweep's colour, at every live
slot (K10's kernel loads only the slots of that colour that no
half-sweep updates; K7's loads it whole, which this covers; K8's tile
starts as zeros, both colours, in the loaded box), a ring of tile planes
for each colour as deep as the kernel's (a plane gone from a ring raises), the skewed wavefront
(half-sweep s at plane p - 2 s once plane p has arrived, all half-sweeps
of a step reading before any writes, as the kernel runs them at once),
each half-sweep on its region, the loaded box shrunk by s, updating its
colour in place, and each colour's owned box written a step after its
last half-sweep. A halo too shallow reads NaN or a
missing plane, so the emulation must equal the plain versions bit for
bit (the same f32 operations on the same values). The card tests hold
the kernels themselves against the plain versions (tests/test_torch_cuda.py).
"""

import numpy as np
import pytest
import torch
import torch_stage_emulation as em

from multigrid_parallel_tpu_torch.ops import pallas_split as tps
from multigrid_parallel_tpu_torch.ops import pallas_splitcolor as tpsc
from multigrid_parallel_tpu_torch.ops.stencils_3d import BLACK, RED

torch.set_num_threads(1)

PLAN_SIZES = [5, 11, 17, 33, 257, 513, 1025]
H100_SMS = 132


def _spans(extent, size):
    return [(a, min(a + size, extent)) for a in range(0, extent, size)]


@pytest.mark.parametrize("n_iter", [1, 2])
@pytest.mark.parametrize("n", PLAN_SIZES)
def test_stage_plan_covers_the_field_once(n, n_iter):
    """The owned boxes tile every axis exactly (so every slot of the field
    is written by one block); halos of 2 n_iter (k_halo at least that where
    k is tiled); shared memory within a Hopper block's 232,448 B."""
    s = tps.split_shape(n)[2]
    plan = tps._stage_plan(n, n_iter, H100_SMS)
    assert plan.halo == 2 * n_iter
    assert plan.smem == tps._stage_smem(n_iter, plan.bj,
                                        plan.bk + 2 * plan.k_halo if plan.k_halo else s)
    assert plan.smem <= tps.SMEM_MAX == 232_448
    assert tps._stage_plan(n, n_iter, H100_SMS, prolong=True).smem <= tps.SMEM_MAX
    assert plan.k_halo == 0 and plan.bk == s or plan.k_halo >= plan.halo and plan.bk < s
    assert 32 <= plan.threads <= tps.STAGE_MAX_THREADS and plan.threads % 32 == 0
    for extent, size, count in zip((n, n, s), (plan.bi, plan.bj, plan.bk), plan.tiles):
        spans = _spans(extent, size)
        assert len(spans) == count and all(a < b for a, b in spans)
        assert [a for a, _ in spans[1:]] == [b for _, b in spans[:-1]]
        assert spans[0][0] == 0 and spans[-1][1] == extent
    assert plan.blocks == np.prod(plan.tiles)


def test_stage_plan_at_257_fills_the_card():
    """The main path's plans (257^3, n_iter 2, K7 and K10): whole k rows
    (a 4-slot group a lane), one wave on the H100's 132 SMs, a warp a row
    tile row; K10's holds its coarse ring too."""
    for prolong in (False, True):
        plan = tps._stage_plan(257, 2, H100_SMS, prolong=prolong)
        assert (plan.k_halo, plan.bk) == (0, 128)
        assert 120 <= plan.blocks <= 132 * (tps.SM_SMEM // (plan.smem + 1024))
        assert plan.threads == 32 * (plan.bj + 2 * plan.halo)
        assert plan.smem == tps._stage_smem(2, plan.bj, 128, prolong) <= tps.SMEM_MAX


def test_stage_plan_rejects_what_the_kernel_does_not_run():
    with pytest.raises(ValueError, match="1 or 2"):
        tps._stage_plan(17, 3, H100_SMS)


# ------------------------------------------------- the schedule, emulated


def _plans(kind, n):
    """The plan of each launch size (n_iter 1, 2), all with tiles smaller
    than the field: the default plan for 4 SMs, 8 whole rows by 7 planes,
    or 4-slot k tiles with the 4-slot k halo."""
    s = tps.split_shape(n)[2]

    def plan(n_iter):
        if kind == "default":
            return tps._stage_plan(n, n_iter, 4)
        if kind == "rows":
            return tps.StagePlan(n, n_iter, 2 * n_iter, 0, 7, 8, s, 256,
                                 tps._stage_smem(n_iter, 8, s))
        return tps.StagePlan(n, n_iter, 2 * n_iter, tps.STAGE_K_HALO, 8, 8, 4,
                             256, tps._stage_smem(n_iter, 8, 12))

    return plan


def _emulate_launch(ins, fs, color0, h, plan, prep=None, from_zero=False):
    """One stage launch as stage_body runs it (torch_stage_emulation.
    emulate_split_launch) on pair colours by stage colour ([0] the first
    half-sweep's colour, ``color0``). Returns the outputs by stage colour
    (NaN where not stored) and how many blocks wrote each slot."""
    outs = [torch.full_like(x, float("nan")) for x in ins]
    writes = em.emulate_split_launch([em.pair_rows(x) for x in ins],
                                     [em.pair_rows(x) for x in fs],
                                     [em.pair_rows(x) for x in outs], color0, h, plan,
                                     ins[0].shape[0], prep, from_zero)
    return outs, writes


def _by_stage(pair, color0):
    """A (red, black) pair by stage colour, and back (the same swap)."""
    return list(pair) if color0 == RED else [pair[1], pair[0]]


def _emulate_k7(er, eb, fr, fb, h, n_iter, red_first, plan_of, writes_seen):
    color0 = RED if red_first else BLACK
    pair = (er, eb)
    for chunk in tps._stage_chunks(n_iter):
        outs, writes = _emulate_launch(_by_stage(pair, color0), _by_stage((fr, fb), color0),
                                       color0, h, plan_of(chunk))
        writes_seen.append(writes)
        pair = tuple(_by_stage(outs, color0))
    return pair


def _emulate_k8(fr, fb, h, n_iter, red_first, plan_of, writes_seen):
    """K8: the first launch from a zero tile, then K7 launches on the pair
    so far."""
    color0 = RED if red_first else BLACK
    first, *rest = tps._stage_chunks(n_iter)
    fs = _by_stage((fr, fb), color0)
    outs, writes = _emulate_launch(fs, fs, color0, h, plan_of(first), from_zero=True)
    writes_seen.append(writes)
    pair = tuple(_by_stage(outs, color0))
    for chunk in rest:
        pair = _emulate_k7(*pair, fr, fb, h, chunk, red_first, plan_of, writes_seen)
    return pair


def _emulate_k10(ec, er, eb, rr, rb, h, n_iter, plan_of, writes_seen):
    n = er.shape[0]
    _, live_r, _ = tps._masks(n, er.device)
    corr_r, _ = tps._prolong_split(ec, n)
    corr_r = torch.where(live_r, corr_r, torch.zeros_like(corr_r))

    def prep(c, q, js, ks, tile):  # stage colour 0 is black, 1 red
        add = corr_r[q, js[0]:js[1], ks[0]:ks[1]] if c == 1 else 0.0
        tile.copy_(tile + add)

    first, *rest = tps._stage_chunks(n_iter)
    outs, writes = _emulate_launch([eb, er], [rb, rr], BLACK, h, plan_of(first), prep)
    writes_seen.append(writes)
    pair = (outs[1], outs[0])
    for chunk in rest:
        pair = _emulate_k7(*pair, rr, rb, h, chunk, False, plan_of, writes_seen)
    return pair


def _split_fields(seed, n, count):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(count):
        x = np.zeros((n, n, n), np.float32)
        x[1:-1, 1:-1, 1:-1] = rng.standard_normal((n - 2,) * 3)
        out.append(tps.pack_split(torch.from_numpy(x)))
    return out


def _bitwise(got, want):
    return all(torch.equal(g, w) for g, w in zip(got, want))


@pytest.mark.parametrize("kind", ["default", "rows", "k_tiles"])
@pytest.mark.parametrize("n_iter", [1, 2, 3])
@pytest.mark.parametrize("n", [17, 33])
def test_emulated_k7_schedule_matches_plain(n, n_iter, kind):
    h = 1.0 / (n - 1)
    e, f = _split_fields(n + n_iter, n, 2)
    plan_of = _plans(kind, n)
    assert plan_of(2).blocks > 1
    for red_first in (True, False):
        writes = []
        got = _emulate_k7(*e, *f, h, n_iter, red_first, plan_of, writes)
        want = tps.rb_smooth_split_plain(*e, *f, h, n_iter, red_first)
        assert _bitwise(got, want), (n, n_iter, kind, red_first)
        assert all(bool((w == 1).all()) for w in writes)


def _random_pair(seed, n):
    """A split pair random at every slot, dead slots and boundary rows too."""
    rng = np.random.default_rng(seed)
    return tuple(torch.from_numpy(rng.standard_normal(tps.split_shape(n)).astype(np.float32))
                 for _ in range(2))


@pytest.mark.parametrize("kind", ["default", "rows", "k_tiles"])
@pytest.mark.parametrize("n_iter", [1, 2, 3])
@pytest.mark.parametrize("n", [17, 33])
def test_emulated_k8_schedule_matches_plain(n, n_iter, kind):
    """K8's schedule from a zero tile, on an f random at every slot: the
    dead slots and boundary rows of the fresh pair come out 0, every slot
    written by one block."""
    h = 1.0 / (n - 1)
    f = _random_pair(3 * n + n_iter, n)
    plan_of = _plans(kind, n)
    for red_first in (True, False):
        writes = []
        got = _emulate_k8(*f, h, n_iter, red_first, plan_of, writes)
        want = tps.rb_smooth_split_from_zero_plain(*f, h, n_iter, red_first)
        assert _bitwise(got, want), (n, n_iter, kind, red_first)
        assert all(bool((w == 1).all()) for w in writes)


@pytest.mark.parametrize("kind", ["default", "rows", "k_tiles"])
@pytest.mark.parametrize("n", [17, 33])
def test_emulated_k10_schedule_matches_plain(n, kind):
    h = 1.0 / (n - 1)
    e, r = _split_fields(2 * n, n, 2)
    nc = (n + 1) // 2
    ec = torch.from_numpy(np.random.default_rng(n).standard_normal((nc,) * 3)
                          .astype(np.float32))
    plan_of = _plans(kind, n)
    for n_iter in (1, 2, 3):
        writes = []
        got = _emulate_k10(ec, *e, *r, h, n_iter, plan_of, writes)
        want = tps.prolong_smooth_split_plain(ec, *e, *r, h, n_iter)
        assert _bitwise(got, want), (n, n_iter, kind)
        assert all(bool((w == 1).all()) for w in writes)


def test_emulation_finds_a_shallow_halo():
    """The emulation is a check: the same schedule with halos one short
    leaves stale or NaN values in the owned box and no longer equals the
    plain version."""
    n, n_iter = 17, 2
    h = 1.0 / (n - 1)
    e, f = _split_fields(5, n, 2)
    plan = tps.StagePlan(n, n_iter, 2 * n_iter, 0, 8, 8, 8, 256,
                         tps._stage_smem(n_iter, 8, 8))
    assert _bitwise(_emulate_k7(*e, *f, h, n_iter, True, lambda _: plan, []),
                    tps.rb_smooth_split_plain(*e, *f, h, n_iter, True))
    short = plan._replace(halo=plan.halo - 1)
    got = _emulate_k7(*e, *f, h, n_iter, True, lambda _: short, [])
    assert not _bitwise(got, tps.rb_smooth_split_plain(*e, *f, h, n_iter, True))
    # K8's, from a zero tile, likewise
    want8 = tps.rb_smooth_split_from_zero_plain(*f, h, n_iter, True)
    assert _bitwise(_emulate_k8(*f, h, n_iter, True, lambda _: plan, []), want8)
    assert not _bitwise(_emulate_k8(*f, h, n_iter, True, lambda _: short, []), want8)


# ------------------------------------- K42: K7's stage on the packed array


def _packed(seed, n):
    """Packed (n, 2 n, S) arrays of u and f from zero-boundary cubes (the
    pair invariant: dead slots and boundary rows 0)."""
    return [torch.cat(pair, dim=1) for pair in _split_fields(seed, n, 2)]


@pytest.mark.parametrize("kind", ["default", "tiled"])
@pytest.mark.parametrize("n_iter", [1, 2])
@pytest.mark.parametrize("n", [9, 17, 33])
def test_emulated_k42_schedule_matches_plain(n, n_iter, kind):
    """K42's one-pass stage on K7's plans (the planner's for 4 SMs, and 4-slot
    k tiles, at 9^3 whole rows of 8 x 7 blocks), through the packed array's
    addresses (plane pitch 2 n S, the black half at n S) in K42's order of
    additions: bit for bit its plain version, both orders, every slot
    written by one block, the input untouched."""
    h = 1.0 / (n - 1)
    u2, f2 = _packed(4 * n + n_iter, n)
    u0 = u2.clone()
    plan_of = _plans(kind if kind == "default" else "k_tiles" if n > 9 else "rows", n)
    assert plan_of(n_iter).blocks > 1
    for red_first in (True, False):
        got, writes = em.emulate_k42(u2, f2, h, n_iter, red_first, plan_of)
        want = tpsc.rb_smooth_split_fused_plain(u2, f2, h, n_iter, red_first)
        assert torch.equal(got, want), (n, n_iter, kind, red_first)
        assert all(bool((w == 1).all()) for w in writes)
    assert torch.equal(u2, u0)


def test_emulation_finds_k42_faults():
    """The emulation is a check: K42 with K7's order of additions, or with
    the pair's plane pitch of n S, no longer equals the plain version; nor
    does a halo one short."""
    n, n_iter = 17, 2
    h = 1.0 / (n - 1)
    u2, f2 = _packed(6, n)
    plan_of = _plans("default", n)
    want = tpsc.rb_smooth_split_fused_plain(u2, f2, h, n_iter, True)
    assert torch.equal(em.emulate_k42(u2, f2, h, n_iter, True, plan_of)[0], want)
    for fault in ("order", "pitch"):
        got = em.emulate_k42(u2, f2, h, n_iter, True, plan_of, fault=fault)[0]
        assert not torch.equal(got, want), fault
    short = plan_of(n_iter)._replace(halo=2 * n_iter - 1)
    assert not torch.equal(em.emulate_k42(u2, f2, h, n_iter, True, lambda _: short)[0], want)


def test_k42_returns_a_fresh_array_and_leaves_its_input():
    """The wrapper's CPU contract: a fresh packed array, u2 untouched, no
    launch counted; n_iter 3 as ceil(3 / 2) chunks in the emulation."""
    n, h = 17, 1.0 / 16
    u2, f2 = _packed(10, n)
    u0 = u2.clone()
    tpsc.reset_launches()
    got = tpsc.rb_smooth_split_fused(u2, f2, h, 3, n, False)
    want = tpsc.rb_smooth_split_fused_plain(u0, f2, h, 3, False)
    assert got is not u2 and torch.equal(u2, u0) and torch.equal(got, want)
    assert torch.equal(em.emulate_k42(u2, f2, h, 3, False, _plans("rows", n))[0], want)
    assert tpsc.LAUNCHES == {"rb_smooth_split_fused": 0}
    assert tpsc.PER_SWEEP_LAUNCHES == {"rb_smooth_split_fused_per_sweep": 0}
    with pytest.raises(ValueError, match="n_iter"):
        tpsc.rb_smooth_split_fused(u2, f2, h, 0, n)


# ------------------------------------------------- the wrappers on the CPU


def test_k7_returns_a_fresh_pair_and_leaves_its_inputs():
    n, h = 17, 1.0 / 16
    e, f = _split_fields(7, n, 2)
    e0 = tuple(x.clone() for x in e)
    got = tps.rb_smooth_split(*e, *f, h, 2, True)
    assert all(g is not x for g, x in zip(got, e))
    assert _bitwise(e, e0)
    assert _bitwise(got, tps.rb_smooth_split_plain(*e0, *f, h, 2, True))
    with pytest.raises(ValueError, match="n_iter"):
        tps.rb_smooth_split(*e, *f, h, 0)


def test_k8_returns_a_fresh_pair_with_zero_dead_slots():
    n, h = 17, 1.0 / 16
    f = _random_pair(9, n)
    f0 = tuple(x.clone() for x in f)
    got = tps.rb_smooth_split_from_zero(*f, h, 3, False)
    assert _bitwise(f, f0) and all(g is not x for g, x in zip(got, f))
    assert _bitwise(got, tps.rb_smooth_split_from_zero_plain(*f, h, 3, False))
    _, live_r, live_b = tps._masks(n, "cpu")
    assert not got[0][~live_r].any() and not got[1][~live_b].any()
    with pytest.raises(ValueError, match="n_iter"):
        tps.rb_smooth_split_from_zero(*f, h, 0)
    tps.reset_launches()
    tps.rb_smooth_split_from_zero(*f, h, 2)
    assert tps.LAUNCHES["rb_smooth_split_from_zero"] == 0  # no launch on the CPU


def test_per_sweep_form_updates_in_place_on_the_cpu():
    n, h = 17, 1.0 / 16
    e, f = _split_fields(8, n, 2)
    want = tps.rb_smooth_split_plain(*e, *f, h, 2, False)
    got = tps.rb_smooth_split_per_sweep(*e, *f, h, 2, False)
    assert all(g is x for g, x in zip(got, e))
    assert _bitwise(got, want)
    assert tps.PER_SWEEP_LAUNCHES == {"rb_smooth_split_per_sweep": 0}  # no launch on the CPU
