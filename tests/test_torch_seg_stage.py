"""The one-pass mixed smoothing stages on one rank's segments of an
i-sharded field (K34 ``mixed_rb_smooth_halo``, K35
``mixed_rb_smooth_from_zero_halo`` and K36 ``mixed_prolong_smooth_halo``,
multigrid_parallel_tpu_torch.ops.pallas_mixed) on the CPU: an emulation of the CUDA kernels' schedule held
against the plain versions, the planner's plans for segments, and the
wrappers' CPU contract.

The CUDA stage (ops/csrc/rect.cuh with ``Layout::kSeg``) cannot run here,
so it is emulated in torch (tests/torch_stage_emulation.py) as the kernel
runs it: K13's, K14's and K15's stage on VIRTUAL fields whose planes are the
global ones, holding a rank's rows where its three buffers (left halo,
body, right halo, the right one composite where it starts with local tail
planes) have them and NaN at every other plane, so that a read outside the
segment shows; the blocks tile the rank's planes clipped to n - 1 (and
plane n - 2 from the left halo where plane n - 1 is row 0), the loaded box
is clipped to the field only, the stores write the rank's nodes only
(plane n - 1 at row 0 from plane n - 2's final value in the tile), and the
pad rows past n - 1 take u's rows (K34), 0 (K35) or e's rows (K36). The fields, f, e and the
coarse correction, are random at every point, the pad planes too, so a pad
row swept or loaded would show.

The geometries, 4 ranks of L planes: rank 0 (its halo rows negative global
planes), an interior rank, plane n - 1 at a rank's row 0 (its left halo 2
n_iter + 1 planes), a rank with a pad tail, a rank of pad rows only; the
right buffers composite (local tail planes before the halo) on every rank.
Each emulated body equals its plain version bit for bit, on the planner's
plans for the H100 and on hand plans (box and wavefront, several blocks in
i and j, k tiles), every point written once. Three faults must not: a left
halo of 2 n_iter at the n - 1 geometry (K36), the n - 1 copy read from
device memory in place of the tile, and the pad rows swept as interior
ones. K34, the stage on the loaded u, is held the same way, on the planner's
plans and hand plans, stitched over the ranks against K13's plain version,
and with five faults of its own that must show: a zero tile in place of u,
a sweep that reads the loaded k-face slot, pad rows written 0, plane n - 1
at row 0 copied from u in place of the tile, and a left halo one plane
short. The card tests hold the kernels themselves against the plain
versions (tests/test_torch_cuda.py).
"""

import numpy as np
import pytest
import torch

import torch_sharded_ranks as rk
import torch_stage_emulation as em
from multigrid_parallel_tpu_torch.ops import pallas_mixed as tpm
from multigrid_parallel_tpu_torch.ops import pallas_sharded as tpx
from multigrid_parallel_tpu_torch.ops import pallas_split as tps

torch.set_num_threads(1)

H100_SMS = 132
D = 4  # ranks

# (n, L, rank): what the rank's segment holds
GEOMETRIES = {
    "rank0": (17, 6, 0),          # halo rows at negative global planes
    "interior": (33, 12, 1),
    "n-1 at row 0": (17, 8, 2),   # plane 16 is row 0
    "n-1 at row 0, 33": (33, 16, 2),
    "pad tail": (33, 12, 2),      # planes 24-32 valid, 33-35 pad
    "whole pad": (17, 6, 3),      # planes 18-23
}


class Rank:
    """One rank's triples of random global fields (f, e: (D L, n, n);
    the coarse correction (D L / 2, nc, nc)), every plane random, its pin
    planes and h; the left halo ``kl`` planes (default the wrappers'
    rule), the right buffers composite."""

    def __init__(self, n, L, rank, n_iter, seed, kl=None):
        rng = np.random.default_rng(seed)
        nc, lc, hh = (n + 1) // 2, L // 2, 2 * n_iter
        self.n, self.L, self.rank, self.n_iter = n, L, rank, n_iter
        self.gi0 = rank * L - hh
        self.kl = tpm._stage_kl(self.gi0, n_iter, n) if kl is None else kl
        self.h = 3e-4 / (n - 1)
        self.pin = em.pins("random", n, rng)
        f, e = em.field(rng, n, D * L), em.field(rng, n, D * L)
        ec = em.field(rng, nc, D * lc)
        e[:n] = tpm.apply_bcs_padded(e[:n], self.pin)  # BC-consistent, as the cycle's
        self.f3 = rk.rank_parts(f, rank, L, self.kl, hh, tail=3)
        self.e3 = rk.rank_parts(e, rank, L, self.kl, hh, tail=2)
        self.ec3 = rk.rank_parts(ec, rank, lc, self.kl - n_iter, n_iter + 1, tail=1)

    def planes(self):
        return tpm._seg_planes(self.gi0, self.n_iter, self.n, self.L)

    def k34_plain(self, red_first=True):
        return tpm.mixed_rb_smooth_halo_plain(self.e3, self.f3, self.pin, self.gi0, self.h,
                                              self.n_iter, self.n, self.L, red_first)

    def k34(self, plan, red_first=True, fault=None):
        return em.emulate_seg(self.f3, self.pin, self.gi0, self.h, self.n_iter, self.n, self.L,
                              plan, self.kl, red_first, e3=self.e3, fault=fault)

    def k35_plain(self, red_first=True):
        return tpm.mixed_rb_smooth_from_zero_halo_plain(self.f3, self.pin, self.gi0, self.h,
                                                        self.n_iter, self.n, self.L, red_first)

    def k36_plain(self):
        return tpm.mixed_prolong_smooth_halo_plain(self.ec3, self.e3, self.f3, self.pin,
                                                   self.gi0, self.h, self.n_iter, self.n,
                                                   self.L)

    def k35(self, plan, red_first=True, fault=None):
        return em.emulate_seg(self.f3, self.pin, self.gi0, self.h, self.n_iter, self.n, self.L,
                              plan, self.kl, red_first, fault=fault)

    def k36(self, plan, fault=None):
        return em.emulate_seg(self.f3, self.pin, self.gi0, self.h, self.n_iter, self.n, self.L,
                              plan, self.kl, e3=self.e3, ec3=self.ec3, fault=fault)


def _plans(kind, n, n_iter, planes):
    """The plans of one launch (K35's, K36's): the planner's for the
    H100's 132 SMs, or a hand plan of the segment's planes: a box of 2
    planes by 4 rows, 3 planes by 8 whole rows on the wavefront, or 4-slot
    k tiles with the 4-slot k halo by 5 rows and 2 planes (wavefront)."""
    halo, s = 2 * n_iter, n // 2
    if kind == "h100":
        return [tps._stage_plan(n, n_iter, H100_SMS, prolong=p, rect=True, seg_planes=planes)
                for p in (False, True)]
    plan = {"box": tps.StagePlan(n, n_iter, halo, 0, 2, 4, s, 256, 0, True, True, planes),
            "rows": tps.StagePlan(n, n_iter, halo, 0, 3, 8, s, 256, 0, True, False, planes),
            "k_tiles": tps.StagePlan(n, n_iter, halo, tps.STAGE_K_HALO, 2, 5, 4, 256, 0, True,
                                     False, planes)}[kind]
    return [plan, plan]


@pytest.mark.parametrize("n_iter", [1, 2])
@pytest.mark.parametrize("geometry", list(GEOMETRIES))
def test_emulated_seg_stages_match_plain(geometry, n_iter):
    """K35 (both orders) and K36 on each geometry, at 17^3 and 33^3, on the
    planner's plans and on hand plans: bit for bit against the plain
    versions, every point of the body written once."""
    n, L, rank = GEOMETRIES[geometry]
    rk_ = Rank(n, L, rank, n_iter, seed=100 * n + 10 * rank + n_iter)
    kinds = ["h100", "box", "rows"] if n == 17 else ["h100", "k_tiles"]
    for kind in kinds:
        k35_plan, k36_plan = _plans(kind, n, n_iter, rk_.planes())
        for red_first in (True, False):
            got, writes = rk_.k35(k35_plan, red_first)
            em.check_writes(writes)
            assert torch.equal(got, rk_.k35_plain(red_first)), (kind, red_first)
        got, writes = rk_.k36(k36_plan)
        em.check_writes(writes)
        assert torch.equal(got, rk_.k36_plain()), kind


def test_emulated_seg_stages_stitch_to_the_full_layout():
    """The four ranks' emulated bodies at 17^3, L = 8 (plane 16 at rank 2's
    row 0, rank 3 pad only), stitched: their first n planes bit for bit
    K14's and K15's plain versions on the whole field."""
    n, L, n_iter = 17, 8, 2
    ranks = [Rank(n, L, r, n_iter, seed=7) for r in range(D)]  # one seed: one global field
    plans = [_plans("h100", n, n_iter, r.planes()) for r in ranks]
    k35 = torch.cat([r.k35(p[0])[0] for r, p in zip(ranks, plans)])[:n]
    k36 = torch.cat([r.k36(p[1])[0] for r, p in zip(ranks, plans)])[:n]
    r0 = ranks[0]
    f = torch.cat([r.f3[0] for r in ranks])[:n]
    e = torch.cat([r.e3[0] for r in ranks])[:n]
    ec = torch.cat([r.ec3[0] for r in ranks])[:(n + 1) // 2]
    assert torch.equal(k35, tpm.mixed_rb_smooth_from_zero_plain(f, r0.pin, r0.h, n_iter))
    assert torch.equal(k36, tpm.mixed_prolong_smooth_plain(ec, e, f, r0.pin, r0.h, n_iter))


@pytest.mark.parametrize("fault", ["short_left_halo", "n1_from_memory", "pad_swept"])
def test_emulation_finds_a_faulty_seg_stage(fault):
    """The emulation is a check. At the n - 1 geometry (17^3, L = 8, rank
    2): a left halo of 2 n_iter planes, or the copy into plane n - 1 read
    from device memory (e, or K35's zeros) in place of the tile; at the
    pad-tail geometry (33^3, L = 12, rank 2): the pad rows swept as
    interior ones. Each leaves a wrong value in K36's body and, but for
    the short halo, in K35's (their NaN where a read left the segment);
    without the fault they equal the plain versions. K35 reads no plane of
    that extra halo row (its tile starts as zeros, and the row is never
    swept, so its f is never read): its launcher refuses the short halo
    (tests/test_torch_cuda.py)."""
    n, L, rank = (33, 12, 2) if fault == "pad_swept" else (17, 8, 2)
    n_iter = 2
    good = Rank(n, L, rank, n_iter, seed=11)
    plans = _plans("h100", n, n_iter, good.planes())
    want35, want36 = good.k35_plain(), good.k36_plain()
    assert torch.equal(good.k35(plans[0])[0], want35)
    assert torch.equal(good.k36(plans[1])[0], want36)
    if fault == "short_left_halo":
        bad = Rank(n, L, rank, n_iter, seed=11, kl=2 * n_iter)
        assert torch.isnan(bad.k36(plans[1])[0][0]).any()  # plane 16 from e's missing row
        assert torch.equal(bad.k35(plans[0])[0], want35)
        return
    assert not torch.equal(good.k35(plans[0], fault=fault)[0], want35)
    assert not torch.equal(good.k36(plans[1], fault=fault)[0], want36)


# (n, L, rank) of K34's cases: GEOMETRIES' edges, an interior rank at 17^3
K34_GEOMETRIES = {**GEOMETRIES, "interior": (17, 6, 1)}


@pytest.mark.parametrize("n_iter", [1, 2])
@pytest.mark.parametrize("geometry", list(K34_GEOMETRIES))
def test_emulated_k34_matches_plain(geometry, n_iter):
    """K34, the stage on the loaded u, on each geometry: red first on the
    planner's plan, black first on a hand plan (a box at 17^3, k tiles at
    33^3, at n_iter 1), bit for bit against the plain version, the pad rows
    u's, every point of the body written once."""
    n, L, rank = K34_GEOMETRIES[geometry]
    rk_ = Rank(n, L, rank, n_iter, seed=100 * n + 10 * rank + n_iter + 5)
    hand = "box" if n == 17 else "k_tiles" if n_iter == 1 else None
    for kind, red_first in (("h100", True), (hand, False)):
        if kind is None:
            continue
        got, writes = rk_.k34(_plans(kind, n, n_iter, rk_.planes())[0], red_first)
        em.check_writes(writes)
        assert torch.equal(got, rk_.k34_plain(red_first)), (kind, red_first)


def test_emulated_k34_stitches_to_k13():
    """The four ranks' emulated K34 bodies at 17^3, L = 8 (plane 16 at rank
    2's row 0, rank 3 pad only), stitched: their first n planes bit for bit
    K13's plain version on the whole field, red first on the planner's
    plans, black first on box plans."""
    n, L, n_iter = 17, 8, 2
    ranks = [Rank(n, L, r, n_iter, seed=8) for r in range(D)]  # one seed: one global field
    f = torch.cat([r.f3[0] for r in ranks])[:n]
    e = torch.cat([r.e3[0] for r in ranks])[:n]
    for kind, red_first in (("h100", True), ("box", False)):
        got = torch.cat([r.k34(_plans(kind, n, n_iter, r.planes())[0], red_first)[0]
                         for r in ranks])[:n]
        want = tpm.mixed_rb_smooth_plain(e, f, ranks[0].pin, ranks[0].h, n_iter, red_first)
        assert torch.equal(got, want), red_first


@pytest.mark.parametrize("fault", ["zero_tile", "k_face_slot", "pad_zero", "n1_from_memory",
                                   "short_left_halo"])
def test_emulation_finds_a_faulty_k34(fault):
    """The emulation is a check of K34 too. At the n - 1 geometry (17^3, L =
    8, rank 2: plane 16 its row 0, planes 17-23 pad), n_iter 2: a zero tile
    in place of the loaded u, the k-face neighbours read from the tile's
    loaded k-face slots, the pad rows written 0, the copy into plane n - 1
    read from u in device memory in place of the tile's final plane n - 2,
    or a left halo of 2 n_iter planes (u's missing plane shows as NaN) each
    leaves a wrong value in the body; without the fault it equals the plain
    version."""
    n, L, rank, n_iter = 17, 8, 2, 2
    good = Rank(n, L, rank, n_iter, seed=12)
    plan = _plans("h100", n, n_iter, good.planes())[0]
    want = good.k34_plain()
    assert torch.equal(good.k34(plan)[0], want)
    if fault == "short_left_halo":
        got = Rank(n, L, rank, n_iter, seed=12, kl=2 * n_iter).k34(plan)[0]
        assert torch.isnan(got[0]).any()
        return
    assert not torch.equal(good.k34(plan, fault=fault)[0], want)


# ------------------------------------------------------------- the plans


@pytest.mark.parametrize("n", [9, 17, 33, 65, 129, 257])
def test_seg_plans_tile_the_planes_of_a_segment(n):
    """A segment stage's plan (``seg_planes``) tiles only its planes: for
    the production segments (one rank's L = 320 .. 10 clipped to n, four
    ranks' L = 96 .. 6 and their clipped last valid rank), one plane and
    two, its i tiles cover the planes and no more, the schedule is the
    level's (a box up to 129^3), within the shared memory and the
    kernels' 512-thread launch bound (rect.cuh, kSegStageMaxThreads);
    whole rows where the level's plan has them; the planes each wrapper
    asks for are rect.cuh's seg_geometry's (the emulation's span)."""
    for n_iter in (1, 2):
        for prolong in (False, True):
            whole = tps._stage_plan(n, n_iter, H100_SMS, prolong, True)
            l4 = 96 * (n - 1) // 256
            for planes in {n, max(1, l4), max(1, n - 3 * l4), 1, 2}:
                plan = tps._stage_plan(n, n_iter, H100_SMS, prolong, True, seg_planes=planes)
                ni = plan.tiles[0]
                assert ni == -(-planes // plan.bi) and (ni - 1) * plan.bi < planes
                assert plan.box == whole.box and plan.smem <= tps.SMEM_MAX
                assert plan.threads <= tps.SEG_MAX_THREADS and plan.threads % 32 == 0
                assert plan.smem == tps._stage_smem(n_iter, plan.bj, tps._stage_width(
                    n, plan.bk, plan.k_halo, True), prolong, True, plan.bi if plan.box else 0)
                if planes >= 8:
                    assert plan.k_halo == whole.k_halo
    for geometry, (m, L, rank) in GEOMETRIES.items():
        for n_iter in (1, 2):
            gi0 = rank * L - 2 * n_iter
            span = em.seg_span(gi0 + 2 * n_iter, L, m)
            assert tpm._seg_planes(gi0, n_iter, m, L) == max(1, span.c1 - span.c0), geometry
    with pytest.raises(ValueError, match="seg_planes"):
        tps._stage_plan(33, 2, H100_SMS, seg_planes=10)  # a split plan has no segment form
    with pytest.raises(ValueError, match="seg_planes"):
        tps._stage_plan(33, 2, H100_SMS, rect=True, seg_planes=0)


# ------------------------------------------------- the wrappers on the CPU


def test_k35_k36_wrappers_on_the_cpu_are_the_plain_versions():
    """On the CPU the wrappers are the plain versions: fresh bodies (pad
    rows 0 for K35, e's for K36, u's for K34), the inputs as they were, no
    launch counted; the ext forms raise at the n - 1 geometry."""
    rk_ = Rank(33, 12, 2, 2, seed=3)
    before = [t.clone() for t in (*rk_.f3, *rk_.e3, *rk_.ec3)]
    tpm.reset_launches()
    got35 = tpm.mixed_rb_smooth_from_zero_halo(rk_.f3, rk_.pin, rk_.gi0, rk_.h, 2, 33, 12)
    got36 = tpm.mixed_prolong_smooth_halo(rk_.ec3, rk_.e3, rk_.f3, rk_.pin, rk_.gi0, rk_.h, 2,
                                          33, 12)
    got34 = tpm.mixed_rb_smooth_halo(rk_.e3, rk_.f3, rk_.pin, rk_.gi0, rk_.h, 2, 33, 12)
    assert all(torch.equal(a, b) for a, b in zip((*rk_.f3, *rk_.e3, *rk_.ec3), before))
    assert got34.data_ptr() != rk_.e3[0].data_ptr() and torch.equal(got34, rk_.k34_plain())
    assert torch.equal(got34[9:], rk_.e3[0][9:])
    assert torch.equal(got35, rk_.k35_plain()) and torch.equal(got36, rk_.k36_plain())
    assert not got35[9:].any() and torch.equal(got36[9:], rk_.e3[0][9:])  # pad rows 33-35
    assert not any(tpm.LAUNCHES.values())
    last = Rank(17, 8, 2, 2, seed=4)
    with pytest.raises(ValueError, match="halo"):
        tpm.mixed_rb_smooth_from_zero_ext(torch.cat([last.f3[1][1:], last.f3[0],
                                                     last.f3[2][3:]]),
                                          last.pin, last.gi0, last.h, 2, 17, 8)
    assert tpx._gi0_int(last.gi0) + 4 == 16
