"""The streaming restriction stage on one rank's segmented block (K30
``residual_restrict_halo`` of multigrid_parallel_tpu_torch.ops.
pallas_sharded on an i-sharded field, K39 ``residual_restrict_halo2d`` of
ops.pallas_sharded2d on an (i, j)-sharded one) on the CPU: an emulation of
the CUDA kernels' schedule held against the plain versions, the planner's
plans for segments, and the wrappers' CPU contract.

The CUDA stage (ops/csrc/restrict.cuh with ``SegLayout``) cannot run here,
so it is emulated in torch (tests/torch_stage_emulation.py,
emulate_restrict with a SegRestrict) as the kernel runs it: K3's stage,
its tile rows copied from a slab of the rank's segments (the three parts
of an i-sharded block, the five of an (i, j) one with the corner blocks in
its j-extended i halos) at local indices, NaN past what the segments hold,
so that a read outside them shows; the blocks tile the rank's local coarse
rows (and columns) whose global index is interior; the planes outside
them, and the rows and k ends around the boxes, written 0 by the same
launch; each coarse point written once. The fields are random at every
point, the pad rows and columns too.

The geometries: on four i-sharded ranks, rank 0 (its left halo rows past
the field), an interior rank, a rank with a pad tail, a rank of pad rows
only, and the ext form; on (i, j) blocks, every block of a 2x2 mesh whose
blocks meet at an interior corner (the last with pad rows and columns),
the 1x1 block with pad rows and columns, a 1x4 mesh whose last column rank
holds pad columns only, and the ext form. Each emulated block equals its
plain version bit for bit at 17^3 and 33^3, on the planner's plans for the
H100 and on hand plans (several blocks along each axis, k tiles), and the
stitched blocks equal K3's plain version on the whole field. Five faults
must not: an e halo one row short, one column short, the corner blocks
zeroed, a non-interior coarse point left unwritten, and the k taps before
the j taps. The card tests hold the kernels themselves against the plain
versions (tests/test_torch_cuda.py).
"""

import numpy as np
import pytest
import torch

import torch_sharded_ranks as rk
import torch_stage_emulation as em
from multigrid_parallel_tpu_torch.ops import pallas3d as tpk
from multigrid_parallel_tpu_torch.ops import pallas_sharded as tpx
from multigrid_parallel_tpu_torch.ops import pallas_sharded2d as tpx2
from multigrid_parallel_tpu_torch.ops import pallas_split as tps

torch.set_num_threads(1)

H100_SMS = 132
D = 4    # i-sharded ranks
PAD = 2  # NaN planes and rows around an emulated slab

# (n, L, rank, ext): what the rank's segments hold
GEOMETRIES = {
    "rank0": (17, 6, 0, False),       # halo rows at negative global planes
    "interior": (33, 12, 1, False),
    "pad tail": (33, 12, 2, False),   # coarse planes 12-15 interior, 16-17 not
    "whole pad": (17, 6, 3, False),   # planes 18-23
    "ext": (17, 6, 1, True),
}
# (n, (nx, ny), Li, Lj, blocks, ext): the (i, j) blocks of a mesh
GEOMETRIES2D = {
    "2x2 interior corner": (17, (2, 2), 10, 10, [(0, 0), (0, 1), (1, 0), (1, 1)], False),
    "2x2 interior corner, 33": (33, (2, 2), 18, 18, [(1, 1)], False),
    "1x1 with pad": (17, (1, 1), 20, 20, [(0, 0)], False),
    "1x1 with pad, 33": (33, (1, 1), 36, 36, [(0, 0)], False),
    "1x4 pad-only columns": (17, (1, 4), 18, 6, [(0, 2), (0, 3)], False),
    "2x2 ext": (17, (2, 2), 10, 10, [(1, 0)], True),
}


def _rnd(rng, shape):
    return torch.from_numpy(rng.standard_normal(shape).astype(np.float32))


def _plans(n, rows, cols=None):
    """The planner's plan for the H100's 132 SMs, and hand plans of the
    segment's interior rows (and columns): several blocks along i and j
    with whole k rows, k tiles of 2 coarse points, and of 3 with 8 rows."""
    m = (n + 1) // 2 - 2
    plans = [tps._restrict_plan(n, H100_SMS, seg_rows=rows, seg_cols=cols)]
    for bci, bcj, bck in ((2, 3, m), (3, 2, 2), (1, 8, 3)):
        bci, bcj, bck = min(bci, rows), min(bcj, cols or m, tps.RESTRICT_MAX_ROWS), min(bck, m)
        plans.append(tps.RestrictPlan(n, False, bci, bcj, bck, tps._restrict_chunks(bck, False),
                                      32 * (2 * bcj + 1), tps._restrict_smem(bcj, bck, False),
                                      rows=rows, cols=cols))
    return plans


class Rank:
    """One i-sharded rank's segments (2 planes before the body, 1 after)
    of random global fields e and r (D L planes, every plane random), or
    its ext copies (2 planes on each side); its h."""

    def __init__(self, n, L, rank, ext=False, seed=0):
        rng = np.random.default_rng(seed)
        self.n, self.L, self.rank, self.ext = n, L, rank, ext
        self.g0, self.gi0, self.h = rank * L, rank * L - 2, 1.0 / (n - 1)
        self.e, self.r = _rnd(rng, (D * L, n, n)), _rnd(rng, (D * L, n, n))
        if ext:
            self.e3, self.r3 = (rk.rank_ext(x, rank, L, 2) for x in (self.e, self.r))
        else:
            self.e3, self.r3 = (rk.rank_parts(x, rank, L, 2, 1) for x in (self.e, self.r))

    def rows(self):
        return tpx.seg_restrict_extents(self.n, self.g0, self.L)[0]

    def plain(self):
        if self.ext:
            return tpx.residual_restrict_ext(self.e3, self.r3, self.gi0, self.h, self.n,
                                             self.L // 2)
        return tpx.residual_restrict_halo_plain(self.e3, self.r3, self.gi0, self.h, self.n,
                                                self.L // 2)

    def segs(self):
        parts = (tpx._ext_parts(x, 2, self.L) for x in (self.e3, self.r3)) if self.ext else (
            self.e3, self.r3)
        return [tpx._seg(x, 2, 1, self.L, composite=False) for x in parts]

    def emulate(self, plan, kl=2, fault=None):
        slabs = [em.nan_padded(s.rows(kl, 1), PAD) for s in self.segs()]
        seg = em.seg_restrict(self.n, self.g0, self.L, kl + PAD, PAD)
        return em.emulate_restrict(plan, (slabs[0],), (slabs[1],), self.h, seg=seg, fault=fault)


class Block:
    """One (i, j) block's five parts (2 rows and columns before the body,
    1 after, the right i buffer plain) of random global fields e and r, or
    its ext copies (2 on each side); its h."""

    def __init__(self, n, mesh, li, lj, ix, iy, ext=False, seed=0):
        rng = np.random.default_rng(seed)
        (nx, ny) = mesh
        self.n, self.li, self.lj, self.ext = n, li, lj, ext
        self.g0, self.gj0 = ix * li, iy * lj
        self.gij0 = (self.g0 - 2, self.gj0 - 2)
        self.h = 1.0 / (n - 1)
        self.e, self.r = _rnd(rng, (nx * li, ny * lj, n)), _rnd(rng, (nx * li, ny * lj, n))
        if ext:
            self.e5, self.r5 = (rk.rank_ext2d(x, ix, iy, li, lj, 2, 2, 2, 2)
                                for x in (self.e, self.r))
        else:
            self.e5, self.r5 = (rk.rank_parts2d(x, ix, iy, li, lj, 2, 1)
                                for x in (self.e, self.r))

    def extents(self):
        return tpx.seg_restrict_extents(self.n, self.g0, self.li, self.gj0, self.lj)

    def plain(self):
        args = (self.e5, self.r5, self.gij0, self.h, self.n, self.li // 2, self.lj // 2)
        if self.ext:
            return tpx2.residual_restrict_ext2d(*args)
        return tpx2.residual_restrict_halo2d_plain(*args)

    def emulate(self, plan, kl=2, hjl=2, corners=True, fault=None):
        k_ext = 2 if self.ext else 0
        slabs = []
        for x in (self.e5, self.r5):
            s = tpx2._seg2(x, self.li, self.lj, 2, 1, 2, 1, k_ext, composite=False).slab(
                kl, 1, hjl, 1)
            if not corners:  # the fault: the j-extended i halos' corner blocks zeroed
                for rows in (slice(0, kl), slice(kl + self.li, None)):
                    s[rows, :hjl] = 0.0
                    s[rows, hjl + self.lj:] = 0.0
            slabs.append(em.nan_padded(s, PAD))
        seg = em.seg_restrict(self.n, self.g0, self.li, kl + PAD, hjl + PAD, self.gj0, self.lj)
        return em.emulate_restrict(plan, (slabs[0],), (slabs[1],), self.h, seg=seg, fault=fault)


def _check_writes(w):
    assert torch.equal(w, torch.ones_like(w)), "a point written other than once"


@pytest.mark.parametrize("geometry", list(GEOMETRIES))
def test_emulated_k30_stage_matches_plain(geometry):
    """K30 on each i-sharded geometry, at 17^3 and 33^3, on the planner's
    plan and on hand plans: bit for bit against the plain version, every
    point of the coarse block written once (the pad rows 0)."""
    n, L, rank, ext = GEOMETRIES[geometry]
    r = Rank(n, L, rank, ext, seed=10 * n + rank)
    want = r.plain()
    assert torch.isfinite(want).all()
    for plan in _plans(n, r.rows()):
        got, w = r.emulate(plan)
        _check_writes(w)
        assert torch.equal(got, want), plan


@pytest.mark.parametrize("geometry", list(GEOMETRIES2D))
def test_emulated_k39_stage_matches_plain(geometry):
    """K39 on each (i, j) block, at 17^3 and 33^3, on the planner's plan
    and on hand plans: bit for bit against the plain version, every point
    of the coarse block written once (the pad rows and columns 0)."""
    n, mesh, li, lj, blocks, ext = GEOMETRIES2D[geometry]
    for ix, iy in blocks:
        b = Block(n, mesh, li, lj, ix, iy, ext, seed=10 * n + 3 * ix + iy)
        want = b.plain()
        assert torch.isfinite(want).all()
        for plan in _plans(n, *b.extents()):
            got, w = b.emulate(plan)
            _check_writes(w)
            assert torch.equal(got, want), (plan, ix, iy)


def test_emulated_stages_stitch_to_k3():
    """The four i-sharded ranks' emulated coarse blocks at 17^3, L = 6
    (rank 3 pad only), and the four 2x2 blocks' (Li = Lj = 10, meeting at
    an interior corner), stitched: their points of the coarse field bit for
    bit K3's plain version on the whole field, every point past it 0."""
    n, nc = 17, 9
    ranks = [Rank(n, 6, r, seed=7) for r in range(D)]  # one seed: one global field
    got = torch.cat([r.emulate(_plans(n, r.rows())[0])[0] for r in ranks])
    r0 = ranks[0]
    assert torch.equal(got[:nc], tpk.residual_restrict_plain(r0.e[:n], r0.r[:n], r0.h))
    assert not got[nc:].any()
    blocks = {(ix, iy): Block(n, (2, 2), 10, 10, ix, iy, seed=8)
              for ix in range(2) for iy in range(2)}
    outs = {k: b.emulate(_plans(n, *b.extents())[0])[0] for k, b in blocks.items()}
    got = torch.cat([torch.cat([outs[ix, iy] for iy in range(2)], dim=1) for ix in range(2)])
    b0 = blocks[0, 0]
    want = tpk.residual_restrict_plain(b0.e[:n, :n].contiguous(), b0.r[:n, :n].contiguous(), b0.h)
    assert torch.equal(got[:nc, :nc], want)
    assert not got[nc:].any() and not got[:, nc:].any()


@pytest.mark.parametrize("fault", ["short_i_halo", "short_j_halo", "corners_zeroed",
                                   "pad_unwritten", "order"])
def test_emulation_finds_a_faulty_seg_restrict_stage(fault):
    """The emulation is a check. On the (1, 1) block of a 2x2 mesh at 17^3
    (its left halos and the corner block from the other three ranks, pad
    rows and columns past 16; the 1x1 block's pad columns for the unwritten
    point): e loaded with one halo row or column short (NaN where a read
    left the segment), the corner blocks of the j-extended i halos zeroed,
    the rows past the interior columns left unwritten, or the k taps
    applied before the j taps: each leaves a wrong value in K39's block,
    and the short row and the tap order in K30's at the interior rank
    (33^3, L = 12, rank 1); without the fault both equal their plain
    versions."""
    n = 17
    good = Block(n, (2, 2), 10, 10, 1, 1, seed=11)
    plan = _plans(n, *good.extents())[0]
    want = good.plain()
    assert torch.equal(good.emulate(plan)[0], want)
    rank = Rank(33, 12, 1, seed=12)
    plan1 = _plans(33, rank.rows())[0]
    want1 = rank.plain()
    assert torch.equal(rank.emulate(plan1)[0], want1)
    if fault == "short_i_halo":
        assert torch.isnan(good.emulate(plan, kl=1)[0]).any()
        assert torch.isnan(rank.emulate(plan1, kl=1)[0]).any()
    elif fault == "short_j_halo":
        assert torch.isnan(good.emulate(plan, hjl=1)[0]).any()
    elif fault == "corners_zeroed":
        assert not torch.equal(good.emulate(plan, corners=False)[0], want)
    elif fault == "pad_unwritten":
        pad = Block(n, (1, 1), 20, 20, 0, 0, seed=13)
        got, w = pad.emulate(_plans(n, *pad.extents())[0], fault=fault)
        assert torch.isnan(got).any() and not torch.equal(w, torch.ones_like(w))
    else:
        assert not torch.equal(good.emulate(plan, fault=fault)[0], want)
        assert not torch.equal(rank.emulate(plan1, fault=fault)[0], want1)


# ------------------------------------------------------------- the plans


def test_seg_restrict_extents_are_the_kernels():
    """The interior coarse rows (and columns) the wrappers plan for are
    restrict.cuh's seg_setup's (the emulation's SegRestrict): the rank's
    coarse rows whose global index lies in [1, nc - 2], 1 for a rank
    without any (its launch writes zeros only)."""
    for (n, g0, L, gj0, Lj), want in [((257, 0, 320, None, None), (127, None)),
                                      ((257, 96, 96, None, None), (48, None)),
                                      ((257, 0, 96, None, None), (47, None)),
                                      ((257, 192, 96, None, None), (32, None)),
                                      ((257, 288, 96, None, None), (1, None)),
                                      ((257, 0, 272, 0, 272), (127, 127)),
                                      ((257, 144, 144, 144, 144), (56, 56)),
                                      ((17, 0, 18, 18, 6), (1, 1)),
                                      ((17, 0, 18, 12, 6), (7, 2))]:
        assert tpx.seg_restrict_extents(n, g0, L, gj0, Lj) == want, (n, g0, L, gj0, Lj)
    for name, (n, L, rank, _) in GEOMETRIES.items():
        seg = em.seg_restrict(n, rank * L, L, 0, 0)
        rows = tpx.seg_restrict_extents(n, rank * L, L)[0]
        assert rows == (seg.c1 - seg.c0 if seg.c1 > seg.c0 else 1), name


# ------------------------------------------------- the wrappers on the CPU


def test_k30_k39_wrappers_on_the_cpu_are_the_plain_versions():
    """On the CPU the wrappers are the plain versions: fresh coarse blocks,
    zero off the global interior, the inputs as they were, no launch
    counted; the ext forms give the same blocks."""
    r = Rank(33, 12, 2, seed=3)
    before = [t.clone() for t in (*r.e3, *r.r3)]
    tpx.reset_launches()
    tpx2.reset_launches()
    got = tpx.residual_restrict_halo(r.e3, r.r3, r.gi0, r.h, 33, 6)
    assert all(torch.equal(a, b) for a, b in zip((*r.e3, *r.r3), before))
    assert torch.equal(got, r.plain()) and not got[4:].any()
    ext = tpx.residual_restrict_ext(rk.rank_ext(r.e, 2, 12, 2), rk.rank_ext(r.r, 2, 12, 2),
                                    r.gi0, r.h, 33, 6)
    assert torch.equal(ext, got)
    b = Block(17, (1, 1), 20, 20, 0, 0, seed=4)
    got2 = tpx2.residual_restrict_halo2d(b.e5, b.r5, b.gij0, b.h, 17, 10, 10)
    assert torch.equal(got2, b.plain())
    assert not got2[8:].any() and not got2[:, 8:].any() and not got2[..., [0, 8]].any()
    assert not any(tpx.LAUNCHES.values()) and not any(tpx2.LAUNCHES.values())
