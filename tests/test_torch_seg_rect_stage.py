"""The one-pass Dirichlet stages on one rank's segmented block, the
prolongation stage (K31 ``prolong_smooth_halo`` of
multigrid_parallel_tpu_torch.ops.pallas_sharded on an i-sharded field, K40
``prolong_smooth_halo2d`` of ops.pallas_sharded2d on an (i, j)-sharded
one), the smoothing stage from a loaded u (K28 ``rb_smooth_halo``, K37
``rb_smooth_halo2d``) and from a zero one (K29
``rb_smooth_from_zero_halo``, K38 ``rb_smooth_from_zero_halo2d``), on the
CPU: an emulation of the CUDA kernels' schedule held against the plain
versions, the planner's plans for segments, and the wrappers' CPU
contract.

The CUDA stage (ops/csrc/rect.cuh with ``Layout::kSegRect``) cannot run
here, so it is emulated in torch (tests/torch_stage_emulation.py,
emulate_seg_rect) as the kernel runs it: K4's stage, black first, e + P ec
made as each plane arrives, on VIRTUAL fields whose planes and rows are the
global ones, holding a rank's points where its segments have them (the
three parts of an i-sharded block, the five of an (i, j) one with the
corner blocks in its j-extended i halos, the right buffers composite where
they start with local tail rows) and NaN everywhere else, so that a read
outside the segments shows; the blocks tile the rank's planes and rows
clipped to n - 1, the loaded box is clipped to the field only, no boundary
node is swept, the stores write the rank's owned points, and the pad
points past n - 1 take e + P ec from the coarse block's own pad rows. The
fields, e, r and the coarse correction, are random at every point, the pad
rows and columns too, so that a pad point swept or loaded would show.

The geometries: on four i-sharded ranks, rank 0 (its halo rows negative
global planes), an interior rank, plane n - 1 at a rank's row 0, a rank
with a pad tail, a rank of pad rows only; on (i, j) blocks, every block of
a 2x2 mesh whose blocks meet at an interior corner (the last one with pad
rows and columns), the 1x1 block with pad rows and columns, and a 1x4
mesh whose last column rank holds pad columns only. Each emulated body
equals its plain version bit for bit, at 17^3 and 33^3, n_iter 1 and 2, on
the planner's plans for the H100 and on hand plans (box and wavefront,
several blocks along each axis, k tiles), every point written once, and
the stitched bodies equal K4's plain version on the whole field. Four
faults must not: a j halo one column short, the corner blocks zeroed, the
pad rows and columns swept as interior ones, and the interpolation in
another order. K28 and K37 (K1's stage, no correction, red or black
first, the pad points u's own) are held the same way on every geometry,
n_iter 1 and 2, both orders, on fewer plans a case, stitched against K1's
plain version, and with the same four faults (the last: the colours in
the other order). K29 and K38 (K2's stage from a zero tile, f alone read,
the pad points 0) likewise, stitched against K2's plain version, with a
fifth fault, the pad points left unwritten; f's j halo must be two columns
short to show, as the zero tile's outer ring is never swept. The card
tests hold the kernels themselves against the plain versions
(tests/test_torch_cuda.py).
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
D = 4  # i-sharded ranks

# (n, L, rank): what the rank's segment holds
GEOMETRIES = {
    "rank0": (17, 6, 0),          # halo rows at negative global planes
    "interior": (33, 12, 1),
    "n-1 at row 0": (17, 8, 2),   # plane 16 is row 0: a boundary plane
    "pad tail": (33, 12, 2),      # planes 24-32 valid, 33-35 pad
    "whole pad": (17, 6, 3),      # planes 18-23
}
# (n, (nx, ny), Li, Lj, blocks): the (i, j) blocks of a mesh
GEOMETRIES2D = {
    "2x2 interior corner": (17, (2, 2), 10, 10, [(0, 0), (0, 1), (1, 0), (1, 1)]),
    "2x2 interior corner, 33": (33, (2, 2), 18, 18, [(1, 1)]),
    "1x1 with pad": (17, (1, 1), 20, 20, [(0, 0)]),
    "1x1 with pad, 33": (33, (1, 1), 36, 36, [(0, 0)]),
    "1x4 pad-only columns": (17, (1, 4), 18, 6, [(0, 2), (0, 3)]),
}


def _rnd(rng, shape):
    return torch.from_numpy(rng.standard_normal(shape).astype(np.float32))


def _plans(kind, n, n_iter, planes, cols=None, prolong=True):
    """The plan of one launch: the planner's for the H100's 132 SMs (K31's
    and K40's, or without ``prolong`` K28's and K37's), or a hand plan of
    the segment's planes (and rows): a box of 2 planes by 4 rows, 3 planes
    by 8 whole rows on the wavefront, or 4-slot k tiles with the 4-slot k
    halo by 5 rows and 2 planes (wavefront)."""
    halo, s = 2 * n_iter, n // 2
    if kind == "h100":
        return tps._stage_plan(n, n_iter, H100_SMS, prolong=prolong, rect=True,
                               seg_planes=planes, seg_cols=cols)
    return {"box": tps.StagePlan(n, n_iter, halo, 0, 2, 4, s, 256, 0, True, True, planes, cols),
            "rows": tps.StagePlan(n, n_iter, halo, 0, 3, 8, s, 256, 0, True, False, planes, cols),
            "k_tiles": tps.StagePlan(n, n_iter, halo, tps.STAGE_K_HALO, 2, 5, 4, 256, 0, True,
                                     False, planes, cols)}[kind]


class Rank:
    """One i-sharded rank's triples of random global fields (e, r: (D L, n,
    n); the coarse correction (D L / 2, nc, nc)), every plane random, the
    right buffers composite; its h."""

    def __init__(self, n, L, rank, n_iter, seed):
        rng = np.random.default_rng(seed)
        nc, lc, hh = (n + 1) // 2, L // 2, 2 * n_iter
        self.n, self.L, self.rank, self.n_iter = n, L, rank, n_iter
        self.gi0, self.g0 = rank * L - hh, rank * L
        self.h = 1.0 / (n - 1)
        self.e, self.r, self.ec = _rnd(rng, (D * L, n, n)), _rnd(rng, (D * L, n, n)), _rnd(
            rng, (D * lc, nc, nc))
        self.e3 = rk.rank_parts(self.e, rank, L, hh, hh, tail=2)
        self.r3 = rk.rank_parts(self.r, rank, L, hh, hh, tail=3)
        self.ec3 = rk.rank_parts(self.ec, rank, lc, n_iter, n_iter + 1, tail=1)

    def planes(self):
        return tpx.seg_rect_planes(self.g0, self.L, self.n)

    def plain(self):
        return tpx.prolong_smooth_halo_plain(self.ec3, self.e3, self.r3, self.gi0, self.h,
                                             self.n_iter, self.n, self.L)

    def emulate(self, plan, fault=None):
        hh, ni = 2 * self.n_iter, self.n_iter
        e, r = tpx._seg(self.e3, hh, hh, self.L), tpx._seg(self.r3, hh, hh, self.L)
        c = tpx._seg(self.ec3, ni, ni + 1, self.L // 2)
        body, w = em.emulate_seg_rect(e.rows(hh, hh), r.rows(hh, hh), c.rows(ni, ni + 1),
                                      (self.g0 - hh, 0), (self.g0 // 2 - ni, 0),
                                      (self.g0, self.L, 0, self.n), self.n, ni, self.h, plan,
                                      fault)
        return body, w

    def smooth_plain(self, red_first):
        """K28's plain version on u = e, f = r."""
        return tpx.rb_smooth_halo_plain(self.e3, self.r3, self.gi0, self.h, self.n_iter, self.n,
                                        self.L, red_first)

    def emulate_smooth(self, plan, red_first, fault=None):
        hh = 2 * self.n_iter
        u, f = tpx._seg(self.e3, hh, hh, self.L), tpx._seg(self.r3, hh, hh, self.L)
        return em.emulate_seg_rect(u.rows(hh, hh), f.rows(hh, hh), None, (self.g0 - hh, 0), None,
                                   (self.g0, self.L, 0, self.n), self.n, self.n_iter, self.h,
                                   plan, fault, red_first)

    def zero_plain(self, red_first):
        """K29's plain version on f = r."""
        return tpx.rb_smooth_from_zero_halo_plain(self.r3, self.gi0, self.h, self.n_iter,
                                                  self.n, self.L, red_first)

    def emulate_zero(self, plan, red_first, fault=None):
        hh = 2 * self.n_iter
        f = tpx._seg(self.r3, hh, hh, self.L)
        return em.emulate_seg_rect(None, f.rows(hh, hh), None, (self.g0 - hh, 0), None,
                                   (self.g0, self.L, 0, self.n), self.n, self.n_iter, self.h,
                                   plan, fault, red_first)


class Block:
    """One (i, j) block's five parts of random global fields (e, r: (nx
    Li, ny Lj, n); the coarse correction at half the rows and columns),
    every point random, the right i buffers composite; its h."""

    def __init__(self, n, mesh, li, lj, ix, iy, n_iter, seed, hjl=None, corners=True):
        rng = np.random.default_rng(seed)
        (nx, ny), nc, hh = mesh, (n + 1) // 2, 2 * n_iter
        self.n, self.li, self.lj, self.n_iter = n, li, lj, n_iter
        self.g0, self.gj0 = ix * li, iy * lj
        self.gij0 = (self.g0 - hh, self.gj0 - hh)
        self.h = 1.0 / (n - 1)
        self.e = _rnd(rng, (nx * li, ny * lj, n))
        self.r = _rnd(rng, (nx * li, ny * lj, n))
        self.ec = _rnd(rng, (nx * li // 2, ny * lj // 2, nc))
        self.e5 = rk.rank_parts2d(self.e, ix, iy, li, lj, hh, hh, tail=2)
        self.r5 = rk.rank_parts2d(self.r, ix, iy, li, lj, hh, hh, tail=1)
        self.c5 = rk.rank_parts2d(self.ec, ix, iy, li // 2, lj // 2, n_iter, n_iter + 1)
        self.hjl = hh if hjl is None else hjl
        self.corners = corners

    def planes(self):
        return tpx.seg_rect_planes(self.g0, self.li, self.n)

    def cols(self):
        return tpx.seg_rect_planes(self.gj0, self.lj, self.n)

    def plain(self):
        return tpx2.prolong_smooth_halo2d_plain(self.c5, self.e5, self.r5, self.gij0, self.h,
                                                self.n_iter, self.n, self.li, self.lj)

    def _slabs(self):
        """e's and r's slabs, ``hjl`` columns before the block (the
        corner blocks zeroed where ``corners`` is False)."""
        hh = 2 * self.n_iter
        seg = lambda x: tpx2._seg2(x, self.li, self.lj, hh, hh, hh, hh)  # noqa: E731
        slabs = [seg(x).slab(hh, hh, self.hjl, hh) for x in (self.e5, self.r5)]
        if not self.corners:  # the fault: the j-extended i halos' corner blocks zeroed
            for x in slabs:
                for rows in (slice(0, hh), slice(hh + self.li, None)):
                    x[rows, :self.hjl] = 0.0
                    x[rows, self.hjl + self.lj:] = 0.0
        return slabs

    def emulate(self, plan, fault=None):
        hh, ni, kc = 2 * self.n_iter, self.n_iter, self.n_iter + 1
        c = tpx2._seg2(self.c5, self.li // 2, self.lj // 2, ni, kc, ni, kc)
        slabs = self._slabs()
        return em.emulate_seg_rect(slabs[0], slabs[1], c.slab(ni, kc, ni, kc),
                                   (self.g0 - hh, self.gj0 - self.hjl),
                                   (self.g0 // 2 - ni, self.gj0 // 2 - ni),
                                   (self.g0, self.li, self.gj0, self.lj), self.n, ni, self.h,
                                   plan, fault)

    def smooth_plain(self, red_first):
        """K37's plain version on u = e, f = r."""
        return tpx2.rb_smooth_halo2d_plain(self.e5, self.r5, self.gij0, self.h, self.n_iter,
                                           self.n, self.li, self.lj, red_first)

    def emulate_smooth(self, plan, red_first, fault=None):
        hh = 2 * self.n_iter
        slabs = self._slabs()
        return em.emulate_seg_rect(slabs[0], slabs[1], None, (self.g0 - hh, self.gj0 - self.hjl),
                                   None, (self.g0, self.li, self.gj0, self.lj), self.n,
                                   self.n_iter, self.h, plan, fault, red_first)

    def zero_plain(self, red_first):
        """K38's plain version on f = r."""
        return tpx2.rb_smooth_from_zero_halo2d_plain(self.r5, self.gij0, self.h, self.n_iter,
                                                     self.n, self.li, self.lj, red_first)

    def emulate_zero(self, plan, red_first, fault=None):
        hh = 2 * self.n_iter
        return em.emulate_seg_rect(None, self._slabs()[1], None,
                                   (self.g0 - hh, self.gj0 - self.hjl), None,
                                   (self.g0, self.li, self.gj0, self.lj), self.n, self.n_iter,
                                   self.h, plan, fault, red_first)


def _check_writes(w):
    assert torch.equal(w, torch.ones_like(w)), "a point written other than once"


@pytest.mark.parametrize("n_iter", [1, 2])
@pytest.mark.parametrize("geometry", list(GEOMETRIES))
def test_emulated_k31_stage_matches_plain(geometry, n_iter):
    """K31 on each i-sharded geometry, at 17^3 and 33^3, on the planner's
    plans and on hand plans: bit for bit against the plain version, every
    point of the body written once (the pad rows e + P ec)."""
    n, L, rank = GEOMETRIES[geometry]
    rk_ = Rank(n, L, rank, n_iter, seed=100 * n + 10 * rank + n_iter)
    want = rk_.plain()
    for kind in (["h100", "box", "rows"] if n == 17 else ["h100", "k_tiles"]):
        got, w = rk_.emulate(_plans(kind, n, n_iter, rk_.planes()))
        _check_writes(w)
        assert torch.equal(got, want), kind


@pytest.mark.parametrize("n_iter", [1, 2])
@pytest.mark.parametrize("geometry", list(GEOMETRIES2D))
def test_emulated_k40_stage_matches_plain(geometry, n_iter):
    """K40 on each (i, j) block, at 17^3 and 33^3, on the planner's plans
    and on hand plans: bit for bit against the plain version, every point
    of the block written once (the pad rows and columns e + P ec)."""
    n, mesh, li, lj, blocks = GEOMETRIES2D[geometry]
    for ix, iy in blocks:
        b = Block(n, mesh, li, lj, ix, iy, n_iter, seed=100 * n + 10 * ix + iy + n_iter)
        want = b.plain()
        for kind in (["h100", "box", "rows"] if n == 17 else ["h100", "k_tiles"]):
            got, w = b.emulate(_plans(kind, n, n_iter, b.planes(), b.cols()))
            _check_writes(w)
            assert torch.equal(got, want), (kind, ix, iy)


def test_emulated_stages_stitch_to_k4():
    """The four i-sharded ranks' emulated bodies at 17^3, L = 6 (rank 3 pad
    only), and the four 2x2 blocks' (Li = Lj = 10, meeting at an interior
    corner), stitched: their points of the field bit for bit K4's plain
    version on the whole field."""
    n, n_iter = 17, 2
    ranks = [Rank(n, 6, r, n_iter, seed=7) for r in range(D)]  # one seed: one global field
    got = torch.cat([r.emulate(_plans("h100", n, n_iter, r.planes()))[0] for r in ranks])[:n]
    r0 = ranks[0]
    want = tpk.prolong_smooth_plain(r0.ec[:(n + 1) // 2], r0.e[:n], r0.r[:n], r0.h, n_iter)
    assert torch.equal(got, want)
    blocks = {(ix, iy): Block(n, (2, 2), 10, 10, ix, iy, n_iter, seed=8)
              for ix in range(2) for iy in range(2)}
    outs = {k: b.emulate(_plans("h100", n, n_iter, b.planes(), b.cols()))[0]
            for k, b in blocks.items()}
    got = torch.cat([torch.cat([outs[ix, iy] for iy in range(2)], dim=1) for ix in range(2)])
    b0, nc = blocks[0, 0], (n + 1) // 2
    want = tpk.prolong_smooth_plain(b0.ec[:nc, :nc], b0.e[:n, :n], b0.r[:n, :n], b0.h, n_iter)
    assert torch.equal(got[:n, :n], want)


@pytest.mark.parametrize("fault", ["short_j_halo", "corners_zeroed", "pad_swept", "order"])
def test_emulation_finds_a_faulty_seg_rect_stage(fault):
    """The emulation is a check. On the (1, 1) block of a 2x2 mesh at 17^3
    (its left halos and the corner block from the other three ranks, pad
    rows and columns past 16): a j halo one column short (NaN where a read
    left the segment), the corner blocks of the j-extended i halos zeroed,
    the pad rows and columns swept as interior ones, or the interpolation
    made i, then j, then k: each leaves a wrong value in K40's block, and
    the last two in K31's at the pad-tail geometry (33^3, L = 12, rank 2);
    without the fault both equal their plain versions."""
    n, n_iter = 17, 2
    good = Block(n, (2, 2), 10, 10, 1, 1, n_iter, seed=11)
    plan = _plans("h100", n, n_iter, good.planes(), good.cols())
    want = good.plain()
    assert torch.equal(good.emulate(plan)[0], want)
    rank = Rank(33, 12, 2, n_iter, seed=12)
    plan1 = _plans("h100", 33, n_iter, rank.planes())
    want1 = rank.plain()
    assert torch.equal(rank.emulate(plan1)[0], want1)
    if fault == "short_j_halo":
        bad = Block(n, (2, 2), 10, 10, 1, 1, n_iter, seed=11, hjl=2 * n_iter - 1)
        assert torch.isnan(bad.emulate(plan)[0]).any()
        return
    if fault == "corners_zeroed":
        bad = Block(n, (2, 2), 10, 10, 1, 1, n_iter, seed=11, corners=False)
        assert not torch.equal(bad.emulate(plan)[0], want)
        return
    assert not torch.equal(good.emulate(plan, fault=fault)[0], want)
    assert not torch.equal(rank.emulate(plan1, fault=fault)[0], want1)


# -------------------------------------- K28 and K37: K1's stage on segments


def _smooth_kinds(n, red_first):
    """The plans of a K28 or K37 case: at 17^3 the planner's and a hand
    box (red first) or wavefront (black first); at 33^3 the planner's (red
    first) or the k tiles (black first)."""
    if n == 17:
        return ["h100", "box" if red_first else "rows"]
    return ["h100" if red_first else "k_tiles"]


@pytest.mark.parametrize("red_first", [True, False])
@pytest.mark.parametrize("n_iter", [1, 2])
@pytest.mark.parametrize("geometry", list(GEOMETRIES))
def test_emulated_k28_stage_matches_plain(geometry, n_iter, red_first):
    """K28 on each i-sharded geometry, at 17^3 and 33^3, both orders: bit
    for bit against the plain version, every point of the body written
    once (the pad rows u's own)."""
    n, L, rank = GEOMETRIES[geometry]
    rk_ = Rank(n, L, rank, n_iter, seed=100 * n + 10 * rank + n_iter + 5 * red_first)
    want = rk_.smooth_plain(red_first)
    for kind in _smooth_kinds(n, red_first):
        got, w = rk_.emulate_smooth(_plans(kind, n, n_iter, rk_.planes(), prolong=False),
                                    red_first)
        _check_writes(w)
        assert torch.equal(got, want), kind


@pytest.mark.parametrize("red_first", [True, False])
@pytest.mark.parametrize("n_iter", [1, 2])
@pytest.mark.parametrize("geometry", list(GEOMETRIES2D))
def test_emulated_k37_stage_matches_plain(geometry, n_iter, red_first):
    """K37 on each (i, j) block, at 17^3 and 33^3, both orders: bit for
    bit against the plain version, every point of the block written once
    (the pad rows and columns u's own)."""
    n, mesh, li, lj, blocks = GEOMETRIES2D[geometry]
    for ix, iy in blocks:
        b = Block(n, mesh, li, lj, ix, iy, n_iter,
                  seed=100 * n + 10 * ix + iy + n_iter + 5 * red_first)
        want = b.smooth_plain(red_first)
        for kind in _smooth_kinds(n, red_first):
            got, w = b.emulate_smooth(_plans(kind, n, n_iter, b.planes(), b.cols(),
                                             prolong=False), red_first)
            _check_writes(w)
            assert torch.equal(got, want), (kind, ix, iy)


def test_emulated_smoothing_stages_stitch_to_k1():
    """The four i-sharded ranks' emulated K28 bodies at 17^3, L = 6 (rank
    3 pad only), red first, and the four 2x2 blocks' K37 ones (Li = Lj =
    10), black first, stitched: their points of the field bit for bit K1's
    plain version on the whole field."""
    n, n_iter = 17, 2
    ranks = [Rank(n, 6, r, n_iter, seed=7) for r in range(D)]  # one seed: one global field
    got = torch.cat([r.emulate_smooth(_plans("h100", n, n_iter, r.planes(), prolong=False),
                                      True)[0] for r in ranks])[:n]
    r0 = ranks[0]
    assert torch.equal(got, tpk.rb_smooth_plain(r0.e[:n], r0.r[:n], r0.h, n_iter, True))
    blocks = {(ix, iy): Block(n, (2, 2), 10, 10, ix, iy, n_iter, seed=8)
              for ix in range(2) for iy in range(2)}
    outs = {k: b.emulate_smooth(_plans("h100", n, n_iter, b.planes(), b.cols(), prolong=False),
                                False)[0] for k, b in blocks.items()}
    got = torch.cat([torch.cat([outs[ix, iy] for iy in range(2)], dim=1) for ix in range(2)])
    b0 = blocks[0, 0]
    want = tpk.rb_smooth_plain(b0.e[:n, :n], b0.r[:n, :n], b0.h, n_iter, False)
    assert torch.equal(got[:n, :n], want)


@pytest.mark.parametrize("fault", ["short_j_halo", "corners_zeroed", "pad_swept", "order"])
def test_emulation_finds_a_faulty_seg_smooth_stage(fault):
    """The emulation of K28 and K37 is a check. On the (1, 1) block of a
    2x2 mesh at 17^3: a j halo one column short (NaN where a read left the
    segment), the corner blocks zeroed, the pad rows and columns swept as
    interior ones, or the colours in the other order: each leaves a wrong
    value in K37's block, and the last two in K28's at the pad-tail
    geometry (33^3, L = 12, rank 2); without the fault both equal their
    plain versions, red first."""
    n, n_iter = 17, 2
    good = Block(n, (2, 2), 10, 10, 1, 1, n_iter, seed=11)
    plan = _plans("h100", n, n_iter, good.planes(), good.cols(), prolong=False)
    want = good.smooth_plain(True)
    assert torch.equal(good.emulate_smooth(plan, True)[0], want)
    rank = Rank(33, 12, 2, n_iter, seed=12)
    plan1 = _plans("h100", 33, n_iter, rank.planes(), prolong=False)
    want1 = rank.smooth_plain(True)
    assert torch.equal(rank.emulate_smooth(plan1, True)[0], want1)
    if fault == "short_j_halo":
        bad = Block(n, (2, 2), 10, 10, 1, 1, n_iter, seed=11, hjl=2 * n_iter - 1)
        assert torch.isnan(bad.emulate_smooth(plan, True)[0]).any()
        return
    if fault == "corners_zeroed":
        bad = Block(n, (2, 2), 10, 10, 1, 1, n_iter, seed=11, corners=False)
        assert not torch.equal(bad.emulate_smooth(plan, True)[0], want)
        return
    assert not torch.equal(good.emulate_smooth(plan, True, fault)[0], want)
    assert not torch.equal(rank.emulate_smooth(plan1, True, fault)[0], want1)


# --------------------------- K29 and K38: K2's stage from a zero tile on segments


@pytest.mark.parametrize("red_first", [True, False])
@pytest.mark.parametrize("n_iter", [1, 2])
@pytest.mark.parametrize("geometry", list(GEOMETRIES))
def test_emulated_k29_stage_matches_plain(geometry, n_iter, red_first):
    """K29 on each i-sharded geometry, at 17^3 and 33^3, both orders: bit
    for bit against the plain version, every point of the body written
    once (the pad rows 0)."""
    n, L, rank = GEOMETRIES[geometry]
    rk_ = Rank(n, L, rank, n_iter, seed=200 * n + 10 * rank + n_iter + 5 * red_first)
    want = rk_.zero_plain(red_first)
    for kind in _smooth_kinds(n, red_first):
        got, w = rk_.emulate_zero(_plans(kind, n, n_iter, rk_.planes(), prolong=False),
                                  red_first)
        _check_writes(w)
        assert torch.equal(got, want), kind
    assert not want[max(0, n - rk_.g0):].any(), "pad rows not 0"


@pytest.mark.parametrize("red_first", [True, False])
@pytest.mark.parametrize("n_iter", [1, 2])
@pytest.mark.parametrize("geometry", list(GEOMETRIES2D))
def test_emulated_k38_stage_matches_plain(geometry, n_iter, red_first):
    """K38 on each (i, j) block, at 17^3 and 33^3, both orders: bit for
    bit against the plain version, every point of the block written once
    (the pad rows and columns 0)."""
    n, mesh, li, lj, blocks = GEOMETRIES2D[geometry]
    for ix, iy in blocks:
        b = Block(n, mesh, li, lj, ix, iy, n_iter,
                  seed=200 * n + 10 * ix + iy + n_iter + 5 * red_first)
        want = b.zero_plain(red_first)
        for kind in _smooth_kinds(n, red_first):
            got, w = b.emulate_zero(_plans(kind, n, n_iter, b.planes(), b.cols(),
                                           prolong=False), red_first)
            _check_writes(w)
            assert torch.equal(got, want), (kind, ix, iy)
        assert not want[max(0, n - b.g0):].any() and not want[:, max(0, n - b.gj0):].any()


def test_emulated_from_zero_stages_stitch_to_k2():
    """The four i-sharded ranks' emulated K29 bodies at 17^3, L = 6 (rank
    3 pad only), red first, and the four 2x2 blocks' K38 ones (Li = Lj =
    10), black first, stitched: their points of the field bit for bit K2's
    plain version on the whole field, the pad points 0."""
    n, n_iter = 17, 2
    ranks = [Rank(n, 6, r, n_iter, seed=9) for r in range(D)]  # one seed: one global field
    got = torch.cat([r.emulate_zero(_plans("h100", n, n_iter, r.planes(), prolong=False),
                                    True)[0] for r in ranks])
    r0 = ranks[0]
    assert torch.equal(got[:n], tpk.rb_smooth_from_zero_plain(r0.r[:n], r0.h, n_iter, True))
    assert not got[n:].any()
    blocks = {(ix, iy): Block(n, (2, 2), 10, 10, ix, iy, n_iter, seed=10)
              for ix in range(2) for iy in range(2)}
    outs = {k: b.emulate_zero(_plans("h100", n, n_iter, b.planes(), b.cols(), prolong=False),
                              False)[0] for k, b in blocks.items()}
    got = torch.cat([torch.cat([outs[ix, iy] for iy in range(2)], dim=1) for ix in range(2)])
    b0 = blocks[0, 0]
    want = tpk.rb_smooth_from_zero_plain(b0.r[:n, :n], b0.h, n_iter, False)
    assert torch.equal(got[:n, :n], want)
    assert not got[n:].any() and not got[:, n:].any()


@pytest.mark.parametrize("fault", ["short_j_halo", "corners_zeroed", "pad_swept", "order",
                                   "pad_unwritten"])
def test_emulation_finds_a_faulty_seg_from_zero_stage(fault):
    """The emulation of K29 and K38 is a check. On the (1, 1) block of a
    2x2 mesh at 17^3: f's j halo short of what the stage reads (NaN where a
    read left the segment; two columns short, as the zero tile's outer ring
    is never swept, so f's column H before the block is never read), f's
    corner blocks zeroed, the pad rows and columns swept as interior ones,
    the colours in the other order, or the pad points left unwritten: each
    leaves a wrong value in K38's block, and the last three in K29's at the
    pad-tail geometry (33^3, L = 12, rank 2); without the fault both equal
    their plain versions, red first."""
    n, n_iter = 17, 2
    good = Block(n, (2, 2), 10, 10, 1, 1, n_iter, seed=13)
    plan = _plans("h100", n, n_iter, good.planes(), good.cols(), prolong=False)
    want = good.zero_plain(True)
    assert torch.equal(good.emulate_zero(plan, True)[0], want)
    rank = Rank(33, 12, 2, n_iter, seed=14)
    plan1 = _plans("h100", 33, n_iter, rank.planes(), prolong=False)
    want1 = rank.zero_plain(True)
    assert torch.equal(rank.emulate_zero(plan1, True)[0], want1)
    if fault == "short_j_halo":
        ok = Block(n, (2, 2), 10, 10, 1, 1, n_iter, seed=13, hjl=2 * n_iter - 1)
        assert torch.equal(ok.emulate_zero(plan, True)[0], want)  # column H: never read
        bad = Block(n, (2, 2), 10, 10, 1, 1, n_iter, seed=13, hjl=2 * n_iter - 2)
        assert torch.isnan(bad.emulate_zero(plan, True)[0]).any()
        return
    if fault == "corners_zeroed":
        bad = Block(n, (2, 2), 10, 10, 1, 1, n_iter, seed=13, corners=False)
        assert not torch.equal(bad.emulate_zero(plan, True)[0], want)
        return
    assert not torch.equal(good.emulate_zero(plan, True, fault)[0], want)
    assert not torch.equal(rank.emulate_zero(plan1, True, fault)[0], want1)


# ------------------------------------------------------------- the plans


@pytest.mark.parametrize("n", [9, 17, 33, 65, 129, 257])
def test_seg_rect_plans_tile_the_rows_of_a_block(n):
    """K31's and K40's plans (``seg_planes``, ``seg_cols``), and K28's and K37's
    at n_iter 2, tile only a rank's planes and rows: for the production
    segments (the one-rank L = 320 .. 10 and the four-rank L = 96 .. 6
    clipped to n; the 1x1 blocks of 272 .. 34 and the 2x2 ones of 144 ..
    18 clipped to n, and their clipped last blocks), one row and two, its
    tiles cover them and no more, the schedule is the level's (a box up to
    129^3), within the shared memory and the kernels' 512-thread launch
    bound; the planes the wrappers ask for are rect.cuh's
    seg_rect_geometry's (the emulation's spans)."""
    four, half = 96 * (n - 1) // 256, 144 * (n - 1) // 256
    extents = {n, max(1, four), max(1, n - 3 * four), 1, 2, max(1, half), max(1, n - half)}
    for n_iter, prolong in ((1, True), (2, True), (2, False)):
        whole = tps._stage_plan(n, n_iter, H100_SMS, prolong, True)
        for planes in extents:
            for cols in (None, n, max(1, half), max(1, n - half), 1):
                plan = tps._stage_plan(n, n_iter, H100_SMS, prolong, True, seg_planes=planes,
                                       seg_cols=cols)
                ni, nj, _ = plan.tiles
                m = cols or n
                assert ni == -(-planes // plan.bi) and (ni - 1) * plan.bi < planes
                assert nj == -(-m // plan.bj) and (nj - 1) * plan.bj < m
                assert plan.box == whole.box and plan.smem <= tps.SMEM_MAX
                assert plan.threads <= tps.SEG_MAX_THREADS and plan.threads % 32 == 0
                assert plan.smem == tps._stage_smem(n_iter, plan.bj, tps._stage_width(
                    n, plan.bk, plan.k_halo, True), prolong, True, plan.bi if plan.box else 0)
    for name, (m, L, rank) in GEOMETRIES.items():
        g0 = rank * L
        assert tpx.seg_rect_planes(g0, L, m) == max(1, (min(g0 + L, m) if g0 < m else g0) - g0)
    for g0, L, m, want in [(0, 320, 257, 257), (288, 96, 257, 1), (192, 96, 257, 65),
                           (144, 144, 257, 113), (0, 272, 257, 257), (0, 10, 9, 9)]:
        assert tpx.seg_rect_planes(g0, L, m) == want, (g0, L, m)
    with pytest.raises(ValueError, match="seg_cols"):
        tps._stage_plan(33, 2, H100_SMS, rect=True, seg_cols=10)  # rows need planes too
    with pytest.raises(ValueError, match="seg_cols"):
        tps._stage_plan(33, 2, H100_SMS, rect=True, seg_planes=10, seg_cols=0)


# ------------------------------------------------- the wrappers on the CPU


def test_k31_k40_wrappers_on_the_cpu_are_the_plain_versions():
    """On the CPU the wrappers are the plain versions: fresh bodies whose pad
    rows (and columns) hold e + P ec from the coarse block's own pad rows
    (random here, so not zero and not e), the inputs as they were, no
    launch counted; the ext forms give the same bodies."""
    n_iter, hh = 2, 4
    rk_ = Rank(33, 12, 2, n_iter, seed=3)
    before = [t.clone() for t in (*rk_.e3, *rk_.r3, *rk_.ec3)]
    tpx.reset_launches()
    tpx2.reset_launches()
    got = tpx.prolong_smooth_halo(rk_.ec3, rk_.e3, rk_.r3, rk_.gi0, rk_.h, n_iter, 33, 12)
    assert all(torch.equal(a, b) for a, b in zip((*rk_.e3, *rk_.r3, *rk_.ec3), before))
    assert torch.equal(got, rk_.plain())
    pad = got[9:]  # planes 33-35
    p_ec = em.prolongation(rk_.ec[12:20])[:, :33, :33]  # fine planes 24 .. 38
    assert torch.equal(pad, rk_.e[33:36] + p_ec[9:12])
    assert not torch.equal(pad, rk_.e[33:36])
    ext = tpx.prolong_smooth_ext(rk.rank_ext(rk_.ec, 2, 6, n_iter + 1),
                                 rk.rank_ext(rk_.e, 2, 12, hh), rk.rank_ext(rk_.r, 2, 12, hh),
                                 rk_.gi0, rk_.h, n_iter, 33, 12)
    assert torch.equal(ext, got)
    b = Block(17, (1, 1), 20, 20, 0, 0, n_iter, seed=4)
    got2 = tpx2.prolong_smooth_halo2d(b.c5, b.e5, b.r5, b.gij0, b.h, n_iter, 17, 20, 20)
    assert torch.equal(got2, b.plain())
    ecz = torch.zeros((11, 11, 9))  # the chain ends' zero halo past the coarse block
    ecz[:10, :10] = b.ec
    p_ec = em.prolongation(ecz)[:20, :20]
    assert torch.equal(got2[17:], b.e[17:] + p_ec[17:])
    assert torch.equal(got2[:, 17:], b.e[:, 17:] + p_ec[:, 17:])
    assert not any(tpx.LAUNCHES.values()) and not any(tpx2.LAUNCHES.values())


def test_k28_k37_wrappers_on_the_cpu_are_the_plain_versions():
    """On the CPU the smoothing wrappers are the plain versions: fresh
    bodies (K37's contiguous) whose pad rows (and columns) hold u's own
    values, the inputs as they were, no launch counted; the ext forms give
    the same bodies; n_iter 0 refused."""
    n_iter, hh = 2, 4
    rk_ = Rank(33, 12, 2, n_iter, seed=3)
    before = [t.clone() for t in (*rk_.e3, *rk_.r3)]
    tpx.reset_launches()
    tpx2.reset_launches()
    for red in (True, False):
        got = tpx.rb_smooth_halo(rk_.e3, rk_.r3, rk_.gi0, rk_.h, n_iter, 33, 12, red)
        assert torch.equal(got, rk_.smooth_plain(red))
        assert torch.equal(got[9:], rk_.e[33:36])  # planes 33-35: pad
        assert not torch.equal(got[:9], rk_.e[24:33])
    assert all(torch.equal(a, b) for a, b in zip((*rk_.e3, *rk_.r3), before))
    ext = tpx.rb_smooth_ext(rk.rank_ext(rk_.e, 2, 12, hh), rk.rank_ext(rk_.r, 2, 12, hh),
                            rk_.gi0, rk_.h, n_iter, 33, 12, False)
    assert torch.equal(ext, got)
    b = Block(17, (1, 1), 20, 20, 0, 0, n_iter, seed=4)
    got2 = tpx2.rb_smooth_halo2d(b.e5, b.r5, b.gij0, b.h, n_iter, 17, 20, 20)
    assert got2.is_contiguous() and torch.equal(got2, b.smooth_plain(True))
    assert torch.equal(got2[17:], b.e[17:]) and torch.equal(got2[:, 17:], b.e[:, 17:])
    ext2 = tpx2.rb_smooth_ext2d(rk.rank_ext2d(b.e, 0, 0, 20, 20, hh, hh, hh, hh),
                                rk.rank_ext2d(b.r, 0, 0, 20, 20, hh, hh, hh, hh), b.gij0, b.h,
                                n_iter, 17, 20, 20)
    assert torch.equal(ext2, got2)
    assert not any(tpx.LAUNCHES.values()) and not any(tpx2.LAUNCHES.values())
    with pytest.raises(ValueError, match="n_iter"):
        tpx.rb_smooth_halo(rk_.e3, rk_.r3, rk_.gi0, rk_.h, 0, 33, 12)
    with pytest.raises(ValueError, match="n_iter"):
        tpx2.rb_smooth_halo2d(b.e5, b.r5, b.gij0, b.h, 0, 17, 20, 20)


def test_k29_k38_wrappers_on_the_cpu_are_the_plain_versions():
    """On the CPU the from-zero wrappers are the plain versions: fresh
    bodies whose pad rows (and columns) are 0 though f's are random, f as
    it was, no launch counted; the ext forms give the same bodies; n_iter 0
    refused."""
    n_iter, hh = 2, 4
    rk_ = Rank(33, 12, 2, n_iter, seed=5)
    before = [t.clone() for t in rk_.r3]
    tpx.reset_launches()
    tpx2.reset_launches()
    for red in (True, False):
        got = tpx.rb_smooth_from_zero_halo(rk_.r3, rk_.gi0, rk_.h, n_iter, 33, 12, red)
        assert torch.equal(got, rk_.zero_plain(red))
        assert not got[9:].any() and rk_.r[33:36].all()  # planes 33-35: pad
        assert got[:8, 1:-1, 1:-1].all() and not got[8].any()  # plane 32: a boundary
    assert all(torch.equal(a, b) for a, b in zip(rk_.r3, before))
    ext = tpx.rb_smooth_from_zero_ext(rk.rank_ext(rk_.r, 2, 12, hh), rk_.gi0, rk_.h, n_iter, 33,
                                      12, False)
    assert torch.equal(ext, got)
    b = Block(17, (1, 1), 20, 20, 0, 0, n_iter, seed=6)
    got2 = tpx2.rb_smooth_from_zero_halo2d(b.r5, b.gij0, b.h, n_iter, 17, 20, 20)
    assert got2.is_contiguous() and torch.equal(got2, b.zero_plain(True))
    assert not got2[17:].any() and not got2[:, 17:].any()
    ext2 = tpx2.rb_smooth_from_zero_ext2d(rk.rank_ext2d(b.r, 0, 0, 20, 20, hh, hh, hh, hh),
                                          b.gij0, b.h, n_iter, 17, 20, 20)
    assert torch.equal(ext2, got2)
    assert not any(tpx.LAUNCHES.values()) and not any(tpx2.LAUNCHES.values())
    with pytest.raises(ValueError, match="n_iter"):
        tpx.rb_smooth_from_zero_halo(rk_.r3, rk_.gi0, rk_.h, 0, 33, 12)
    with pytest.raises(ValueError, match="n_iter"):
        tpx2.rb_smooth_from_zero_halo2d(b.r5, b.gij0, b.h, 0, 17, 20, 20)
