"""The streaming double-float residual-and-norm stage on one rank's
segmented block (K32 ``residual_df_norm_halo`` of
multigrid_parallel_tpu_torch.ops.pallas_sharded on an i-sharded field, K41
``residual_df_norm_halo2d`` of ops.pallas_sharded2d on an (i, j)-sharded
one) on the CPU: an emulation of the CUDA kernel's schedule held against
the plain versions, the planner's plans, and the wrappers' CPU contract.

The CUDA stage (ops/csrc/residual_df_norm_seg.cu, df_stage_kernel) cannot
run here, so it is emulated in torch (tests/torch_stage_emulation.py,
emulate_df) as the kernel runs it: the blocks tile the rank's interior
planes, rows and k; each streams its planes of u_hi and u_lo through the
kernel's ring of tile planes, copied from a slab of the rank's segments
(the three parts of an i-sharded block, the five of an (i, j) one) at
local indices, NaN past what they hold, so that a read outside them
shows; f is read at the owned points; the zeros of the planes outside the
interior and of the rows, columns and k ends around each box come from
the same launch; each thread sums its squares in f64 in the kernel's
order, the block by its warp tree, the partials by eft.cuh's sum. The
fields are random at every point, the pad planes and columns too.

The geometries are those of the one-pass segment stages
(tests/test_torch_seg_rect_stage.py): on four i-sharded ranks, rank 0,
an interior rank, plane n - 1 at a rank's row 0, a pad tail and a pad-only
rank; on (i, j) blocks, every block of a 2x2 mesh meeting at an interior
corner, the 1x1 block with pad rows and columns, and a 1x4 mesh whose last
column rank holds pad columns only. Each emulated r equals its plain
version bit for bit at 17^3 and 33^3, on the planner's plan for the H100
and on hand plans, every point written once, and its norm is within rel
1e-6 of the plain version's (the f64 sum in another order); the stitched
r equals K5's plain version on the whole field. Four faults must not: a
ring slot reused one plane early, a j halo row read from the body
buffer, the k + 1 (k - 1) neighbour of a chunk's last (first) lane taken
from its first (last) lane, and the pad planes left unwritten. The card
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
from test_torch_seg_rect_stage import GEOMETRIES, GEOMETRIES2D

torch.set_num_threads(1)

H100_SMS = 132
D = 4    # i-sharded ranks
PAD = 2  # NaN planes and rows around an emulated slab
NORM_RTOL = 1e-6


def _df_fields(rng, shape):
    """u_hi, u_lo, f_hi, f_lo: double-float splits of two random f64
    fields."""
    out = []
    for _ in range(2):
        x = rng.standard_normal(shape) * (1.0 + 1e-3 * rng.standard_normal(shape))
        out.extend(tpk.df_split(torch.from_numpy(x)))
    return out


def _plans(n, rows, cols):
    """The planner's plan for the H100's 132 SMs and two hand plans of the
    rank's interior: several blocks along i and j with whole k rows, and k
    tiles of 5 with 8 rows (the level's plan for a rank without interior
    points)."""
    m = n - 2
    if not rows:
        return [tps._df_plan(n, H100_SMS, m, m)]
    plans = [tps._df_plan(n, H100_SMS, rows, cols)]
    for bi, bj, bk in ((2, 3, m), (3, 8, 5)):
        plans.append(tps._df_make(n, min(bi, rows), min(bj, cols), min(bk, m), rows, cols))
    return plans


def _norm_close(got, want):
    return abs(float(got) - float(want)) <= NORM_RTOL * abs(float(want))


def _check_writes(w):
    assert torch.equal(w, torch.ones_like(w)), "a point written other than once"


class Rank:
    """One i-sharded rank's triples (1 plane of halo on each side, the
    right buffers composite) of random global double-float fields (D L
    planes, every plane random); its h."""

    def __init__(self, n, L, rank, seed):
        rng = np.random.default_rng(seed)
        self.n, self.L, self.rank = n, L, rank
        self.g0, self.gi0, self.h = rank * L, rank * L - 1, 1.0 / (n - 1)
        self.fields = _df_fields(rng, (D * L, n, n))
        self.parts = [rk.rank_parts(x, rank, L, 1, 1, tail=2) for x in self.fields]

    def extents(self):
        return tpx.seg_df_extents(self.n, self.g0, self.L)

    def plain(self):
        return tpx.residual_df_norm_halo_plain(*self.parts, self.gi0, self.h, self.n, self.L)

    def emulate(self, plan, fault=None):
        uh, ul = (em.nan_padded(tpx._seg(x, 1, 1, self.L).rows(1, 1), PAD) for x in self.parts[:2])
        seg = em.df_seg(self.n, self.g0, self.L, 1 + PAD, PAD)
        return em.emulate_df(plan, uh, ul, self.parts[2][0], self.parts[3][0], self.h, seg, fault)


class Block:
    """One (i, j) block's five parts (1 row and column of halo on each
    side) of random global double-float fields; its h."""

    def __init__(self, n, mesh, li, lj, ix, iy, seed):
        rng = np.random.default_rng(seed)
        (nx, ny) = mesh
        self.n, self.li, self.lj = n, li, lj
        self.g0, self.gj0 = ix * li, iy * lj
        self.gij0 = (self.g0 - 1, self.gj0 - 1)
        self.h = 1.0 / (n - 1)
        self.fields = _df_fields(rng, (nx * li, ny * lj, n))
        self.parts = [rk.rank_parts2d(x, ix, iy, li, lj, 1, 1, tail=1) for x in self.fields]

    def extents(self):
        return tpx.seg_df_extents(self.n, self.g0, self.li, self.gj0, self.lj)

    def plain(self):
        return tpx2.residual_df_norm_halo2d_plain(*self.parts, self.gij0, self.h, self.n,
                                                  self.li, self.lj)

    def emulate(self, plan, fault=None):
        slabs = []
        for x in self.parts[:2]:
            s = tpx2._seg2(x, self.li, self.lj, 1, 1, 1, 1).slab(1, 1, 1, 1).clone()
            if fault == "j_halo_from_body":  # row j = -1 (Lj) read at body + t pitch - n (+ Lj n)
                flat = x[0].reshape(-1, self.n)
                for t in range(self.li):
                    for col, row in ((0, t * self.lj - 1), (self.lj + 1, (t + 1) * self.lj)):
                        s[1 + t, col] = flat[row] if 0 <= row < flat.shape[0] else em.NAN
            slabs.append(em.nan_padded(s, PAD))
        seg = em.df_seg(self.n, self.g0, self.li, 1 + PAD, 1 + PAD, self.gj0, self.lj)
        return em.emulate_df(plan, *slabs, self.parts[2][0], self.parts[3][0], self.h, seg,
                             None if fault == "j_halo_from_body" else fault)


@pytest.mark.parametrize("geometry", list(GEOMETRIES))
def test_emulated_k32_stage_matches_plain(geometry):
    """K32 on each i-sharded geometry, at 17^3 and 33^3, on the planner's
    plan and on hand plans: r bit for bit against the plain version, every
    point of the block written once (the boundary and pad planes 0), the
    norm within rel 1e-6."""
    n, L, rank = GEOMETRIES[geometry]
    r = Rank(n, L, rank, seed=20 * n + rank)
    want, want_n2 = r.plain()
    assert torch.isfinite(want).all()
    for plan in _plans(n, *r.extents()):
        got, w, n2 = r.emulate(plan)
        _check_writes(w)
        assert torch.equal(got, want), plan
        assert _norm_close(n2, want_n2), (plan, float(n2), float(want_n2))


@pytest.mark.parametrize("geometry", list(GEOMETRIES2D))
def test_emulated_k41_stage_matches_plain(geometry):
    """K41 on each (i, j) block, at 17^3 and 33^3, on the planner's plan
    and on hand plans: r bit for bit against the plain version, every point
    written once (the pad rows and columns 0), the norm within rel 1e-6."""
    n, mesh, li, lj, blocks = GEOMETRIES2D[geometry]
    for ix, iy in blocks:
        b = Block(n, mesh, li, lj, ix, iy, seed=20 * n + 3 * ix + iy)
        want, want_n2 = b.plain()
        assert torch.isfinite(want).all()
        for plan in _plans(n, *b.extents()):
            got, w, n2 = b.emulate(plan)
            _check_writes(w)
            assert torch.equal(got, want), (plan, ix, iy)
            assert _norm_close(n2, want_n2), (plan, ix, iy)


def test_emulated_stages_stitch_to_k5():
    """The four i-sharded ranks' emulated r at 17^3, L = 6 (rank 3 pad
    only), and the four 2x2 blocks' (Li = Lj = 10), stitched: bit for bit
    K5's plain version on the whole field, every point past it 0; the
    ranks' norms summed within rel 1e-6 of K5's."""
    n = 17
    ranks = [Rank(n, 6, r, seed=7) for r in range(D)]  # one seed: one global field
    outs = [r.emulate(_plans(n, *r.extents())[0]) for r in ranks]
    got = torch.cat([o[0] for o in outs])
    want, want_n2 = tpk.residual_df_norm_plain(*(x[:n] for x in ranks[0].fields), ranks[0].h)
    assert torch.equal(got[:n], want) and not got[n:].any()
    assert _norm_close(sum(float(o[2]) for o in outs), want_n2)
    blocks = {(ix, iy): Block(n, (2, 2), 10, 10, ix, iy, seed=8)
              for ix in range(2) for iy in range(2)}
    outs = {k: b.emulate(_plans(n, *b.extents())[0]) for k, b in blocks.items()}
    got = torch.cat([torch.cat([outs[ix, iy][0] for iy in range(2)], dim=1) for ix in range(2)])
    want, want_n2 = tpk.residual_df_norm_plain(
        *(x[:n, :n].contiguous() for x in blocks[0, 0].fields), blocks[0, 0].h)
    assert torch.equal(got[:n, :n], want)
    assert not got[n:].any() and not got[:, n:].any()
    assert _norm_close(sum(float(o[2]) for o in outs.values()), want_n2)


@pytest.mark.parametrize("fault", ["ring_early", "j_halo_from_body", "k_wrap", "pad_unwritten"])
def test_emulation_finds_a_faulty_df_stage(fault):
    """The emulation is a check. Without the fault K41 on the (1, 1) block
    of a 2x2 mesh at 17^3 (its left halos from the other ranks) and K32 on
    an interior rank of 65^3 (L = 4: rows of 63 points, two chunks a lane)
    and on the pad-tail rank of 33^3 equal their plain versions; with it: a
    ring slot reused one plane early (K32 at 65^3, K41), the j halo rows of
    K41's body planes read from its body buffer, the k neighbours at a
    chunk's edges from the wrong lane (K32 at 65^3) or the planes past the
    interior left unwritten (the pad-tail rank) each leave r wrong."""
    good = Block(17, (2, 2), 10, 10, 1, 1, seed=11)
    plan = tps._df_make(17, 3, 6, 15, *good.extents())
    want = good.plain()[0]
    assert torch.equal(good.emulate(plan)[0], want)
    wide = Rank(65, 4, 2, seed=12)
    plan1 = tps._df_make(65, 4, 4, 63, *wide.extents())
    assert plan1.chunks == 2
    want1 = wide.plain()[0]
    assert torch.equal(wide.emulate(plan1)[0], want1)
    if fault == "ring_early":
        assert not torch.equal(wide.emulate(plan1, fault)[0], want1)
        assert not torch.equal(good.emulate(plan, fault)[0], want)
    elif fault == "j_halo_from_body":
        assert not torch.equal(good.emulate(plan, fault)[0], want)
    elif fault == "k_wrap":
        assert not torch.equal(wide.emulate(plan1, fault)[0], want1)
    else:
        tail = Rank(33, 12, 2, seed=13)
        plan2 = _plans(33, *tail.extents())[0]
        assert torch.equal(tail.emulate(plan2)[0], tail.plain()[0])
        got, w, _ = tail.emulate(plan2, fault)
        assert torch.isnan(got).any() and not torch.equal(w, torch.ones_like(w))


# ------------------------------------------------------------- the plans


def test_seg_df_extents_are_the_kernels():
    """The interior planes and columns the wrappers plan for are
    residual_df_norm_seg.cu's df_setup's (the emulation's DfSeg): the
    rank's rows (and columns) whose global index lies in [1, n - 2], the
    level's n - 2 columns on an i-sharded block, (0, 0) for a rank without
    interior points."""
    for (n, g0, L, gj0, Lj), want in [((257, 0, 320, None, None), (255, 255)),
                                      ((257, 96, 96, None, None), (96, 255)),
                                      ((257, 0, 96, None, None), (95, 255)),
                                      ((257, 192, 96, None, None), (64, 255)),
                                      ((257, 288, 96, None, None), (0, 0)),
                                      ((257, 0, 272, 0, 272), (255, 255)),
                                      ((257, 144, 144, 144, 144), (112, 112)),
                                      ((17, 0, 18, 18, 6), (0, 0)),
                                      ((17, 0, 18, 12, 6), (15, 4))]:
        assert tpx.seg_df_extents(n, g0, L, gj0, Lj) == want, (n, g0, L, gj0, Lj)
    for name, (n, L, rank) in GEOMETRIES.items():
        seg = em.df_seg(n, rank * L, L, 0, 0)
        assert tpx.seg_df_extents(n, rank * L, L) == (
            (seg.t1 - seg.t0, seg.j1 - seg.j0) if seg.t1 > seg.t0 else (0, 0)), name


@pytest.mark.parametrize("n", [9, 17, 33, 65, 129, 257, 513])
def test_df_plans_fit_the_kernel(n):
    """The planner's plans for the production segments and blocks of each
    level (one rank's L = 320 (n - 1) / 256, rank 1's of four ranks' 96 (n
    - 1) / 256, the 1x1 block's 272 (n - 1) / 256 and the 2x2 mesh's 144 (n
    - 1) / 256, each at least n / D or so): a box inside the interior, at
    most DF_MAX_PLANES planes and DF_MAX_ROWS rows, the chunks that cover
    a k tile, the shared
    memory of the formula within a block's, at least one block an SM where
    the interior has 132, and partials one a block."""
    m = n - 2
    for g0, L, gj0, Lj in ((0, max(320 * (n - 1) // 256, n + 1), None, None),
                           (96 * (n - 1) // 256 + 2, 96 * (n - 1) // 256 + 2, None, None),
                           (0, 272 * (n - 1) // 256 + 2, 0, 272 * (n - 1) // 256 + 2),
                           (0, 144 * (n - 1) // 256 + 2, 0, 144 * (n - 1) // 256 + 2)):
        rows, cols = tpx.seg_df_extents(n, g0, L, gj0, Lj)
        plan = tps._df_plan(n, H100_SMS, rows, cols)
        assert 1 <= plan.bi <= min(rows, tps.DF_MAX_PLANES)
        assert 1 <= plan.bj <= min(cols, tps.DF_MAX_ROWS)
        assert 1 <= plan.bk <= m and 32 * plan.chunks >= plan.bk
        assert plan.chunks in (1, 2, 4, 8) and (plan.chunks == 1 or 16 * plan.chunks < plan.bk)
        assert plan.threads == 32 * plan.bj and plan.smem == tps._df_smem(plan.bj, plan.bk)
        assert plan.smem <= tps.SMEM_MAX
        if rows * cols >= H100_SMS:
            assert plan.blocks >= H100_SMS, plan
        assert plan.tiles[0] * plan.bi >= rows and plan.tiles[1] * plan.bj >= cols


# ------------------------------------------------- the wrappers on the CPU


def test_k32_k41_wrappers_on_the_cpu_are_the_plain_versions():
    """On the CPU the wrappers are the plain versions: fresh r and norm,
    zero off the global interior, the inputs as they were, no launch
    counted; the ext forms give the same."""
    r = Rank(33, 12, 2, seed=3)
    before = [t.clone() for p in r.parts for t in p]
    tpx.reset_launches()
    tpx2.reset_launches()
    got, n2 = tpx.residual_df_norm_halo(*r.parts, r.gi0, r.h, 33, 12)
    assert all(torch.equal(a, b) for a, b in zip((t for p in r.parts for t in p), before))
    want, want_n2 = r.plain()
    assert torch.equal(got, want) and torch.equal(n2, want_n2) and not got[9:].any()
    ext = tpx.residual_df_norm_ext(*(rk.rank_ext(x, 2, 12, 1) for x in r.fields), r.gi0, r.h,
                                   33, 12)
    assert torch.equal(ext[0], got) and torch.equal(ext[1], n2)
    b = Block(17, (1, 1), 20, 20, 0, 0, seed=4)
    got2, n22 = tpx2.residual_df_norm_halo2d(*b.parts, b.gij0, b.h, 17, 20, 20)
    want2, want2_n2 = b.plain()
    assert torch.equal(got2, want2) and torch.equal(n22, want2_n2)
    assert not got2[16:].any() and not got2[:, 16:].any() and not got2[..., [0, 16]].any()
    assert not any(tpx.LAUNCHES.values()) and not any(tpx2.LAUNCHES.values())
