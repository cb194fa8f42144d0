"""The streaming residual stage on one rank's segmented block (K33
``residual_ext`` of multigrid_parallel_tpu_torch.ops.pallas_sharded on an
i-sharded field) on the CPU: an emulation of the CUDA kernel's schedule
held against the plain version, the planner's plans, and the wrapper's CPU
contract.

The CUDA stage (ops/csrc/residual.cu, resid_stage_kernel) cannot run
here, so it is emulated in torch (tests/torch_stage_emulation.py,
emulate_resid) as the kernel runs it: K32's stream (emulate_df) with one
field, u, in the ring and no norm. The blocks tile the rank's interior
planes, rows and k; each streams its planes of u through the kernel's ring
of tile planes, copied from the rank's ext slab at local indices, NaN past
what it holds, so that a read outside it shows; f is read at the owned
points; the zeros of the planes outside the interior and of the rows and
k ends around each box come from the same launch. The fields are random at
every point, the pad planes too.

The geometries are those of the one-pass segment stages
(tests/test_torch_seg_rect_stage.py): on four i-sharded ranks, rank 0, an
interior rank, plane n - 1 at a rank's row 0, a pad tail and a pad-only
rank. Each emulated r equals the plain version (``residual_ext_plain``)
bit for bit at 17^3 and 33^3, on the planner's plan for the H100 and on
hand plans, every point written once; the stitched r equals R's plain
version on the whole field. Two faults must not: a ring slot reused one
plane early, and the pad planes left unwritten. K32's and K41's plans are
the ones they were before the planner took a stage. The card tests
hold the kernel itself against the plain version (tests/test_torch_cuda.py).
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

import torch_sharded_ranks as rk
import torch_stage_emulation as em
from multigrid_parallel_tpu_torch.ops import pallas3d as tpk
from multigrid_parallel_tpu_torch.ops import pallas_sharded as tpx
from multigrid_parallel_tpu_torch.ops import pallas_split as tps
from test_torch_seg_rect_stage import GEOMETRIES

torch.set_num_threads(1)

H100_SMS = 132
D = 4    # i-sharded ranks
PAD = 2  # NaN planes and rows around an emulated slab
CSRC = Path(tps.__file__).resolve().parent / "csrc"


def _plans(n, rows):
    """The planner's plan for the H100's 132 SMs and two hand plans of the
    rank's interior: several blocks along i and j with whole k rows, and k
    tiles of 5 with 8 rows (the level's plan for a rank without interior
    points)."""
    m = n - 2
    if not rows:
        return [tps._df_plan(n, H100_SMS, m, m, stage="resid")]
    plans = [tps._df_plan(n, H100_SMS, rows, m, stage="resid")]
    for bi, bj, bk in ((2, 3, m), (3, 8, 5)):
        plans.append(tps._df_make(n, min(bi, rows), bj, min(bk, m), rows, m, stage="resid"))
    return plans


class Rank:
    """One i-sharded rank's ext tensors (1 plane of halo on each side) of
    random global fields u and f (D L planes, every plane random); its h."""

    def __init__(self, n, L, rank, seed):
        rng = np.random.default_rng(seed)
        self.n, self.L, self.rank = n, L, rank
        self.g0, self.gi0, self.h = rank * L, rank * L - 1, 1.0 / (n - 1)
        self.fields = [torch.from_numpy(rng.standard_normal((D * L, n, n)).astype(np.float32))
                       for _ in range(2)]
        self.u_ext, self.f_ext = (rk.rank_ext(x, rank, L, 1) for x in self.fields)

    def rows(self):
        return tpx.seg_df_extents(self.n, self.g0, self.L)[0]

    def plain(self):
        return tpx.residual_ext_plain(self.u_ext, self.f_ext, self.gi0, self.h, self.n, self.L)

    def emulate(self, plan, fault=None):
        seg = em.df_seg(self.n, self.g0, self.L, 1 + PAD, PAD)
        return em.emulate_resid(plan, em.nan_padded(self.u_ext, PAD), self.f_ext[1:-1], self.h,
                                seg, fault)


def _check_writes(w):
    assert torch.equal(w, torch.ones_like(w)), "a point written other than once"


@pytest.mark.parametrize("geometry", list(GEOMETRIES))
def test_emulated_k33_stage_matches_plain(geometry):
    """K33 on each i-sharded geometry, at 17^3 and 33^3, on the planner's
    plan and on hand plans: r bit for bit against the plain version, every
    point of the block written once (the boundary and pad planes 0)."""
    n, L, rank = GEOMETRIES[geometry]
    r = Rank(n, L, rank, seed=30 * n + rank)
    want = r.plain()
    assert torch.isfinite(want).all()
    for plan in _plans(n, r.rows()):
        got, w = r.emulate(plan)
        _check_writes(w)
        assert torch.equal(got, want), plan


def test_emulated_k33_stitches_to_r():
    """The four i-sharded ranks' emulated r at 17^3, L = 6 (rank 3 pad
    only), stitched: bit for bit R's plain version on the whole field,
    every point past it 0."""
    n = 17
    ranks = [Rank(n, 6, r, seed=9) for r in range(D)]  # one seed: one global field
    got = torch.cat([r.emulate(_plans(n, r.rows())[0])[0] for r in ranks])
    u, f = (x[:n] for x in ranks[0].fields)
    assert torch.equal(got[:n], tpk.residual_plain(u, f, ranks[0].h)) and not got[n:].any()


@pytest.mark.parametrize("fault", ["ring_early", "pad_unwritten"])
def test_emulation_finds_a_faulty_resid_stage(fault):
    """The emulation is a check. Without the fault K33 on an interior rank
    of 65^3 (L = 4: rows of 63 points, two chunks a lane) and on the
    pad-tail rank of 33^3 equals its plain version; with it, a ring slot
    reused one plane early or the planes past the interior left unwritten
    leave r wrong."""
    if fault == "ring_early":
        wide = Rank(65, 4, 2, seed=12)
        plan = tps._df_make(65, 4, 4, 63, wide.rows(), 63, stage="resid")
        assert plan.chunks == 2
        want = wide.plain()
        assert torch.equal(wide.emulate(plan)[0], want)
        assert not torch.equal(wide.emulate(plan, fault)[0], want)
    else:
        tail = Rank(33, 12, 2, seed=13)
        plan = _plans(33, tail.rows())[0]
        assert torch.equal(tail.emulate(plan)[0], tail.plain())
        got, w = tail.emulate(plan, fault)
        assert torch.isnan(got).any() and not torch.equal(w, torch.ones_like(w))


# ------------------------------------------------------------- the plans

# _df_plan(n, 132, rows, cols) for K32's and K41's production blocks, as it
# planned them before it took a stage: (n, rows, cols) -> (n, bi, bj,
# bk, chunks, threads, smem, rows, cols)
DF_PLANS = {
    (9, 7, 7): (9, 1, 1, 4, 1, 32, 576, 7, 7), (9, 3, 7): (9, 1, 1, 4, 1, 32, 576, 3, 7),
    (9, 5, 5): (9, 1, 1, 4, 1, 32, 576, 5, 5), (17, 15, 15): (17, 1, 2, 8, 1, 64, 1152, 15, 15),
    (17, 8, 15): (17, 1, 1, 8, 1, 32, 864, 8, 15),
    (17, 10, 10): (17, 1, 1, 8, 1, 32, 864, 10, 10),
    (33, 31, 31): (33, 1, 8, 16, 1, 256, 4800, 31, 31),
    (33, 14, 31): (33, 1, 4, 16, 1, 128, 2880, 14, 31),
    (33, 19, 19): (33, 1, 2, 16, 1, 64, 1920, 19, 19),
    (65, 63, 63): (65, 2, 8, 63, 2, 256, 16320, 63, 63),
    (65, 26, 63): (65, 1, 7, 63, 2, 224, 14688, 26, 63),
    (65, 37, 37): (65, 1, 8, 32, 1, 256, 8640, 37, 37),
    (129, 127, 127): (129, 8, 8, 127, 4, 256, 31680, 127, 127),
    (129, 50, 127): (129, 5, 5, 127, 4, 160, 22176, 50, 127),
    (129, 73, 73): (129, 3, 6, 64, 2, 192, 13056, 73, 73),
    (257, 255, 255): (257, 32, 8, 255, 8, 256, 62400, 255, 255),
    (257, 98, 255): (257, 14, 7, 255, 8, 224, 56160, 98, 255),
    (257, 145, 145): (257, 13, 7, 255, 8, 224, 56160, 145, 145),
    (513, 511, 511): (513, 32, 8, 256, 8, 256, 62400, 511, 511),
    (513, 194, 511): (513, 25, 8, 256, 8, 256, 62400, 194, 511),
    (513, 289, 289): (513, 21, 8, 256, 8, 256, 62400, 289, 289),
}


def test_k32_k41_plans_are_unchanged():
    """K32's and K41's plans for the production segments and blocks at
    9^3-513^3 are those _df_plan gave before it took a stage."""
    for (n, rows, cols), want in DF_PLANS.items():
        plan = tps._df_plan(n, H100_SMS, rows, cols)
        assert tuple(plan) == want + ("df",) and plan.fields == 2, (n, rows, cols)


def _header_smem(bj, bk, fields):
    """seg_stream.cuh's smem_bytes, its constants read from the header."""
    text = (CSRC / "seg_stream.cuh").read_text()
    ring = int(re.search(r"constexpr int kRing = (\d+);", text).group(1))
    assert re.search(r"return 4LL \* fields \* kRing \* \(bj \+ 2\) \* tile_width\(bk\);", text)
    assert re.search(r"tile_width\(int bk\) \{ return round4\(bk \+ 2\); \}", text)
    return 4 * fields * ring * (bj + 2) * ((bk + 2 + 3) // 4 * 4)


@pytest.mark.parametrize("n", [9, 17, 33, 65, 129, 257, 513])
def test_resid_plans_fit_the_kernel(n):
    """The planner's one-field plans for K33's production blocks of each
    level (one rank's L = 320 (n - 1) / 256, rank 1's of four ranks' 96 (n
    - 1) / 256) and for a rank without interior points: a box inside the
    interior, at most DF_MAX_PLANES planes and DF_MAX_ROWS rows, the chunks
    that cover a k tile, the shared memory of the C++ formula (one ring,
    half of K32's for the same box, within the 48 KB a block takes without
    opting in), and at least one block an SM where the interior has 132
    rows."""
    m = n - 2
    for g0, L in ((0, max(320 * (n - 1) // 256, n + 1)),
                  (96 * (n - 1) // 256 + 2, 96 * (n - 1) // 256 + 2), (n + 1, 4)):
        rows = tpx.seg_df_extents(n, g0, L)[0]
        plan = tps._df_plan(n, H100_SMS, rows or m, m, stage="resid")
        assert plan.fields == 1
        assert 1 <= plan.bi <= min(rows or m, tps.DF_MAX_PLANES)
        assert 1 <= plan.bj <= tps.DF_MAX_ROWS and 1 <= plan.bk <= m
        assert plan.chunks in (1, 2, 4, 8) and 32 * plan.chunks >= plan.bk
        assert plan.chunks == 1 or 16 * plan.chunks < plan.bk
        assert plan.threads == 32 * plan.bj
        assert plan.smem == _header_smem(plan.bj, plan.bk, 1) == tps._df_smem(plan.bj, plan.bk, 1)
        assert 2 * plan.smem == tps._df_smem(plan.bj, plan.bk) <= tps.SMEM_MAX
        assert plan.smem <= 48 * 1024
        if (rows or m) * m >= H100_SMS:
            assert plan.blocks >= H100_SMS, plan
        assert plan.tiles[0] * plan.bi >= (rows or m) and plan.tiles[1] * plan.bj >= m
    assert _header_smem(8, 255, 2) == tps._df_smem(8, 255)


# ------------------------------------------------- the wrapper on the CPU


def test_k33_wrapper_on_the_cpu_is_the_plain_version():
    """On the CPU the wrapper is the plain version at every size: a fresh
    r, zero off the global interior, the inputs as they were, no launch
    counted."""
    tpx.reset_launches()
    for n, L, rank in ((33, 12, 2), (129, 8, 1)):
        r = Rank(n, L, rank, seed=3)
        before = (r.u_ext.clone(), r.f_ext.clone())
        got = tpx.residual_ext(r.u_ext, r.f_ext, r.gi0, r.h, n, L)
        assert torch.equal(r.u_ext, before[0]) and torch.equal(r.f_ext, before[1])
        want = r.plain()
        assert torch.equal(got, want) and got.data_ptr() != r.f_ext.data_ptr()
        g = torch.arange(L) + r.g0
        assert not got[(g < 1) | (g > n - 2)].any()
        assert not got[:, [0, n - 1]].any() and not got[..., [0, n - 1]].any()
    assert not any(tpx.LAUNCHES.values())
