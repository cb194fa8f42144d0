"""The streaming restriction stage of K3 (``residual_restrict_fused``,
multigrid_parallel_tpu_torch.ops.pallas3d), K9
(``residual_restrict_split``, ops.pallas_split), K18
(``residual_restrict_fold``, ops.pallas_mixed_fold, on the electrospray's
(n, n, n - 2) fold layout) and K23 (``residual_restrict_msplit``,
ops.pallas_mixed_split, the electrospray's split pair into the coarse
fold) on the CPU: its plan, an emulation of the CUDA kernel's schedule
held against the plain versions bit for bit, and the wrappers' CPU
contract.

The CUDA kernel (ops/csrc/restrict.cuh, ``restrict_body``) cannot run
here, so its schedule is emulated in torch (tests/torch_stage_emulation.py,
emulate_restrict, which K30's and K39's segment tests share), block by
block, as the kernel runs it: the plan's boxes of interior coarse points (``_restrict_plan``,
and hand plans with several blocks along each axis, k tiles among them);
each block's tile planes filled with NaN outside the footprint it loads
(e with one row and one k, or the 16-byte slot windows, of halo; r
without), one NaN column past each side of a tile row; each plane in the
kernel's slot of a ring of three e planes and two r planes (a plane read
from a slot that another has taken raises); the e of the
plane before at each point held from the step before; each fine residual
computed once, in the plain version's neighbour order; K9's k taps within
the fine row; the i taps as a running partial closed by plane 2 ci + 1;
the j (and K3's k) taps from the closed plane; the coarse boundary zeroed
by the blocks at the field's edge; and each coarse point written by one
block. K18's tile is K3's, loaded from fold rows: its window stops at the
stored slots, so the k-face columns stay NaN and its k - 1 neighbour at
k = 1 and k + 1 one at k = n - 2 are selects of the point's own value.
K23's tile and plan are K9's, its odd-k residuals summed k - 1 before
k + 1 with the same k-edge selects (the guard and e's dead slots, NaN
here, never read), its coarse fold rows K18's. A halo too shallow, or a
k-edge select left out, reads NaN, so the emulation must equal the plain
versions bit for bit. The card tests hold the kernels themselves against
the plain versions (tests/test_torch_cuda.py).
"""

import numpy as np
import pytest
import torch

import torch_stage_emulation as em
from multigrid_parallel_tpu_torch.ops import pallas3d as tpk
from multigrid_parallel_tpu_torch.ops import pallas_mixed_fold as tpmf
from multigrid_parallel_tpu_torch.ops import pallas_mixed_split as tpms
from multigrid_parallel_tpu_torch.ops import pallas_split as tps

torch.set_num_threads(1)

PLAN_SIZES = [5, 9, 17, 33, 65, 129, 257, 513, 1025]
H100_SMS = 132
NAN = float("nan")


LAYOUTS = ["k3", "k9", "k18", "k23"]


def _spans(extent, size):
    return [(a, min(a + size, extent)) for a in range(0, extent, size)]


def _flags(layout):
    """(split, fold) of a layout's plan (K23's is K9's)."""
    return layout in ("k9", "k23"), layout == "k18"


def _emulate(plan, layout, e, r, h, **kw):
    return em.emulate_restrict(plan, e, r, h, msplit=layout == "k23", **kw)


@pytest.mark.parametrize("split", [False, True], ids=["k3", "k9"])
@pytest.mark.parametrize("n", PLAN_SIZES)
def test_restrict_plan_covers_the_interior_once(n, split):
    """The boxes tile each axis of the m = nc - 2 interior coarse points
    exactly; at most RESTRICT_MAX_ROWS coarse rows, a warp a fine row of
    the cone; chunks of 128 points (32 lanes x 4), 1 or RESTRICT_MAX_CHUNKS,
    cover a row's residual points; the shared memory the launchers' formula
    gives,
    within a Hopper block's 232,448 B; on a split level whose rows hold a
    multiple of 4 slots, k tiles of a multiple of 4 (the 16-byte
    windows)."""
    plan = tps._restrict_plan(n, H100_SMS, split)
    m = (n + 1) // 2 - 2
    s = (n - 1) // 2
    assert plan.split == split and 1 <= plan.bcj <= min(m, tps.RESTRICT_MAX_ROWS)
    assert plan.threads == 32 * (2 * plan.bcj + 1) <= 544
    points = plan.bck + 1 if split else 2 * plan.bck + 1
    assert plan.chunks in (1, 2) and 128 * plan.chunks >= points
    assert plan.chunks == 1 or points > 128  # the fewest that cover
    assert plan.smem == tps._restrict_smem(plan.bcj, plan.bck, split) <= tps.SMEM_MAX
    assert plan.args == (plan.bci, plan.bcj, plan.bck, plan.chunks, plan.threads, plan.smem)
    if split and s % 4 == 0 and plan.bck < m:
        assert plan.bck % 4 == 0
    for size, count in zip((plan.bci, plan.bcj, plan.bck), plan.tiles):
        spans = _spans(m, size)
        assert len(spans) == count and spans[-1][1] == m
        assert -(-m // count) == size  # evened: no tile count with smaller tiles
    assert plan.blocks == np.prod(plan.tiles)


# the production segments: (n, L, Lj, ranks) of the one-rank i-sharded plan (L = 320 at
# 257^3), the four-rank one (L = 96 at 257^3), the 1x1 (i, j) plan (272^2) and the 2x2
# one (144^2), halved at each level below; Lj None on an i-sharded block
SEG_BLOCKS = ([(257 >> d | 1, 320 >> d, None, 1) for d in range(6)]
              + [(257 >> d | 1, 96 >> d, None, 4) for d in range(5)]
              + [(257 >> d | 1, 272 >> d, 272 >> d, 1) for d in range(4)]
              + [(257 >> d | 1, 144 >> d, 144 >> d, 2) for d in range(4)])


@pytest.mark.parametrize("n,L,Lj,ranks", SEG_BLOCKS)
def test_seg_restrict_plan_tiles_a_ranks_interior(n, L, Lj, ranks):
    """K30's and K39's plans (``seg_rows``, ``seg_cols``) on the production
    segments and blocks, every rank: the boxes tile the rank's interior
    coarse rows (and columns) exactly and evenly, at most RESTRICT_MAX_ROWS
    coarse rows, K3's tile rows and k tiling (the level's interior k), the
    shared memory the launchers' formula gives; at 257^3 at least one block
    an SM where the rank has that many boxes of one row and plane; a plan
    of a plain level's rows only (segments are K3's layout)."""
    from multigrid_parallel_tpu_torch.ops import pallas_sharded as tpx

    m = (n + 1) // 2 - 2
    whole = tps._restrict_plan(n, H100_SMS)
    for ri in range(ranks):
        for rj in range(ranks if Lj else 1):
            rows, cols = (tpx.seg_restrict_extents(n, ri * L, L, rj * Lj, Lj) if Lj
                          else tpx.seg_restrict_extents(n, ri * L, L))
            plan = tps._restrict_plan(n, H100_SMS, seg_rows=rows, seg_cols=cols)
            assert (plan.rows, plan.cols) == (rows, cols) and not plan.split and not plan.fold
            assert plan.bck == whole.bck and plan.chunks == whole.chunks
            assert 1 <= plan.bcj <= min(cols or m, tps.RESTRICT_MAX_ROWS)
            assert plan.threads == 32 * (2 * plan.bcj + 1)
            assert plan.smem == tps._restrict_smem(plan.bcj, plan.bck, False) <= tps.SMEM_MAX
            for size, count, extent in zip((plan.bci, plan.bcj, plan.bck), plan.tiles,
                                           (rows, cols or m, m)):
                spans = _spans(extent, size)
                assert len(spans) == count and spans[-1][1] == extent
                assert -(-extent // count) == size
            if n == 257 and rows * (cols or m) * plan.tiles[2] >= H100_SMS:
                assert plan.blocks >= H100_SMS
    with pytest.raises(ValueError, match="seg_rows"):
        tps._restrict_plan(33, H100_SMS, split=True, seg_rows=4)
    with pytest.raises(ValueError, match="seg_cols"):
        tps._restrict_plan(33, H100_SMS, seg_cols=4)


@pytest.mark.parametrize("n", PLAN_SIZES)
def test_fold_restrict_plan_is_k3s(n):
    """K18's fold levels take K3's plan: the same interior coarse counts
    on every axis and the same tile rows (n - 2 stored k hold the same
    cone), so the same boxes, threads and shared memory; a level split and
    fold at once is refused."""
    plan = tps._restrict_plan(n, H100_SMS, fold=True)
    assert plan.fold and not plan.split
    assert plan == tps._restrict_plan(n, H100_SMS)._replace(fold=True)
    assert plan.args == tps._restrict_plan(n, H100_SMS).args
    with pytest.raises(ValueError, match="split or fold"):
        tps._restrict_plan(n, H100_SMS, split=True, fold=True)


def test_fold_restrict_crossover_is_a_level_size():
    """The level size from which K18 takes the stage is an odd size of
    the hierarchy (2^m + 1) that the stage plans for."""
    n = tps.FOLD_RESTRICT_STAGE_MIN_N
    assert n >= 5 and ((n - 1) & (n - 2)) == 0
    assert tps._restrict_plan(n, H100_SMS, fold=True).blocks >= 1


def test_msplit_restrict_crossover_is_a_level_size():
    """The level size from which K23 takes the stage (on K9's plan) is an
    odd size of the hierarchy (2^m + 1) that the stage plans for, the
    msplit tier's finest level at 257^3 among them."""
    n = tps.MSPLIT_RESTRICT_STAGE_MIN_N
    assert 5 <= n <= 257 and ((n - 1) & (n - 2)) == 0
    assert tps._restrict_plan(n, H100_SMS, split=True).blocks >= H100_SMS


def test_restrict_plan_at_257_fills_the_card():
    """The main path's plans (K3 on the fused path's finest level, K9 on
    the split one's): at least one block an SM of the H100's 132; 129^3
    and 513^3 plan as well; levels without interior coarse points, or even
    ones, are refused."""
    for split in (False, True):
        plan = tps._restrict_plan(257, H100_SMS, split)
        assert plan.blocks >= H100_SMS
        assert tps._restrict_plan(129, H100_SMS, split).blocks >= 1
    for n in (3, 4, 16):
        with pytest.raises(ValueError, match="odd n >= 5"):
            tps._restrict_plan(n, H100_SMS)


# ------------------------------------------------------------ the emulation


def _fields(seed, n, layout):
    """(e, r) random at every point, faces included (K18: every stored
    point of the fold); for K9 split pairs random at every slot but r's
    dead slots, which hold NaN (no residual reads them); for K23 e's dead
    slots NaN too (its k-edge selects read none)."""
    rng = np.random.default_rng(seed)
    if layout not in ("k9", "k23"):
        shape = (n, n, n - 2) if layout == "k18" else (n, n, n)
        e, r = (torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
                for _ in range(2))
        return (e,), (r,)
    shape = tps.split_shape(n)
    e, r = ([torch.from_numpy(rng.standard_normal(shape).astype(np.float32)) for _ in range(2)]
            for _ in range(2))
    _, live_r, live_b = tps._masks(n, torch.device("cpu"))
    idx = torch.arange(n)
    inner = ((idx >= 1) & (idx <= n - 2))
    rows = inner[:, None, None] & inner[None, :, None]
    for x, live in zip(r, (live_r, live_b)):
        x[rows.expand(shape) & ~live] = NAN  # the dead slot of every interior row
    if layout == "k23":
        for x, k in zip(e, tps._slot_k(n, torch.device("cpu"))):
            x[k.expand(shape) > n - 2] = NAN  # every row's dead slot
    return tuple(e), tuple(r)


def _plain(layout, e, r, h):
    if layout == "k9":
        return tps.residual_restrict_split_plain(*e, *r, h)
    if layout == "k23":
        return tpms.residual_restrict_msplit_plain(*e, *r, h)
    if layout == "k18":
        return tpmf.residual_restrict_fold_plain(*e, *r, h)
    return tpk.residual_restrict_plain(*e, *r, h)


def _hand_plans(n, layout):
    """Several blocks along i and j, whole k rows, and
    k tiles: of 2
    coarse k (on a split level with 16-byte rows, the 4-byte copies'
    exact windows) and of 3 (a split level's 16-byte windows: 4 slots)."""
    split, fold = _flags(layout)
    m = (n + 1) // 2 - 2
    plans = []
    for bci, bcj, bck in ((2, 3, m), (3, 2, 2), (5, 8, 4 if split else 3)):
        bci, bcj, bck = min(bci, m), min(bcj, m, tps.RESTRICT_MAX_ROWS), min(bck, m)
        plans.append(tps.RestrictPlan(n, split, bci, bcj, bck, tps._restrict_chunks(bck, split),
                                      32 * (2 * bcj + 1), tps._restrict_smem(bcj, bck, split),
                                      fold))
    return plans


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("n", [9, 17, 33])
def test_emulated_stage_matches_plain_bitwise(n, layout):
    """The planner's plan and hand plans (several blocks in i, j and k):
    the emulated schedule equals the plain version bit for bit, every
    coarse point written by one block (K18's with NaN in the k-face tile
    columns, which its window never loads; K23's with NaN in e's dead
    slots)."""
    h = 1.0 / (n - 1)
    e, r = _fields(40 + n, n, layout)
    want = _plain(layout, e, r, h)
    assert torch.isfinite(want).all()
    plans = [tps._restrict_plan(n, H100_SMS, *_flags(layout))] + _hand_plans(n, layout)
    assert any(p.tiles[2] > 1 for p in plans) and any(min(p.tiles[:2]) > 1 for p in plans)
    for plan in plans:
        got, writes = _emulate(plan, layout, e, r, h)
        assert bool((writes == 1).all()), plan
        assert torch.equal(got, want), plan


def test_emulated_k9_on_rows_of_an_odd_slot_count():
    """K9 where a row holds 17 slots (n = 35): 4-byte copies, exact
    windows, whole rows and k tiles not a multiple of 4."""
    n = 35
    h = 1.0 / (n - 1)
    e, r = _fields(75, n, "k9")
    want = _plain("k9", e, r, h)
    for bci, bcj, bck in ((4, 5, 16), (6, 3, 7)):
        plan = tps.RestrictPlan(n, True, bci, bcj, bck, tps._restrict_chunks(bck, True),
                                32 * (2 * bcj + 1), tps._restrict_smem(bcj, bck, True))
        got, writes = em.emulate_restrict(plan, e, r, h)
        assert bool((writes == 1).all()) and torch.equal(got, want), plan


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("fault", ["e_halo_one_row_short", "last_plane_left_out"])
def test_emulated_stage_fails_with_a_fault(layout, fault):
    """The emulation is a real check: e loaded one halo row short (its
    first row's residuals read NaN), or the last fine plane of a box left
    out of its last coarse plane's i taps, each gives another result."""
    n = 17
    h = 1.0 / (n - 1)
    e, r = _fields(60, n, layout)
    plan = _hand_plans(n, layout)[0]
    kw = {"e_halo_rows": 0} if fault == "e_halo_one_row_short" else {"close_last": False}
    got, _ = _emulate(plan, layout, e, r, h, **kw)
    assert not torch.equal(got, _plain(layout, e, r, h))


@pytest.mark.parametrize("n", [9, 17, 33])
def test_emulated_k18_fails_without_its_k_edge_selects(n):
    """K18 with its k-edge neighbours read from the tile instead of
    selected: the k-face columns were never loaded (NaN), so the coarse
    points of the first and last coarse k differ from the plain version,
    on the planner's plan and on k tiles."""
    h = 1.0 / (n - 1)
    e, r = _fields(65 + n, n, "k18")
    want = _plain("k18", e, r, h)
    for plan in (tps._restrict_plan(n, H100_SMS, fold=True), _hand_plans(n, "k18")[1]):
        got, _ = em.emulate_restrict(plan, e, r, h, k_edge_select=False)
        bad = ~(got == want)
        assert bool(bad[1:-1, 1:-1, 0].all() and bad[1:-1, 1:-1, -1].all()), plan
        assert not bool(bad[1:-1, 1:-1, 1:-1].any()), plan


@pytest.mark.parametrize("n", [9, 17])
def test_emulated_k23_fails_without_its_k_edge_selects(n):
    """K23 with its odd-k residuals' k-edge neighbours read as K9 reads
    them, the guard's 0 at k = 1 and the dead slot (NaN here) at
    k = n - 2, in place of the point's own value: the coarse points of
    the first and last coarse k differ from the plain version, and only
    they, on the planner's plan and on k tiles."""
    h = 3e-4 / (n - 1)
    e, r = _fields(80 + n, n, "k23")
    want = _plain("k23", e, r, h)
    for plan in (tps._restrict_plan(n, H100_SMS, split=True), _hand_plans(n, "k23")[1]):
        got, _ = _emulate(plan, "k23", e, r, h, k_edge_select=False)
        bad = ~(got == want)
        assert bool(bad[1:-1, 1:-1, 0].all() and bad[1:-1, 1:-1, -1].all()), plan
        assert not bool(bad[1:-1, 1:-1, 1:-1].any()), plan


@pytest.mark.parametrize("fault", ["k9_row", "k9_order"])
def test_emulated_k23_fails_with_k9s_row_or_order(fault):
    """K23 with K9's coarse rows (coarse k at ck of rows of nc, not at
    slot ck - 1 of rows of nc - 2) or K9's order of the odd-k residuals'
    k terms (k + 1 before k - 1) gives another result; the same plans
    without the fault equal the plain version."""
    n = 17
    h = 3e-4 / (n - 1)
    e, r = _fields(90, n, "k23")
    want = _plain("k23", e, r, h)
    for plan in (tps._restrict_plan(n, H100_SMS, split=True), _hand_plans(n, "k23")[2]):
        assert torch.equal(_emulate(plan, "k23", e, r, h)[0], want)
        assert not torch.equal(_emulate(plan, "k23", e, r, h, fault=fault)[0], want), plan


def test_cpu_wrappers_return_the_plain_result_and_leave_inputs():
    """On the CPU the wrappers are the plain versions: a fresh (nc, nc, nc)
    field (K18, K23: the (nc, nc, nc - 2) fold), the inputs untouched, no
    launch counted."""
    n = 9
    nc = (n + 1) // 2
    h = 1.0 / (n - 1)
    tpk.reset_launches()
    tps.reset_launches()
    tpmf.reset_launches()
    tpms.reset_launches()
    wrappers = {"k3": tpk.residual_restrict_fused, "k9": tps.residual_restrict_split,
                "k18": tpmf.residual_restrict_fold, "k23": tpms.residual_restrict_msplit}
    for layout, fn in wrappers.items():
        e, r = _fields(70, n, layout)
        before = [x.clone() for x in (*e, *r)]
        got = fn(*e, *r, h)
        assert got.shape == ((nc, nc, nc - 2) if layout in ("k18", "k23") else (nc,) * 3)
        assert torch.equal(got, _plain(layout, e, r, h))
        assert all(torch.equal(x.isnan(), b.isnan()) and torch.equal(x.nan_to_num(), b.nan_to_num())
                   for x, b in zip((*e, *r), before))  # r's dead slots hold NaN
    assert tpk.LAUNCHES["residual_restrict_fused"] == 0
    assert tps.LAUNCHES["residual_restrict_split"] == 0
    assert tpmf.LAUNCHES["residual_restrict_fold"] == 0
    assert tpms.LAUNCHES["residual_restrict_msplit"] == 0
