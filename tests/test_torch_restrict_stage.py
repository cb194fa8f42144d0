"""The streaming restriction stage of K3 (``residual_restrict_fused``,
multigrid_parallel_tpu_torch.ops.pallas3d), K9
(``residual_restrict_split``, ops.pallas_split) and K18
(``residual_restrict_fold``, ops.pallas_mixed_fold, on the electrospray's
(n, n, n - 2) fold layout) on the CPU: its plan, an emulation of the
CUDA kernel's schedule held against the plain versions bit for bit, and
the wrappers' CPU contract.

The CUDA kernel (ops/csrc/restrict.cuh, ``restrict_body``) cannot run
here, so its schedule is emulated in torch, block by block, as the kernel
runs it: the plan's boxes of interior coarse points (``_restrict_plan``,
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
A halo too shallow, or a k-edge select left out, reads NaN, so the
emulation must equal the plain versions bit for bit. The card tests hold
the kernels themselves against the plain versions
(tests/test_torch_cuda.py).
"""

import numpy as np
import pytest
import torch

from multigrid_parallel_tpu_torch.ops import pallas3d as tpk
from multigrid_parallel_tpu_torch.ops import pallas_mixed_fold as tpmf
from multigrid_parallel_tpu_torch.ops import pallas_split as tps

torch.set_num_threads(1)

PLAN_SIZES = [5, 9, 17, 33, 65, 129, 257, 513, 1025]
H100_SMS = 132
NAN = float("nan")


LAYOUTS = ["k3", "k9", "k18"]


def _spans(extent, size):
    return [(a, min(a + size, extent)) for a in range(0, extent, size)]


def _flags(layout):
    """(split, fold) of a layout."""
    return layout == "k9", layout == "k18"


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


def _geometry(plan, ti, tj, tk):
    """restrict.cuh, geometry: the block's owned interior coarse box, its
    cone's fine rows and residual points a row, and the loaded windows
    (K18's in slots: fine k k at slot k - 1, clipped to the n - 2
    stored)."""
    n = plan.n
    nc, s = (n + 1) // 2, (n - 1) // 2
    m = nc - 2
    g = {"n": n, "nc": nc, "S": s}
    for ax, t, b in (("i", ti, plan.bci), ("j", tj, plan.bcj), ("k", tk, plan.bck)):
        g[f"c{ax}0"] = 1 + t * b
        g[f"c{ax}1"] = min(1 + t * b + b, nc - 1)
    ck0, ck1 = g["ck0"], g["ck1"]
    g["rows"] = 2 * (g["cj1"] - g["cj0"]) + 1
    if plan.fold:
        g.update(pts=2 * (ck1 - ck0) + 1, ka=max(2 * ck0 - 3, 0), kb=min(2 * ck1, n - 2),
                 ra=2 * ck0 - 2, rb=2 * ck1 - 1)
    elif not plan.split:
        g.update(pts=2 * (ck1 - ck0) + 1, ka=2 * ck0 - 2, kb=2 * ck1 + 1, ra=2 * ck0 - 1,
                 rb=2 * ck1)
    elif s % 4 == 0 and (plan.bck >= m or plan.bck % 4 == 0):  # 16-byte windows
        g.update(pts=ck1 - ck0 + 1, ka=max(ck0 - 5, 0), kb=min((ck1 + 4) & ~3, s), ra=ck0 - 1,
                 rb=min((ck1 + 3) & ~3, s))
    else:
        g.update(pts=ck1 - ck0 + 1, ka=max(ck0 - 2, 0), kb=min(ck1 + 1, s), ra=ck0 - 1, rb=ck1)
    return g


def _tap3(a, b, c):
    return 0.25 * a + 0.5 * b + 0.25 * c


def _emulate(plan, e, r, h, e_halo_rows=1, close_last=True, k_edge_select=True):
    """One launch of the restriction stage as the kernel runs it. ``e``
    and ``r`` are tuples of one field (K3, K18) or of the pair (red,
    black) (K9). ``e_halo_rows`` 0 loads e without its first halo row,
    ``close_last`` False leaves the last fine plane of each box out of the
    i taps of its last coarse plane, and ``k_edge_select`` False reads
    K18's k-edge neighbours from the tile (all must fail). Returns the
    coarse field and how many blocks wrote each point."""
    n, split = plan.n, plan.split
    nc = (n + 1) // 2
    inv_h2 = 1.0 / (h * h)
    we, wr, wa = tps._restrict_widths(plan.bck, split)
    re_, rr_ = 2 * plan.bcj + 3, 2 * plan.bcj + 1
    shape = (nc, nc, nc - 2) if plan.fold else (nc, nc, nc)
    out = torch.full(shape, NAN)
    writes = torch.zeros(shape, dtype=torch.int32)
    ni, nj, nk = plan.tiles
    for ti in range(ni):
        for tj in range(nj):
            for tk in range(nk):
                g = _geometry(plan, ti, tj, tk)
                _zero_boundary(out, writes, g, plan.fold)
                _emulate_block(plan, g, e, r, inv_h2, out, writes, (we, wr, wa), (re_, rr_),
                               e_halo_rows, close_last, k_edge_select)
    return out, writes


def _zero_boundary(out, writes, g, fold=False):
    """The block's coarse boundary points (K18: of the x and y faces only,
    over the box's own k, at slot ck - 1)."""
    nc = g["nc"]
    ext = []
    for ax in "ijk":
        a, b = g[f"c{ax}0"], g[f"c{ax}1"]
        if fold and ax == "k":
            ext.append(range(a, b))
        else:
            ext.append(range(0 if a == 1 else a, nc if b == nc - 1 else b))
    for ci in ext[0]:
        for cj in ext[1]:
            for ck in ext[2]:
                faces = (ci, cj) if fold else (ci, cj, ck)
                if min(faces) == 0 or max(faces) == nc - 1:
                    at = (ci, cj, ck - 1) if fold else (ci, cj, ck)
                    out[at] = 0.0
                    writes[at] += 1


def _emulate_block(plan, g, e, r, inv_h2, out, writes, widths, tile_rows, e_halo_rows,
                   close_last, k_edge_select):
    split, fold = plan.split, plan.fold
    we, wr, wa = widths
    re_, rr_ = tile_rows
    colours = len(e)
    cj0, cj1, ck0, ck1 = g["cj0"], g["cj1"], g["ck0"], g["ck1"]
    rows, pts = g["rows"], g["pts"]
    ka, kb, ra, rb = g["ka"], g["kb"], g["ra"], g["rb"]
    k0 = 2 * ck0 - 1 if not split else ck0 - 1
    # the windows fit the plan's tile rows: e from column RESTRICT_PAD +
    # ka - k0 (K18: slot ka holds fine k ka + 1), the last group's reads to
    # RESTRICT_PAD + pts rounded up to 4, plus one; r from column 0
    pad, shift = tps.RESTRICT_PAD, int(fold)
    assert pad + ka + shift - k0 >= 0 and pad + kb + shift - k0 <= we
    assert pad + -(-pts // 4) * 4 + 1 <= we
    assert rb - ra <= wr and x_cols(split, pts) <= wa
    pa, pe, p1 = 2 * g["ci0"] - 2, 2 * g["ci1"], 2 * g["ci1"] - 1
    # the tile planes, each (plane held, tile), in the kernel's ring slots,
    # (q - pa) modulo the ring's depth: a plane read from a slot that
    # another has taken raises
    e_slots, r_slots = [None] * 3, [None] * 2

    def load(slots, fields, q, j0, j1, jt, c0, c1, width, nrows, col=1):
        """Tile plane q of each colour: rows [j0, j1) x columns [c0, c1) of
        the field, tile row 0 at field row jt, field column c0 at tile
        column ``col``; NaN elsewhere, one NaN column past each side."""
        tile = torch.full((colours, nrows, width + 2), NAN)
        for c in range(colours):
            tile[c, j0 - jt:j1 - jt, col:col + c1 - c0] = fields[c][q, j0:j1, c0:c1]
        slots[(q - pa) % len(slots)] = (q, tile)

    def held(slots, q):
        plane, tile = slots[(q - pa) % len(slots)]
        assert plane == q, (plane, q)
        return tile

    def load_e(q):
        # K18: fine k k0 - 1 (slot k0 - 2) at tile column 1, as K3's, so a
        # window clipped at slot 0 starts one column in
        load(e_slots, e, q, 2 * cj0 - 2 + (1 - e_halo_rows), 2 * cj1 + 1, 2 * cj0 - 2, ka, kb,
             we, re_, 1 + ka - (k0 - 2) if fold else 1)

    def load_r(q):
        load(r_slots, r, q, 2 * cj0 - 1, 2 * cj1, 2 * cj0 - 1, ra, rb, wr, rr_)

    a = torch.arange(rows)[:, None]
    for q in range(pa, pa + 3):
        load_e(q)
    for q in range(pa + 1, pa + 3):
        load_r(q)
    if split:
        kk = ck0 - 1 + torch.arange(pts)[None, :]  # the lane's slots
        ke, kr = kk - ka + 1, kk - ra + 1          # their tile columns

        def even_colour(q):
            j = 2 * cj0 - 1 + a
            return torch.where((q + j) % 2 == 1, 0, 1).expand(rows, pts)

        ce = even_colour(pa)
        first = held(e_slots, pa)
        prev = [first[ce, a + 1, ke], first[1 - ce, a + 1, ke]]
    else:
        prev = [held(e_slots, pa)[0, 1:rows + 1, 1 + 1:pts + 2]]
    acc = None
    for p in range(pa + 1, p1 + 1):
        if p + 2 <= pe:  # into the ring slot of e plane p - 1
            load_e(p + 2)
        if p > pa + 1 and p + 1 <= p1:  # of r plane p - 1
            load_r(p + 1)
        mid, hi = held(e_slots, p), held(e_slots, p + 1)
        rt = held(r_slots, p)
        if split:
            ce = even_colour(p)
            co = 1 - ce
            s_ = g["S"]

            def residual(own, other, lo, pc):
                s = lo + hi[other, a + 1, ke]
                s = s + mid[other, a, ke]
                s = s + mid[other, a + 2, ke]
                s = s + mid[other, a + 1, ke]
                if pc == 0:
                    s = s + torch.where(kk > 0, mid[other, a + 1, ke - 1], 0.0)
                else:
                    s = s + torch.where(kk + 1 < s_, mid[other, a + 1, ke + 1], 0.0)
                return rt[own, a, kr] - inv_h2 * (s - 6.0 * mid[own, a + 1, ke])

            se = residual(ce, co, prev[0], 1)
            so = residual(co, ce, prev[1], 0)
            prev = [mid[ce, a + 1, ke], mid[co, a + 1, ke]]
            x = 0.5 * se[:, :-1] + 0.25 * (so[:, :-1] + so[:, 1:])
        else:
            t = mid[0]
            cols = slice(2, pts + 2)
            cen = t[1:rows + 1, cols]
            left, right = t[1:rows + 1, 1:pts + 1], t[1:rows + 1, 3:pts + 3]
            if fold and k_edge_select:  # the k faces' BC copies: the point's own value
                k = k0 + torch.arange(pts)[None, :]
                left = torch.where(k == 1, cen, left)
                right = torch.where(k == g["n"] - 2, cen, right)
            s = prev[0] + hi[0, 1:rows + 1, cols]
            s = s + t[0:rows, cols]
            s = s + t[2:rows + 2, cols]
            s = s + left
            s = s + right
            x = rt[0, 0:rows, 1:pts + 1] - inv_h2 * (s - 6.0 * cen)
            prev = [t[1:rows + 1, cols]]
        ci = (p + 1) // 2
        if p % 2 == 1:  # p = 2 ci - 1 opens ci and closes ci - 1
            q = 0.25 * x
            if ci > g["ci0"]:
                plane = torch.full((rr_, wa), NAN)
                closed = acc if (p == p1 and not close_last) else acc + q
                plane[:rows, :x.shape[1]] = closed
                _coarse_rows(plane, g, ci - 1, split, out, writes, fold)
            acc = q
        else:
            acc = acc + 0.5 * x


def x_cols(split, pts):
    """Columns of A a fine row's i-tapped values take: the k-tapped ones
    of the split row (pts - 1), or the row's fine k."""
    return pts - 1 if split else pts


def _coarse_rows(plane, g, ci, split, out, writes, fold=False):
    """The closed plane's j taps (then K3's and K18's k taps) into coarse
    plane ci (K18: coarse k at slot ck - 1)."""
    cj0, cj1, ck0, ck1 = g["cj0"], g["cj1"], g["ck0"], g["ck1"]
    nr, nk = cj1 - cj0, ck1 - ck0
    y = _tap3(plane[0:2 * nr:2], plane[1:2 * nr + 1:2], plane[2:2 * nr + 2:2])
    if split:
        v = y[:, :nk]
    else:
        v = _tap3(y[:, 0:2 * nk:2], y[:, 1:2 * nk + 1:2], y[:, 2:2 * nk + 2:2])
    ks = slice(ck0 - 1, ck1 - 1) if fold else slice(ck0, ck1)
    out[ci, cj0:cj1, ks] = v
    writes[ci, cj0:cj1, ks] += 1


def _fields(seed, n, layout):
    """(e, r) random at every point, faces included (K18: every stored
    point of the fold); for K9 split pairs random at every slot but r's
    dead slots, which hold NaN (no residual reads them)."""
    rng = np.random.default_rng(seed)
    if layout != "k9":
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
    return tuple(e), tuple(r)


def _plain(layout, e, r, h):
    if layout == "k9":
        return tps.residual_restrict_split_plain(*e, *r, h)
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
    columns, which its window never loads)."""
    h = 1.0 / (n - 1)
    e, r = _fields(40 + n, n, layout)
    want = _plain(layout, e, r, h)
    assert torch.isfinite(want).all()
    plans = [tps._restrict_plan(n, H100_SMS, *_flags(layout))] + _hand_plans(n, layout)
    assert any(p.tiles[2] > 1 for p in plans) and any(min(p.tiles[:2]) > 1 for p in plans)
    for plan in plans:
        got, writes = _emulate(plan, e, r, h)
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
        got, writes = _emulate(plan, e, r, h)
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
    got, _ = _emulate(plan, e, r, h, **kw)
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
        got, _ = _emulate(plan, e, r, h, k_edge_select=False)
        bad = ~(got == want)
        assert bool(bad[1:-1, 1:-1, 0].all() and bad[1:-1, 1:-1, -1].all()), plan
        assert not bool(bad[1:-1, 1:-1, 1:-1].any()), plan


def test_cpu_wrappers_return_the_plain_result_and_leave_inputs():
    """On the CPU the wrappers are the plain versions: a fresh (nc, nc, nc)
    field (K18: the (nc, nc, nc - 2) fold), the inputs untouched, no
    launch counted."""
    n = 9
    nc = (n + 1) // 2
    h = 1.0 / (n - 1)
    tpk.reset_launches()
    tps.reset_launches()
    tpmf.reset_launches()
    wrappers = {"k3": tpk.residual_restrict_fused, "k9": tps.residual_restrict_split,
                "k18": tpmf.residual_restrict_fold}
    for layout, fn in wrappers.items():
        e, r = _fields(70, n, layout)
        before = [x.clone() for x in (*e, *r)]
        got = fn(*e, *r, h)
        assert got.shape == ((nc, nc, nc - 2) if layout == "k18" else (nc,) * 3)
        assert torch.equal(got, _plain(layout, e, r, h))
        assert all(torch.equal(x.isnan(), b.isnan()) and torch.equal(x.nan_to_num(), b.nan_to_num())
                   for x, b in zip((*e, *r), before))  # r's dead slots hold NaN
    assert tpk.LAUNCHES["residual_restrict_fused"] == 0
    assert tps.LAUNCHES["residual_restrict_split"] == 0
    assert tpmf.LAUNCHES["residual_restrict_fold"] == 0
