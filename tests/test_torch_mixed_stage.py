"""The one-pass full-layout mixed smoothing stages (K14
``mixed_rb_smooth_from_zero_fused`` and K15 ``mixed_prolong_smooth_fused``,
multigrid_parallel_tpu_torch.ops.pallas_mixed) on the CPU: an emulation of
the CUDA kernels' schedule held against the plain versions, and the
wrappers' CPU contract.

The CUDA stage (ops/csrc/rect.cuh with the kMixed layout, ``stage_body``
and ``box_body``) cannot run here, so its schedule is emulated in torch,
block by block, as the kernel runs it, on rect.cuh's tile: a field row
(i, j) of the (n, n, n) field held as two colour rows of slots, slot kk of
a colour holding k = 2 kk + 1 + p, the k-face slots (k = 0 and n - 1)
holding the loaded face values (K14: zeros); the plan's boxes with halos of
2 n_iter planes and rows (and k_halo slots where k is tiled); tile planes
filled with NaN outside the loaded box, K14's tile all zeros instead; a
ring of tile planes for each colour as deep as the kernel's (a plane gone
from a ring raises); K15's e + P ec on every point of each plane as it
arrives (K4's step, the coarse boundary live); the skewed wavefront
(half-sweep s at plane p - 2 s once plane p has arrived; a step's
half-sweeps and store all read before any writes, as the kernel runs them
at once), each half-sweep on its region updating its colour in place, the
neighbours summed in the plain version's order, those across a face (i, j
or k at 1 or n - 2) selected as the slot's own value, 0 at a pinned x-face
node; and the store with the BC pass: a step after its last half-sweep,
each interior plane's owned rows written with the boundary nodes they are
the copy source of (k = 0 from k = 1, row 0 from row 1, plane 0 from plane
1, ..., 0 at a pinned x-face node, the pin read at the node's own (j, k)).
The emulation must equal the plain versions bit for bit, and three faults
of the schedule must not: a halo one plane short, a k-face neighbour read
from the tile's loaded k-face slot, and an x-face or a z-face node stored
before its source's last half-sweep. The card tests hold the kernels
themselves against the plain versions (tests/test_torch_cuda.py).
"""

import numpy as np
import pytest
import torch

import multigrid_parallel_tpu_torch as tmg
from multigrid_parallel_tpu_torch.ops import pallas3d as tpk
from multigrid_parallel_tpu_torch.ops import pallas_mixed as tpm
from multigrid_parallel_tpu_torch.ops import pallas_split as tps
from multigrid_parallel_tpu_torch.ops.stencils_3d import BLACK, RED

torch.set_num_threads(1)

H100_SMS = 132
NAN = float("nan")


# ------------------------------------------------------ the layout, emulated


def _slot_k(n):
    """(k_red, k_black), each (n, n, n // 2 + 1): the k that slot kk - 1
    of the colour holds in row (i, j), k = 2 kk - 1 + p."""
    idx = torch.arange(n)
    q = (idx[:, None, None] + idx[None, :, None]) % 2
    kk = torch.arange(-1, n // 2)[None, None, :]
    return 2 * kk + 1 + q, 2 * kk + 2 - q


def _deinterleave(x):
    """(n, n, n) field -> its colours by field colour (red, black), each
    (n, n, n // 2 + 1), slot kk at index kk + 1; NaN where a slot holds no
    point of the field."""
    n = x.shape[0]
    out = []
    for k in _slot_k(n):
        ok = (k >= 0) & (k < n)
        vals = torch.gather(x, 2, k.clamp(0, n - 1))
        out.append(torch.where(ok, vals, torch.full_like(vals, NAN)))
    return out


def _by_stage(colours, color0):
    """(red, black) by stage colour, and back (the same swap)."""
    return list(colours) if color0 == RED else [colours[1], colours[0]]


def _emulate_launch(ins, fs, pin, color0, h, plan, corr=None, fault=None):
    """One full-layout mixed stage launch as the kernel runs it:
    stage_body's wavefront or, for a box plan, box_body. ``ins``, ``fs`` and
    ``corr`` (K15's P ec, or None) are de-interleaved by stage colour ([0]
    the first half-sweep's colour, ``color0``), ``ins`` None for K14's zero
    tile; ``pin`` the (2, n, n) pin planes. ``fault`` names a broken
    schedule: "k_face_slot" reads the k-face neighbours from the tile's
    k-face slots, "early_x" writes the x-face planes at their own turn,
    "early_z" the z faces a step before their source's last half-sweep.
    Returns the output and how many times each of its points was written."""
    n, s = fs[0].shape[0], fs[0].shape[2] - 1
    big_h, levels = plan.halo, 2 * plan.n_iter
    depth = 2 * levels + 3  # each colour's ring (the wavefront)
    out = torch.full((n, n, n), NAN)
    writes = torch.zeros((n, n, n), dtype=torch.int32)
    width = plan.bk + 2 * plan.k_halo if plan.k_halo else -(-s // 4) * 4 + 4
    colours = (color0, 1 - color0)  # field colour of stage colour c
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
                kr0, kr1 = (0 if k0 == 0 else 2 * k0 + 1), min(2 * k1 + 1, n)
                tiles = [{}, {}]

                def par(q, j, c):
                    """p of stage colour c in row (q, j)."""
                    return ((q + j) % 2) ^ colours[c] ^ 1

                def load(q):
                    for c in (0, 1):
                        # one column past the tile: a slot's kk + 1 read at the last slot
                        t = torch.full((plan.bj + 2 * big_h, width + 1), NAN)
                        if ins is None:
                            t.zero_()
                        else:
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
                    jl, jh = max(jb0 + lvl, 1), min(j1 + big_h - lvl, n - 1)
                    kl = 0 if k0 == 0 else k0 - plan.k_halo + lvl
                    kh = s if k1 == s else min(k1 + plan.k_halo - lvl, s)  # the live slots
                    if jh <= jl or kh <= kl:  # an empty region (a halo too short)
                        return None
                    lo, mid, hi = tiles[1 - c][q - 1], tiles[1 - c][q], tiles[1 - c][q + 1]
                    dst = tiles[c][q]
                    r = slice(jl - jb0, jh - jb0)
                    cl = slice(kl - kb0, kh - kb0)
                    kk = torch.arange(kl, kh)[None, :]
                    j = torch.arange(jl, jh)[:, None]
                    p = par(q, j, c)
                    k = 2 * kk + 1 + p
                    cen = dst[r, cl]
                    left = mid[r, kl - kb0 - 1:kh - kb0 - 1]
                    right = mid[r, kl - kb0 + 1:kh - kb0 + 1]
                    k_lo = torch.where(p == 0, left, mid[r, cl])
                    k_hi = torch.where(p == 0, mid[r, cl], right)
                    if fault != "k_face_slot":
                        k_lo = torch.where(k == 1, cen, k_lo)
                        k_hi = torch.where(k == n - 2, cen, k_hi)
                    j_lo = torch.where(j == 1, cen, mid[jl - jb0 - 1:jh - jb0 - 1, cl])
                    j_hi = torch.where(j == n - 2, cen, mid[jl - jb0 + 1:jh - jb0 + 1, cl])
                    i_lo, i_hi = lo[r, cl], hi[r, cl]
                    pk = k.clamp(0, n - 1)
                    if q == 1:
                        i_lo = torch.where(pin[0][j, pk] > 0.5, torch.zeros_like(cen), cen)
                    if q == n - 2:
                        i_hi = torch.where(pin[1][j, pk] > 0.5, torch.zeros_like(cen), cen)
                    acc = i_lo + i_hi + j_lo + j_hi + k_lo + k_hi
                    upd = (acc - (h * h) * fs[c][q, jl:jh, kl + 1:kh + 1]) * (1.0 / 6.0)
                    return dst, r, cl, torch.where(k <= n - 2, upd, cen)

                def store(q, planes=None, z=None):
                    """The nodes whose copy source lies in interior plane q
                    (``planes``: only those target planes; ``z``: only the
                    z-face columns, or all but them): (target, value) pairs,
                    read now."""
                    jl, jh = max(j0, 1), min(j1, n - 1)
                    if not 1 <= q <= n - 2 or jl >= jh:
                        return []
                    targets = [q] + ([0] if q == 1 else []) + ([n - 1] if q == n - 2 else [])
                    jt = torch.arange(0 if jl == 1 else jl, n if jh == n - 1 else jh)[:, None]
                    kt = torch.arange(kr0, kr1)[None, :]
                    if z is not None:
                        kt = kt[(kt == 0) | (kt == n - 1)] if z else kt[(kt > 0) & (kt < n - 1)]
                        kt = kt[None, :]
                    js, ks = jt.clamp(1, n - 2), kt.clamp(1, n - 2)  # each target's source
                    p = 1 - ks % 2
                    slot = (ks - 1 - p) // 2
                    jt, kt, js, ks, p, slot = torch.broadcast_tensors(jt, kt, js, ks, p, slot)
                    v = torch.full(jt.shape, NAN)
                    for c in (0, 1):
                        mine = par(q, js, c) == p
                        v = torch.where(mine, tiles[c][q][js - jb0, slot - kb0], v)
                    found = []
                    for qt in targets if planes is None else [t for t in targets if t in planes]:
                        val = v
                        if qt != q:
                            pinned = pin[0 if qt == 0 else 1][jt, kt]
                            val = torch.where(pinned > 0.5, torch.zeros_like(v), v)
                        found.append(((torch.full_like(jt, qt), jt, kt), val))
                    return found

                def run(updates, stores=()):  # all of a step reads before any writes
                    for dst, r, cl, value in [u for u in updates if u is not None]:
                        dst[r, cl] = value
                    for idx, v in stores:
                        out[idx] = v
                        writes[idx] += 1

                def owned_store(q):
                    if fault == "early_x" and q in (1, n - 2):
                        return store(q, planes=[q])  # the x-face plane at its own turn instead
                    if fault == "early_z":
                        return store(q, z=False)  # the z faces a step before instead
                    return store(q)

                def early_x(q):  # the fault: x-face plane q written at its own turn
                    if fault != "early_x" or q not in (0, n - 1):
                        return []
                    src = 1 if q == 0 else n - 2
                    if not i0 <= src < i1:
                        return []
                    return store(src, planes=[q])

                def early_z(q):  # the fault: plane q's z faces read before its last half-sweep
                    return store(q, z=True) if fault == "early_z" and i0 <= q < i1 else []

                if plan.box:  # every plane, then the half-sweeps one by one
                    for q in range(ia, ib):
                        load(q)
                    for lvl in range(1, levels + 1):
                        if lvl == levels:  # the faults: faces stored before the last half-sweep
                            run([], [st for q in range(i0, i1) for st in early_x(q) + early_z(q)])
                        run([sweep(lvl, q) for q in range(ia, ib)])
                    run([], [st for q in range(i0, i1) for st in owned_store(q)])
                    continue
                load(ia)
                for p in range(ia, i1 + 2 * levels + 1):
                    if p + 1 < ib:
                        load(p + 1)
                    qb = p - 1 - 2 * levels
                    stores = early_z(p - 2 * levels)  # with half-sweep H's step, not after it
                    if i0 <= qb < i1:  # both colours' last half-sweeps finished a step ago
                        stores = stores + owned_store(qb) + early_x(qb)
                    run([sweep(lvl, p - 2 * lvl) for lvl in range(1, levels + 1)], stores)
    return out, writes


def _check_writes(writes):
    """Every point of the field written by exactly one block, once."""
    assert torch.equal(writes, torch.ones_like(writes))


def _emulate_k14(r, pin, h, n_iter, red_first, plan_of, fault=None):
    """K14 from a zero tile, then the stage on the field so far."""
    color0 = RED if red_first else BLACK
    fs, u = _by_stage(_deinterleave(r), color0), None
    for chunk in tps._stage_chunks(n_iter):
        ins = None if u is None else _by_stage(_deinterleave(u), color0)
        u, writes = _emulate_launch(ins, fs, pin, color0, h, plan_of(chunk), fault=fault)
        _check_writes(writes)
    return u


def _emulate_k15(ec, e, r, pin, h, n_iter, plan_of, fault=None):
    """K15: e + P ec made as planes arrive, then the stage (black first);
    past n_iter 2 the stage on the field so far."""
    t = ec
    for axis in (1, 2, 0):
        t = tpk._interp_axis(t, axis)
    fs, u = _by_stage(_deinterleave(r), BLACK), e
    corr = _by_stage(_deinterleave(t), BLACK)
    for chunk in tps._stage_chunks(n_iter):
        u, writes = _emulate_launch(_by_stage(_deinterleave(u), BLACK), fs, pin, BLACK, h,
                                    plan_of(chunk), corr, fault)
        _check_writes(writes)
        corr = None
    return u


def _plans(kind, n):
    """The plan of each launch size (n_iter 1, 2): the planner's for the
    H100's 132 SMs (a box up to 129^3), its wavefront's for 4 SMs, a box of
    5 planes by 4 rows, 7 planes by 8 whole rows on the wavefront, 4-slot k
    tiles with the 4-slot k halo by 12 rows and 11 planes (wavefront), or
    boxes of 1 plane by 1 row with 4-slot k tiles. The H100's plans at 9^3
    and 17^3 are boxes of one plane (and one row): every x- and y-face node
    is written by the block of its source, not its own."""
    s = n // 2

    def plan(n_iter):
        halo = 2 * n_iter
        if kind == "h100":
            return tps._stage_plan(n, n_iter, H100_SMS, rect=True)
        if kind == "wave":
            return tps._wave_plan(n, n_iter, 4, False, True)
        if kind == "box":
            return tps.StagePlan(n, n_iter, halo, 0, 5, 4, s, 256, 0, True, True)
        if kind == "rows":
            return tps.StagePlan(n, n_iter, halo, 0, 7, 8, s, 256, 0, True)
        if kind == "one_k_tiles":
            return tps.StagePlan(n, n_iter, halo, tps.STAGE_K_HALO, 1, 1, 4, 256, 0, True, True)
        return tps.StagePlan(n, n_iter, halo, tps.STAGE_K_HALO, 11, 12, 4, 256, 0, True)

    return plan


def _field(rng, n):
    """A field random at every point, the boundary too."""
    return torch.from_numpy(rng.standard_normal((n, n, n)).astype(np.float32))


def _pins(kind, n, rng):
    """The (2, n, n) pin planes: the electrospray's at this level, or a
    random patch mask, the k = 0 and n - 1 columns included."""
    if kind == "electrospray":
        return tpm.dirichlet_pin_planes(tmg.electrospray_problem(), n, "cpu")
    pin = torch.from_numpy((rng.random((2, n, n)) < 0.3).astype(np.float32))
    assert bool(pin[:, :, 0].any()) and bool(pin[:, :, n - 1].any())
    return pin


CASES = [(9, "h100"), (9, "wave"), (17, "h100"), (17, "rows"), (33, "box"), (33, "k_tiles")]


@pytest.mark.parametrize("pins", ["electrospray", "random"])
@pytest.mark.parametrize("n_iter", [1, 2])
@pytest.mark.parametrize("n,kind", CASES)
def test_emulated_mixed_stages_match_plain(n, kind, n_iter, pins):
    """K14 (both orders) and K15 on the level sizes 9^3, 17^3 and 33^3, on
    box and wavefront plans with several blocks in i and j (and k where
    tiled, down to 1 x 1 blocks), the electrospray's pins and random ones
    (k-face columns too), fields and the coarse correction random at every
    point (the coarse boundary live): bit for bit against the plain
    versions."""
    h = 3e-4 / (n - 1)
    rng = np.random.default_rng(10 * n + n_iter)
    pin = _pins(pins, n, rng)
    e, r, ec = _field(rng, n), _field(rng, n), _field(rng, (n + 1) // 2)
    plan_of = _plans(kind, n)
    assert plan_of(n_iter).blocks > 1
    for red_first in (True, False):
        got = _emulate_k14(r, pin, h, n_iter, red_first, plan_of)
        want = tpm.mixed_rb_smooth_from_zero_plain(r, pin, h, n_iter, red_first)
        assert torch.equal(got, want), red_first
    got = _emulate_k15(ec, e, r, pin, h, n_iter, plan_of)
    assert torch.equal(got, tpm.mixed_prolong_smooth_plain(ec, e, r, pin, h, n_iter))


def test_emulated_mixed_stages_on_one_row_k_tiles():
    """Boxes of 1 plane by 1 row by 4 slots (13^3: two k tiles a row), so
    that every face node, the z faces too, is written by a block of its
    source's and no block holds a whole row: bit for bit."""
    n, h = 13, 3e-4 / 12
    rng = np.random.default_rng(13)
    pin = _pins("random", n, rng)
    e, r, ec = _field(rng, n), _field(rng, n), _field(rng, 7)
    plan_of = _plans("one_k_tiles", n)
    assert plan_of(2).tiles == (n, n, 2)
    got = _emulate_k14(r, pin, h, 2, True, plan_of)
    assert torch.equal(got, tpm.mixed_rb_smooth_from_zero_plain(r, pin, h, 2, True))
    got = _emulate_k15(ec, e, r, pin, h, 2, plan_of)
    assert torch.equal(got, tpm.mixed_prolong_smooth_plain(ec, e, r, pin, h, 2))


def test_emulated_mixed_stages_chain_past_two_iterations():
    """n_iter 3: a two-iteration launch (K14 from zero, K15 with its
    correction), then the stage on the field so far."""
    n, h = 17, 3e-4 / 16
    rng = np.random.default_rng(3)
    pin = _pins("random", n, rng)
    e, r, ec = _field(rng, n), _field(rng, n), _field(rng, 9)
    plan_of = _plans("rows", n)
    for red_first in (True, False):
        got = _emulate_k14(r, pin, h, 3, red_first, plan_of)
        assert torch.equal(got, tpm.mixed_rb_smooth_from_zero_plain(r, pin, h, 3, red_first))
    got = _emulate_k15(ec, e, r, pin, h, 3, plan_of)
    assert torch.equal(got, tpm.mixed_prolong_smooth_plain(ec, e, r, pin, h, 3))


@pytest.mark.parametrize("fault", ["short_halo", "k_face_slot", "early_x", "early_z"])
@pytest.mark.parametrize("kind", ["rows", "box"])
def test_emulation_finds_a_faulty_schedule(kind, fault):
    """The emulation is a check: a halo one plane short, the k-face
    neighbours read from the tile's k-face slots (K14's zeros, K15's loaded
    e + P ec), or the x-face planes or the z faces stored before their
    sources' last half-sweep, each leaves a wrong value in the output of
    K14 and of K15, on the wavefront and on the box; the same plans
    without the fault equal the plain versions."""
    n, n_iter = 17, 2
    h = 3e-4 / (n - 1)
    rng = np.random.default_rng(5)
    pin = _pins("electrospray", n, rng)
    e, r, ec = _field(rng, n), _field(rng, n), _field(rng, 9)
    plan = _plans(kind, n)(n_iter)
    want14 = tpm.mixed_rb_smooth_from_zero_plain(r, pin, h, n_iter, True)
    want15 = tpm.mixed_prolong_smooth_plain(ec, e, r, pin, h, n_iter)
    assert torch.equal(_emulate_k14(r, pin, h, n_iter, True, lambda _: plan), want14)
    assert torch.equal(_emulate_k15(ec, e, r, pin, h, n_iter, lambda _: plan), want15)
    bad, broken = plan, None
    if fault == "short_halo":
        bad = plan._replace(halo=plan.halo - 1)
    else:
        broken = fault
    # the faulty schedules still write every point once: a wrong value, not a count
    got14 = _emulate_k14(r, pin, h, n_iter, True, lambda _: bad, broken)
    got15 = _emulate_k15(ec, e, r, pin, h, n_iter, lambda _: bad, broken)
    assert not torch.equal(got14, want14)
    assert not torch.equal(got15, want15)


# ------------------------------------------------- the wrappers on the CPU


def test_k14_k15_return_fresh_fields_and_leave_their_inputs():
    """On the CPU the wrappers are the plain versions: fresh outputs, the
    inputs as they were, no launch counted; n_iter < 1 is refused."""
    n, h = 17, 3e-4 / 16
    rng = np.random.default_rng(7)
    pin = _pins("random", n, rng)
    e, r, ec = _field(rng, n), _field(rng, n), _field(rng, 9)
    before = [x.clone() for x in (e, r, ec, pin)]
    tpm.reset_launches()
    got15 = tpm.mixed_prolong_smooth_fused(ec, e, r, pin, h, 2)
    got14 = tpm.mixed_rb_smooth_from_zero_fused(r, pin, h, 2)
    assert all(torch.equal(a, b) for a, b in zip((e, r, ec, pin), before))
    assert got15 is not e and got14 is not r
    assert torch.equal(got15, tpm.mixed_prolong_smooth_plain(ec, e, r, pin, h, 2))
    assert torch.equal(got14, tpm.mixed_rb_smooth_from_zero_plain(r, pin, h, 2))
    assert not any(tpm.LAUNCHES.values())
    for call in (lambda: tpm.mixed_rb_smooth_from_zero_fused(r, pin, h, 0),
                 lambda: tpm.mixed_prolong_smooth_fused(ec, e, r, pin, h, 0)):
        with pytest.raises(ValueError, match="n_iter"):
            call()
