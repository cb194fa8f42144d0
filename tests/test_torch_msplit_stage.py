"""The one-pass msplit smoothing stages (K21 ``mixed_rb_smooth_msplit``,
K22 ``mixed_rb_smooth_from_zero_msplit`` and K24
``mixed_prolong_smooth_msplit``, multigrid_parallel_tpu_torch.ops.
pallas_mixed_split) on the CPU: an emulation of the CUDA kernels'
schedule held against the plain versions, and the wrappers' CPU
contract.

The CUDA stage (ops/csrc/split.cuh, ``stage_body`` with MIXED) cannot run
here, so its schedule is emulated in torch, block by block, as the kernel
runs it, on the pair's own layout (red, black), (n, n, S) each: the plan's
boxes with halos of 2 n_iter planes and rows (and k_halo slots where k is
tiled); tile planes filled with NaN outside the loaded box, K22's tile
all zeros instead, K21's loaded from its pair (random at its boundary
rows and dead slots, which no sweep may read); a ring of tile planes for each colour as deep as the
kernel's (a plane gone from a ring raises); K24's coarse fold planes in a
ring of 3, NaN outside the rows and slots the block copies, copied with
the fine planes that first need them, and e + P ec of both colours made as
each plane arrives (the sign-plane term d of the x faces' k edges from
the whole coarse field, as the kernel reads it from device memory); the
skewed wavefront (half-sweep s at plane p - 2 s once plane p has arrived;
a step's half-sweeps and store all read before any writes), each
half-sweep on its region updating its colour in place, the neighbours
summed in mixed_nbr_sum's order, those across a face (i, j or k at 1 or
n - 2) selected as the slot's own value, 0 at a pinned x-face node (the
reader's parity pack); and the store with the cross-colour BC pass: both
colours of a plane at the step after the second colour's last
half-sweep, each interior row written with the face rows it is the copy
source of, the colour flipped once a copied coordinate, 0 at a pinned
x-face node and at the dead slots. The emulation must equal the plain
versions bit for bit, and three faults of the schedule must not: a face
row stored at the first colour's step, K10's load of the first colour
only where no half-sweep rewrites it, and a k-edge neighbour read as the
dead slot's or the guard's 0 in place of the select; nor two of K21's:
a zero tile in place of its pair (K22's launch), and a j-face neighbour
read from the tile's boundary row in place of the select. The card tests
hold the kernels themselves against the plain versions
(tests/test_torch_cuda.py).
"""

import numpy as np
import pytest
import torch

import multigrid_parallel_tpu_torch as tmg
from multigrid_parallel_tpu_torch.ops import pallas_mixed_fold as tpmf
from multigrid_parallel_tpu_torch.ops import pallas_mixed_split as tpms
from multigrid_parallel_tpu_torch.ops import pallas_split as tps
from multigrid_parallel_tpu_torch.ops.stencils_3d import BLACK, RED

torch.set_num_threads(1)

NAN = float("nan")
H100_SMS = 132
FAULTS = ("early_face_store", "fixed_first", "k_edge_zero")
K21_FAULTS = ("zero_tile", "face_read")


def _by_stage(pair, color0):
    """A (red, black) pair by stage colour, and back (the same swap)."""
    return list(pair) if color0 == RED else [pair[1], pair[0]]


def _emulate_launch(ins, fs, packs, color0, h, plan, coarse=None, fault=None):
    """One msplit stage launch as stage_body runs it with MIXED. ``ins``
    and ``fs`` by stage colour ([0] the first half-sweep's colour,
    ``color0``), ``ins`` None for K22's zero tile; ``coarse`` K24's (ec,
    sgn_c); ``fault`` one of FAULTS, or "face_read" (a j-face neighbour
    read from the tile's boundary row). Returns the outputs by stage
    colour and how many times each slot of each was written."""
    n, s = fs[0].shape[0], fs[0].shape[2]
    big_h, levels = plan.halo, 2 * plan.n_iter
    depth = 2 * levels + 3  # each colour's ring
    outs = [torch.full((n, n, s), NAN) for _ in range(2)]
    writes = torch.zeros((2, n, n, s), dtype=torch.int32)
    width = plan.bk + 2 * plan.k_halo if plan.k_halo else s
    colours = (color0, 1 - color0)  # field colour of stage colour c
    live0 = tps._masks(n, "cpu")[1 if color0 == RED else 2]
    if coarse is not None:
        ec, sgn_c = coarse
        nc = ec.shape[0]
        delta = torch.zeros_like(ec)
        delta[0], delta[-1] = sgn_c[0] * ec[1], sgn_c[1] * ec[-2]
        d_full = tpms._interp_ji(delta, n)  # (n, n, nc - 2): D at every fine row
    ni, nj, nk = plan.tiles
    for ti in range(ni):
        for tj in range(nj):
            for tk in range(nk):
                i0, i1 = ti * plan.bi, min(ti * plan.bi + plan.bi, n)
                j0, j1 = tj * plan.bj, min(tj * plan.bj + plan.bj, n)
                k0, k1 = tk * plan.bk, min(tk * plan.bk + plan.bk, s)
                jb0, kb0 = j0 - big_h, k0 - plan.k_halo
                ia, ib = max(i0 - big_h, 0), min(i1 + big_h, n)
                ja, jb = max(jb0, 0), min(j1 + big_h, n)
                ka, kb = max(kb0, 0), min(k1 + plan.k_halo, s)
                # tile column of slot kk: kk - kb0 + 1 (a NaN column each side)
                rows, cols = slice(ja - jb0, jb - jb0), slice(ka - kb0 + 1, kb - kb0 + 1)
                tiles, ring = [{}, {}], {}
                cja = ja >> 1
                a0 = max(ka - 1, 0)

                def par(q, j, c):
                    """p of stage colour c in row (q, j)."""
                    return ((q + j) % 2) ^ colours[c] ^ 1

                def load(q):
                    for c in (0, 1):
                        t = torch.full((plan.bj + 2 * big_h, width + 2), NAN)
                        if ins is None:
                            t.zero_()
                        else:
                            box = ins[c][q, ja:jb, ka:kb]
                            if fault == "fixed_first" and c == 0:  # K10's load
                                box = torch.where(live0[q, ja:jb, ka:kb],
                                                  torch.full_like(box, NAN), box)
                            t[rows, cols] = box
                        tiles[c][q] = t
                        tiles[c].pop(q - depth, None)  # the ring slot plane q takes
                    if coarse is None or (q != ia and q % 2 == 0):
                        return
                    a1 = min(kb, nc - 2)
                    for c in range(q >> 1 if q == ia else (q + 1) >> 1, ((q + 1) >> 1) + 1):
                        t = torch.full((nc, nc - 2), NAN)
                        t[cja:(jb >> 1) + 1, a0:a1] = ec[c, cja:(jb >> 1) + 1, a0:a1]
                        ring[c] = t
                        ring.pop(c - 3, None)  # the ring slot coarse plane c takes

                def correct(q):
                    """K24's e + P ec of plane q's loaded box, both colours
                    (+0 off the live interior slots)."""
                    if coarse is None:
                        return
                    j = torch.arange(ja, jb)[:, None]
                    kk = torch.arange(ka, kb)[None, :]
                    top = nc - 3
                    inner = (1 <= q <= n - 2) & (j >= 1) & (j <= n - 2)
                    if 1 <= q <= n - 2 and bool(inner.any()):
                        planes = [ring[q >> 1]] + ([ring[(q >> 1) + 1]] if q % 2 else [])
                        jj = j.clamp(1, n - 2)[:, 0]
                        cj, oj = jj >> 1, (jj % 2 == 1)[:, None]

                        def y_at(a):  # Y at coarse slots a (a row of them), the j step then i
                            ys = [torch.where(oj, 0.5 * pl[cj][:, a] + 0.5 * pl[cj + 1][:, a],
                                              pl[cj][:, a]) for pl in planes]
                            return 0.5 * (ys[0] + ys[1]) if q % 2 else ys[0]

                        ylo = y_at(torch.clamp(kk[0] - 1, 0, top))
                        yhi = y_at(torch.clamp(kk[0], 0, top))
                        edge = (q in (1, n - 2)) & ((kk == 0) | (kk == nc - 2))
                        d = torch.where(edge, d_full[q, jj][:, torch.where(kk[0] == 0, 0, top)],
                                        torch.zeros_like(ylo))
                        odd = 0.5 * (ylo + yhi) + 0.5 * d
                        even = yhi  # Y[kk] where kk <= top
                    for c in (0, 1):
                        p = par(q, j, c)
                        corr = torch.zeros((jb - ja, kb - ka))
                        if 1 <= q <= n - 2 and bool(inner.any()):
                            live = inner & (2 * kk + 1 + p <= n - 2)
                            corr = torch.where(live, torch.where(p == 0, odd, even), corr)
                        tiles[c][q][rows, cols] = tiles[c][q][rows, cols] + corr

                def sweep(lvl, q):
                    """Half-sweep lvl's update of plane q: (tile, rows, cols,
                    value), or None outside its region."""
                    c = (lvl - 1) % 2
                    if not max(i0 - big_h + lvl, 1) <= q < min(i1 + big_h - lvl, n - 1):
                        return None
                    jl, jh = max(jb0 + lvl, 1), min(j1 + big_h - lvl, n - 1)
                    kl = 0 if k0 == 0 else k0 - plan.k_halo + lvl
                    kh = s if k1 == s else k1 + plan.k_halo - lvl
                    if jh <= jl or kh <= kl:  # an empty region (a halo too short)
                        return None
                    lo, mid, hi = tiles[1 - c][q - 1], tiles[1 - c][q], tiles[1 - c][q + 1]
                    dst = tiles[c][q]
                    r = slice(jl - jb0, jh - jb0)
                    cl = slice(kl - kb0 + 1, kh - kb0 + 1)
                    kk = torch.arange(kl, kh)[None, :]
                    j = torch.arange(jl, jh)[:, None]
                    p = par(q, j, c)
                    k = 2 * kk + 1 + p
                    cen, m = dst[r, cl], mid[r, cl]
                    left = mid[r, kl - kb0:kh - kb0]
                    right = mid[r, kl - kb0 + 2:kh - kb0 + 2]
                    k_lo = torch.where(p == 0, left, m)  # k - 1: slot kk - 1 (p = 0) or kk
                    k_hi = torch.where(p == 0, m, right)  # k + 1: slot kk (p = 0) or kk + 1
                    zero = torch.zeros_like(cen)
                    edge_value = zero if fault == "k_edge_zero" else cen
                    k_lo = torch.where(k == 1, edge_value, k_lo)
                    k_hi = torch.where(k == n - 2, edge_value, k_hi)
                    j_lo, j_hi = mid[jl - jb0 - 1:jh - jb0 - 1, cl], mid[jl - jb0 + 1:jh - jb0 + 1, cl]
                    if fault != "face_read":
                        j_lo = torch.where(j == 1, cen, j_lo)
                        j_hi = torch.where(j == n - 2, cen, j_hi)
                    i_lo, i_hi = lo[r, cl], hi[r, cl]
                    pk = p.expand_as(k)
                    rows_j = j.expand_as(k)
                    if q == 1:
                        i_lo = torch.where(packs[pk, 0, rows_j, kk.expand_as(k)] > 0.5, zero, cen)
                    if q == n - 2:
                        i_hi = torch.where(packs[pk, 1, rows_j, kk.expand_as(k)] > 0.5, zero, cen)
                    acc = i_lo + i_hi + j_lo + j_hi + k_lo + k_hi
                    upd = (acc - (h * h) * fs[c][q, jl:jh, kl:kh]) * (1.0 / 6.0)
                    return dst, r, cl, torch.where(k <= n - 2, upd, cen)

                def store(q, stage_colours=(0, 1)):
                    """The target rows whose copy source lies in interior
                    plane q, for ``stage_colours``: (index, value) pairs,
                    read now."""
                    jl, jh = max(j0, 1), min(j1, n - 1)
                    if not 1 <= q <= n - 2 or jl >= jh:
                        return []
                    targets = [q] + ([0] if q == 1 else []) + ([n - 1] if q == n - 2 else [])
                    jt = torch.arange(0 if jl == 1 else jl, n if jh == n - 1 else jh)[:, None]
                    js = jt.clamp(1, n - 2)  # each target row's source row
                    kk = torch.arange(k0, k1)[None, :]
                    found = []
                    for qt in targets:
                        flip = (jt != js) ^ (qt != q)
                        for c in stage_colours:
                            mine = tiles[c][q][js - jb0, kk - kb0 + 1]
                            other = tiles[1 - c][q][js - jb0, kk - kb0 + 1]
                            v = torch.where(flip, other, mine)
                            p = par(qt, jt, c)
                            v = torch.where(2 * kk + 1 + p > n - 2, torch.zeros_like(v), v)
                            if qt != q:
                                pin = packs[p.expand_as(v), 0 if qt == 0 else 1,
                                            jt.expand_as(v), kk.expand_as(v)]
                                v = torch.where(pin > 0.5, torch.zeros_like(v), v)
                            found.append(((c, qt, jt.expand_as(v), kk.expand_as(v)), v))
                    return found

                def run(updates, stores):  # all of a step reads before any writes
                    for dst, r, cl, value in [u for u in updates if u is not None]:
                        dst[r, cl] = value
                    for (c, *idx), v in stores:
                        outs[c][tuple(idx)] = v
                        writes[c][tuple(idx)] += 1

                load(ia)
                for p in range(ia, i1 + 2 * levels + 1):
                    if p + 1 < ib:
                        load(p + 1)
                    if p < ib:
                        correct(p)
                    qa, qb = p - 1 - 2 * (levels - 1), p - 1 - 2 * levels
                    stores = []
                    if fault == "early_face_store":  # the first colour at its own step
                        if i0 <= qa < i1:
                            stores += store(qa, (0,))
                        if i0 <= qb < i1:
                            stores += store(qb, (1,))
                    elif i0 <= qb < i1:  # both colours' last half-sweeps finished a step ago
                        stores = store(qb)
                    run([sweep(lvl, p - 2 * lvl) for lvl in range(1, levels + 1)], stores)
    return outs, writes


def _check_writes(writes):
    """Every slot of both colours written by exactly one block, once."""
    assert torch.equal(writes, torch.ones_like(writes))


def _emulate_k22(fr, fb, packs, h, n_iter, red_first, plan_of, fault=None):
    """K22 from a zero tile, then the stage on the pair so far."""
    color0 = RED if red_first else BLACK
    fs, pair = _by_stage((fr, fb), color0), None
    for chunk in tps._stage_chunks(n_iter):
        ins = None if pair is None else _by_stage(pair, color0)
        outs, writes = _emulate_launch(ins, fs, packs, color0, h, plan_of(chunk), fault=fault)
        _check_writes(writes)
        pair = tuple(_by_stage(outs, color0))
    return pair


def _emulate_k21(er, eb, fr, fb, packs, h, n_iter, red_first, plan_of, fault=None):
    """K21: the stage with the pair loaded, then on the pair so far
    ("zero_tile": the first launch from a zero tile, K22's)."""
    color0 = RED if red_first else BLACK
    fs, pair = _by_stage((fr, fb), color0), (er, eb)
    for i, chunk in enumerate(tps._stage_chunks(n_iter)):
        ins = None if fault == "zero_tile" and i == 0 else _by_stage(pair, color0)
        outs, writes = _emulate_launch(ins, fs, packs, color0, h, plan_of(chunk),
                                       fault=None if fault == "zero_tile" else fault)
        _check_writes(writes)
        pair = tuple(_by_stage(outs, color0))
    return pair


def _emulate_k24(ec, er, eb, rr, rb, packs, sgn_c, h, n_iter, plan_of, fault=None):
    """K24's launch with its correction, then the stage on the pair so
    far, black first."""
    pair, coarse = (er, eb), (ec, sgn_c)
    for chunk in tps._stage_chunks(n_iter):
        outs, writes = _emulate_launch([pair[1], pair[0]], [rb, rr], packs, BLACK, h,
                                       plan_of(chunk), coarse, fault)
        _check_writes(writes)
        pair, coarse = (outs[1], outs[0]), None
    return pair


def _plans(kind, n):
    """The plan of each launch size (n_iter 1, 2): the msplit planner's for
    the H100's 132 SMs (up to 65^3 the fewest-steps plan: at 9^3 one row
    by one plane a block, at 33^3 one plane by 9 rows), 8 whole rows by 7
    planes, 1 row by 1 plane (whose x- and y-face rows
    the block of their source writes), or 4-slot k tiles with the 4-slot k
    halo, two blocks in i and two in j. Shared memory does not enter the
    emulation."""
    s = tps.split_shape(n)[2]

    def plan(n_iter):
        halo = 2 * n_iter
        if kind == "h100":
            return tps._stage_plan(n, n_iter, H100_SMS, msplit=True)
        if kind == "rows":
            return tps.StagePlan(n, n_iter, halo, 0, 7, 8, s, 256, 0)
        if kind == "tiny":
            return tps.StagePlan(n, n_iter, halo, 0, 1, 1, s, 32, 0)
        half = (n + 1) // 2
        return tps.StagePlan(n, n_iter, halo, tps.STAGE_K_HALO, half, half, 4, 256, 0)

    return plan


def _pair(rng, n):
    """A split pair random at every slot, dead slots and boundary rows too:
    what the stages must neither read nor keep."""
    return tuple(torch.from_numpy(rng.standard_normal(tps.split_shape(n)).astype(np.float32))
                 for _ in range(2))


def _pins(kind, n, rng):
    """(parity pin packs (2, 2, n, S), coarse sign planes (2, nc, nc - 2)):
    the electrospray's at this level and the next coarser one, or a random
    patch mask and random signs in {-1, 0, 1} (nonzero at the k-edge
    columns K24 reads)."""
    nc = (n + 1) // 2
    if kind == "electrospray":
        es = tmg.electrospray_problem()
        return tpms.msplit_pin_packs(es, n, "cpu"), tpmf.fold_edge_sign_planes(es, nc, "cpu")
    mask = torch.from_numpy((rng.random((2, n, n)) < 0.3).astype(np.float32))
    sgn = torch.from_numpy(rng.integers(-1, 2, (2, nc, nc - 2)).astype(np.float32))
    return tpms.msplit_plane_packs(mask), sgn


def _fields(n, seed):
    rng = np.random.default_rng(seed)
    nc = (n + 1) // 2
    e, r = _pair(rng, n), _pair(rng, n)
    ec = torch.from_numpy(rng.standard_normal((nc, nc, nc - 2)).astype(np.float32))
    return rng, e, r, ec


def _bitwise(got, want):
    return all(torch.equal(g, w) for g, w in zip(got, want))


CASES = [(9, "h100"), (17, "rows"), (17, "k_tiles"), (33, "h100"), (33, "k_tiles")]


@pytest.mark.parametrize("n_iter", [1, 2])
@pytest.mark.parametrize("n", [5, 9, 17, 33, 65, 129, 257, 513])
def test_msplit_plan_covers_the_field_once(n, n_iter):
    """The msplit stages' plans (K22's, and K24's with its coarse ring):
    past 65^3 K7's and K10's; up to it the fewest-steps plan, whole rows,
    one wave of blocks on the H100's 132 SMs, a warp a tile row (17^3: one
    plane by 3 rows, the fastest measured). The owned boxes tile every axis
    exactly, the shared memory is the launchers' formula, within a block's
    232,448 B."""
    s = tps.split_shape(n)[2]
    for prolong in (False, True):
        plan = tps._stage_plan(n, n_iter, H100_SMS, prolong=prolong, msplit=True)
        width = plan.bk + 2 * plan.k_halo if plan.k_halo else s
        assert plan.halo == 2 * n_iter
        assert plan.smem == tps._stage_smem(n_iter, plan.bj, width, prolong) <= tps.SMEM_MAX
        assert 32 <= plan.threads <= tps.STAGE_MAX_THREADS and plan.threads % 32 == 0
        for extent, size, count in zip((n, n, s), (plan.bi, plan.bj, plan.bk), plan.tiles):
            assert count == -(-extent // size) and (count - 1) * size < extent
        if n > tps.MSPLIT_STEPS_MAX_N:
            assert plan == tps._stage_plan(n, n_iter, H100_SMS, prolong=prolong)
            continue
        assert (plan.k_halo, plan.bk) == (0, s) and plan.blocks <= H100_SMS
        assert plan.threads == 32 * min(n, plan.bj + 2 * plan.halo)
        if n == 17:
            assert (plan.bi, plan.bj) == (1, 3)


def _check_stages(n, kind, n_iter, pins):
    """K22 (both orders) and K24 by the emulation against the plain
    versions, bit for bit, on pairs random at every slot."""
    h = 3e-4 / (n - 1)
    rng, e, r, ec = _fields(n, 10 * n + n_iter)
    packs, sgn_c = _pins(pins, n, rng)
    if pins == "random" or n == 17:
        assert bool(sgn_c.any())
    plan_of = _plans(kind, n)
    assert plan_of(min(n_iter, 2)).blocks > 1
    if kind == "k_tiles":
        assert plan_of(2).tiles[2] > 1
    for red_first in (True, False):
        got = _emulate_k22(*r, packs, h, n_iter, red_first, plan_of)
        want = tpms.mixed_rb_smooth_from_zero_msplit_plain(*r, packs, h, n_iter, red_first)
        assert _bitwise(got, want), red_first
    got = _emulate_k24(ec, *e, *r, packs, sgn_c, h, n_iter, plan_of)
    assert _bitwise(got, tpms.mixed_prolong_smooth_msplit_plain(ec, *e, *r, packs, sgn_c, h,
                                                                n_iter))


@pytest.mark.parametrize("pins", ["electrospray", "random"])
@pytest.mark.parametrize("n_iter", [1, 2])
@pytest.mark.parametrize("n,kind", CASES)
def test_emulated_msplit_stages_match_plain(n, kind, n_iter, pins):
    """K22 (both orders) and K24 at 9^3, 17^3 and 33^3, one launch each,
    on plans of several blocks in i and j (and k on the k tiles), with the
    electrospray's pins and random ones, nonzero coarse signs, on pairs
    random at every slot: bit for bit against the plain versions, every
    slot written once."""
    _check_stages(n, kind, n_iter, pins)


@pytest.mark.parametrize("pins", ["electrospray", "random"])
@pytest.mark.parametrize("n,kind", [(9, "tiny"), (17, "rows"), (17, "k_tiles")])
def test_emulated_msplit_stages_chain_past_two_iterations(n, kind, pins):
    """n_iter 3: a two-iteration launch (K22 from zero, K24 with its
    correction), then the stage on the pair so far, loaded."""
    _check_stages(n, kind, 3, pins)


def _faulty(n, kind, fault):
    """(K22 emulated with ``fault`` (None where the fault is the load, which
    K22 does not make) and its plain version, K24 likewise) at n_iter 2,
    the electrospray's pins and signs."""
    n_iter = 2
    h = 3e-4 / (n - 1)
    rng, e, r, ec = _fields(n, 5)
    packs, sgn_c = _pins("electrospray", n, rng)
    plan_of = _plans(kind, n)
    got22 = (None if fault == "fixed_first"
             else _emulate_k22(*r, packs, h, n_iter, True, plan_of, fault))
    return (got22, tpms.mixed_rb_smooth_from_zero_msplit_plain(*r, packs, h, n_iter, True),
            _emulate_k24(ec, *e, *r, packs, sgn_c, h, n_iter, plan_of, fault),
            tpms.mixed_prolong_smooth_msplit_plain(ec, *e, *r, packs, sgn_c, h, n_iter))


@pytest.mark.parametrize("fault", (None,) + FAULTS)
@pytest.mark.parametrize("n,kind", [(17, "rows"), (9, "tiny")])
def test_emulation_finds_a_faulty_schedule(n, kind, fault):
    """The emulation is a check: a face row stored at the first colour's
    step (it reads the other colour before that colour's last
    half-sweep), K10's load of the first colour only where no half-sweep
    rewrites it (the selects read its live slots as centres), or a k-edge
    neighbour read as 0 (the dead slot or the guard, as the Dirichlet
    stage reads it) in place of the select, each leaves a wrong value in
    the output of K24 and, but for the load (K22 loads nothing), of K22;
    the same plans without a fault equal the plain versions."""
    got22, want22, got24, want24 = _faulty(n, kind, fault)
    if fault is None:
        assert _bitwise(got22, want22) and _bitwise(got24, want24)
        return
    assert not _bitwise(got24, want24)
    if got22 is not None:
        assert not _bitwise(got22, want22)


def _check_k21(n, kind, n_iters, pins, seed):
    """K21 by the emulation against its plain version, bit for bit, both
    orders, on a pair random at every slot, boundary rows and dead slots
    too."""
    h = 3e-4 / (n - 1)
    rng, e, r, _ = _fields(n, seed)
    packs, _ = _pins(pins, n, rng)
    plan_of = _plans(kind, n)
    for n_iter in n_iters:
        for red_first in (True, False):
            got = _emulate_k21(*e, *r, packs, h, n_iter, red_first, plan_of)
            want = tpms.mixed_rb_smooth_msplit_plain(*e, *r, packs, h, n_iter, red_first)
            assert _bitwise(got, want), (n_iter, red_first)


@pytest.mark.parametrize("n,kind,pins", [(9, "h100", "electrospray"), (17, "rows", "random"),
                                         (17, "k_tiles", "electrospray")])
def test_emulated_k21_stage_matches_plain(n, kind, pins):
    """K21, the loaded stage, one launch at n_iter 1 and 2, both orders, on
    plans of several blocks (whole rows, k tiles; one a plane at 9^3),
    the electrospray's pins and random ones, on a pair random at its
    boundary rows and dead slots: bit for bit against the plain version,
    every slot written once."""
    assert _plans(kind, n)(2).blocks > 1
    _check_k21(n, kind, (1, 2), pins, 3 * n)


def test_emulated_k21_stage_chains_past_two_iterations():
    """n_iter 3: a two-iteration launch on the pair, then the stage on
    the pair so far, both orders."""
    _check_k21(9, "rows", (3,), "random", 4)


@pytest.mark.parametrize("fault", K21_FAULTS)
def test_emulated_k21_fails_with_a_fault(fault):
    """K21's launch from a zero tile (K22's) in place of its pair, or a
    j-face neighbour read from the tile's boundary row (random, not the
    BC) in place of the select, leaves a wrong value in the output."""
    n, n_iter = 9, 2
    h = 3e-4 / (n - 1)
    rng, e, r, _ = _fields(n, 6)
    packs, _ = _pins("electrospray", n, rng)
    want = tpms.mixed_rb_smooth_msplit_plain(*e, *r, packs, h, n_iter, True)
    got = _emulate_k21(*e, *r, packs, h, n_iter, True, _plans("rows", n), fault)
    assert not _bitwise(got, want)


# ------------------------------------------------- the wrappers on the CPU


def test_k22_k24_return_fresh_pairs_and_leave_their_inputs():
    """On the CPU the wrappers are the plain versions: fresh pairs (dead
    slots 0), the inputs as they were, no launch counted (K21's too);
    n_iter < 1 is refused."""
    n, h = 17, 3e-4 / 16
    rng, e, r, ec = _fields(n, 7)
    packs, sgn_c = _pins("random", n, rng)
    inputs = (*e, *r, ec, packs, sgn_c)
    before = [x.clone() for x in inputs]
    tpms.reset_launches()
    got24 = tpms.mixed_prolong_smooth_msplit(ec, *e, *r, packs, sgn_c, h, 2)
    got22 = tpms.mixed_rb_smooth_from_zero_msplit(*r, packs, h, 3, False)
    got21 = tpms.mixed_rb_smooth_msplit(*e, *r, packs, h, 3, False)
    assert _bitwise(inputs, before)
    assert all(g is not x for g in (*got21, *got22, *got24) for x in inputs)
    assert _bitwise(got24, tpms.mixed_prolong_smooth_msplit_plain(ec, *e, *r, packs, sgn_c, h, 2))
    assert _bitwise(got22, tpms.mixed_rb_smooth_from_zero_msplit_plain(*r, packs, h, 3, False))
    assert _bitwise(got21, tpms.mixed_rb_smooth_msplit_plain(*e, *r, packs, h, 3, False))
    _, live_r, live_b = tps._masks(n, "cpu")
    dead_r, dead_b = tps._slot_k(n, "cpu")[0] > n - 2, tps._slot_k(n, "cpu")[1] > n - 2
    for got in (got21, got22, got24):
        assert not got[0][dead_r].any() and not got[1][dead_b].any()
    assert not any(tpms.LAUNCHES.values())
    for call in (lambda: tpms.mixed_rb_smooth_from_zero_msplit(*r, packs, h, 0),
                 lambda: tpms.mixed_rb_smooth_msplit(*e, *r, packs, h, 0),
                 lambda: tpms.mixed_prolong_smooth_msplit(ec, *e, *r, packs, sgn_c, h, 0)):
        with pytest.raises(ValueError, match="n_iter"):
            call()
