"""The one-pass fold smoothing stages (K16 ``mixed_rb_smooth_fold``, K17
``mixed_rb_smooth_from_zero_fold`` and K19 ``mixed_prolong_smooth_fold``,
multigrid_parallel_tpu_torch.ops.pallas_mixed_fold) on the CPU: an
emulation of the CUDA kernels' schedule held against the plain versions,
and the wrappers' CPU contract.

The CUDA stage (ops/csrc/rect.cuh with FOLD, ``stage_body`` and
``box_body``) cannot run here, so its schedule is emulated in torch, block
by block, as the kernel runs it, on rect.cuh's tile: a field row (i, j) of
the fold layout (stored k = 1 .. n - 2) held as two colour rows of slots,
slot kk of a colour holding k = 2 kk + 1 + p, the k-face slots (k = 0 and
n - 1) holding no stored point; the plan's boxes with halos of 2 n_iter
planes and rows (and k_halo slots where k is tiled); tile planes filled
with NaN outside the loaded box and at the k-face slots, K17's tile all
zeros instead (K16's loaded from a field whose x and y faces hold NaN: only
its interior may be read); a ring of tile planes for each colour as deep as the
kernel's (a plane gone from a ring raises); K19's coarse planes in a ring
of 3 (the box: all of them), copied with the fine planes that first need
them, the coarse k faces as copies of the stored columns, and e + P ec of
each interior row as its plane arrives, the coarse x faces' k-face nodes
rebuilt as v + sgn * (the interior neighbour plane's value) from the ring;
the skewed wavefront (half-sweep s at plane p - 2 s once plane p has
arrived; a step's half-sweeps and store all read before any writes, as
the kernel runs them at once), each half-sweep on its region updating its
colour in place, the neighbours summed in the plain version's order, those
across a face (i, j or k at 1 or n - 2) selected as the slot's own value,
0 at a pinned x-face node; and the store with the BC pass: a step after
its last half-sweep, each interior plane's owned rows written with the
boundary nodes they are the copy source of (row 0 from row 1, plane 0
from plane 1, ..., 0 at a pinned x-face node). The emulation must equal
the plain versions bit for bit, and three faults of the schedule must
not: a halo one plane short, a face neighbour read from the tile's face
slot, and an x-face node stored before its source's last half-sweep. The
card tests hold the kernels themselves against the plain versions
(tests/test_torch_cuda.py).
"""

import numpy as np
import pytest
import torch

import multigrid_parallel_tpu_torch as tmg
from multigrid_parallel_tpu_torch.ops import pallas_mixed_fold as tpmf
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


def _deinterleave_fold(x):
    """(n, n, n - 2) fold field -> its colours by field colour (red,
    black), each (n, n, n // 2 + 1), slot kk at index kk + 1; NaN where a
    slot holds no stored point (the k faces and past the row)."""
    n = x.shape[0]
    out = []
    for k in _slot_k(n):
        ok = (k >= 1) & (k <= n - 2)
        vals = torch.gather(x, 2, (k - 1).clamp(0, n - 3))
        out.append(torch.where(ok, vals, torch.full_like(vals, NAN)))
    return out


def _by_stage(colours, color0):
    """(red, black) by stage colour, and back (the same swap)."""
    return list(colours) if color0 == RED else [colours[1], colours[0]]


def _coarse_full(ec):
    """The coarse fold correction as the kernel's coarse tile holds it: the
    grid's k = 0 .. nc - 1, the k faces copies of the stored columns."""
    return torch.cat([ec[..., :1], ec, ec[..., -1:]], dim=-1)


def _emulate_fold_launch(ins, fs, pin, color0, h, plan, coarse=None, fault=None):
    """One fold stage launch as the kernel runs it: stage_body's wavefront
    or, for a box plan, box_body. ``ins`` and ``fs`` are de-interleaved by
    stage colour ([0] the first half-sweep's colour, ``color0``), ``ins``
    None for K17's zero tile; ``pin`` the (2, n, n - 2) pin planes;
    ``coarse`` K19's (ec, sgn_c). ``fault`` names a broken schedule:
    "face_slot" reads the j-face neighbours from the tile, "early_store"
    writes the x-face planes at their own turn. Returns the fold output and
    how many times each of its points was written."""
    n, s = fs[0].shape[0], fs[0].shape[2] - 1
    big_h, levels = plan.halo, 2 * plan.n_iter
    depth = 2 * levels + 3  # each colour's ring (the wavefront)
    out = torch.full((n, n, n - 2), NAN)
    writes = torch.zeros((n, n, n - 2), dtype=torch.int32)
    width = plan.bk + 2 * plan.k_halo if plan.k_halo else -(-s // 4) * 4 + 4
    colours = (color0, 1 - color0)  # field colour of stage colour c
    if coarse is not None:
        ec_full, sgn_c = _coarse_full(coarse[0]), coarse[1]
        nc = ec_full.shape[0]
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
                tiles, ring = [{}, {}], {}
                cja, cka = ja >> 1, max(ka, 0)

                def par(q, j, c):
                    """p of stage colour c in row (q, j)."""
                    return ((q + j) % 2) ^ colours[c] ^ 1

                def load_coarse(q):
                    if coarse is None or (q != ia and q % 2 == 0):
                        return
                    for c in range(q >> 1 if q == ia else (q + 1) >> 1, ((q + 1) >> 1) + 1):
                        t = torch.full((nc, nc), NAN)
                        t[cja:(jb >> 1) + 1, cka:kb + 1] = ec_full[c, cja:(jb >> 1) + 1, cka:kb + 1]
                        ring[c] = t
                        if not plan.box:
                            ring.pop(c - 3, None)  # the ring slot coarse plane c takes

                def correct(q):
                    """K19's e + P ec on the interior rows of plane q."""
                    if coarse is None or not 1 <= q <= n - 2:
                        return
                    oi = q % 2
                    xf = 0 if q == 1 else (1 if q == n - 2 else None)
                    j = torch.arange(max(ja, 1), min(jb, n - 1))
                    if not len(j):
                        return
                    cj, oj = j >> 1, (j % 2 == 1)[:, None]
                    planes = [ring[q >> 1]] + ([ring[(q >> 1) + 1]] if oi else [])
                    y = []
                    for a, plane in enumerate(planes):
                        if xf == a:  # the coarse x face's k-face nodes, rebuilt
                            nbr, plane = planes[-1 - a], plane.clone()
                            for k, kk in ((0, 0), (nc - 1, nc - 3)):
                                plane[:, k] = plane[:, k] + sgn_c[xf, :, kk] * nbr[:, k]
                        y.append(torch.where(oj, 0.5 * plane[cj] + 0.5 * plane[cj + 1],
                                             plane[cj]))  # the j step
                    k = torch.arange(1, n - 1)  # the k step, then the i step
                    yk = [torch.where(k % 2 == 1, 0.5 * ya[:, k >> 1] + 0.5 * ya[:, (k >> 1) + 1],
                                      ya[:, k >> 1]) for ya in y]
                    corr = 0.5 * yk[0] + 0.5 * yk[1] if oi else yk[0]
                    for c in (0, 1):
                        p = par(q, j, c)[:, None]
                        kk = (k[None, :] - 1 - p) // 2
                        mine = ((k[None, :] - 1 - p) % 2 == 0) & (kk >= ka) & (kk < kb)
                        rr, _ = mine.nonzero(as_tuple=True)
                        at = (j[rr] - jb0, kk[mine] - kb0)
                        tiles[c][q][at] = tiles[c][q][at] + corr[mine]

                def load(q):
                    for c in (0, 1):
                        # one column past the tile: a slot's kk + 1 read at the last slot
                        t = torch.full((plan.bj + 2 * big_h, width + 1), NAN)
                        if ins is None:
                            t.zero_()
                        else:
                            t[rows, cols] = ins[c][q][box]
                        tiles[c][q] = t
                        if not plan.box:
                            tiles[c].pop(q - depth, None)  # the ring slot plane q takes
                    load_coarse(q)

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
                    cl = slice(kl - kb0, kh - kb0)
                    kk = torch.arange(kl, kh)[None, :]
                    j = torch.arange(jl, jh)[:, None]
                    p = par(q, j, c)
                    k = 2 * kk + 1 + p
                    cen = dst[r, cl]
                    left = mid[r, kl - kb0 - 1:kh - kb0 - 1]
                    right = mid[r, kl - kb0 + 1:kh - kb0 + 1]
                    k_lo = torch.where(k == 1, cen, torch.where(p == 0, left, mid[r, cl]))
                    k_hi = torch.where(k == n - 2, cen, torch.where(p == 0, mid[r, cl], right))
                    j_lo = mid[jl - jb0 - 1:jh - jb0 - 1, cl]
                    j_hi = mid[jl - jb0 + 1:jh - jb0 + 1, cl]
                    if fault != "face_slot":
                        j_lo = torch.where(j == 1, cen, j_lo)
                        j_hi = torch.where(j == n - 2, cen, j_hi)
                    i_lo, i_hi = lo[r, cl], hi[r, cl]
                    pk = (k - 1).clamp(0, n - 3)
                    if q == 1:
                        i_lo = torch.where(pin[0][j, pk] > 0.5, torch.zeros_like(cen), cen)
                    if q == n - 2:
                        i_hi = torch.where(pin[1][j, pk] > 0.5, torch.zeros_like(cen), cen)
                    acc = i_lo + i_hi + j_lo + j_hi + k_lo + k_hi
                    upd = (acc - (h * h) * fs[c][q, jl:jh, kl + 1:kh + 1]) * (1.0 / 6.0)
                    return dst, r, cl, torch.where(k <= n - 2, upd, cen)

                def store(q, planes=None):
                    """The nodes whose copy source lies in interior plane q
                    (``planes``: only those target planes): (target, value)
                    pairs, read now."""
                    jl, jh = max(j0, 1), min(j1, n - 1)
                    if not 1 <= q <= n - 2 or jl >= jh:
                        return []
                    targets = [q] + ([0] if q == 1 else []) + ([n - 1] if q == n - 2 else [])
                    jt = torch.arange(0 if jl == 1 else jl, n if jh == n - 1 else jh)[:, None]
                    js = jt.clamp(1, n - 2)  # each target row's source row
                    kk = torch.arange(-1, s)[None, :]
                    found = []
                    for qt in targets if planes is None else [t for t in targets if t in planes]:
                        for c in (0, 1):
                            k = 2 * kk + 1 + par(q, js, c)
                            mine = (k >= max(kr0, 1)) & (k < min(kr1, n - 1))
                            v = tiles[c][q][js - jb0, (kk - kb0).clamp(0, width)]
                            if qt != q:
                                pinned = pin[0 if qt == 0 else 1][jt, (k - 1).clamp(0, n - 3)]
                                v = torch.where(pinned > 0.5, torch.zeros_like(v), v)
                            rows = jt.expand_as(k)
                            found.append(((qt, rows[mine], k[mine] - 1), v[mine]))
                    return found

                def run(updates, stores=()):  # all of a step reads before any writes
                    for dst, r, cl, value in [u for u in updates if u is not None]:
                        dst[r, cl] = value
                    for idx, v in stores:
                        out[idx] = v
                        writes[idx] += 1

                def owned_store(q):
                    if fault == "early_store" and q in (1, n - 2):
                        return store(q, planes=[q])  # the x-face plane at its own turn instead
                    return store(q)

                def early(q):  # the fault: x-face plane q written at its own turn
                    if fault != "early_store" or q not in (0, n - 1):
                        return []
                    src = 1 if q == 0 else n - 2
                    if not i0 <= src < i1:
                        return []
                    return store(src, planes=[q])

                if plan.box:  # every plane, then the half-sweeps one by one
                    for q in range(ia, ib):
                        load(q)
                    for q in range(ia, ib):
                        correct(q)
                    for lvl in range(1, levels + 1):
                        if lvl == levels:  # the fault: x faces stored before the last half-sweep
                            faults = [st for q in (0, n - 1) if i0 <= q < i1 for st in early(q)]
                            run([], faults)
                        run([sweep(lvl, q) for q in range(ia, ib)])
                    run([], [st for q in range(i0, i1) for st in owned_store(q)])
                    continue
                load(ia)
                for p in range(ia, i1 + 2 * levels + 1):
                    if p + 1 < ib:
                        load(p + 1)
                    if p < ib:
                        correct(p)
                    qb = p - 1 - 2 * levels
                    stores = []
                    if i0 <= qb < i1:  # both colours' last half-sweeps finished a step ago
                        stores = owned_store(qb) + early(qb)
                    run([sweep(lvl, p - 2 * lvl) for lvl in range(1, levels + 1)], stores)
    return out, writes


def _stage_inputs(u, r, color0):
    fs = _by_stage(_deinterleave_fold(r), color0)
    return (None if u is None else _by_stage(_deinterleave_fold(u), color0)), fs


def _check_writes(writes):
    """Every stored point of the field written by exactly one block, once."""
    assert torch.equal(writes, torch.ones_like(writes))


def _emulate_k16(e, r, pin, h, n_iter, red_first, plan_of, fault=None):
    """K16: the fold stage on the loaded e, then on the field so far (e
    None: K17, its first launch from a zero tile)."""
    color0 = RED if red_first else BLACK
    u = e
    for chunk in tps._stage_chunks(n_iter):
        ins, fs = _stage_inputs(u, r, color0)
        u, writes = _emulate_fold_launch(ins, fs, pin, color0, h, plan_of(chunk), fault=fault)
        _check_writes(writes)
    return u


def _emulate_k17(r, pin, h, n_iter, red_first, plan_of, fault=None):
    return _emulate_k16(None, r, pin, h, n_iter, red_first, plan_of, fault)


def _emulate_k19(ec, e, r, pin, sgn_c, h, n_iter, plan_of, fault=None):
    u, coarse = e, (ec, sgn_c)
    for chunk in tps._stage_chunks(n_iter):
        ins, fs = _stage_inputs(u, r, BLACK)
        u, writes = _emulate_fold_launch(ins, fs, pin, BLACK, h, plan_of(chunk), coarse, fault)
        _check_writes(writes)
        coarse = None
    return u


def _plans(kind, n):
    """The plan of each launch size (n_iter 1, 2): the planner's for the
    H100's 132 SMs (a box up to 129^3), its wavefront's for 4 SMs, a box of
    5 planes by 4 rows, 7 planes by 8 whole rows on the wavefront, or
    4-slot k tiles with the 4-slot k halo by 12 rows and 11 planes
    (wavefront). The H100's plans at 9^3 and 17^3 are boxes of one plane
    (and one row): every x- and y-face node is written by the block of its
    source, not its own."""
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
        return tps.StagePlan(n, n_iter, halo, tps.STAGE_K_HALO, 11, 12, 4, 256, 0, True)

    return plan


def _fold_field(rng, n):
    """A fold field random at every stored point, the boundary too."""
    return torch.from_numpy(rng.standard_normal((n, n, n - 2)).astype(np.float32))


def _pins(kind, n, rng):
    """(fine pin planes (2, n, n - 2), coarse sign planes (2, nc, nc - 2)):
    the electrospray's at this level and the next coarser one, or random
    patch masks and random signs in {-1, 0, 1} (nonzero at the k-edge
    columns the kernel reads)."""
    nc = (n + 1) // 2
    if kind == "electrospray":
        es = tmg.electrospray_problem()
        return tpmf.fold_pin_planes(es, n, "cpu"), tpmf.fold_edge_sign_planes(es, nc, "cpu")
    pin = torch.from_numpy((rng.random((2, n, n - 2)) < 0.3).astype(np.float32))
    sgn = torch.from_numpy(rng.integers(-1, 2, (2, nc, nc - 2)).astype(np.float32))
    return pin, sgn


CASES = [(9, "h100"), (9, "wave"), (17, "h100"), (17, "rows"), (33, "box"), (33, "k_tiles")]


@pytest.mark.parametrize("pins", ["electrospray", "random"])
@pytest.mark.parametrize("n_iter", [1, 2])
@pytest.mark.parametrize("n,kind", CASES)
def test_emulated_fold_stages_match_plain(n, kind, n_iter, pins):
    """K17 (both orders) and K19 on the level sizes 9^3, 17^3 and 33^3,
    on box and wavefront plans with several blocks in i and j (and k at
    33^3), the electrospray's pins and random ones, nonzero coarse signs:
    bit for bit against the plain versions."""
    h = 3e-4 / (n - 1)
    rng = np.random.default_rng(10 * n + n_iter)
    pin, sgn_c = _pins(pins, n, rng)
    if pins == "random" or n == 17:
        assert bool(sgn_c.any())
    e, r, ec = _fold_field(rng, n), _fold_field(rng, n), _fold_field(rng, (n + 1) // 2)
    plan_of = _plans(kind, n)
    assert plan_of(n_iter).blocks > 1
    for red_first in (True, False):
        got = _emulate_k17(r, pin, h, n_iter, red_first, plan_of)
        want = tpmf.mixed_rb_smooth_from_zero_fold_plain(r, pin, h, n_iter, red_first)
        assert torch.equal(got, want), red_first
    got = _emulate_k19(ec, e, r, pin, sgn_c, h, n_iter, plan_of)
    assert torch.equal(got, tpmf.mixed_prolong_smooth_fold_plain(ec, e, r, pin, sgn_c, h, n_iter))


def _nan_faces(e):
    """e with NaN on its x and y faces."""
    e = e.clone()
    e[0] = e[-1] = NAN
    e[:, 0] = e[:, -1] = NAN
    return e


@pytest.mark.parametrize("n_iter", [1, 2, 3])
@pytest.mark.parametrize("n,kind", CASES)
def test_emulated_k16_on_a_loaded_field_with_nan_faces(n, kind, n_iter):
    """K16, the fold stage on a loaded e whose x and y faces hold NaN (the
    plain version rebuilds them by its BC pass first, so the stage may read
    only e's interior), both orders, n_iter 1-3 (3: a second launch on the
    field so far), on the plans of the K17 cases: bit for bit against the
    plain version, every stored point written once a launch."""
    h = 3e-4 / (n - 1)
    rng = np.random.default_rng(20 * n + n_iter)
    pin, _ = _pins("electrospray" if kind == "h100" else "random", n, rng)
    e, r = _nan_faces(_fold_field(rng, n)), _fold_field(rng, n)
    plan_of = _plans(kind, n)
    for red_first in (True, False):
        want = tpmf.mixed_rb_smooth_fold_plain(e, r, pin, h, n_iter, red_first)
        assert bool(torch.isfinite(want).all())
        got = _emulate_k16(e, r, pin, h, n_iter, red_first, plan_of)
        assert torch.equal(got, want), red_first


def test_emulated_fold_stages_chain_past_two_iterations():
    """n_iter 3: a two-iteration launch (K17 from zero, K19 with its
    correction), then the fold stage on the field so far."""
    n, h = 17, 3e-4 / 16
    rng = np.random.default_rng(3)
    pin, sgn_c = _pins("random", n, rng)
    e, r, ec = _fold_field(rng, n), _fold_field(rng, n), _fold_field(rng, 9)
    plan_of = _plans("rows", n)
    got = _emulate_k17(r, pin, h, 3, True, plan_of)
    assert torch.equal(got, tpmf.mixed_rb_smooth_from_zero_fold_plain(r, pin, h, 3, True))
    got = _emulate_k19(ec, e, r, pin, sgn_c, h, 3, plan_of)
    assert torch.equal(got, tpmf.mixed_prolong_smooth_fold_plain(ec, e, r, pin, sgn_c, h, 3))


@pytest.mark.parametrize("fault", ["short_halo", "face_slot", "early_store"])
@pytest.mark.parametrize("kind", ["rows", "box"])
def test_emulation_finds_a_faulty_schedule(kind, fault):
    """The emulation is a check: a halo one plane short, the j-face
    neighbours read from the tile's face row (a value of the input, stale
    after the first half-sweep), or the x-face planes stored before their
    source planes' last half-sweep, each leaves a wrong value in the
    output of K17 and of K19, on the wavefront and on the box; the same
    plans without the fault equal the plain versions."""
    n, n_iter = 17, 2
    h = 3e-4 / (n - 1)
    rng = np.random.default_rng(5)
    pin, sgn_c = _pins("electrospray", n, rng)
    e, r, ec = _fold_field(rng, n), _fold_field(rng, n), _fold_field(rng, 9)
    plan = _plans(kind, n)(n_iter)
    want17 = tpmf.mixed_rb_smooth_from_zero_fold_plain(r, pin, h, n_iter, True)
    want19 = tpmf.mixed_prolong_smooth_fold_plain(ec, e, r, pin, sgn_c, h, n_iter)
    assert torch.equal(_emulate_k17(r, pin, h, n_iter, True, lambda _: plan), want17)
    assert torch.equal(_emulate_k19(ec, e, r, pin, sgn_c, h, n_iter, lambda _: plan), want19)
    bad, broken = plan, None
    if fault == "short_halo":
        bad = plan._replace(halo=plan.halo - 1)
    else:
        broken = fault
    with pytest.raises(AssertionError):  # NaN or a stale value reaches the output
        assert torch.equal(_emulate_k17(r, pin, h, n_iter, True, lambda _: bad, broken), want17)
    with pytest.raises(AssertionError):
        assert torch.equal(_emulate_k19(ec, e, r, pin, sgn_c, h, n_iter, lambda _: bad, broken),
                           want19)


# ------------------------------------------------- the wrappers on the CPU


def test_k17_k19_return_fresh_fields_and_leave_their_inputs():
    """On the CPU the wrappers are the plain versions: fresh outputs (K16's
    too), the inputs as they were, no launch counted; n_iter < 1 is
    refused."""
    n, h = 17, 3e-4 / 16
    rng = np.random.default_rng(7)
    pin, sgn_c = _pins("random", n, rng)
    e, r, ec = _fold_field(rng, n), _fold_field(rng, n), _fold_field(rng, 9)
    before = [x.clone() for x in (e, r, ec, pin, sgn_c)]
    tpmf.reset_launches()
    got19 = tpmf.mixed_prolong_smooth_fold(ec, e, r, pin, sgn_c, h, 2)
    got17 = tpmf.mixed_rb_smooth_from_zero_fold(r, pin, h, 2)
    got16 = tpmf.mixed_rb_smooth_fold(e, r, pin, h, 2, False)
    assert all(torch.equal(a, b) for a, b in zip((e, r, ec, pin, sgn_c), before))
    assert got19 is not e and got17 is not r and got16 is not e
    assert torch.equal(got19, tpmf.mixed_prolong_smooth_fold_plain(ec, e, r, pin, sgn_c, h, 2))
    assert torch.equal(got17, tpmf.mixed_rb_smooth_from_zero_fold_plain(r, pin, h, 2))
    assert torch.equal(got16, tpmf.mixed_rb_smooth_fold_plain(e, r, pin, h, 2, False))
    assert not any(tpmf.LAUNCHES.values())
    for call in (lambda: tpmf.mixed_rb_smooth_from_zero_fold(r, pin, h, 0),
                 lambda: tpmf.mixed_rb_smooth_fold(e, r, pin, h, 0),
                 lambda: tpmf.mixed_prolong_smooth_fold(ec, e, r, pin, sgn_c, h, 0)):
        with pytest.raises(ValueError, match="n_iter"):
            call()
