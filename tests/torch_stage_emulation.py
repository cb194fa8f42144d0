"""A torch emulation of rect.cuh's mixed-BC one-pass stage, as the CUDA
kernels run it, shared by the stage tests (torch only): K13, K14 and K15 on
the full (n, n, n) layout (``Layout::kMixed``; tests/test_torch_mixed_stage.py)
and K34, K35 and K36 on one rank's segments of an i-sharded field (``kSeg``;
tests/test_torch_seg_stage.py); and of its Dirichlet stage on a rank's
segmented block, K31, K28 and K29 on an i-sharded field and K40, K37 and
K38 on an (i, j)-sharded one (``kSegRect``;
tests/test_torch_seg_rect_stage.py, below); and of the streaming
restriction (restrict.cuh) and the double-float residual-and-norm stage
(residual_df_norm_seg.cu, K32 and K41; tests/test_torch_seg_df_stage.py)
further below; and of split.cuh's stage (K7, K8 and K10 on the pair,
tests/test_torch_split_stage.py; K42 on the packed array, its plane pitch
and order of additions, through the colours' addresses, ``Rows``) at the
end. The Dirichlet launch also emulates K26 (``r_outs``: K1's stage with
halos one deeper that writes the residual of its result;
tests/test_torch_rect_stage.py).

The stage runs block by block on rect.cuh's tile: a field row (i, j) held
as two colour rows of slots, slot kk of a colour holding k = 2 kk + 1 + p,
the k-face slots (k = 0 and n - 1) holding the loaded face values (a zero
tile: zeros); the plan's boxes with halos of 2 n_iter planes and rows (and
k_halo slots where k is tiled); tile planes filled with NaN outside the
loaded box, a zero tile all zeros instead; a ring of tile planes for each
colour as deep as the kernel's (a plane gone from a ring raises); K15's and
K36's e + P ec on every point of each plane as it arrives (K4's step, the
coarse boundary live); the skewed wavefront (half-sweep s at plane p - 2 s
once plane p has arrived; a step's half-sweeps and store all read before
any writes, as the kernel runs them at once), or the box (every plane, then
the half-sweeps one by one), each half-sweep on its region updating its
colour in place, the neighbours summed in the plain version's order, those
across a face (i, j or k at 1 or n - 2) selected as the slot's own value, 0
at a pinned x-face node; and the store with the BC pass: a step after its
last half-sweep, each interior plane's owned rows written with the boundary
nodes they are the copy source of (k = 0 from k = 1, row 0 from row 1,
plane 0 from plane 1, ..., 0 at a pinned x-face node, the pin read at the
node's own (j, k)).

On a segment (``span``) the fields are VIRTUAL: (N, n, n) arrays, N >= n,
whose plane q is global plane q, holding a rank's rows where its segments
have them and NaN everywhere else, so that a read outside the segment
shows in the output. The blocks tile the planes [c0, c1) and store only
target planes [o0, o1); the loaded box is clipped to the field's planes [0,
n) only, as the kernel's is.
"""

from typing import NamedTuple

import numpy as np
import torch

import multigrid_parallel_tpu_torch as tmg
from multigrid_parallel_tpu_torch.ops import pallas3d as tpk
from multigrid_parallel_tpu_torch.ops import pallas_mixed as tpm
from multigrid_parallel_tpu_torch.ops import pallas_sharded as tpx
from multigrid_parallel_tpu_torch.ops import pallas_split as tps
from multigrid_parallel_tpu_torch.ops.stencils_3d import BLACK, RED

NAN = float("nan")


# ------------------------------------------------------ the layout, emulated


def _slot_k(n, planes=None, rows=None):
    """(k_red, k_black), each (planes, rows, n // 2 + 1): the k that slot
    kk - 1 of the colour holds in row (i, j), k = 2 kk - 1 + p (planes,
    rows: n)."""
    i, idx = torch.arange(planes or n), torch.arange(rows or n)
    q = (i[:, None, None] + idx[None, :, None]) % 2
    kk = torch.arange(-1, n // 2)[None, None, :]
    return 2 * kk + 1 + q, 2 * kk + 2 - q


def deinterleave(x):
    """(planes, rows, n) field -> its colours by field colour (red, black),
    each (planes, rows, n // 2 + 1), slot kk at index kk + 1; NaN where a
    slot holds no point of the field."""
    n = x.shape[2]
    out = []
    for k in _slot_k(n, x.shape[0], x.shape[1]):
        ok = (k >= 0) & (k < n)
        vals = torch.gather(x, 2, k.clamp(0, n - 1))
        out.append(torch.where(ok, vals, torch.full_like(vals, NAN)))
    return out


def interleave(colours, n):
    """deinterleave's inverse: colours by field colour -> the (planes,
    rows, n) field."""
    planes, rows = colours[0].shape[:2]
    out = torch.full((planes, rows, n), NAN)
    for x, k in zip(colours, _slot_k(n, planes, rows)):
        ok = (k >= 0) & (k < n)
        out[ok.nonzero(as_tuple=True)[:2] + (k[ok],)] = x[ok]
    return out


def by_stage(colours, color0):
    """(red, black) by stage colour, and back (the same swap)."""
    return list(colours) if color0 == RED else [colours[1], colours[0]]


class Span(NamedTuple):
    """The planes a launch's blocks tile, [c0, c1), and the target planes
    its stores write, [o0, o1) (rect.cuh, seg_geometry)."""
    c0: int
    c1: int
    o0: int
    o1: int


def emulate_launch(ins, fs, pin, color0, h, plan, corr=None, fault=None, span=None, mem=None):
    """One mixed stage launch as the kernel runs it: stage_body's wavefront
    or, for a box plan, box_body. ``ins``, ``fs`` and ``corr`` (K15's P ec,
    or None) are de-interleaved by stage colour ([0] the first half-sweep's
    colour, ``color0``), ``ins`` None for a zero tile; ``pin`` the (2, n, n)
    pin planes. ``span``: a segment's planes (the full field's by default);
    ``mem``: the (N, n, n) input as device memory holds it, for the fault
    that reads it. ``fault`` names a broken schedule: "k_face_slot" reads
    the k-face neighbours from the tile's k-face slots, "early_x" writes the
    x-face planes at their own turn, "early_z" the z faces a step before
    their source's last half-sweep, "n1_from_memory" stores plane n - 1 of a
    rank that does not own plane n - 2 from ``mem`` in place of the tile,
    "pad_swept" tiles, loads, sweeps and stores the planes past n - 1 as
    interior ones (the span's c1 and o1 then its last plane). Returns the
    (N, n, n) output and how many times each of its points was written."""
    n, s = pin.shape[1], fs[0].shape[2] - 1
    planes_n = fs[0].shape[0]
    c0, c1, o0, o1 = span or (0, n, 0, n)
    pad_swept = fault == "pad_swept"
    edge = planes_n if pad_swept else n  # the planes a box is clipped to
    big_h, levels = plan.halo, 2 * plan.n_iter
    depth = 2 * levels + 3  # each colour's ring (the wavefront)
    out = torch.full((planes_n, n, n), NAN)
    writes = torch.zeros((planes_n, n, n), dtype=torch.int32)
    width = plan.bk + 2 * plan.k_halo if plan.k_halo else -(-s // 4) * 4 + 4
    colours = (color0, 1 - color0)  # field colour of stage colour c
    _, nj, nk = plan.tiles
    for ti in range(-(-(c1 - c0) // plan.bi)):
        for tj in range(nj):
            for tk in range(nk):
                i0 = c0 + ti * plan.bi
                i1 = min(i0 + plan.bi, c1)
                j0, j1 = tj * plan.bj, min(tj * plan.bj + plan.bj, n)
                k0, k1 = tk * plan.bk, min(tk * plan.bk + plan.bk, s)
                jb0, kb0 = j0 - big_h, (k0 - plan.k_halo if plan.k_halo else -4)
                ia, ib = max(i0 - big_h, 0), min(i1 + big_h, edge)
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

                def in_region(lvl, q):
                    top = min(i1 + big_h - lvl, n - 1)
                    if max(i0 - big_h + lvl, 1) <= q < top:
                        return True
                    return pad_swept and n <= q < min(i1 + big_h - lvl, planes_n - 1)

                def sweep(lvl, q):
                    """Half-sweep lvl's update of plane q: (tile, rows, cols,
                    value), or None outside its region."""
                    c = (lvl - 1) % 2
                    if not in_region(lvl, q):
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
                    z-face columns, or all but them), targets in [o0, o1):
                    (target, value) pairs, read now."""
                    jl, jh = max(j0, 1), min(j1, n - 1)
                    if not (1 <= q <= n - 2 or pad_swept and q >= n) or jl >= jh:
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
                        if not o0 <= qt < o1:
                            continue  # another rank's node
                        val = v
                        if fault == "n1_from_memory" and qt == n - 1 and not o0 <= q < o1:
                            val = mem[q][js, ks]  # the source's row as device memory holds it
                        if qt != q:
                            pinned = pin[0 if qt == 0 else 1][jt, kt]
                            val = torch.where(pinned > 0.5, torch.zeros_like(val), val)
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


def check_writes(writes):
    """Every point of the field written by exactly one block, once."""
    assert torch.equal(writes, torch.ones_like(writes))


def prolongation(ec, order=(1, 2, 0)):
    """P ec: the trilinear interpolation of a coarse field (j, then k, then
    i, as the plain versions make it; ``order``: the axes in another
    order), NaN where a coarse plane is NaN."""
    t = ec
    for axis in order:
        t = tpk._interp_axis(t, axis)
    return t


def emulate_k14(r, pin, h, n_iter, red_first, plan_of, fault=None, e=None):
    """K14 from a zero tile (``e`` None) or K13 with e loaded, then the
    stage on the field so far. The fault "zero_tile" starts K13's first
    launch from a zero tile in place of e."""
    color0 = RED if red_first else BLACK
    fs, u = by_stage(deinterleave(r), color0), e
    for chunk in tps._stage_chunks(n_iter):
        zero = u is None or fault == "zero_tile" and u is e
        ins = None if zero else by_stage(deinterleave(u), color0)
        u, writes = emulate_launch(ins, fs, pin, color0, h, plan_of(chunk), fault=fault)
        check_writes(writes)
    return u


def emulate_k15(ec, e, r, pin, h, n_iter, plan_of, fault=None):
    """K15: e + P ec made as planes arrive, then the stage (black first);
    past n_iter 2 the stage on the field so far."""
    fs, u = by_stage(deinterleave(r), BLACK), e
    corr = by_stage(deinterleave(prolongation(ec)), BLACK)
    for chunk in tps._stage_chunks(n_iter):
        u, writes = emulate_launch(by_stage(deinterleave(u), BLACK), fs, pin, BLACK, h,
                                   plan_of(chunk), corr, fault)
        check_writes(writes)
        corr = None
    return u


# ----------------------------------------------------------- segments


def _virtual(rows, first, planes):
    """(planes, m, m): ``rows`` (a slab whose row 0 is global plane
    ``first``) at their global planes, NaN at every other plane (rank 0's
    negative halo planes dropped)."""
    out = torch.full((planes,) + tuple(rows.shape[1:]), NAN)
    lo, hi = max(first, 0), min(first + rows.shape[0], planes)
    if hi > lo:
        out[lo:hi] = rows[lo - first:hi - first]
    return out


def seg_span(g0, L, n):
    """rect.cuh's seg_geometry: the planes a rank's launch tiles and the
    planes whose nodes it stores."""
    last = g0 == n - 1
    o1 = min(g0 + L, n) if g0 < n else g0
    return Span(g0 - last, o1 if g0 < n else g0 - last, g0, o1)


def emulate_seg(f3, pin, gi0, h, n_iter, n, L, plan, kl, red_first=True, e3=None, ec3=None,
                fault=None):
    """K35 (``e3`` None: a zero tile, ``red_first``), K34 (``e3`` the loaded
    u, no ``ec3``, ``red_first``) or K36 (black first, e + P ec as planes
    arrive) on one rank's segments as the kernel runs it: the fine triples
    read with ``kl`` left halo planes (the wrappers' rule is
    tpm._stage_kl) and 2 n_iter on the right, the coarse one with kl -
    n_iter and n_iter + 1, as virtual fields; one launch on ``plan`` over
    seg_span's planes, then the pad rows (past n - 1) written, 0 for K35
    and e's (u's) rows for K34 and K36. Beside emulate_launch's faults,
    "zero_tile" starts K34 from a zero tile in place of u, and "pad_zero"
    writes K34's and K36's pad rows 0. Returns the (L, n, n) body and each
    point's writes."""
    hh, g0 = 2 * n_iter, tpx._gi0_int(gi0) + 2 * n_iter
    f = tpx._seg(f3, kl, hh, L)
    planes = max(n, g0 + L + hh)
    fv = _virtual(f.rows(kl, hh), g0 - kl, planes)
    span = seg_span(g0, L, n)
    if fault == "pad_swept":
        span = Span(span.c0, g0 + L, g0, g0 + L)
    color0, corr = (RED if red_first and ec3 is None else BLACK), None
    if e3 is None:
        ins, mem = None, torch.zeros_like(fv)
    else:
        e = tpx._seg(e3, kl, hh, L)
        mem = _virtual(e.rows(kl, hh), g0 - kl, planes)
        ins = None if fault == "zero_tile" else by_stage(deinterleave(mem), color0)
    if ec3 is not None:
        kc, lc = kl - n_iter, L // 2
        c = tpx._seg(ec3, kc, n_iter + 1, lc)
        cv = _virtual(c.rows(kc, n_iter + 1), g0 // 2 - kc, (planes + 2) // 2)
        t = prolongation(cv)[:planes]
        t[n:] = 0.0  # pad planes take no correction
        corr = by_stage(deinterleave(t), color0)
    fs = by_stage(deinterleave(fv), color0)
    out, writes = emulate_launch(ins, fs, pin, color0, h, plan, corr, fault, span, mem)
    body, w = out[g0:g0 + L].clone(), writes[g0:g0 + L].clone()
    if fault != "pad_swept":  # every block's share of the pad rows
        t0 = span.o1 - g0
        body[t0:] = 0.0 if e3 is None or fault == "pad_zero" else e.body[t0:]
        w[t0:] += 1
    return body, w


# ------------------------------------------------------ inputs of the tests


def field(rng, n, planes=None):
    """A field random at every point, the boundary too."""
    return torch.from_numpy(rng.standard_normal((planes or n, n, n)).astype(np.float32))


def pins(kind, n, rng):
    """The (2, n, n) pin planes: the electrospray's at this level, or a
    random patch mask, the k = 0 and n - 1 columns included."""
    if kind == "electrospray":
        return tpm.dirichlet_pin_planes(tmg.electrospray_problem(), n, "cpu")
    pin = torch.from_numpy((rng.random((2, n, n)) < 0.3).astype(np.float32))
    assert bool(pin[:, :, 0].any()) and bool(pin[:, :, n - 1].any())
    return pin


# ------------------------------------- the Dirichlet stage on segments


def emulate_dirichlet_launch(ins, fs, color0, h, plan, n, span=None, cols=None, corr=None,
                             fault=None, r_outs=None):
    """One Dirichlet stage launch as the kernel runs it (rect.cuh with
    ``Layout::kRect`` for K1, K2 and K4 on the whole field, or
    ``Layout::kSegRect`` for K28, K29, K31, K37, K38 and K40 on a rank's
    block: stage_body's wavefront or, for a box plan, box_body) on (P, C,
    n) fields whose plane and row indices are the global ones (a rank's
    VIRTUAL fields). ``ins`` (the initial guess, e; zeros for a zero
    tile), ``fs`` (f, r) and ``corr`` (P ec, or None) are de-interleaved by
    stage colour; the blocks tile the planes ``span`` = (c0, c1) and the
    rows ``cols`` = (cj0, cj1) (by default the field's; a rank's clipped to
    n - 1), their
    loaded boxes clipped to the field [0, n) only; each half-sweep updates
    its region (the loaded box shrunk by its level, clipped to the
    interior) in place, the neighbours read from the tile in the plain
    version's order, no boundary node swept; the store writes both colours
    of the owned box, boundary nodes included. ``fault`` "pad_swept"
    tiles, loads, sweeps and stores the rows and planes past n - 1 as
    interior ones (the spans then the rank's whole body). Returns the
    outputs by stage colour (NaN where not stored) and each slot's writes.

    ``r_outs`` (K26, rect.cuh with RESID: K1's stage that also writes the
    residual of its result): two NaN tensors by stage colour, de-interleaved
    as ``ins``, into which each owned point's residual f - (1/h^2)(sum6 -
    6 u') is written (0 on the boundary), the neighbours read from the
    tile planes q - 1 .. q + 1 of the other colour in neighbor_sum's order;
    the rings two planes deeper, plane q's u' and r stored a step after
    plane q + 1's last half-sweep (the box: after its last half-sweep).
    The halo is the plan's (H + 1 for K26). ``fault`` "resid_early" takes
    plane q's residual (and stores it) a step sooner, before plane q + 1's
    last half-sweep (the box: before its last half-sweep); "resid_boundary"
    leaves r unwritten at the boundary points."""
    s = n // 2
    planes_n, rows_n = ins[0].shape[:2]
    (c0, c1), (cj0, cj1) = span or (0, n), cols or (0, n)
    edge_i, edge_j = (planes_n, rows_n) if fault == "pad_swept" else (n, n)
    big_h, levels = plan.halo, 2 * plan.n_iter
    resid = r_outs is not None
    depth = 2 * levels + 3 + 2 * resid  # each colour's ring (the wavefront)
    inv_h2 = 1.0 / (h * h)
    outs = [torch.full_like(x, NAN) for x in ins]
    writes = torch.zeros((2,) + ins[0].shape, dtype=torch.int32)
    width = plan.bk + 2 * plan.k_halo if plan.k_halo else -(-s // 4) * 4 + 4
    nk = plan.tiles[2]
    for ti in range(max(1, -(-(c1 - c0) // plan.bi))):
        for tj in range(max(1, -(-(cj1 - cj0) // plan.bj))):
            for tk in range(nk):
                i0 = c0 + ti * plan.bi
                i1 = min(i0 + plan.bi, c1)
                j0 = cj0 + tj * plan.bj
                j1 = min(j0 + plan.bj, cj1)
                if i0 >= i1 or j0 >= j1:
                    continue  # a pad rank's block
                k0, k1 = tk * plan.bk, min(tk * plan.bk + plan.bk, s)
                jb0, kb0 = j0 - big_h, (k0 - plan.k_halo if plan.k_halo else -4)
                ia, ib = max(i0 - big_h, 0), min(i1 + big_h, edge_i)
                ja, jb = max(jb0, 0), min(j1 + big_h, edge_j)
                ka, kb = max(kb0, -1), min(k1 + plan.k_halo, s)
                rows, kcols = slice(ja - jb0, jb - jb0), slice(ka - kb0, kb - kb0)
                box = (slice(ja, jb), slice(ka + 1, kb + 1))
                tiles = [{}, {}]

                def load(q):
                    for c in (0, 1):
                        # one column past the tile: a slot's kk + 1 read at the last slot
                        t = torch.full((plan.bj + 2 * big_h, width + 1), NAN)
                        t[rows, kcols] = ins[c][q][box]
                        if corr is not None:  # e + P ec as the plane arrives
                            t[rows, kcols] = t[rows, kcols] + corr[c][q][box]
                        tiles[c][q] = t
                        if not plan.box:
                            tiles[c].pop(q - depth, None)  # the ring slot plane q takes

                def sweep(lvl, q):
                    c = (lvl - 1) % 2
                    if not max(i0 - big_h + lvl, 1) <= q < min(i1 + big_h - lvl, edge_i - 1):
                        return None
                    color = color0 if c == 0 else 1 - color0
                    jl, jh = max(jb0 + lvl, 1), min(j1 + big_h - lvl, edge_j - 1)
                    kl = 0 if k0 == 0 else k0 - plan.k_halo + lvl
                    kh = s if k1 == s else k1 + plan.k_halo - lvl
                    if jh <= jl or kh <= kl:
                        return None
                    lo, mid, hi = tiles[1 - c][q - 1], tiles[1 - c][q], tiles[1 - c][q + 1]
                    r = slice(jl - jb0, jh - jb0)
                    cl = slice(kl - kb0, kh - kb0)
                    kk = torch.arange(kl, kh)[None, :]
                    j = torch.arange(jl, jh)[:, None]
                    par = ((q + j) % 2) ^ color ^ 1
                    left = mid[r, kl - kb0 - 1:kh - kb0 - 1]
                    right = mid[r, kl - kb0 + 1:kh - kb0 + 1]
                    k_lo = torch.where(par == 0, left, mid[r, cl])
                    k_hi = torch.where(par == 0, mid[r, cl], right)
                    r_lo = slice(jl - jb0 - 1, jh - jb0 - 1)
                    r_hi = slice(jl - jb0 + 1, jh - jb0 + 1)
                    acc = lo[r, cl] + hi[r, cl] + mid[r_lo, cl] + mid[r_hi, cl] + k_lo + k_hi
                    upd = (acc - (h * h) * fs[c][q, jl:jh, kl + 1:kh + 1]) * (1.0 / 6.0)
                    live = 2 * kk + 1 + par <= n - 2
                    dst = tiles[c][q]
                    return dst, r, cl, torch.where(live, upd, dst[r, cl])

                def run(updates):  # all of a step (or half-sweep) reads before any writes
                    for dst, r, cl, value in [u for u in updates if u is not None]:
                        dst[r, cl] = value

                def store(q):
                    lo_slot = -1 if k0 == 0 else k0  # a block owns k = 0 with slot 0
                    for c in (0, 1):
                        outs[c][q, j0:j1, lo_slot + 1:k1 + 1] = tiles[c][q][
                            j0 - jb0:j1 - jb0, lo_slot - kb0:k1 - kb0]
                        writes[c, q, j0:j1, lo_slot + 1:k1 + 1] += 1

                def residual(q):  # K26: r of the owned points of plane q
                    lo_slot = -1 if k0 == 0 else k0
                    r = slice(j0 - jb0, j1 - jb0)
                    cl = slice(lo_slot - kb0, k1 - kb0)
                    kk = torch.arange(lo_slot, k1)[None, :]
                    j = torch.arange(j0, j1)[:, None]
                    for c in (0, 1):
                        par = ((q + j) % 2) ^ (color0 if c == 0 else 1 - color0) ^ 1
                        k = 2 * kk + 1 + par
                        inner = (j >= 1) & (j <= n - 2) & (k >= 1) & (k <= n - 2) & (
                            1 <= q <= n - 2)
                        value = torch.zeros(inner.shape)
                        if 1 <= q <= n - 2:  # a boundary plane reads no neighbour
                            lo, mid, hi = tiles[1 - c][q - 1], tiles[1 - c][q], tiles[1 - c][q + 1]
                            own = tiles[c][q][r, cl]
                            left = mid[r, lo_slot - kb0 - 1:k1 - kb0 - 1]
                            right = mid[r, lo_slot - kb0 + 1:k1 - kb0 + 1]
                            k_lo = torch.where(par == 0, left, mid[r, cl])
                            k_hi = torch.where(par == 0, mid[r, cl], right)
                            r_lo = slice(j0 - jb0 - 1, j1 - jb0 - 1)
                            r_hi = slice(j0 - jb0 + 1, j1 - jb0 + 1)
                            acc = lo[r, cl] + hi[r, cl] + mid[r_lo, cl] + mid[r_hi, cl] + k_lo + k_hi
                            f = fs[c][q, j0:j1, lo_slot + 1:k1 + 1]
                            value = torch.where(inner, f - inv_h2 * (acc - 6.0 * own), value)
                        dst = r_outs[c][q, j0:j1, lo_slot + 1:k1 + 1]
                        keep = inner if fault == "resid_boundary" else torch.ones_like(inner)
                        dst.copy_(torch.where(keep, value, dst))

                early = resid and fault == "resid_early"
                if plan.box:  # every plane, then the half-sweeps one by one
                    for q in range(ia, ib):
                        load(q)
                    for lvl in range(1, levels + 1):
                        if early and lvl == levels:
                            for q in range(i0, i1):
                                residual(q)
                        run([sweep(lvl, q) for q in range(ia, ib)])
                    for q in range(i0, i1):
                        store(q)
                        if resid and not early:
                            residual(q)
                    continue
                # K26 stores plane q a step later than K1: once plane q + 1 is final too
                late = 1 if resid and not early else 0
                load(ia)
                for p in range(ia, i1 + 2 * levels + 1 + late):
                    if p + 1 < ib:
                        load(p + 1)
                    q = p - 1 - 2 * levels - late
                    if early and i0 <= q < i1:  # before this step's half-sweeps write
                        store(q)
                        residual(q)
                    run([sweep(lvl, p - 2 * lvl) for lvl in range(1, levels + 1)])
                    if not early and i0 <= q < i1:  # both colours' last half-sweeps done
                        store(q)
                        if resid:
                            residual(q)
    return outs, writes


def virtual2d(slab, first, shape):
    """(planes, rows, m): ``slab`` (its point [0, 0] at GLOBAL (plane, row)
    ``first``) at its global indices, NaN everywhere else (negative halo
    indices dropped)."""
    out = torch.full(tuple(shape) + tuple(slab.shape[2:]), NAN)
    (g, gj), (p, c) = first, slab.shape[:2]
    lo, hi = max(g, 0), min(g + p, shape[0])
    lo_j, hi_j = max(gj, 0), min(gj + c, shape[1])
    if hi > lo and hi_j > lo_j:
        out[lo:hi, lo_j:hi_j] = slab[lo - g:hi - g, lo_j - gj:hi_j - gj]
    return out


def emulate_seg_rect(e_slab, r_slab, c_slab, first, c_first, body, n, n_iter, h, plan,
                     fault=None, red_first=False):
    """K31 (i-sharded: rows whole) or K40 ((i, j)-sharded) on one rank's
    block as the kernel runs it: the fine slabs e and r (their point [0, 0]
    at GLOBAL (plane, row) ``first``) and the coarse one (at ``c_first``)
    read as virtual fields, NaN outside them; one Dirichlet stage launch,
    black first, e + P ec made as planes arrive, its blocks tiling the
    rank's planes and rows clipped to n - 1 (rect.cuh, seg_rect_geometry);
    then the pad points of the body (past n - 1) written as e + P ec. With
    ``c_slab`` None, K28 or K37: K1's stage on u = ``e_slab`` against f =
    ``r_slab``, red first where ``red_first``, the pad points u's own; with
    ``e_slab`` None too, K29 or K38: K2's stage from a zero tile (the loaded
    box all zeros, nothing of u read), the pad points 0. ``body`` = (g0, L,
    gj0, Lj). ``fault``: "pad_swept" (the pad swept as interior and stored
    by the blocks), "order" (P ec interpolated i, then j, then k; K28, K29,
    K37 and K38: the colours in the other order), "pad_unwritten" (no
    block writes the pad points). Returns the (L, Lj, n) body and each
    point's writes."""
    g0, L, gj0, Lj = body
    hh = 2 * n_iter
    shape = (g0 + L + 2 * hh + 2, max(n, gj0 + Lj + 2 * hh + 2))
    rv = virtual2d(r_slab, first, shape)
    ev = torch.zeros_like(rv) if e_slab is None else virtual2d(e_slab, first, shape)
    if c_slab is None:
        color0 = (RED if red_first else BLACK) if fault != "order" else (
            BLACK if red_first else RED)
        u, corr = ev, None
    else:
        color0 = BLACK
        cshape = (shape[0] // 2 + 1, shape[1] // 2 + 1)
        cv = virtual2d(c_slab, c_first, cshape)
        t = prolongation(cv, (0, 1, 2) if fault == "order" else (1, 2, 0))[:shape[0], :shape[1]]
        u, corr = ev + t, by_stage(deinterleave(t), color0)
    span = (g0, min(g0 + L, n) if g0 < n else g0)
    cols = (gj0, min(gj0 + Lj, n) if gj0 < n else gj0)
    if fault == "pad_swept":
        span, cols = (g0, g0 + L), (gj0, gj0 + Lj)
    outs, writes = emulate_dirichlet_launch(
        by_stage(deinterleave(ev), color0), by_stage(deinterleave(rv), color0), color0, h, plan,
        n, span, cols, corr, fault)
    out = interleave(by_stage(outs, color0), n)
    w = interleave(by_stage([x.float() for x in writes], color0), n)
    pad = torch.ones(shape[:2], dtype=torch.bool)
    pad[:n, :n] = False
    if fault not in ("pad_swept", "pad_unwritten"):  # every block's share of the pad points
        out[pad] = u[pad]
        w[pad] += 1
    sl = (slice(g0, g0 + L), slice(gj0, gj0 + Lj))
    return out[sl].clone(), w[sl].clone()


# ---------------------------------- the streaming restriction stage (restrict.cuh)
#
# K3 (a plain field), K9 (a split pair), K18 (the fold layout), and K30 and
# K39 (K3's tile on one rank's segmented block, restrict.cuh's SegLayout):
# a block's box of interior coarse points, its tile planes filled with NaN
# outside the footprint it loads (e with one row and one k, or the 16-byte
# slot windows, of halo; r without), one NaN column past each side of a
# tile row; each plane in the kernel's slot of a ring of three e planes and
# two r planes (a plane read from a slot that another has taken raises);
# the e of the plane before at each point held from the step before; each
# fine residual computed once, in the plain version's neighbour order;
# K9's k taps within the fine row; the i taps as a running partial closed
# by plane 2 ci + 1; the j (and K3's k) taps from the closed plane; the
# zeros; and each coarse point written by one block.


class SegRestrict(NamedTuple):
    """A segment launch (K30, K39): e and r given as slabs whose point
    [oi, oj] is local (plane 0, row 0) of the rank's block, NaN past what
    its segments hold; the coarse block's lc rows of ljc columns; the local
    interior coarse rows [c0, c1) and columns [cj0, cj1) its blocks tile
    (all 0 for a rank without interior coarse points)."""
    oi: int
    oj: int
    lc: int
    ljc: int
    c0: int
    c1: int
    cj0: int
    cj1: int


def seg_restrict(n, g0, L, oi, oj, gj0=None, Lj=None):
    """SegRestrict of a rank's block from the global fine row g0 of body
    row 0 and L rows (and, on an (i, j) block, gj0 and Lj columns; else
    the j axis whole), as restrict.cuh's seg_setup makes it."""
    nc = (n + 1) // 2

    def span(cg0, length):
        return max(0, 1 - cg0), min(length, nc - 1 - cg0)

    lc, ljc = L // 2, nc if Lj is None else Lj // 2
    (c0, c1), (cj0, cj1) = span(g0 // 2, lc), span(0 if Lj is None else gj0 // 2, ljc)
    if c1 <= c0 or cj1 <= cj0:
        c0 = c1 = cj0 = cj1 = 0
    return SegRestrict(oi, oj, lc, ljc, c0, c1, cj0, cj1)


def nan_padded(slab, pad):
    """slab with ``pad`` NaN planes and rows before and after it (its
    point [0, 0] at [pad, pad])."""
    out = torch.full((slab.shape[0] + 2 * pad, slab.shape[1] + 2 * pad) + tuple(slab.shape[2:]),
                     NAN)
    out[pad:pad + slab.shape[0], pad:pad + slab.shape[1]] = slab
    return out


def restrict_geometry(plan, ti, tj, tk, box=None):
    """restrict.cuh, geometry: the block's owned interior coarse box, its
    cone's fine rows and residual points a row, and the loaded windows
    (K18's in slots: fine k k at slot k - 1, clipped to the n - 2 stored).
    ``box``: ((c0, c1), (cj0, cj1)), the local interior rows and columns a
    segment launch tiles; else the level's [1, nc - 1)."""
    n = plan.n
    nc, s = (n + 1) // 2, (n - 1) // 2
    m = nc - 2
    g = {"n": n, "nc": nc, "S": s}
    (ai, bi), (aj, bj) = box or ((1, nc - 1), (1, nc - 1))
    for ax, t, b, lo, hi in (("i", ti, plan.bci, ai, bi), ("j", tj, plan.bcj, aj, bj),
                             ("k", tk, plan.bck, 1, nc - 1)):
        g[f"c{ax}0"] = lo + t * b
        g[f"c{ax}1"] = min(lo + t * b + b, hi)
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


def emulate_restrict(plan, e, r, h, e_halo_rows=1, close_last=True, k_edge_select=True,
                     seg=None, fault=None, msplit=False):
    """One launch of the restriction stage as the kernel runs it. ``e``
    and ``r`` are tuples of one field (K3, K18; K30, K39: a slab as
    ``seg`` says) or of the pair (red, black) (K9; K23 where ``msplit``,
    on K9's plan: the residual's O terms k - 1 before k + 1, the k-edge
    neighbours selects of the point's own value, the coarse fold out).
    ``e_halo_rows`` 0 loads e without its first halo row, ``close_last``
    False leaves the last fine plane of each box out of the i taps of its
    last coarse plane, ``k_edge_select`` False reads K18's k-edge
    neighbours from the tile (K23's as K9 reads them: the guard's 0 and
    the dead slot), ``fault`` "order" applies the k taps before the j taps,
    "pad_unwritten" leaves a segment block's rows past its interior
    columns unwritten, "k9_row" stores K23's coarse rows as K9's (coarse k
    at ck of rows of nc, in the fold's memory) and "k9_order" sums K23's
    O terms in K9's order (all must fail). Returns the coarse field (a
    segment's (lc, ljc, nc) block) and how many blocks wrote each point."""
    n, split = plan.n, plan.split
    assert split or not msplit, "K23 runs on a split plan"
    nc = (n + 1) // 2
    inv_h2 = 1.0 / (h * h)
    we, wr, wa = tps._restrict_widths(plan.bck, split)
    re_, rr_ = 2 * plan.bcj + 3, 2 * plan.bcj + 1
    if seg is not None:
        shape = (seg.lc, seg.ljc, nc)
    else:
        shape = (nc, nc, nc - 2) if plan.fold or msplit else (nc, nc, nc)
    out = torch.full(shape, NAN)
    writes = torch.zeros(shape, dtype=torch.int32)
    box = None
    if seg is not None:
        _seg_zero_planes(out, writes, seg)
        if seg.c1 <= seg.c0:
            return out, writes  # one block: its zeros only
        box = ((seg.c0, seg.c1), (seg.cj0, seg.cj1))
        m = nc - 2
        tiles = (-(-(seg.c1 - seg.c0) // plan.bci), -(-(seg.cj1 - seg.cj0) // plan.bcj),
                 -(-m // plan.bck))
    else:
        tiles = plan.tiles
    ni, nj, nk = tiles
    for ti in range(ni):
        for tj in range(nj):
            for tk in range(nk):
                g = restrict_geometry(plan, ti, tj, tk, box)
                if seg is not None:
                    _seg_zero_block(out, writes, g, seg, fault)
                else:
                    _zero_boundary(out, writes, g, plan.fold or msplit)
                _emulate_block(plan, g, e, r, inv_h2, out, writes, (we, wr, wa), (re_, rr_),
                               e_halo_rows, close_last, k_edge_select, seg, fault, msplit)
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


def _seg_zero_planes(out, writes, seg):
    """restrict.cuh, seg_zero_planes: the coarse planes outside [c0, c1)
    of the rank's block."""
    for rows in (slice(0, seg.c0), slice(seg.c1, seg.lc)):
        out[rows] = 0.0
        writes[rows] += 1


def _seg_zero_block(out, writes, g, seg, fault=None):
    """SegLayout::zero's share of a block: in its planes, the points off
    the interior of its box widened to the block's edge on each side that
    reaches the end of the interior: whole rows off [cj0, cj1), else the k
    ends ("pad_unwritten": the rows past cj1 left out)."""
    nc = g["nc"]
    ja = 0 if g["cj0"] == seg.cj0 else g["cj0"]
    jb = seg.ljc if g["cj1"] == seg.cj1 else g["cj1"]
    k_lo, k_hi = g["ck0"] == 1, g["ck1"] == nc - 1
    ka, kb = (0 if k_lo else g["ck0"]), (nc if k_hi else g["ck1"])
    planes = slice(g["ci0"], g["ci1"])
    for cj in range(ja, jb):
        if cj < seg.cj0 or cj >= seg.cj1:
            if fault == "pad_unwritten" and cj >= seg.cj1:
                continue
            out[planes, cj, ka:kb] = 0.0
            writes[planes, cj, ka:kb] += 1
        else:
            for ck in [0] * k_lo + [nc - 1] * k_hi:
                out[planes, cj, ck] = 0.0
                writes[planes, cj, ck] += 1


def _emulate_block(plan, g, e, r, inv_h2, out, writes, widths, tile_rows, e_halo_rows,
                   close_last, k_edge_select, seg=None, fault=None, msplit=False):
    split, fold = plan.split, plan.fold
    we, wr, wa = widths
    re_, rr_ = tile_rows
    colours = len(e)
    oi, oj = (seg.oi, seg.oj) if seg is not None else (0, 0)
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
        the field (a segment's slab at its offsets), tile row 0 at field
        row jt, field column c0 at tile column ``col``; NaN elsewhere, one
        NaN column past each side."""
        assert q + oi >= 0 and j0 + oj >= 0, "a read before the slab"
        tile = torch.full((colours, nrows, width + 2), NAN)
        for c in range(colours):
            tile[c, j0 - jt:j1 - jt, col:col + c1 - c0] = fields[c][q + oi, j0 + oj:j1 + oj,
                                                                    c0:c1]
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
                cen = mid[own, a + 1, ke]
                s = lo + hi[other, a + 1, ke]
                s = s + mid[other, a, ke]
                s = s + mid[other, a + 2, ke]
                if msplit and pc == 0:
                    # K23's O: k - 1 (slot kk - 1), then k + 1 (slot kk), the
                    # k faces' BC copies the point's own value (without the
                    # selects K9's reads: the guard's 0, the dead slot)
                    km = torch.where(kk > 0, mid[other, a + 1, ke - 1],
                                     cen if k_edge_select else 0.0)
                    kp = mid[other, a + 1, ke]
                    if k_edge_select:
                        kp = torch.where(kk + 1 < s_, kp, cen)
                    first, second = (kp, km) if fault == "k9_order" else (km, kp)
                    s = s + first
                    s = s + second
                else:
                    s = s + mid[other, a + 1, ke]
                    if pc == 0:
                        s = s + torch.where(kk > 0, mid[other, a + 1, ke - 1], 0.0)
                    else:
                        s = s + torch.where(kk + 1 < s_, mid[other, a + 1, ke + 1], 0.0)
                return rt[own, a, kr] - inv_h2 * (s - 6.0 * cen)

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
        if p % 2 != 0:  # p = 2 ci - 1 opens ci and closes ci - 1
            q = 0.25 * x
            if ci > g["ci0"]:
                plane = torch.full((rr_, wa), NAN)
                closed = acc if (p == p1 and not close_last) else acc + q
                plane[:rows, :x.shape[1]] = closed
                _coarse_rows(plane, g, ci - 1, split, out, writes, fold or msplit, fault)
            acc = q
        else:
            acc = acc + 0.5 * x


def x_cols(split, pts):
    """Columns of A a fine row's i-tapped values take: the k-tapped ones
    of the split row (pts - 1), or the row's fine k."""
    return pts - 1 if split else pts


def _coarse_rows(plane, g, ci, split, out, writes, fold=False, fault=None):
    """The closed plane's j taps (then K3's and K18's k taps) into coarse
    plane ci (K18, K23: coarse k at slot ck - 1; "order": the k taps first;
    "k9_row": K23's rows at K9's coarse k ck of rows of nc, in the fold's
    memory, what lies past its end dropped)."""
    cj0, cj1, ck0, ck1 = g["cj0"], g["cj1"], g["ck0"], g["ck1"]
    nr, nk = cj1 - cj0, ck1 - ck0
    if split:
        y = _tap3(plane[0:2 * nr:2], plane[1:2 * nr + 1:2], plane[2:2 * nr + 2:2])
        v = y[:, :nk]
    elif fault == "order":
        y = _tap3(plane[:, 0:2 * nk:2], plane[:, 1:2 * nk + 1:2], plane[:, 2:2 * nk + 2:2])
        v = _tap3(y[0:2 * nr:2], y[1:2 * nr + 1:2], y[2:2 * nr + 2:2])
    else:
        y = _tap3(plane[0:2 * nr:2], plane[1:2 * nr + 1:2], plane[2:2 * nr + 2:2])
        v = _tap3(y[:, 0:2 * nk:2], y[:, 1:2 * nk + 1:2], y[:, 2:2 * nk + 2:2])
    if fault == "k9_row":
        nc = g["nc"]
        at = ((ci * nc + torch.arange(cj0, cj1)[:, None]) * nc
              + torch.arange(ck0, ck1)[None, :]).reshape(-1)
        inside = at < out.numel()
        out.view(-1)[at[inside]] = v.reshape(-1)[inside]
        writes.view(-1)[at[inside]] += 1
        return
    ks = slice(ck0 - 1, ck1 - 1) if fold else slice(ck0, ck1)
    out[ci, cj0:cj1, ks] = v
    writes[ci, cj0:cj1, ks] += 1


# ----------------------------- the double-float residual-and-norm stage
# (K32 and K41: residual_df_norm_seg.cu, df_stage_kernel), emulated as the
# kernel runs it on a rank's segmented block: the blocks tile the rank's
# interior planes, rows and k on the plan (bi planes x bj rows x bk k, k
# fastest, then j, then i); a block streams its planes through a ring of
# DF_RING tile planes of u_hi and u_lo (rows ja - 1 .. jb and k ka - 1 ..
# kb, copied from a slab of the rank's segments at local indices, NaN past
# what they hold; a plane read from a slot that another has taken raises),
# the plane before at each point held from the step before, f read at the
# owned points, K5's compensated residual in nbr_sum order; the zeros of
# the planes outside the interior and, around each box, of its boundary
# rows, pad columns and k ends; each thread's f64 sum of squares (lane l
# of warp w the points ka + l + 32 c of row ja + w), planes in order, then
# its chunks; the block's warp tree and its warps in order; and the sum of
# the partials, 1,024 strided sums and their tree.


class DfSeg(NamedTuple):
    """A K32 or K41 launch: u_hi and u_lo given as slabs whose point [oi,
    oj] is local (plane 0, row 0) of the rank's (L, Lj, n) block (Lj = n on
    an i-sharded one), NaN past what its segments hold; the local interior
    planes [t0, t1) and rows [j0, j1) (all 0 for a rank without interior
    points)."""
    oi: int
    oj: int
    L: int
    Lj: int
    t0: int
    t1: int
    j0: int
    j1: int


def df_seg(n, g0, L, oi, oj, gj0=None, Lj=None):
    """DfSeg of a rank's block from the global plane g0 of body row 0 and L
    rows (and, on an (i, j) block, gj0 and Lj columns; else the j axis
    whole), as residual_df_norm_seg.cu's df_setup makes it."""
    t0, t1 = max(0, 1 - g0), min(L, n - 1 - g0)
    if Lj is None:
        Lj, j0, j1 = n, 1, n - 1
    else:
        j0, j1 = max(0, 1 - gj0), min(Lj, n - 1 - gj0)
    if t1 <= t0 or j1 <= j0:
        t0 = t1 = j0 = j1 = 0
    return DfSeg(oi, oj, L, Lj, t0, t1, j0, j1)


def _warp_tree(v):
    """A warp's sum of its lanes' values (..., 32), as the kernel's
    __shfl_down_sync tree leaves it in lane 0."""
    for o in (16, 8, 4, 2, 1):
        v = v[..., :o] + v[..., o:2 * o]
    return v[..., 0]


def _sum_partials(partials):
    """eft.cuh's sum_partials_kernel: 1,024 threads each summing the
    partials q = t, t + 1,024, ... in order, then their tree."""
    m = partials.shape[0]
    acc = torch.zeros(1024, dtype=torch.float64)
    for q0 in range(0, m, 1024):
        chunk = partials[q0:q0 + 1024]
        acc[:chunk.shape[0]] = acc[:chunk.shape[0]] + chunk
    w = 512
    while w:
        acc = acc[:w] + acc[w:2 * w]
        w //= 2
    return acc[0]


def emulate_df(plan, uh, ul, fh, fl, h, seg, fault=None):
    """One K32 or K41 launch on ``plan`` (a pallas_split.DfPlan; its rows
    and cols are the rank's interior ones, anything for a rank without
    them). ``uh`` and ``ul`` are slabs as ``seg`` says; ``fh`` and ``fl``
    the owned (L, Lj, n) bodies. ``fault``: "ring_early" starts copying
    plane p + 2 into the ring slot of plane p, one plane early;
    "k_wrap" takes the k + 1 neighbour of a chunk's lane 31 from its lane 0
    and the k - 1 one of its lane 0 from its lane 31 (a warp shuffle that
    wraps); "pad_unwritten" leaves the planes past the interior unwritten
    (all must fail). Returns (r, how many times each point was written,
    the f32 norm)."""
    n, inv_h2 = plan.n, 1.0 / (h * h)
    out, writes = _launch_out(seg, n, fault)
    if seg.t1 <= seg.t0:
        blocks = tps._df_zero_blocks(seg.L * seg.Lj * n, plan.threads)
        return out, writes, _sum_partials(torch.zeros(blocks, dtype=torch.float64)).float()

    def value(p, jj, kk, c, nbrs):  # K5's EFT residual, a field each of c's and nbrs' first axis
        return tpk._eft_residual(fh[p, jj, kk], fl[p, jj, kk], c[0], [x[0] for x in nbrs], c[1],
                                 [x[1] for x in nbrs], inv_h2)

    partials = [_warps_in_order(_warp_tree(acc))
                for acc in _stream(plan, (uh, ul), seg, out, writes, fault, value)]
    return out, writes, _sum_partials(torch.tensor(partials, dtype=torch.float64)).float()


def emulate_resid(plan, u, f, h, seg, fault=None):
    """One K33 launch (residual.cu, resid_stage_kernel) on ``plan`` (a
    pallas_split.DfPlan of one field): K32's stream with u alone in the
    ring, R's arithmetic f - (1/h^2) (nbr - 6 u), the neighbours in
    seg_nbr_sum's order, and no norm. ``u`` is a slab as ``seg`` says, ``f``
    the owned (L, n, n) body; ``fault`` as emulate_df's ("ring_early",
    "pad_unwritten"). Returns (r, how many times each point was written)."""
    n, inv_h2 = plan.n, 1.0 / (h * h)
    out, writes = _launch_out(seg, n, fault)
    if seg.t1 > seg.t0:
        def value(p, jj, kk, c, nbrs):
            s = nbrs[0][0]
            for x in nbrs[1:]:
                s = s + x[0]
            return f[p, jj, kk] - inv_h2 * (s - 6.0 * c[0])

        for _ in _stream(plan, (u,), seg, out, writes, fault, value):
            pass
    return out, writes


def _launch_out(seg, n, fault):
    """A launch's output, NaN but for the planes outside the interior,
    which are 0 (those past it left unwritten under "pad_unwritten"), and
    how many times each point was written."""
    shape = (seg.L, seg.Lj, n)
    out = torch.full(shape, NAN)
    writes = torch.zeros(shape, dtype=torch.int32)
    planes = [slice(0, seg.t0), slice(seg.t1, seg.L)]
    if fault == "pad_unwritten":
        planes = planes[:1]
    for rows in planes:
        out[rows] = 0.0
        writes[rows] += 1
    return out, writes


def _stream(plan, us, seg, out, writes, fault, value):
    """Each block of a K32, K41 or K33 launch on the rank's interior: its
    zeros, then its stream of the fields ``us`` (slabs as ``seg`` says)
    through the ring, ``value(p, rows, ks, c, nbrs)`` the residual of plane
    p's box rows and k from the tile values c and the six neighbours nbrs
    (each with a leading field axis). Yields each block's threads' f64 sums
    of squares, (bj, 32)."""
    n = plan.n
    ring_w = -(-(plan.bk + 2) // 4) * 4
    ni, nj, nk = (-(-(seg.t1 - seg.t0) // plan.bi), -(-(seg.j1 - seg.j0) // plan.bj),
                  -(-(n - 2) // plan.bk))
    for ti in range(ni):
        for tj in range(nj):
            for tk in range(nk):
                ta = seg.t0 + ti * plan.bi
                tb = min(ta + plan.bi, seg.t1)
                ja = seg.j0 + tj * plan.bj
                jb = min(ja + plan.bj, seg.j1)
                ka = 1 + tk * plan.bk
                kb = min(ka + plan.bk, n - 1)
                _df_zero_box(out, writes, seg, n, ta, tb, ja, jb, ka, kb)
                yield _df_block(plan, us, seg, ta, tb, ja, jb, ka, kb, ring_w, out, writes,
                                fault, value)


def _warps_in_order(per_warp):
    s = per_warp[0]
    for w in range(1, per_warp.shape[0]):
        s = s + per_warp[w]
    return float(s)


def _df_zero_box(out, writes, seg, n, ta, tb, ja, jb, ka, kb):
    """The block's zeros in its planes: rows off [j0, j1) of its box
    widened to the block's edges where it reaches them, else the k ends."""
    jlo = 0 if ja == seg.j0 else ja
    jhi = seg.Lj if jb == seg.j1 else jb
    klo, khi = (0 if ka == 1 else ka), (n if kb == n - 1 else kb)
    for j in range(jlo, jhi):
        if j < seg.j0 or j >= seg.j1:
            out[ta:tb, j, klo:khi] = 0.0
            writes[ta:tb, j, klo:khi] += 1
        else:
            for k in [0] * (ka == 1) + [n - 1] * (kb == n - 1):
                out[ta:tb, j, k] = 0.0
                writes[ta:tb, j, k] += 1


def _df_block(plan, us, seg, ta, tb, ja, jb, ka, kb, ring_w, out, writes, fault, value):
    """One block's stream; returns its threads' f64 sums, (bj, 32)."""
    rows, pts, chunks = jb - ja, kb - ka, plan.chunks
    slots = [None] * tps.DF_RING

    def slot(q):
        return (q - ta + 1) % tps.DF_RING

    def load(q, into):
        assert q + seg.oi >= 0 and ja - 1 + seg.oj >= 0, "a read before the slab"
        tiles = torch.full((len(us), plan.bj + 2, ring_w), NAN)
        for c, u in enumerate(us):
            tiles[c, :rows + 2, :pts + 2] = u[q + seg.oi, ja - 1 + seg.oj:jb + 1 + seg.oj,
                                             ka - 1:kb + 1]
        slots[into] = (q, tiles)

    def held(q):
        plane, tiles = slots[slot(q)]
        if fault is None:
            assert plane == q, (plane, q)
        return tiles

    for q in range(ta - 1, ta + 2):
        load(q, slot(q))
    lane = torch.arange(pts) % 32
    first = held(ta - 1)
    prev = first[:, 1:rows + 1, 1:pts + 1]
    acc = torch.zeros((plan.bj, 32), dtype=torch.float64)  # a thread's sum
    for p in range(ta, tb):
        if p + 2 <= tb:
            load(p + 2, slot(p) if fault == "ring_early" else slot(p + 2))
        mid, hi = held(p), held(p + 1)
        c = mid[:, 1:rows + 1, 1:pts + 1]
        left, right = mid[:, 1:rows + 1, 0:pts], mid[:, 1:rows + 1, 2:pts + 2]
        if fault == "k_wrap":
            b = torch.arange(pts)
            right = torch.where(lane == 31, c[..., (b - 31).clamp(min=0)], right)
            wraps = (lane == 0) & (b + 31 < pts)
            left = torch.where(wraps, c[..., torch.where(wraps, b + 31, b)], left)
        nbrs = [prev, hi[:, 1:rows + 1, 1:pts + 1], mid[:, 0:rows, 1:pts + 1],
                mid[:, 2:rows + 2, 1:pts + 1], left, right]
        v = value(p, slice(ja, jb), slice(ka, kb), c, nbrs)
        out[p, ja:jb, ka:kb] = v
        writes[p, ja:jb, ka:kb] += 1
        sq = torch.zeros((plan.bj, chunks * 32), dtype=torch.float64)
        sq[:rows, :pts] = v.double() * v.double()
        for ch in range(chunks):  # the thread's chunks in order
            acc = acc + sq[:, ch * 32:(ch + 1) * 32]
        prev = c
    return acc


# ------------------------------------- the split stage (K7, K8, K10, K42)


class Rows(NamedTuple):
    """One colour's rows as split.cuh's stage addresses them (row_at): row
    (q, j) at flat offset base + (q * pitch + j) * S of ``flat``, a 1-D
    view of its tensor. A pair colour: base 0, pitch n; K42's packed
    array: base 0 (red) or n S (black), pitch 2 n."""
    flat: torch.Tensor
    base: int
    pitch: int
    S: int

    def index(self, q, ja, jb, ka, kb):
        j = torch.arange(ja, jb)[:, None]
        return self.base + (q * self.pitch + j) * self.S + torch.arange(ka, kb)[None, :]

    def get(self, q, ja, jb, ka, kb):
        return self.flat[self.index(q, ja, jb, ka, kb)]

    def put(self, q, ja, jb, ka, kb, value):
        self.flat[self.index(q, ja, jb, ka, kb)] = value


def pair_rows(x):
    """A pair colour's (n, n, S) contiguous tensor as Rows."""
    n, _, s = x.shape
    return Rows(x.view(-1), 0, n, s)


def emulate_split_launch(ins, fs, outs, color0, h, plan, n, prep=None, from_zero=False,
                         order="split"):
    """One split.cuh stage launch as stage_body runs it. ``ins``, ``fs``
    and ``outs`` are Rows by stage colour ([0] the first half-sweep's
    colour, ``color0``), read and written only through their addresses;
    ``prep(c, q, rows, cols, tile)`` corrects a newly loaded tile plane;
    ``from_zero`` (K8): the tile planes start as zeros, nothing read from
    ``ins`` (the kernel zeros whole tile planes; what lies outside the
    loaded box stays NaN here, as no half-sweep may read it). The first
    colour's live slots load as NaN: no half-sweep may read them before it
    rewrites them. The half-sweeps of a step (and the correction of its new
    plane) run as if at once: all of them read the tiles before any writes.
    ``order``: "split", the pair kernels' six adds one at a time, or
    "packed", K42's (the i and j terms, then the same-slot value plus the
    other k neighbour as one term). Returns how many blocks wrote each slot
    of colour 0, (n, n, S)."""
    s = (n - 1) // 2
    dtype = ins[0].flat.dtype
    live0 = tps._masks(n, "cpu")[1 if color0 == RED else 2]
    big_h, levels = plan.halo, 2 * plan.n_iter
    depth = 2 * levels + 3  # each colour's ring
    writes = torch.zeros((n, n, s), dtype=torch.int32)
    width = plan.bk + 2 * plan.k_halo if plan.k_halo else s
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
                rows, cols = slice(ja - jb0, jb - jb0), slice(ka - kb0, kb - kb0)
                ring = [{}, {}]

                def load(q):
                    for c in (0, 1):
                        t = torch.full((plan.bj + 2 * big_h, width), NAN, dtype=dtype)
                        box = ins[c].get(q, ja, jb, ka, kb)
                        if from_zero:
                            box = torch.zeros_like(box)
                        elif c == 0:  # only the slots that no half-sweep updates
                            box = torch.where(live0[q, ja:jb, ka:kb],
                                              torch.full_like(box, NAN), box)
                        t[rows, cols] = box
                        ring[c][q] = t
                        ring[c].pop(q - depth, None)  # the slot plane q takes

                load(ia)
                for p in range(ia, i1 + 2 * levels + 1):
                    if p + 1 < ib:
                        load(p + 1)
                    updates = []
                    for lvl in range(1, levels + 1):
                        c, q = (lvl - 1) % 2, p - 2 * lvl
                        if not max(i0 - big_h + lvl, 1) <= q < min(i1 + big_h - lvl, n - 1):
                            continue
                        color = color0 if c == 0 else 1 - color0
                        jl, jh = max(jb0 + lvl, 1), min(j1 + big_h - lvl, n - 1)
                        kl = 0 if k0 == 0 else k0 - plan.k_halo + lvl
                        kh = s if k1 == s else k1 + plan.k_halo - lvl
                        if jh <= jl or kh <= kl:  # an empty region (a halo too short)
                            continue
                        lo, mid, hi = ring[1 - c][q - 1], ring[1 - c][q], ring[1 - c][q + 1]
                        r = slice(jl - jb0, jh - jb0)
                        cl = slice(kl - kb0, kh - kb0)
                        kk = torch.arange(kl, kh)[None, :]
                        j = torch.arange(jl, jh)[:, None]
                        par = ((q + j) % 2) ^ color ^ 1
                        left = torch.full_like(mid[r, cl], NAN)
                        right = torch.full_like(mid[r, cl], NAN)
                        lc = max(kl - kb0 - 1, 0)
                        left[:, lc - (kl - kb0 - 1):] = mid[r, lc:kh - kb0 - 1]
                        rc = min(kh - kb0 + 1, width)
                        right[:, :rc - (kl - kb0 + 1)] = mid[r, kl - kb0 + 1:rc]
                        zero = torch.zeros_like(left)
                        last = torch.where(par == 0, torch.where(kk > 0, left, zero),
                                           torch.where(kk + 1 < s, right, zero))
                        r_lo = slice(jl - jb0 - 1, jh - jb0 - 1)
                        r_hi = slice(jl - jb0 + 1, jh - jb0 + 1)
                        acc = lo[r, cl] + hi[r, cl] + mid[r_lo, cl] + mid[r_hi, cl]
                        if order == "packed":
                            acc = acc + (mid[r, cl] + last)
                        else:
                            acc = acc + mid[r, cl] + last
                        upd = (acc - (h * h) * fs[c].get(q, jl, jh, kl, kh)) * (1.0 / 6.0)
                        live = 2 * kk + 1 + par <= n - 2
                        dst = ring[c][q]
                        updates.append((dst, r, cl, torch.where(live, upd, dst[r, cl])))
                    if prep is not None and p < ib:
                        for c in (0, 1):
                            prep(c, p, (ja, jb), (ka, kb), ring[c][p][rows, cols])
                    for dst, r, cl, value in updates:
                        dst[r, cl] = value
                    # each colour's last half-sweep finished a step ago
                    for c, q in ((0, p - 1 - 2 * (levels - 1)), (1, p - 1 - 2 * levels)):
                        if i0 <= q < i1:
                            outs[c].put(q, j0, j1, k0, k1,
                                        ring[c][q][j0 - jb0:j1 - jb0, k0 - kb0:k1 - kb0])
                            if c == 0:
                                writes[q, j0:j1, k0:k1] += 1
    return writes


def emulate_k42(u2, f2, h, n_iter, red_first, plan_of, fault=None):
    """K42 (rb_smooth_splitcolor.cu): K7's stage on the packed (n, 2 n, S)
    array, chunk after chunk (pallas_split._stage_chunks), each launch into
    a fresh NaN array; ``plan_of(n_iter)`` gives each launch's plan (K7's).
    ``fault`` "order": the pair kernels' order of additions; "pitch": the
    pair's plane pitch of n S (for the loads, f and the stores). Returns
    the result and each launch's writes."""
    n = u2.shape[0]
    s = (n - 1) // 2
    color0 = RED if red_first else BLACK
    pitch = n if fault == "pitch" else 2 * n

    def rows(x, c):  # stage colour c's half of the packed array x
        color = color0 if c == 0 else 1 - color0
        return Rows(x.view(-1), (0 if color == RED else 1) * n * s, pitch, s)

    writes = []
    for chunk in tps._stage_chunks(n_iter):
        out = torch.full_like(u2, NAN)
        writes.append(emulate_split_launch(
            [rows(u2, c) for c in (0, 1)], [rows(f2, c) for c in (0, 1)],
            [rows(out, c) for c in (0, 1)], color0, h, plan_of(chunk), n,
            order="split" if fault == "order" else "packed"))
        u2 = out
    return u2, writes
