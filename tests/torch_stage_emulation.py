"""A torch emulation of rect.cuh's mixed-BC one-pass stage, as the CUDA
kernels run it, shared by the stage tests (torch only): K14 and K15 on the
full (n, n, n) layout (``Layout::kMixed``; tests/test_torch_mixed_stage.py)
and K35 and K36 on one rank's segments of an i-sharded field (``kSeg``;
tests/test_torch_seg_stage.py); and of its Dirichlet stage on a rank's
segmented block, K31 on an i-sharded field and K40 on an (i, j)-sharded
one (``kSegRect``; tests/test_torch_seg_rect_stage.py, below).

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


def emulate_k14(r, pin, h, n_iter, red_first, plan_of, fault=None):
    """K14 from a zero tile, then the stage on the field so far."""
    color0 = RED if red_first else BLACK
    fs, u = by_stage(deinterleave(r), color0), None
    for chunk in tps._stage_chunks(n_iter):
        ins = None if u is None else by_stage(deinterleave(u), color0)
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
    """K35 (``e3`` None: a zero tile, ``red_first``) or K36 (black first, e
    + P ec as planes arrive) on one rank's segments as the kernel runs it:
    the fine triples read with ``kl`` left halo planes (the wrappers' rule
    is tpm._stage_kl) and 2 n_iter on the right, the coarse one with kl -
    n_iter and n_iter + 1, as virtual fields; one launch on ``plan`` over
    seg_span's planes, then the pad rows (past n - 1) written, 0 for K35
    and e's rows for K36. Returns the (L, n, n) body and each point's
    writes."""
    hh, g0 = 2 * n_iter, tpx._gi0_int(gi0) + 2 * n_iter
    f = tpx._seg(f3, kl, hh, L)
    planes = max(n, g0 + L + hh)
    fv = _virtual(f.rows(kl, hh), g0 - kl, planes)
    span = seg_span(g0, L, n)
    if fault == "pad_swept":
        span = Span(span.c0, g0 + L, g0, g0 + L)
    if e3 is None:
        color0, ins, corr, mem = (RED if red_first else BLACK), None, None, torch.zeros_like(fv)
    else:
        color0 = BLACK
        e = tpx._seg(e3, kl, hh, L)
        mem = _virtual(e.rows(kl, hh), g0 - kl, planes)
        ins = by_stage(deinterleave(mem), color0)
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
        body[t0:] = 0.0 if e3 is None else e.body[t0:]
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
                             fault=None):
    """One Dirichlet stage launch as the kernel runs it (rect.cuh with
    ``Layout::kRect`` for K1, K2 and K4 on the whole field, or
    ``Layout::kSegRect`` for K31 and K40 on a rank's block: stage_body's
    wavefront or, for a box plan, box_body) on (P, C, n) fields whose plane
    and row indices are the global ones (a rank's VIRTUAL fields). ``ins``
    (the initial guess, e), ``fs`` (f, r) and ``corr`` (P ec, or None) are
    de-interleaved by stage colour; the blocks tile the planes ``span`` =
    (c0, c1) and the rows ``cols`` = (cj0, cj1) (by default the field's; a
    rank's clipped to n - 1), their loaded boxes clipped to the field [0,
    n) only; each half-sweep
    updates its region (the loaded box shrunk by its level, clipped to the
    interior) in place, the neighbours read from the tile in the plain
    version's order, no boundary node swept; the store writes both colours
    of the owned box, boundary nodes included. ``fault`` "pad_swept" tiles,
    loads, sweeps and stores the rows and planes past n - 1 as interior ones
    (the spans then the rank's whole body). Returns the outputs by stage
    colour (NaN where not stored) and each slot's writes."""
    s = n // 2
    planes_n, rows_n = ins[0].shape[:2]
    (c0, c1), (cj0, cj1) = span or (0, n), cols or (0, n)
    edge_i, edge_j = (planes_n, rows_n) if fault == "pad_swept" else (n, n)
    big_h, levels = plan.halo, 2 * plan.n_iter
    depth = 2 * levels + 3  # each colour's ring (the wavefront)
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

                if plan.box:  # every plane, then the half-sweeps one by one
                    for q in range(ia, ib):
                        load(q)
                    for lvl in range(1, levels + 1):
                        run([sweep(lvl, q) for q in range(ia, ib)])
                    for q in range(i0, i1):
                        store(q)
                    continue
                load(ia)
                for p in range(ia, i1 + 2 * levels + 1):
                    if p + 1 < ib:
                        load(p + 1)
                    run([sweep(lvl, p - 2 * lvl) for lvl in range(1, levels + 1)])
                    if i0 <= p - 1 - 2 * levels < i1:  # both colours' last half-sweeps done
                        store(p - 1 - 2 * levels)
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
                     fault=None):
    """K31 (i-sharded: rows whole) or K40 ((i, j)-sharded) on one rank's
    block as the kernel runs it: the fine slabs e and r (their point [0, 0]
    at GLOBAL (plane, row) ``first``) and the coarse one (at ``c_first``)
    read as virtual fields, NaN outside them; one Dirichlet stage launch,
    black first, e + P ec made as planes arrive, its blocks tiling the
    rank's planes and rows clipped to n - 1 (rect.cuh, seg_rect_geometry);
    then the pad points of the body (past n - 1) written as e + P ec.
    ``body`` = (g0, L, gj0, Lj). ``fault``: "pad_swept" (the pad swept as
    interior and stored by the blocks), "order" (P ec interpolated i, then
    j, then k). Returns the (L, Lj, n) body and each point's writes."""
    g0, L, gj0, Lj = body
    hh = 2 * n_iter
    shape = (g0 + L + 2 * hh + 2, max(n, gj0 + Lj + 2 * hh + 2))
    ev, rv = virtual2d(e_slab, first, shape), virtual2d(r_slab, first, shape)
    cshape = (shape[0] // 2 + 1, shape[1] // 2 + 1)
    cv = virtual2d(c_slab, c_first, cshape)
    t = prolongation(cv, (0, 1, 2) if fault == "order" else (1, 2, 0))[:shape[0], :shape[1]]
    span = (g0, min(g0 + L, n) if g0 < n else g0)
    cols = (gj0, min(gj0 + Lj, n) if gj0 < n else gj0)
    if fault == "pad_swept":
        span, cols = (g0, g0 + L), (gj0, gj0 + Lj)
    outs, writes = emulate_dirichlet_launch(
        by_stage(deinterleave(ev), BLACK), by_stage(deinterleave(rv), BLACK), BLACK, h, plan, n,
        span, cols, by_stage(deinterleave(t), BLACK), fault)
    out = interleave(by_stage(outs, BLACK), n)
    w = interleave(by_stage([x.float() for x in writes], BLACK), n)
    pad = torch.ones(shape[:2], dtype=torch.bool)
    pad[:n, :n] = False
    if fault != "pad_swept":  # every block's share of the pad points
        out[pad] = (ev + t)[pad]
        w[pad] += 1
    sl = (slice(g0, g0 + L), slice(gj0, gj0 + Lj))
    return out[sl].clone(), w[sl].clone()
