"""Time the rect stage kernels (K2's and K4's, ops/csrc/rect.cuh), with
``--fold`` the same stage on the electrospray's fold layout (K17's, K16's
on a loaded field, and K19's), with ``--mixed`` on its full layout (K14's,
K13's on a loaded field, and K15's), with ``--seg`` on one rank's segments
of an i-sharded field (K35's, K34's on a loaded field, and K36's), with ``--seg-rect`` K4's, K1's and K2's Dirichlet
stages there (K31's, K28's and K29's) and on one rank's block of an (i,
j)-sharded field (K40's, K37's and K38's), with
``--seg-restrict`` the streaming restriction stage there (K30's and K39's,
K3's beside them), with ``--seg-df`` the streaming double-float
residual-and-norm stage there (K32's and K41's, their first forms and K5
beside them), with ``--msplit`` the split pair's mixed stage (K22's,
K21's and K24's, ops/csrc/split.cuh with MIXED), or, with ``--restrict``,
the streaming restriction stage (K3's, K9's, on the fold layout K18's,
and on the electrospray's pair K23's, ops/csrc/restrict.cuh; K18's and
K23's first forms beside them) on candidate plans at each level size on
one card: the planner's own and plans of several block sizes, each held
bit for bit against its plain version.

    python -m multigrid_parallel_tpu_torch.utils.stage_plans [--sizes 9 17 33 65 129]
                                                             [--reps 20]
                                                             [--restrict | --fold | --mixed
                                                              | --seg | --seg-rect
                                                              | --seg-restrict | --seg-df
                                                              | --msplit | --offpath]
                                                             [--kernels K29 K38 K2 ...]
                                                             [--parent ROOT]
    python -m multigrid_parallel_tpu_torch.utils.stage_plans --offpath
                                                             [--kernels K26 K42 K33
                                                              R K5 K6 K11 K12 K20 K25 K27]
                                                             [--parent ROOT]

For each size and kernel (K2 from zero, K4, both at n_iter 2; K17, K16 and
K19 likewise, with the electrospray's pins and coarse signs; K14, K13 (on
a BC-consistent e) and K15 with its pins, and with ``--parent ROOT`` K13's
first form from that checkout in place and on a copy of e; K35, K34 and K36
likewise on the production segments of the level (one rank's L = 320 (n -
1) / 256, rank 0's, and rank 1's of four ranks' L = 96 (n - 1) / 256), by
default at 65^3, 129^3 and 257^3, the plans tiling the rank's planes, and
K34's first form in place and on a copy of e's segments; K31, K28 and K29 at n_iter 2 on the production
segments of the level (one rank's L = 320 (n - 1) / 256 and, from 17^3
up, rank 1's of four ranks' L = 96 (n - 1) / 256) and K40, K37 and K38 on
its production blocks from 33^3 up (the 1x1 block of 272 (n - 1) / 256
rows and columns, rank (0, 0)'s of the 2x2 mesh's 144 (n - 1) / 256), by
default at 129^3 and 257^3, the plans tiling the rank's planes and rows,
with the first form (4 launches a call: K31's and K40's correction and 3
half-sweeps, K28's and K37's 4 half-sweeps, K29's and K38's from-zero
launch and 3 half-sweeps, their device times summed) as the plan
"first_form", and K1 and K2 on the level on their planner's plan
(``--kernels`` picks some of these, with ``--msplit``, ``--restrict`` and
``--offpath`` too); K22 and K24 with its pin packs and coarse signs, on
the msplit planner's plan, K7's and K10's and wavefront plans of several
block sizes, and K21 on its planner's plan, with ``--parent ROOT``
beside its first form from that checkout in place; or K3, K9,
K18 and K23, K18's and K23's first forms as the plan "first_form" (K23's
from ``--parent ROOT`` where given);
or K30 and K39 on the production segments and blocks of the level (as
K31's and K40's, each covering the level, at 9^3-257^3 by default), and K3
on the level; or K32 and K41 on those segments and blocks, their first
forms as the plan "first_form", and K5 on the level, at 65^3-513^3 by
default, a call its partials kernel and their sum; or, with
``--offpath``, the kernels no solve launches at 9^3-513^3 by default
(time_offpath, ``--kernels`` picking some of K26, K42 and K33): K26's
and K42's one-pass stages beside their first forms (K26's from
``--parent ROOT``), K1 + R and K7's stage, K26's stage on its candidate
plans too, and K33's stage on the production ext blocks, on its planner's
plan and (from 65^3) its candidate plans, beside its first form (from
``--parent ROOT``), each with its bound;
and, named in ``--kernels``, the kernels never redesigned, R, K5, K6, K11,
K12, K20, K25 and K27 (time_retimed), each on its own inputs with its
bound) and plan, one JSON line:
the plan, whether the output equals the plain version, and the median
device time of ``reps`` launches from a torch.profiler trace
(``utils.split_trace.kernel_intervals``). The numbers serve to tune
``pallas_split._stage_plan``'s choice between the wavefront and the box,
and the box's block size, ``pallas_split._restrict_plan``'s and
``_df_plan``'s cost models, ``pallas_split.FOLD_RESTRICT_STAGE_MIN_N``, the
level from which K18 takes the stage, and ``DF_STAGE_MIN_N``, K32's and
K41's; the card's name and power limit first.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess

import numpy as np
import torch

from multigrid_parallel_tpu_torch.ops import pallas3d as pk
from multigrid_parallel_tpu_torch.ops import pallas_split as ps
from multigrid_parallel_tpu_torch.utils.split_trace import kernel_intervals
from multigrid_parallel_tpu_torch.utils.timing import HBM_BYTES_PER_S, split_stage_bytes


def launch(plan, f, h, ec=None, u=None):
    """One launch of K2's stage (from zero, or on u) or, given ec, K4's (u
    is e) on ``plan``, into a fresh field."""
    out = torch.empty_like(f)
    args = (plan.n_iter, plan.bi, plan.bj, plan.bk, plan.k_halo, plan.threads, plan.smem,
            int(plan.box), pk._stream())
    lib = pk._lib()
    if ec is None:
        err = lib.mg_rect_stage(out.data_ptr(), None if u is None else u.data_ptr(),
                                f.data_ptr(), plan.n, h * h, 1, *args)
    else:
        err = lib.mg_rect_prolong_stage(out.data_ptr(), ec.data_ptr(), u.data_ptr(),
                                        f.data_ptr(), plan.n, h * h, *args)
    pk._check(err, "stage_plans")
    return out


def fold_launch(plan, r, pin, h, ec=None, e=None, sgn=None):
    """One launch of K17's stage (from zero; K16's on e where e is given)
    or, given ec, K19's on ``plan``, into a fresh fold field."""
    out = torch.empty_like(r)
    args = (plan.n_iter, plan.bi, plan.bj, plan.bk, plan.k_halo, plan.threads, plan.smem,
            int(plan.box), pk._stream())
    lib = pk._lib()
    if ec is None:
        err = lib.mg_fold_stage(out.data_ptr(), None if e is None else e.data_ptr(), r.data_ptr(),
                                pin.data_ptr(), plan.n, h * h, 1, *args)
    else:
        err = lib.mg_fold_prolong_stage(out.data_ptr(), ec.data_ptr(), e.data_ptr(), r.data_ptr(),
                                        pin.data_ptr(), sgn.data_ptr(), plan.n, h * h, *args)
    pk._check(err, "stage_plans")
    return out


def mixed_launch(plan, r, pin, h, ec=None, e=None):
    """One launch of K14's stage (from zero), given e K13's (on e) or, given
    ec too, K15's on ``plan``, into a fresh field."""
    out = torch.empty_like(r)
    args = (plan.n_iter, plan.bi, plan.bj, plan.bk, plan.k_halo, plan.threads, plan.smem,
            int(plan.box), pk._stream())
    lib = pk._lib()
    if ec is None:
        err = lib.mg_mixed_stage(out.data_ptr(), None if e is None else e.data_ptr(),
                                 r.data_ptr(), pin.data_ptr(), plan.n, h * h, 1, *args)
    else:
        err = lib.mg_mixed_prolong_stage(out.data_ptr(), ec.data_ptr(), e.data_ptr(),
                                         r.data_ptr(), pin.data_ptr(), plan.n, h * h, *args)
    pk._check(err, "stage_plans")
    return out


def msplit_launch(plan, r, packs, h, ec=None, e=None, sgn=None):
    """One launch of K22's stage (from zero, red first; given e K21's, on
    e) or, given ec, K24's on ``plan``, into a fresh pair."""
    out = [torch.empty_like(x) for x in r]
    args = (plan.n_iter, plan.bi, plan.bj, plan.bk, plan.k_halo, plan.threads, plan.smem,
            pk._stream())
    lib = pk._lib()
    ptrs = [x.data_ptr() for x in out]
    if ec is None:
        ins = (None, None) if e is None else (e[0].data_ptr(), e[1].data_ptr())
        err = lib.mg_msplit_stage(*ptrs, *ins, *(x.data_ptr() for x in r), packs.data_ptr(),
                                  plan.n, h * h, 1, *args)
    else:
        err = lib.mg_msplit_prolong_stage(*ptrs, ec.data_ptr(), sgn.data_ptr(),
                                          *(x.data_ptr() for x in (*e, *r)), packs.data_ptr(),
                                          plan.n, h * h, *args)
    pk._check(err, "stage_plans")
    return out


def split_wave(n, bi, bj, prolong, n_iter=2):
    """A split wavefront plan of bi planes x bj rows (whole rows), or None
    where it does not fit."""
    s, halo = ps.split_shape(n)[2], 2 * n_iter
    smem = ps._stage_smem(n_iter, bj, s, prolong)
    if smem > ps.SMEM_MAX:
        return None
    threads = 32 * min(ps.STAGE_MAX_THREADS // 32, n, bj + 2 * halo)
    return ps.StagePlan(n, n_iter, halo, 0, bi, bj, s, threads, smem)


def split_candidates(n, prolong, sms):
    """The msplit planner's plan (K22's, or K24's where ``prolong``), K7's
    (K10's), and wavefront plans of other block sizes (up to 65^3, every
    pair of a few small ones)."""
    plans = {"planner": ps._stage_plan(n, 2, sms, prolong=prolong, msplit=True),
             "k7_plan": ps._stage_plan(n, 2, sms, prolong=prolong)}
    sizes = ((4, 4), (8, 4), (8, 8), (16, 4), (16, 8), (16, 12), (33, 8), (33, 12), (43, 10),
             (65, 8))
    if n <= 65:
        sizes = [(bi, bj) for bi in (1, 2, 3, 4, 5, 6, 8) for bj in (1, 2, 3, 4, 6, 8, 9, 11)]
    for bi, bj in sizes:
        bi, bj = evened(n, bi), evened(n, bj)
        plan = split_wave(n, bi, bj, prolong)
        if plan is not None and plan not in plans.values():
            plans[f"wave{bi}x{bj}"] = plan
    return plans


def time_msplit(n, sms, reps, dev, kernels=None, parent=None):
    """One JSON line a (kernel, plan) at level n: K22 from zero, K21 (on
    its planner's plan, K22's) and K24 at n_iter 2 on pairs random at every
    slot (K21's e with its dead slots 0, as the solve keeps them), with the
    electrospray's pin packs and the coarse level's sign planes, each
    candidate's output against the plain version and its median device
    time over ``reps`` launches from a trace of its own (``kernels``: only
    these); with ``parent`` (a checkout whose K21 has its first form),
    K21's first form from that checkout's library beside them, in place
    ("first_form": four half-sweeps and the BC pass, the parent's
    contract)."""
    import multigrid_parallel_tpu_torch as mg
    from multigrid_parallel_tpu_torch.ops import pallas_mixed_fold as pmf
    from multigrid_parallel_tpu_torch.ops import pallas_mixed_split as pms

    es = mg.electrospray_problem()
    h, nc = es.length / (n - 1), (n + 1) // 2
    rng = np.random.default_rng(n)
    e, r = ([torch.from_numpy(rng.standard_normal(ps.split_shape(n)).astype(np.float32)).to(dev)
             for _ in range(2)] for _ in range(2))
    ec = torch.from_numpy(rng.standard_normal((nc, nc, nc - 2)).astype(np.float32)).to(dev)
    packs, sgn = pms.msplit_pin_packs(es, n, dev), pmf.fold_edge_sign_planes(es, nc, dev)
    e21 = pms.fold_to_split(pms.split_to_fold(*e))  # the dead slots 0
    stages = {"K22": (lambda plan: msplit_launch(plan, r, packs, h),
                      lambda: pms.mixed_rb_smooth_from_zero_msplit_plain(*r, packs, h, 2)),
              "K21": (lambda plan: msplit_launch(plan, r, packs, h, e=e21),
                      lambda: pms.mixed_rb_smooth_msplit_plain(*e21, *r, packs, h, 2)),
              "K24": (lambda plan: msplit_launch(plan, r, packs, h, ec, e, sgn),
                      lambda: pms.mixed_prolong_smooth_msplit_plain(ec, *e, *r, packs, sgn, h,
                                                                    2))}
    for kernel, (launch_on, plain) in stages.items():
        if kernels and kernel not in kernels:
            continue
        prolong, want = kernel == "K24", plain()
        plans = split_candidates(n, prolong, sms)
        if kernel == "K21":
            plans = {"planner": plans["planner"]}
        for label, plan in plans.items():
            exact = all(torch.equal(g, w) for g, w in zip(launch_on(plan), want))
            torch.cuda.synchronize()
            times = [(b - a) / 1e3 for a, b, name, *_ in
                     kernel_intervals(lambda: [launch_on(plan) for _ in range(reps)])
                     if name.startswith("msplit_")]
            print(json.dumps({"n": n, "kernel": kernel, "plan": label, "bi": plan.bi,
                              "bj": plan.bj, "blocks": plan.blocks, "threads": plan.threads,
                              "smem": plan.smem, "exact": exact,
                              "device_ms": statistics.median(times) if times else None}),
                  flush=True)
        if kernel == "K21" and parent is not None:
            old, rhs = parent_lib(parent), dict(zip((pk.RED, pk.BLACK), r))

            def first_form(pair):
                for c in list(pk._colors(True)) * 2:
                    pk._check(old.mg_msplit_half_sweep(*(x.data_ptr() for x in pair),
                                                       rhs[c].data_ptr(), packs.data_ptr(), n,
                                                       h * h, c, pk._stream()), "stage_plans")
                pk._check(old.mg_msplit_bc_pass(*(x.data_ptr() for x in pair), packs.data_ptr(),
                                                n, pk._stream()), "stage_plans")
                return pair

            scratch = [x.clone() for x in e21]
            first_form_rows({"first_form": lambda: first_form(scratch)}, want, reps,
                            {"n": n, "kernel": kernel})


def box(n, bi, bj, prolong, n_iter=2, max_threads=ps.RECT_MAX_THREADS):
    """A box plan of bi planes x bj rows (whole rows), at most
    ``max_threads`` threads, or None where it does not fit."""
    s, halo = n // 2, 2 * n_iter
    smem = ps._stage_smem(n_iter, bj, ps._stage_width(n, s, 0, True), prolong, True, box_bi=bi)
    if smem > ps.SMEM_MAX:
        return None
    rows = min(n, bi + 2 * halo) * min(n, bj + 2 * halo)
    threads = 32 * max(1, min(max_threads // 32, -(-rows * ps._row_lanes(s) // 32)))
    return ps.StagePlan(n, n_iter, halo, 0, bi, bj, s, threads, smem, True, True)


def wave(n, bi, bj, prolong, n_iter=2, max_threads=ps.RECT_MAX_THREADS):
    """A wavefront plan of bi planes x bj rows (whole rows), at most
    ``max_threads`` threads, or None where it does not fit."""
    s, halo = n // 2, 2 * n_iter
    smem = ps._stage_smem(n_iter, bj, ps._stage_width(n, s, 0, True), prolong, True)
    if smem > ps.SMEM_MAX:
        return None
    rows = min(n, bj + 2 * halo)
    threads = 32 * max(1, min(max_threads // 32, -(-rows * ps._row_lanes(s) // 32)))
    return ps.StagePlan(n, n_iter, halo, 0, bi, bj, s, threads, smem, True, False)


def evened(n, b):
    return -(-n // -(-n // min(b, n)))


def candidates(n, prolong, sms, planes=None, cols=None):
    """The planner's plan, the wavefront's, and box plans of square blocks
    and wavefront plans of a few box sizes; ``planes``: a segment stage's
    plans of that many planes (their bi evened over them, at most
    ``SEG_MAX_THREADS`` threads), ``cols`` (with ``planes``): of that many
    rows j too (their bj evened over them)."""
    m, cap = (planes, ps.SEG_MAX_THREADS) if planes else (n, ps.RECT_MAX_THREADS)
    mj = cols or n
    plans = {"planner": ps._stage_plan(n, 2, sms, prolong=prolong, rect=True,
                                       seg_planes=planes, seg_cols=cols),
             "wave": ps._wave_plan(n, 2, sms, prolong, True, planes, cols)}
    for b in (1, 2, 3, 4, 6, 8, 10, 12, 16, 24, 33):
        plan = box(n, evened(m, b), evened(mj, b), prolong, max_threads=cap)
        if plan is not None:
            plans[f"box{plan.bi}x{plan.bj}"] = plan._replace(planes=planes, cols=cols)
    for bi, bj in ((8, 4), (8, 10), (16, 4), (16, 6), (33, 4)):
        plan = wave(n, evened(m, bi), evened(mj, bj), prolong, max_threads=cap)
        if plan is not None and n >= 65:
            plans[f"wave{plan.bi}x{plan.bj}"] = plan._replace(planes=planes, cols=cols)
    return plans


def resid_plan(n, bi, bj, bk=None, box=False, n_iter=2):
    """A K26 plan (halos 2 n_iter + 1, rings 2 H + 5) of bi planes x bj
    rows, whole rows or (``bk``) k tiles under the 8-slot k halo, the box
    or the wavefront, or None where it does not fit or the kernel would
    refuse it."""
    s, halo = n // 2, 2 * n_iter + 1
    k_halo = -(-halo // 4) * 4 if bk is not None and bk < s else 0
    bk = bk if k_halo else s
    if k_halo and (bk % 4 or bk < k_halo):
        return None
    width = ps._stage_width(n, bk, k_halo, True)
    smem = ps._stage_smem(n_iter, bj, width, rect=True, box_bi=bi if box else 0, resid=True)
    if smem > ps.SMEM_MAX:
        return None
    rows = min(n, bj + 2 * halo) * (min(n, bi + 2 * halo) if box else 1)
    lanes = ps._row_lanes(width if k_halo else s)
    threads = 32 * max(1, min(ps.RECT_MAX_THREADS // 32, -(-rows * lanes // 32)))
    return ps.StagePlan(n, n_iter, halo, k_halo, bi, bj, bk, threads, smem, True, box)


def resid_candidates(n, sms):
    """K26's planner plan and others: boxes of a few block sizes (up to
    129^3), and wavefronts of whole rows and of k tiles, their planes cut
    so that the blocks fill about one wave of ``sms`` SMs."""
    plans = {"planner": ps._stage_plan(n, 2, sms, rect=True, resid=True)}
    if n <= 129:
        for bi, bj in ((1, 1), (2, 2), (3, 3), (4, 4), (6, 6), (8, 8), (4, 8), (8, 4), (6, 11),
                       (10, 13), (12, 12), (16, 16)):
            plan = resid_plan(n, evened(n, bi), evened(n, bj), box=True)
            if plan is not None:
                plans[f"box{plan.bi}x{plan.bj}"] = plan
    if n >= 65:
        for bk in (None, 16, 32, 44, 64):
            for bj in (2, 4, 6, 8, 12, 16, 24):
                probe = resid_plan(n, n, evened(n, bj), bk)
                if probe is None:
                    continue
                per_sm = min(2, ps.SM_SMEM // (probe.smem + 1024))
                ni = max(1, per_sm * sms // (probe.tiles[1] * probe.tiles[2]))
                plan = resid_plan(n, evened(n, -(-n // ni)), probe.bj, bk)
                if plan is not None and plan.blocks <= 2 * per_sm * sms:
                    plans[f"wave{plan.bi}x{plan.bj}x{plan.bk}"] = plan
    return plans


def resid_launch(plan, u, f, h, red_first=True):
    """One launch of K26's stage on ``plan`` into a fresh (u', r)."""
    out, r = torch.empty_like(u), torch.empty_like(u)
    pk._check(pk._lib().mg_rect_resid_stage(
        out.data_ptr(), r.data_ptr(), u.data_ptr(), f.data_ptr(), plan.n, h * h, 1.0 / (h * h),
        int(red_first), plan.n_iter, plan.bi, plan.bj, plan.bk, plan.k_halo, plan.threads,
        plan.smem, int(plan.box), pk._stream()), "stage_plans")
    return out, r


def restrict_launch(plan, e, r, h, msplit=False, lib=None):
    """One launch of K3's (K9's where ``plan.split``, e and r then pairs,
    K23's where ``msplit`` too; K18's where ``plan.fold``) restriction
    stage on ``plan``, or of K18's (K23's) first form where ``plan`` is
    None (from ``lib``, another checkout's library, where given), into a
    fresh coarse field."""
    n = e[0].shape[0]
    nc = (n + 1) // 2
    fold = msplit or plan is None or plan.fold
    out = torch.empty((nc, nc, nc - 2) if fold else (nc, nc, nc), device=e[0].device)
    lib = lib or pk._lib()
    ptrs = (out.data_ptr(), *(x.data_ptr() for x in (*e, *r)))
    if plan is None:
        fn = lib.mg_msplit_residual_restrict if msplit else lib.mg_residual_restrict_fold
        err = fn(*ptrs, n, 1.0 / (h * h), pk._stream())
    else:
        fn = (lib.mg_msplit_restrict_stage if msplit
              else lib.mg_split_residual_restrict if plan.split
              else lib.mg_fold_residual_restrict if fold else lib.mg_residual_restrict)
        err = fn(*ptrs, n, 1.0 / (h * h), *plan.args, pk._stream())
    pk._check(err, "stage_plans")
    return out


def restrict_candidates(n, split, sms, fold=False, first_form=False):
    """The planner's plan and plans of bci x bcj coarse planes and rows,
    whole k rows or two k tiles, that the kernels take (K18's: ``fold``,
    its first form as "first_form", a plan of None; K23's, ``split`` with
    ``first_form``, likewise)."""
    m = (n + 1) // 2 - 2
    plans = {"planner": ps._restrict_plan(n, sms, split, fold)}
    if fold or first_form:
        plans["first_form"] = None
    half = -(-m // 2)
    if split and ((n - 1) // 2) % 4 == 0:
        half = -(-half // 4) * 4
    for bck in sorted({m, half} if half < m else {m}):
        chunks = ps._restrict_chunks(bck, split)
        if chunks is None:
            continue
        for bcj in (1, 2, 4, 8):
            bcj = evened(m, bcj)
            smem = ps._restrict_smem(bcj, bck, split)
            if smem > ps.SMEM_MAX:
                continue
            for bci in (1, 2, 4, 8, 16, 32):
                bci = evened(m, bci)
                plans[f"{bci}x{bcj}x{bck}"] = ps.RestrictPlan(n, split, bci, bcj, bck, chunks,
                                                              32 * (2 * bcj + 1), smem, fold)
    return plans


def time_restrict(n, sms, reps, dev, kernels=None, parent=None):
    """One JSON line a (kernel, plan) at level n: K3 on random (e, r), K9
    on random pairs, K18 on random fold fields at the electrospray's h
    (its first form beside the stage) and K23 on random pairs at that h
    (its first form beside the stage: with ``parent``, from that
    checkout's library, else this one's), each candidate's
    output against the plain version and its median device time over
    ``reps`` launches from a trace of its own (``kernels``: only these)."""
    from multigrid_parallel_tpu_torch.ops import pallas_mixed_fold as pmf
    from multigrid_parallel_tpu_torch.ops import pallas_mixed_split as pms

    rng = np.random.default_rng(n)
    for kernel, split, fold in (("K3", False, False), ("K9", True, False),
                                ("K18", False, True), ("K23", True, False)):
        msplit = kernel == "K23"
        h = 3e-4 / (n - 1) if fold or msplit else 1.0 / (n - 1)
        shape = ps.split_shape(n) if split else (n, n, n - 2) if fold else (n, n, n)
        e, r = ([torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(dev)
                 for _ in range(2 if split else 1)] for _ in range(2))
        if kernels and kernel not in kernels:
            continue
        want = (pms.residual_restrict_msplit_plain(*e, *r, h) if msplit
                else ps.residual_restrict_split_plain(*e, *r, h) if split
                else pmf.residual_restrict_fold_plain(*e, *r, h) if fold
                else pk.residual_restrict_plain(*e, *r, h))
        lib = parent_lib(parent) if msplit and parent is not None else pk._lib()
        for label, plan in restrict_candidates(n, split, sms, fold, msplit).items():
            old = lib if plan is None else None
            exact = bool(torch.equal(restrict_launch(plan, e, r, h, msplit, old), want))
            torch.cuda.synchronize()
            times = [(b - a) / 1e3 for a, b, name, *_ in
                     kernel_intervals(lambda: [restrict_launch(plan, e, r, h, msplit, old)
                                               for _ in range(reps)])
                     if "restrict" in name]
            shape = {} if plan is None else {
                "bci": plan.bci, "bcj": plan.bcj, "bck": plan.bck, "blocks": plan.blocks,
                "threads": plan.threads, "smem": plan.smem}
            print(json.dumps({"n": n, "kernel": kernel, "plan": label, **shape, "exact": exact,
                              "device_ms": statistics.median(times) if times else None}),
                  flush=True)


def first_form_rows(forms, want, reps, row):
    """One JSON line a first form (``forms``: label -> a call that returns
    its output): its output against the plain version and its device time
    a call from one trace of ``reps`` calls, each kernel or copy name's
    median time times its launches a call, summed (a trace that drops an
    event still gives the call's parts)."""
    for label, run in forms.items():
        got = run()
        exact = (all(torch.equal(g, w) for g, w in zip(got, want)) if isinstance(want, tuple)
                 else bool(torch.equal(got, want)))
        torch.cuda.synchronize()
        by_name = {}
        for a, b, name, *_ in kernel_intervals(lambda: [run() for _ in range(reps)]):
            by_name.setdefault(name, []).append((b - a) / 1e3)
        each = {name: round(len(v) / reps) for name, v in by_name.items()}
        ms = sum(statistics.median(v) * each[name] for name, v in by_name.items())
        print(json.dumps({**row, "plan": label, "exact": exact, "launches a call": each,
                          "device_ms": ms}), flush=True)


OFFPATH_KERNELS = ("K26", "K42", "K33")


def time_offpath(n, reps, dev, kernels, sms, parent=None):
    """One JSON line a form at level n of the kernels no solve path
    launches (``kernels``: some of OFFPATH_KERNELS), each form's output
    against the plain version and its device time a call from one trace of
    ``reps`` calls (first_form_rows), beside the bound from the bytes the
    function must move over the H100's 3.35 TB/s: K26 at n_iter 2, red
    first, on u and f random everywhere, its one-pass stage, its first form
    (with ``parent``, from that checkout's library: three half-sweeps of
    K1's per-sweep kernel and the launch that sweeps the last colour and
    writes r), in place and on a copy of u made in the call (the stage's
    contract leaves u as it is), and K1's stage then R;
    K42 at n_iter 2 on the packed array of zero-boundary cubes, its
    one-pass stage, its first form (in place) and K7's stage on the pair
    (another order of additions, held against K7's plain version); K33 on
    rank 1's ext block of four ranks' L = 96 (n - 1) / 256 and on the one
    rank's L = 320 (n - 1) / 256 (the ranks' planes past n - 1 zero): its
    stage launched on its planner's plan (``_df_plan(..., stage="resid")``)
    and, from 65^3, on its candidate plans, and with ``parent`` its first
    form from that checkout's library, each against the bytes the function needs
    (12 an interior point: read u and f, write r; 4 any other: write 0).
    K26's stage also on its candidate plans for ``sms`` SMs
    (resid_candidates), which tune ``pallas_split._stage_plan``'s resid
    plans."""
    from multigrid_parallel_tpu_torch.ops import pallas_sharded as px
    from multigrid_parallel_tpu_torch.ops import pallas_splitcolor as psc

    h, rate = 1.0 / (n - 1), HBM_BYTES_PER_S / 1e3  # bytes a millisecond
    rng = np.random.default_rng(n)
    if "K26" in kernels:
        u, f = (torch.from_numpy(rng.standard_normal((n, n, n)).astype(np.float32)).to(dev)
                for _ in range(2))
        want = pk.rb_smooth_residual_plain(u, f, h, 2, True)
        lib, scratch = parent_lib(parent) if parent is not None else None, u.clone()

        def first_form(copy):
            if copy:  # the fresh (u', r) of the stage's contract: u left as it is
                scratch.copy_(u)
            colors = list(pk._colors(True)) * 2
            for c in colors[:-1]:
                pk._check(lib.mg_rb_half_sweep(scratch.data_ptr(), f.data_ptr(), n, h * h, c,
                                               pk._stream()), "stage_plans")
            r = torch.empty_like(u)
            pk._check(lib.mg_rb_last_sweep_residual(scratch.data_ptr(), r.data_ptr(),
                                                    f.data_ptr(), n, h * h, 1.0 / (h * h),
                                                    colors[-1], pk._stream()), "stage_plans")
            return scratch, r

        def k1_r():
            v = pk.rb_smooth_fused(u, f, h, 2, True)
            return v, pk.residual_fused(v, f, h)

        row = {"n": n, "kernel": "K26", "bound_ms": 16 * n ** 3 / rate}
        forms = {"stage": lambda: pk.rb_smooth_residual_fused(u, f, h, 2, True), "K1+R": k1_r}
        if lib is not None:
            forms.update(first_form=lambda: first_form(False),
                         first_form_on_a_copy=lambda: first_form(True))
        first_form_rows(forms, want, reps, row)
        for label, plan in resid_candidates(n, sms).items():
            first_form_rows({label: lambda: resid_launch(plan, u, f, h)}, want, reps,
                            {**row, "bi": plan.bi, "bj": plan.bj, "bk": plan.bk,
                             "box": plan.box, "blocks": plan.blocks, "threads": plan.threads,
                             "smem": plan.smem})
    if "K42" in kernels:
        cubes = []
        for _ in range(2):
            x = np.zeros((n, n, n), np.float32)
            x[1:-1, 1:-1, 1:-1] = rng.standard_normal((n - 2,) * 3)
            cubes.append(torch.from_numpy(x).to(dev))
        u2, f2 = (psc.pack_split(x) for x in cubes)
        pair, rhs = ps.pack_split(cubes[0]), ps.pack_split(cubes[1])
        scratch = u2.clone()
        row = {"n": n, "kernel": "K42",
               "bound_ms": split_stage_bytes(n, True, packed=True) / rate}
        first_form_rows({"stage": lambda: psc.rb_smooth_split_fused(u2, f2, h, 2, n, True),
                         "first_form": lambda: psc.rb_smooth_split_fused_per_sweep(
                             scratch, f2, h, 2, n, True)},
                        psc.rb_smooth_split_fused_plain(u2, f2, h, 2, True), reps, row)
        first_form_rows({"K7 stage": lambda: ps.rb_smooth_split(*pair, *rhs, h, 2, True)},
                        ps.rb_smooth_split_plain(*pair, *rhs, h, 2, True), reps, row)
    if "K33" in kernels:
        lib, stream = pk._lib(), pk._stream()
        old = parent_lib(parent) if parent is not None else None
        for ranks, L in ((4, 96 * (n - 1) // 256), (1, 320 * (n - 1) // 256)):
            rank = 1 if ranks > 1 else 0
            u, f = (torch.zeros((ranks * L, n, n), device=dev) for _ in range(2))
            for x in (u, f):
                x[:n] = torch.from_numpy(rng.standard_normal((n, n, n)).astype(np.float32))
            u_ext, f_ext = (torch.cat([lh, body, rh])
                            for body, lh, rh in (seg_parts(x, rank, L, 1, 1) for x in (u, f)))
            g0 = rank * L
            us, fb = px._seg(px._ext_parts(u_ext, 1, L), 1, 1, L), f_ext[1:-1]
            rows = px.seg_df_extents(n, g0, L)[0]

            def stage(plan, us=us, fb=fb, L=L, g0=g0):
                r = torch.empty((L, n, n), device=dev)
                pk._check(lib.mg_seg_resid_stage(r.data_ptr(), *px._ptrs(us), fb.data_ptr(), 1, L,
                                                 1, n, g0, 1.0 / (h * h), *plan.args, stream),
                          "stage_plans")
                return r

            def first_form(us=us, fb=fb, L=L, g0=g0):
                r = torch.empty((L, n, n), device=dev)
                pk._check(old.mg_seg_residual(r.data_ptr(), *px._ptrs(us), fb.data_ptr(), L, n,
                                              g0, 1.0 / (h * h), stream), "stage_plans")
                return r

            # the bytes the function needs: read u and f and write r at an interior
            # point, write 0 at any other
            inner = rows * (n - 2) ** 2
            row = {"n": n, "kernel": "K33", "L": L, "rank": rank,
                   "bound_ms": (12 * inner + 4 * (L * n * n - inner)) / rate}
            plans = seg_df_candidates(n, rows or n - 2, n - 2, sms, stage="resid")
            forms = {"stage": lambda: stage(plans["planner"])}
            if old is not None:
                forms["first_form"] = first_form
            want = px.residual_ext_plain(u_ext, f_ext, g0 - 1, h, n, L)
            first_form_rows(forms, want, reps, {**row, **_plan_row(plans["planner"], sms)})
            for label, plan in plans.items():
                if label != "planner" and n >= 65 and rows:
                    first_form_rows({label: lambda plan=plan: stage(plan)}, want, reps,
                                    {**row, **_plan_row(plan, sms)})


def _plan_row(plan, sms):
    return {"bi": plan.bi, "bj": plan.bj, "bk": plan.bk, "blocks": plan.blocks,
            "threads": plan.threads, "smem": plan.smem,
            "cost_us": round(ps._df_cost(plan, sms), 2)}


RETIMED_KERNELS = ("R", "K5", "K6", "K11", "K12", "K20", "K25", "K27")


def time_retimed(n, reps, dev, kernels):
    """One JSON line a kernel never redesigned at level n (``kernels``: some
    of RETIMED_KERNELS), on inputs as chip_smoke.py's phase 2 makes them (a
    double-float state near a solution, packed into the split pair and the
    fold layout for K11, K12, K25 and K20): its output against the plain
    version (a norm left out: its f64 sum runs in another order), its device
    time a call from one trace of ``reps`` calls (first_form_rows: a norm
    kernel's partials and their sum together), and its bound, the bytes of
    its inputs read once and its outputs written once over the H100's 3.35
    TB/s."""
    from multigrid_parallel_tpu_torch.ops import pallas_mixed_fold as pmf
    from multigrid_parallel_tpu_torch.ops import pallas_mixed_split as pms

    h, rate = 1.0 / (n - 1), HBM_BYTES_PER_S / 1e3
    rng = np.random.default_rng(n)
    u, f, d = (torch.from_numpy(s * rng.standard_normal((n, n, n)).astype(np.float32)).to(dev)
               for s in (1.0, 1.0, 1e-6))
    c = np.arange(n) * h
    x, y, z = np.meshgrid(c, c, c, indexing="ij")
    u64 = x * x - 2 * y * y + z * z + 1e-9 * rng.standard_normal((n, n, n))
    state = [t.to(dev) for x64 in (u64, 1e-6 * rng.standard_normal((n, n, n)))
             for t in pk.df_split(torch.from_numpy(x64))]
    inner = torch.zeros((n, n, n), dtype=torch.bool, device=dev)
    inner[1:-1, 1:-1, 1:-1] = True
    d2 = ps.pack_split(torch.where(inner, d, torch.zeros_like(d)))
    pair = [x for t in state for x in ps.pack_split(t)]
    fold = [pmf.pack_fold(t) for t in state]
    calls = {  # kernel, plain version, inputs
        "R": (pk.residual_fused, pk.residual_plain, (u, f)),
        "K5": (pk.residual_df_norm_fused, pk.residual_df_norm_plain, state),
        "K6": (pk.df_step_residual_norm_fused, pk.df_step_residual_norm_plain,
               (*state[:2], d, *state[2:])),
        "K11": (ps.df_step_split, ps.df_step_split_plain, (*pair[:4], *d2, *pair[4:])),
        "K12": (ps.residual_df_norm_split, ps.residual_df_norm_split_plain, pair),
        "K20": (pmf.residual_df_norm_fold, pmf.residual_df_norm_fold_plain, fold),
        "K25": (pms.residual_df_norm_msplit, pms.residual_df_norm_msplit_plain, pair),
        "K27": (pk.residual_df_fused, pk.residual_df_plain, state),
    }

    def fields(out):  # the output fields, a norm left out
        if not isinstance(out, tuple):
            return out
        return out[:-1] if out[-1].dim() == 0 else out

    for name in kernels:
        kernel, plain, args = calls[name]
        out = kernel(*args, h)
        nbytes = sum(t.numel() * t.element_size()
                     for t in (*args, *(out if isinstance(out, tuple) else (out,))))
        first_form_rows({"kernel": lambda: fields(kernel(*args, h))}, fields(plain(*args, h)),
                        reps, {"n": n, "kernel": name, "bound_ms": nbytes / rate})


def parent_lib(root):
    """The kernel library of the checkout at ``root`` (built and loaded by
    that checkout's own ops/_build.py), for a first form this tree no
    longer has."""
    import importlib.util
    from pathlib import Path

    spec = importlib.util.spec_from_file_location(
        "parent_build", Path(root) / "multigrid_parallel_tpu_torch" / "ops" / "_build.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.load()


def time_electrospray(n, sms, reps, dev, fold, parent=None):
    """One JSON line a (kernel, plan) at level n: K17 from zero and K19 at
    n_iter 2 on random fold fields with the electrospray's pins and the
    coarse level's signs (``fold``), or K14, K13 (on e made BC-consistent)
    and K15 likewise on full fields (the coarse one's boundary live), each
    candidate's output against the plain version and its median device
    time over ``reps`` launches from a trace of its own; with ``parent``
    (a checkout whose K13 has its first form), K13's first form from that
    checkout's library beside them: in place ("first_form", the parent's
    contract) and on a copy of e ("first_form_copy", the copy in the
    call, the fresh-field contract of this tree's K13)."""
    import multigrid_parallel_tpu_torch as mg
    from multigrid_parallel_tpu_torch.ops import pallas_mixed as pm
    from multigrid_parallel_tpu_torch.ops import pallas_mixed_fold as pmf

    es = mg.electrospray_problem()
    h, nc = es.length / (n - 1), (n + 1) // 2
    rng = np.random.default_rng(n)
    e, r, ec = (torch.from_numpy(rng.standard_normal((m, m, m - 2 * fold)).astype(np.float32))
                .to(dev) for m in (n, n, nc))
    if fold:
        pin, sgn = pmf.fold_pin_planes(es, n, dev), pmf.fold_edge_sign_planes(es, nc, dev)
        stages = {"K17": (lambda plan: fold_launch(plan, r, pin, h),
                          lambda: pmf.mixed_rb_smooth_from_zero_fold_plain(r, pin, h, 2, True)),
                  "K16": (lambda plan: fold_launch(plan, r, pin, h, e=e),
                          lambda: pmf.mixed_rb_smooth_fold_plain(e, r, pin, h, 2, True)),
                  "K19": (lambda plan: fold_launch(plan, r, pin, h, ec, e, sgn),
                          lambda: pmf.mixed_prolong_smooth_fold_plain(ec, e, r, pin, sgn, h, 2))}
    else:
        pin = pm.dirichlet_pin_planes(es, n, dev)
        e_bc = pm.apply_bcs_padded(e, pin)
        stages = {"K14": (lambda plan: mixed_launch(plan, r, pin, h),
                          lambda: pm.mixed_rb_smooth_from_zero_plain(r, pin, h, 2, True)),
                  "K13": (lambda plan: mixed_launch(plan, r, pin, h, e=e_bc),
                          lambda: pm.mixed_rb_smooth_plain(e_bc, r, pin, h, 2, True)),
                  "K15": (lambda plan: mixed_launch(plan, r, pin, h, ec, e),
                          lambda: pm.mixed_prolong_smooth_plain(ec, e, r, pin, h, 2))}
    for kernel, (launch_on, plain) in stages.items():
        prolong, want = kernel in ("K15", "K19"), plain()
        for label, plan in candidates(n, prolong, sms).items():
            exact = bool(torch.equal(launch_on(plan), want))
            torch.cuda.synchronize()
            times = [(b - a) / 1e3 for a, b, name, *_ in
                     kernel_intervals(lambda: [launch_on(plan) for _ in range(reps)])
                     if name.startswith("fold_" if fold else "mixed_")]
            print(json.dumps({"n": n, "kernel": kernel, "plan": label, "box": plan.box,
                              "bi": plan.bi, "bj": plan.bj, "blocks": plan.blocks,
                              "threads": plan.threads, "smem": plan.smem, "exact": exact,
                              "device_ms": statistics.median(times) if times else None}),
                  flush=True)
        if kernel == "K13" and parent is not None:
            old = parent_lib(parent)

            def first_form(u):
                for c in list(pk._colors(True)) * 2:
                    pk._check(old.mg_mixed_half_sweep(u.data_ptr(), r.data_ptr(), pin.data_ptr(),
                                                      n, h * h, c, pk._stream()), "stage_plans")
                pk._check(old.mg_mixed_bc_pass(u.data_ptr(), pin.data_ptr(), n, pk._stream()),
                          "stage_plans")
                return u

            scratch = e_bc.clone()
            first_form_rows({"first_form": lambda: first_form(scratch),
                             "first_form_copy": lambda: first_form(e_bc.clone())},
                            want, reps, {"n": n, "kernel": kernel})


def seg_parts(x, rank, L, kl, kr):
    """Rank ``rank``'s own copies of its (local, lh, rh) planes of the
    global field x; zeros past the chain's ends."""
    ext = torch.cat([x.new_zeros((kl,) + x.shape[1:]), x, x.new_zeros((kr,) + x.shape[1:])])
    lo = rank * L
    return (ext[kl + lo:kl + lo + L].clone(), ext[lo:lo + kl].clone(),
            ext[kl + lo + L:kl + lo + L + kr].clone())


def time_seg(n, L, sms, reps, dev):
    """One JSON line a (kernel, plan) at level n for segments of L planes:
    K35 from zero, K34 on e (red first) and K36 at n_iter 2 on rank 1's
    segments (rank 0's where 2 L > n) of random fields with the
    electrospray's pins (e BC-consistent), and K34's first form in place
    ("first_form") and on a copy of e's segments ("first_form_copy"), each
    candidate plan of the rank's planes (``candidates``) launched through
    the segment launchers, its output against the plain version and its
    median device time over ``reps`` launches from a trace of its own."""
    import multigrid_parallel_tpu_torch as mg
    from multigrid_parallel_tpu_torch.ops import pallas_mixed as pm
    from multigrid_parallel_tpu_torch.ops import pallas_sharded as px

    es = mg.electrospray_problem()
    h, nc, hh, n_iter = es.length / (n - 1), (n + 1) // 2, 4, 2
    rank = 1 if 2 * L <= n else 0
    ranks = max(rank + 2, -(-n // L))
    rng = np.random.default_rng(n + L)
    f, e = (torch.from_numpy(rng.standard_normal((ranks * L, n, n)).astype(np.float32)).to(dev)
            for _ in range(2))
    ec = torch.from_numpy(rng.standard_normal((ranks * L // 2, nc, nc)).astype(np.float32))
    ec = ec.to(dev)
    pin = pm.dirichlet_pin_planes(es, n, dev)
    e[:n] = pm.apply_bcs_padded(e[:n], pin)
    gi0, g0 = rank * L - hh, rank * L
    kl = pm._stage_kl(gi0, n_iter, n)
    f3, e3 = seg_parts(f, rank, L, kl, hh), seg_parts(e, rank, L, kl, hh)
    c3 = seg_parts(ec, rank, L // 2, kl - n_iter, n_iter + 1)
    fs, es_, cs = px._seg(f3, kl, hh, L), px._seg(e3, kl, hh, L), px._seg(c3, kl - n_iter,
                                                                          n_iter + 1, L // 2)
    planes, lib = pm._seg_planes(gi0, n_iter, n, L), pk._lib()

    def args(plan):
        return (plan.n_iter, plan.bi, plan.bj, plan.bk, plan.k_halo, plan.threads, plan.smem,
                int(plan.box), pk._stream())

    def k35(plan, u=None):
        out = torch.empty((L, n, n), device=dev)
        pk._check(lib.mg_seg_mixed_stage(
            out.data_ptr(), *((None, None, None, 0) if u is None else px._ptrs(u)),
            *px._ptrs(fs), pin.data_ptr(), kl, L, hh, n, g0, h * h, 1, *args(plan)),
            "stage_plans")
        return out

    def k36(plan):
        out = torch.empty((L, n, n), device=dev)
        pk._check(lib.mg_seg_mixed_prolong_stage(
            out.data_ptr(), *px._ptrs(cs), cs.kl, n_iter + 1, *px._ptrs(es_), *px._ptrs(fs),
            pin.data_ptr(), kl, L, hh, n, g0, h * h, *args(plan)), "stage_plans")
        return out

    stages = {"K35": (k35, pm.mixed_rb_smooth_from_zero_halo_plain(f3, pin, gi0, h, n_iter, n,
                                                                    L)),
              "K34": (lambda plan: k35(plan, es_),
                      pm.mixed_rb_smooth_halo_plain(e3, f3, pin, gi0, h, n_iter, n, L)),
              "K36": (k36, pm.mixed_prolong_smooth_halo_plain(c3, e3, f3, pin, gi0, h, n_iter,
                                                              n, L))}
    for kernel, (launch_on, want) in stages.items():
        for label, plan in candidates(n, kernel == "K36", sms, planes).items():
            exact = bool(torch.equal(launch_on(plan), want))
            torch.cuda.synchronize()
            times = [(b - a) / 1e3 for a, b, name, *_ in
                     kernel_intervals(lambda: [launch_on(plan) for _ in range(reps)])
                     if name.startswith("mixed_seg")]
            print(json.dumps({"n": n, "L": L, "rank": rank, "planes": planes, "kernel": kernel,
                              "plan": label, "box": plan.box, "bi": plan.bi, "bj": plan.bj,
                              "blocks": plan.blocks, "threads": plan.threads, "smem": plan.smem,
                              "exact": exact,
                              "device_ms": statistics.median(times) if times else None}),
                  flush=True)

    def first_form(u):  # K34's first form: its half-sweeps and BC pass, in place on u
        pm._seg_stage(u, fs, pin, kl, hh, L, n, g0, h * h, list(pk._colors(True)) * 2,
                      "mixed_rb_smooth_seg")
        return u.body

    def copy():
        return px._Seg(*(t.clone() for t in es_[:3]), es_.r_off)

    scratch = copy()
    first_form_rows({"first_form": lambda: first_form(scratch),
                     "first_form_copy": lambda: first_form(copy())}, stages["K34"][1], reps,
                    {"n": n, "L": L, "rank": rank, "planes": planes, "kernel": "K34"})


def time_seg_rect(n, sms, reps, dev, kernels=None):
    """One JSON line a (kernel, segment, plan) at level n: K31, K28 and K29
    (red first) at n_iter 2 on the one-rank segment (L = 320 (n - 1) / 256,
    rank 0) and on rank 1's of four (L = 96 (n - 1) / 256, from 17^3 up),
    and K40, K37 and K38 on the 1x1 block (272 (n - 1) / 256 rows and
    columns) and on rank (0, 0)'s of the 2x2 mesh (144 (n - 1) / 256), from
    33^3 up (the levels that the production plans shard), of random fields,
    zeros past the chain ends: each candidate plan of the rank's planes and
    rows (``candidates``) launched through the segment launchers, and the
    first form ("first_form": K31's and K40's correction launch and 3
    half-sweep launches, K28's and K37's 4 half-sweep launches on a copy of
    u's segments, K29's and K38's from-zero launch and 3 half-sweep
    launches, a call's device time their sum); then K1's and K2's stages on
    the level on their planner's plan; only the ``kernels`` named (all by
    default); each output against the plain version, with the median device
    time a call over ``reps`` calls from a trace of its own."""
    from multigrid_parallel_tpu_torch.ops import pallas_sharded as px
    from multigrid_parallel_tpu_torch.ops import pallas_sharded2d as px2

    h, nc, hh, n_iter = 1.0 / (n - 1), (n + 1) // 2, 4, 2
    lib, stream = pk._lib(), pk._stream()
    rng = np.random.default_rng(n)

    def rnd(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(dev)

    def args(plan):
        return (plan.n_iter, plan.bi, plan.bj, plan.bk, plan.k_halo, plan.threads, plan.smem,
                int(plan.box), stream)

    def first_form_1d(c, e, r, L, g0):
        def run():
            out = px._Seg(e.body.new_empty((hh, n, n)), torch.empty_like(e.body),
                          e.body.new_empty((hh, n, n)), 0)
            pk._check(lib.mg_seg_prolong_correct_black(
                *px._ptrs(out)[:3], *px._ptrs(c), c.kl, c.rh.shape[0] - c.r_off,
                *px._ptrs(e), *px._ptrs(r), hh, L, n, g0, h * h, stream), "stage_plans")
            for color in (1, 0, 1):
                pk._check(lib.mg_seg_half_sweep(*px._ptrs(out), *px._ptrs(r), hh, L, hh, n, g0,
                                                h * h, color, stream), "stage_plans")
            return out.body
        return run

    def first_form_2d(c, e, r, L, Lj, g0, gj0):
        def run():
            out = px2._fresh(e.body, hh)
            od, rd = out.desc(), r.desc()
            pk._check(lib.mg_seg2d_prolong_correct_black(od, c.desc(), e.desc(), rd, hh, L, Lj,
                                                         n, g0, gj0, h * h, stream),
                      "stage_plans")
            for color in (1, 0, 1):
                pk._check(lib.mg_seg2d_half_sweep(od, rd, hh, L, Lj, n, g0, gj0, h * h, color,
                                                  stream), "stage_plans")
            return out.body
        return run

    def first_smooth_1d(u, f, L, g0):
        def run():
            w = px._Seg(*(t.clone() for t in u[:3]), u.r_off)
            for color in (1, 0, 1, 0):
                pk._check(lib.mg_seg_half_sweep(*px._ptrs(w), *px._ptrs(f), hh, L, hh, n, g0,
                                                h * h, color, stream), "stage_plans")
            return w.body
        return run

    def first_zero_1d(f, L, g0):
        def run():
            out = px._Seg(f.body.new_empty((hh, n, n)), torch.empty_like(f.body),
                          f.body.new_empty((hh, n, n)), 0)
            pk._check(lib.mg_seg_half_sweep_from_zero(*px._ptrs(out)[:3], *px._ptrs(f), hh, L, hh,
                                                      n, g0, h * h, 1, stream), "stage_plans")
            for color in (0, 1, 0):
                pk._check(lib.mg_seg_half_sweep(*px._ptrs(out), *px._ptrs(f), hh, L, hh, n, g0,
                                                h * h, color, stream), "stage_plans")
            return out.body
        return run

    def first_zero_2d(f, L, Lj, g0, gj0):
        def run():
            out = px2._fresh(f.body, hh)
            od, fd = out.desc(), f.desc()
            pk._check(lib.mg_seg2d_half_sweep_from_zero(od, fd, hh, L, Lj, n, g0, gj0, h * h, 1,
                                                        stream), "stage_plans")
            for color in (0, 1, 0):
                pk._check(lib.mg_seg2d_half_sweep(od, fd, hh, L, Lj, n, g0, gj0, h * h, color,
                                                  stream), "stage_plans")
            return out.body
        return run

    def first_smooth_2d(u, f, L, Lj, g0, gj0):
        def run():
            w = px2._Seg2(*(t.clone(memory_format=torch.contiguous_format) for t in u.parts()),
                          u.r_off)
            wd, fd = w.desc(), f.desc()
            for color in (1, 0, 1, 0):
                pk._check(lib.mg_seg2d_half_sweep(wd, fd, hh, L, Lj, n, g0, gj0, h * h, color,
                                                  stream), "stage_plans")
            return w.body
        return run

    cases = []
    segments = [(320 * (n - 1) // 256, 0)] + ([(96 * (n - 1) // 256, 1)] if n >= 17 else [])
    for L, rank in segments:
        ranks = max(rank + 2, -(-n // L))
        e, f, ec = rnd(ranks * L, n, n), rnd(ranks * L, n, n), rnd(ranks * L // 2, nc, nc)
        gi0, g0 = rank * L - hh, rank * L
        e3, f3 = seg_parts(e, rank, L, hh, hh), seg_parts(f, rank, L, hh, hh)
        c3 = seg_parts(ec, rank, L // 2, n_iter, n_iter + 1)
        es_, fs = px._seg(e3, hh, hh, L), px._seg(f3, hh, hh, L)
        cs = px._seg(c3, n_iter, n_iter + 1, L // 2)
        planes = px.seg_rect_planes(g0, L, n)

        def k31(plan, L=L, g0=g0, es_=es_, fs=fs, cs=cs):
            out = torch.empty((L, n, n), device=dev)
            pk._check(lib.mg_seg_prolong_stage(
                out.data_ptr(), *px._ptrs(cs), cs.kl, n_iter + 1, *px._ptrs(es_), *px._ptrs(fs),
                hh, L, hh, n, g0, h * h, *args(plan)), "stage_plans")
            return out

        def k28(plan, L=L, g0=g0, es_=es_, fs=fs):
            out = torch.empty((L, n, n), device=dev)
            pk._check(lib.mg_seg_smooth_stage(
                out.data_ptr(), *px._ptrs(es_), *px._ptrs(fs), hh, L, hh, n, g0, h * h, 1,
                *args(plan)), "stage_plans")
            return out

        def k29(plan, L=L, g0=g0, fs=fs):
            out = torch.empty((L, n, n), device=dev)
            pk._check(lib.mg_seg_smooth_from_zero_stage(
                out.data_ptr(), *px._ptrs(fs), hh, L, hh, n, g0, h * h, 1, *args(plan)),
                "stage_plans")
            return out

        where = {"L": L, "rank": rank}
        cases.append(("K31", where, k31, candidates(n, True, sms, planes),
                      first_form_1d(cs, es_, fs, L, g0),
                      px.prolong_smooth_halo_plain(c3, e3, f3, gi0, h, n_iter, n, L)))
        cases.append(("K28", where, k28, candidates(n, False, sms, planes),
                      first_smooth_1d(es_, fs, L, g0),
                      px.rb_smooth_halo_plain(e3, f3, gi0, h, n_iter, n, L, True)))
        cases.append(("K29", where, k29, candidates(n, False, sms, planes),
                      first_zero_1d(fs, L, g0),
                      px.rb_smooth_from_zero_halo_plain(f3, gi0, h, n_iter, n, L, True)))
    blocks = ((272 * (n - 1) // 256, (1, 0)), (144 * (n - 1) // 256, (2, 0))) if n >= 33 else ()
    for w, (nx, ix) in blocks:
        E, F, EC = rnd(nx * w, nx * w, n), rnd(nx * w, nx * w, n), rnd(nx * w // 2, nx * w // 2,
                                                                           nc)
        e5 = seg_parts2d(E, ix, ix, w, hh, hh)
        f5 = seg_parts2d(F, ix, ix, w, hh, hh)
        c5 = seg_parts2d(EC, ix, ix, w // 2, n_iter, n_iter + 1)
        es_, fs = px2._seg2(e5, w, w, hh, hh, hh, hh), px2._seg2(f5, w, w, hh, hh, hh, hh)
        kc = n_iter + 1
        cs = px2._seg2(c5, w // 2, w // 2, n_iter, kc, n_iter, kc)
        g0 = ix * w
        extent = px.seg_rect_planes(g0, w, n)

        def k40(plan, w=w, g0=g0, es_=es_, fs=fs, cs=cs):
            out = torch.empty((w, w, n), device=dev)
            pk._check(lib.mg_seg2d_prolong_stage(
                out.data_ptr(), cs.desc(), es_.desc(), fs.desc(), hh, hh, kc, kc, w, w, n, g0, g0,
                h * h, *args(plan)), "stage_plans")
            return out

        def k37(plan, w=w, g0=g0, es_=es_, fs=fs):
            out = torch.empty((w, w, n), device=dev)
            pk._check(lib.mg_seg2d_smooth_stage(
                out.data_ptr(), es_.desc(), fs.desc(), hh, hh, w, w, n, g0, g0, h * h, 1,
                *args(plan)), "stage_plans")
            return out

        def k38(plan, w=w, g0=g0, fs=fs):
            out = torch.empty((w, w, n), device=dev)
            pk._check(lib.mg_seg2d_smooth_from_zero_stage(
                out.data_ptr(), fs.desc(), hh, hh, w, w, n, g0, g0, h * h, 1, *args(plan)),
                "stage_plans")
            return out

        where = {"Li": w, "Lj": w, "rank": [ix, ix], "mesh": [nx, nx]}
        cases.append(("K40", where, k40, candidates(n, True, sms, extent, extent),
                      first_form_2d(cs, es_, fs, w, w, g0, g0),
                      px2.prolong_smooth_halo2d_plain(c5, e5, f5, (g0 - hh, g0 - hh), h, n_iter,
                                                      n, w, w)))
        cases.append(("K37", where, k37, candidates(n, False, sms, extent, extent),
                      first_smooth_2d(es_, fs, w, w, g0, g0),
                      px2.rb_smooth_halo2d_plain(e5, f5, (g0 - hh, g0 - hh), h, n_iter, n, w, w,
                                                 True)))
        cases.append(("K38", where, k38, candidates(n, False, sms, extent, extent),
                      first_zero_2d(fs, w, w, g0, g0),
                      px2.rb_smooth_from_zero_halo2d_plain(f5, (g0 - hh, g0 - hh), h, n_iter, n,
                                                           w, w, True)))
    u, f = rnd(n, n, n), rnd(n, n, n)
    planner = {"planner": ps._stage_plan(n, n_iter, sms, rect=True)}
    cases.append(("K1", {}, lambda plan: launch(plan, f, h, u=u), planner, None,
                  pk.rb_smooth_plain(u, f, h, n_iter, True)))
    cases.append(("K2", {}, lambda plan: launch(plan, f, h), planner, None,
                  pk.rb_smooth_from_zero_plain(f, h, n_iter, True)))
    for kernel, where, launch_on, plans, first, want in cases:
        if kernels and kernel not in kernels:
            continue
        extra = [] if first is None else [("first_form", None)]
        for label, plan in list(plans.items()) + extra:
            run = first if plan is None else (lambda plan=plan: launch_on(plan))
            exact = bool(torch.equal(run(), want))
            torch.cuda.synchronize()
            intervals = kernel_intervals(lambda: [run() for _ in range(reps)])
            per = [(b - a) / 1e3 for a, b, name, *_ in intervals
                   if ("rect_stage" if kernel in ("K1", "K2") else "seg_") in name]
            calls = [sum(per[i:i + 4]) for i in range(0, len(per), 4)] if plan is None else per
            row = {"n": n, "kernel": kernel, **where, "plan": label, "exact": exact,
                   "device_ms": statistics.median(calls) if calls else None}
            if plan is not None:
                row.update({"box": plan.box, "bi": plan.bi, "bj": plan.bj, "bk": plan.bk,
                            "blocks": plan.blocks, "threads": plan.threads, "smem": plan.smem})
            print(json.dumps(row), flush=True)


def _even_at_least(*xs):
    """The least even number at least each of xs."""
    return 2 * -(-max(xs) // 2)


def seg_restrict_candidates(n, sms, rows, cols=None):
    """The segment planner's plan (``_restrict_plan`` with the rank's
    interior coarse rows and columns) and plans of bci x bcj coarse rows
    and columns of it, whole k rows or two k tiles, that the kernels take."""
    m = (n + 1) // 2 - 2
    plans = {"planner": ps._restrict_plan(n, sms, seg_rows=rows, seg_cols=cols)}
    half = -(-m // 2)
    for bck in sorted({m, half}):
        chunks = ps._restrict_chunks(bck, False)
        if chunks is None:
            continue
        for bcj in (1, 2, 4, 8):
            bcj = evened(cols or m, bcj)
            smem = ps._restrict_smem(bcj, bck, False)
            for bci in (1, 2, 4, 8, 16, 32):
                bci = evened(rows, bci)
                plans[f"{bci}x{bcj}x{bck}"] = ps.RestrictPlan(
                    n, False, bci, bcj, bck, chunks, 32 * (2 * bcj + 1), smem, rows=rows,
                    cols=cols)
    return plans


def time_seg_restrict(n, sms, reps, dev):
    """One JSON line a (kernel, segment, plan) at level n: K30 on the
    one-rank segment (L = 320 (n - 1) / 256, rank 0) and on rank 1's of
    four (L = 96 (n - 1) / 256), and K39 on the 1x1 block (272 (n - 1) /
    256 rows and columns) and on rank (0, 0)'s of the 2x2 mesh (144 (n - 1)
    / 256), each even and covering the level where the production plans
    stop, of random fields: each candidate plan of the rank's interior
    coarse rows and columns (``seg_restrict_candidates``) launched through
    the stage's launchers; then K3's stage on the level on its planner's
    plan, all held against their plain versions, with the median device
    time a call over ``reps`` calls from a trace of their own."""
    from multigrid_parallel_tpu_torch.ops import pallas_sharded as px
    from multigrid_parallel_tpu_torch.ops import pallas_sharded2d as px2

    h, nc = 1.0 / (n - 1), (n + 1) // 2
    inv_h2 = 1.0 / (h * h)
    lib, stream = pk._lib(), pk._stream()
    rng = np.random.default_rng(n)

    def rnd(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(dev)

    cases = []
    for L, rank in ((_even_at_least(320 * (n - 1) // 256, n), 0),
                    (_even_at_least(96 * (n - 1) // 256, -(-n // 4)), 1)):
        e, f = rnd((rank + 2) * L, n, n), rnd((rank + 2) * L, n, n)
        g0 = rank * L
        e3, f3 = seg_parts(e, rank, L, 2, 1), seg_parts(f, rank, L, 2, 1)
        es_, fs = (px._seg(x, 2, 1, L, composite=False) for x in (e3, f3))
        rows, _ = px.seg_restrict_extents(n, g0, L)

        def k30(plan, L=L, g0=g0, es_=es_, fs=fs):
            out = torch.empty((L // 2, nc, nc), device=dev)
            pk._check(lib.mg_seg_restrict_stage(out.data_ptr(), *px._ptrs(es_), *px._ptrs(fs), 2,
                                                L, 1, n, g0, inv_h2, *plan.args, stream),
                      "stage_plans")
            return out

        cases.append(("K30", {"L": L, "rank": rank}, k30, seg_restrict_candidates(n, sms, rows),
                      px.residual_restrict_halo_plain(e3, f3, g0 - 2, h, n, L // 2)))
    for w, nx in ((_even_at_least(272 * (n - 1) // 256, n), 1),
                  (_even_at_least(144 * (n - 1) // 256, -(-n // 2)), 2)):
        E, F = rnd(nx * w, nx * w, n), rnd(nx * w, nx * w, n)
        e5, f5 = seg_parts2d(E, 0, 0, w, 2, 1), seg_parts2d(F, 0, 0, w, 2, 1)
        es_, fs = (px2._seg2(x, w, w, 2, 1, 2, 1, composite=False) for x in (e5, f5))
        rows, cols = px.seg_restrict_extents(n, 0, w, 0, w)

        def k39(plan, w=w, es_=es_, fs=fs):
            out = torch.empty((w // 2, w // 2, nc), device=dev)
            pk._check(lib.mg_seg2d_restrict_stage(out.data_ptr(), es_.desc(), fs.desc(), 1, 1, w,
                                                  w, n, 0, 0, inv_h2, *plan.args, stream),
                      "stage_plans")
            return out

        cases.append(("K39", {"Li": w, "Lj": w, "rank": [0, 0], "mesh": [nx, nx]}, k39,
                      seg_restrict_candidates(n, sms, rows, cols),
                      px2.residual_restrict_halo2d_plain(e5, f5, (-2, -2), h, n, w // 2, w // 2)))
    e, f = rnd(n, n, n), rnd(n, n, n)
    k3_plan = ps._restrict_plan(n, sms)
    cases.append(("K3", {}, lambda plan: restrict_launch(plan, (e,), (f,), h),
                  {"planner": k3_plan}, pk.residual_restrict_plain(e, f, h)))
    for kernel, where, launch_on, plans, want in cases:
        for label, plan in plans.items():
            run = lambda plan=plan: launch_on(plan)  # noqa: E731
            exact = bool(torch.equal(run(), want))
            torch.cuda.synchronize()
            times = [(b - a) / 1e3 for a, b, name, *_ in
                     kernel_intervals(lambda: [run() for _ in range(reps)]) if "restrict" in name]
            print(json.dumps({"n": n, "kernel": kernel, **where, "plan": label, "bci": plan.bci,
                              "bcj": plan.bcj, "bck": plan.bck, "blocks": plan.blocks,
                              "threads": plan.threads, "smem": plan.smem, "exact": exact,
                              "device_ms": statistics.median(times) if times else None}),
                  flush=True)


def seg_df_candidates(n, rows, cols, sms, stage="df"):
    """The df stage planner's plan (``_df_plan`` of the rank's interior
    planes and rows; K33's with ``stage`` "resid") and plans of bi planes x bj
    rows, whole k rows or two k tiles, that the kernels take."""
    plans = {"planner": ps._df_plan(n, sms, rows, cols, stage)}
    for plan in ps._df_candidates(n, rows, cols, stage):
        if (plan.bj == evened(cols, plan.bj) and plan.bj in (evened(cols, 4), evened(cols, 8))
                and plan.bi in {evened(rows, b) for b in (8, 16, 32, 64)}):
            plans[f"{plan.bi}x{plan.bj}x{plan.bk}"] = plan
    return plans


def _df_calls(intervals):
    """Each call's device ms from a trace of df calls: the kernels up to and
    including each sum_partials_kernel (a stage's or first form's partials,
    then their sum)."""
    calls, t = [], 0.0
    for a, b, name, *_ in intervals:
        t += (b - a) / 1e3
        if name.startswith("sum_partials_kernel"):
            calls.append(t)
            t = 0.0
    return calls


def time_seg_df(n, sms, reps, dev):
    """One JSON line a (kernel, segment, plan) at level n: K32 on the
    one-rank segment (L = 320 (n - 1) / 256, rank 0) and on rank 1's of
    four (L = 96 (n - 1) / 256), and K41 on the 1x1 block (272 (n - 1) /
    256 rows and columns) and on rank (0, 0)'s of the 2x2 mesh (144 (n - 1)
    / 256), each covering the level where the production plans stop, of
    random double-float fields: each candidate plan of the rank's interior
    (``seg_df_candidates``) launched through the stage's launchers, and the
    first form (one thread a point) as the plan "first_form" where the
    package has it; then K5 on the level; all held against their plain
    versions (r bit for bit, the norm within rel 1e-6), with the median
    device time a call (its partials kernel and their sum) over ``reps``
    calls from a trace of their own."""
    from multigrid_parallel_tpu_torch.ops import pallas_sharded as px
    from multigrid_parallel_tpu_torch.ops import pallas_sharded2d as px2

    h = 1.0 / (n - 1)
    inv_h2 = 1.0 / (h * h)
    lib, stream = pk._lib(), pk._stream()
    first_form = hasattr(lib, "mg_seg_residual_df_norm")
    rng = np.random.default_rng(n)

    def df(*shape):
        return [t.to(dev) for _ in range(2)
                for t in pk.df_split(torch.from_numpy(rng.standard_normal(shape)))]

    def outputs(shape, blocks):
        return (torch.empty(shape, device=dev), torch.empty((), device=dev),
                torch.empty(blocks, dtype=torch.float64, device=dev))

    cases = []
    for L, rank in ((_even_at_least(320 * (n - 1) // 256, n), 0),
                    (_even_at_least(96 * (n - 1) // 256, -(-n // 4)), 1)):
        fields = df((rank + 2) * L, n, n)
        parts = [seg_parts(x, rank, L, 1, 1) for x in fields]
        uh, ul = (px._seg(x, 1, 1, L) for x in parts[:2])
        fh, fl = parts[2][0], parts[3][0]
        g0 = rank * L
        rows, cols = px.seg_df_extents(n, g0, L)

        def k32(plan, L=L, g0=g0, uh=uh, ul=ul, fh=fh, fl=fl):
            if plan is None:
                r, nrm2, partials = outputs((L, n, n), lib.mg_seg_residual_df_norm_partials(L, n))
                err = lib.mg_seg_residual_df_norm(r.data_ptr(), nrm2.data_ptr(),
                                                  partials.data_ptr(), *px._ptrs(uh),
                                                  *px._ptrs(ul), fh.data_ptr(), fl.data_ptr(), L,
                                                  n, g0, inv_h2, stream)
            else:
                r, nrm2, partials = outputs((L, n, n), plan.blocks)
                err = lib.mg_seg_df_stage(r.data_ptr(), nrm2.data_ptr(), partials.data_ptr(),
                                          plan.blocks, *px._ptrs(uh), *px._ptrs(ul),
                                          fh.data_ptr(), fl.data_ptr(), 1, L, 1, n, g0, inv_h2,
                                          *plan.args, stream)
            pk._check(err, "stage_plans")
            return r, nrm2

        cases.append(("K32", {"L": L, "rank": rank}, k32, seg_df_candidates(n, rows, cols, sms),
                      px.residual_df_norm_halo_plain(*parts, g0 - 1, h, n, L)))
    for w, nx in ((_even_at_least(272 * (n - 1) // 256, n), 1),
                  (_even_at_least(144 * (n - 1) // 256, -(-n // 2)), 2)):
        fields = df(nx * w, nx * w, n)
        parts = [seg_parts2d(x, 0, 0, w, 1, 1) for x in fields]
        segs = px2._norm_segs(parts, w, w)
        rows, cols = px.seg_df_extents(n, 0, w, 0, w)

        def k41(plan, w=w, segs=segs):
            if plan is None:
                r, nrm2, partials = outputs((w, w, n),
                                            lib.mg_seg2d_residual_df_norm_partials(w, w, n))
                err = lib.mg_seg2d_residual_df_norm(r.data_ptr(), nrm2.data_ptr(),
                                                    partials.data_ptr(),
                                                    *(s.desc() for s in segs), w, w, n, 0, 0,
                                                    inv_h2, stream)
            else:
                r, nrm2, partials = outputs((w, w, n), plan.blocks)
                err = lib.mg_seg2d_df_stage(r.data_ptr(), nrm2.data_ptr(), partials.data_ptr(),
                                            plan.blocks, *(s.desc() for s in segs), 1, 1, w, w,
                                            n, 0, 0, inv_h2, *plan.args, stream)
            pk._check(err, "stage_plans")
            return r, nrm2

        cases.append(("K41", {"Li": w, "Lj": w, "rank": [0, 0], "mesh": [nx, nx]}, k41,
                      seg_df_candidates(n, rows, cols, sms),
                      px2.residual_df_norm_halo2d_plain(*parts, (-1, -1), h, n, w, w)))
    cube = df(n, n, n)
    cases.append(("K5", {}, lambda plan: pk.residual_df_norm_fused(*cube, h), {"kernel": None},
                  pk.residual_df_norm_plain(*cube, h)))
    for kernel, where, launch_on, plans, (want, want_n2) in cases:
        extra = [("first_form", None)] if first_form and kernel != "K5" else []
        for label, plan in list(plans.items()) + extra:
            run = lambda plan=plan: launch_on(plan)  # noqa: E731
            got, got_n2 = run()
            exact = bool(torch.equal(got, want)) and (
                abs(float(got_n2) - float(want_n2)) <= 1e-6 * abs(float(want_n2)))
            torch.cuda.synchronize()
            calls = _df_calls(kernel_intervals(lambda: [run() for _ in range(reps)]))
            row = {"n": n, "kernel": kernel, **where, "plan": label, "exact": exact,
                   "device_ms": statistics.median(calls) if calls else None}
            if plan is not None:
                row.update({"bi": plan.bi, "bj": plan.bj, "bk": plan.bk, "blocks": plan.blocks,
                            "threads": plan.threads, "smem": plan.smem,
                            "cost_us": round(ps._df_cost(plan, sms), 2)})
            print(json.dumps(row), flush=True)


def seg_parts2d(x, ix, iy, L, kl, kr):
    """Rank (ix, iy)'s own five parts (body, jl, jr, lh, rh) of the global
    field x of square (L, L) blocks, halos kl before and kr after in i and
    j, corners included; zeros past the chain's ends."""
    rows, cols, m = x.shape
    g = x.new_zeros((rows + kl + kr, cols + kl + kr, m))
    g[kl:kl + rows, kl:kl + cols] = x
    e = g[ix * L:ix * L + kl + L + kr, iy * L:iy * L + kl + L + kr]
    mid = e[kl:kl + L]
    return (mid[:, kl:kl + L].clone(), mid[:, :kl].clone(), mid[:, kl + L:].clone(),
            e[:kl].clone(), e[kl + L:].clone())


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--sizes", type=int, nargs="+",
                        help="level sizes (default 9 17 33 65 129; with --seg 65 129 257)")
    parser.add_argument("--reps", type=int, default=20)
    parser.add_argument("--parent", type=str,
                        help="with --mixed, --msplit or --restrict: a checkout whose K13, K21 "
                             "or K23 first form is timed beside the stage; with --offpath, "
                             "K26's (its in-place half-sweeps and last launch) and K33's")
    parser.add_argument("--kernels", nargs="+",
                        help="with --seg-rect, --msplit, --restrict or --offpath: time only "
                             "these (K1 K2 K28 K29 K31 K37 K38 K40; K21 K22 K24; K3 K9 K18 "
                             "K23; K26 K42 K33, and R K5 K6 K11 K12 K20 K25 K27)")
    group = parser.add_mutually_exclusive_group()
    group.add_argument("--restrict", action="store_true",
                       help="time K3's, K9's, K18's and K23's restriction stage (and K18's "
                            "and K23's first forms) instead")
    group.add_argument("--fold", action="store_true",
                       help="time K17's, K16's and K19's fold stages instead")
    group.add_argument("--mixed", action="store_true",
                       help="time K14's, K13's and K15's full-layout mixed stages instead")
    group.add_argument("--seg", action="store_true",
                       help="time K35's, K34's and K36's stages on the production segments "
                            "(L = 320 and 96 at 257^3, scaled with n) instead")
    group.add_argument("--seg-rect", action="store_true",
                       help="time K31's, K28's, K29's, K40's, K37's and K38's Dirichlet stages "
                            "on the production segments and blocks, and K1's and K2's, instead")
    group.add_argument("--msplit", action="store_true",
                       help="time K22's, K21's and K24's mixed stages on the split pair "
                            "instead")
    group.add_argument("--seg-restrict", action="store_true",
                       help="time K30's and K39's restriction stages on the production "
                            "segments and blocks, and K3's, instead")
    group.add_argument("--offpath", action="store_true",
                       help="time the kernels no solve launches, K26, K42 and K33, beside "
                            "their first forms (at 9^3-513^3 by default) instead")
    group.add_argument("--seg-df", action="store_true",
                       help="time K32's and K41's df residual-and-norm stages on the production "
                            "segments and blocks (and their first forms), and K5, instead")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("stage_plans: needs a CUDA device")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    print(f"[card] {card}", flush=True)
    dev = torch.device("cuda")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    if args.sizes is None:
        args.sizes = ([65, 129, 257] if args.seg else [129, 257] if args.seg_rect
                      else [9, 17, 33, 65, 129, 257, 513] if args.offpath
                      else [9, 17, 33, 65, 129, 257] if args.seg_restrict
                      else [65, 129, 257, 513] if args.seg_df
                      else [9, 17, 33, 65, 129])
    if args.offpath:
        kernels = args.kernels or OFFPATH_KERNELS
        for n in args.sizes:
            time_offpath(n, args.reps, dev, kernels, sms, args.parent)
            time_retimed(n, args.reps, dev, [k for k in kernels if k in RETIMED_KERNELS])
        return 0
    if args.seg_rect:
        for n in args.sizes:
            time_seg_rect(n, sms, args.reps, dev, args.kernels)
        return 0
    if args.seg_restrict:
        for n in args.sizes:
            time_seg_restrict(n, sms, args.reps, dev)
        return 0
    if args.seg_df:
        for n in args.sizes:
            time_seg_df(n, sms, args.reps, dev)
        return 0
    if args.seg:
        for n in args.sizes:
            for L in (320 * (n - 1) // 256, 96 * (n - 1) // 256):
                time_seg(n, L, sms, args.reps, dev)
        return 0
    if args.restrict:
        for n in args.sizes:
            time_restrict(n, sms, args.reps, dev, args.kernels, args.parent)
        return 0
    if args.msplit:
        for n in args.sizes:
            time_msplit(n, sms, args.reps, dev, args.kernels, args.parent)
        return 0
    if args.fold or args.mixed:
        for n in args.sizes:
            time_electrospray(n, sms, args.reps, dev, args.fold, args.parent)
        return 0
    for n in args.sizes:
        h = 1.0 / (n - 1)
        rng = np.random.default_rng(n)
        e, f, ec = (torch.from_numpy(rng.standard_normal((m, m, m)).astype(np.float32)).to(dev)
                    for m in (n, n, (n + 1) // 2))
        for kernel, prolong in (("K2", False), ("K4", True)):
            want = (pk.prolong_smooth_plain(ec, e, f, h, 2) if prolong
                    else pk.rb_smooth_from_zero_plain(f, h, 2, True))
            for label, plan in candidates(n, prolong, sms).items():
                run = ((lambda: launch(plan, f, h, ec=ec, u=e)) if prolong
                       else (lambda: launch(plan, f, h)))
                exact = bool(torch.equal(run(), want))
                torch.cuda.synchronize()
                times = [(b - a) / 1e3 for a, b, name, *_ in
                         kernel_intervals(lambda: [run() for _ in range(args.reps)])
                         if name.startswith("rect_")]
                print(json.dumps({"n": n, "kernel": kernel, "plan": label, "box": plan.box,
                                  "bi": plan.bi, "bj": plan.bj, "blocks": plan.blocks,
                                  "threads": plan.threads, "smem": plan.smem, "exact": exact,
                                  "device_ms": statistics.median(times) if times else None}),
                      flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
