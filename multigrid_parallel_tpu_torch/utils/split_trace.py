"""Trace the split-colour and the fused double-float 257^3 solves of one or
more checkouts of the port, in turns on one card: two versions of the
split-colour kernels compared within one call, with the fused solve,
which runs none of them, as the control; or, with ``--electrospray``, the
electrospray's full, fold and split-colour tiers at 257^3; or, with
``--sharded-electrospray``, the i-sharded electrospray solve at 257^3 on
one NCCL rank, with the full tier as the control; or, with ``--sharded``
and ``--sharded2d``, the i-sharded and the (i, j)-sharded Dirichlet solves
at 257^3 on one NCCL rank, with the fused solve as the control.

    python -m multigrid_parallel_tpu_torch.utils.split_trace [ROOT ...] [--rounds R]
                                             [--electrospray [--inner-cycles N]
                                              | --sharded-electrospray
                                              | --sharded | --sharded2d]

Each ROOT is a directory that holds a ``multigrid_parallel_tpu_torch``
package (default: this checkout). Round r runs every ROOT once, each in a
process of its own (this file run as a script, the ROOT's package first
on the path), in the order given on even rounds and reversed on odd ones:
A B, B A, ... A process builds its checkout's kernels, solves each path
twice to warm up, times ``--walls`` solves of each (host clock,
interleaved, alternating which goes first), then takes ``--traces``
torch.profiler traces of each solve and prints one JSON line: per path
the outer steps, the median wall and every wall, and from the trace with
the median busy time the device busy time (the union of kernel
intervals), the kernel count, the span from the first kernel to the last, the idle share of that
span, each kernel name's summed ms, count and the device idle time
just before its kernels (``idle_before``; a stage kernel's name carries
its template arguments, which tell K1 from K2 and K7 from K8), and each
smoothing stage call's device time by level (``stage_calls``: K1, K2, K4,
K7, K8, K10, K13-K17, K19, K21, K22, K24, K28, K29, K31, K34-K38 and K40,
the one-pass form's kernel, or a first form's head kernel and the
half-sweeps that follow it, and the BC pass that ends a mixed-BC call),
and each restriction call's (``restrict_calls``: K3, K9, K18, K23, K30 and
K39, a kernel a call, the first forms' one thread a coarse point or the
streaming stage's plan; K30's and K39's stage on a rank's segments,
``seg_restrict_kernel``, by its plan of the rank's interior rows), and each
double-float residual-and-norm call's (``norm_calls``: K5, K32 and K41, the
partials kernel and the sum after it; K32's and K41's first form, one
thread a point, or their stage, ``df_stage_kernel``). The parent prints
the lines as they come and the card's name and power limit, and at the
end each path's solution of round 0 against the first ROOT's
(max|u - u_0|, held in a temporary directory).

The problem is ``chip_smoke.py``'s main path: the quadratic Dirichlet
problem at 257^3 (coarse_n 5, 7 levels), n_smooth 2, 4 inner V-cycles an
outer step, rel_tol 1e-8 of the reference initial norm. With
``--electrospray``: its phases 7 and 8, the electrospray problem at 257^3
in the production configuration (n_smooth 2, gamma 2 capped at 65^3, one
inner cycle an outer step, rel_tol 1e-8) on the full tier (``full``,
K13-K15 with K3 and K5, its phase 6), the fold tier (``fold``, K16-K20)
and the split-colour tier (``split``, K22-K25 on the finest level over
the fold cycle below it); with ``--inner-cycles 2`` two finest-level
cycles an outer step, the second from the correction so far (the split
tier's K21, the fold tier's K16 and the full tier's K13 at the finest
level). With ``--sharded-electrospray``: phase 11b of
``chip_smoke.py``, the same solve through
``parallel.sharded_mixed_padded.make_sharded_mixed_padded_df_solver`` on
one rank of an NCCL group (world size 1, started in the child process;
the plan shards six levels, L = 320 at 257^3: K34-K36, K30 and K32),
``sharded``, and the full tier, ``full``, as the control. With
``--sharded``: phase 10b, the Dirichlet problem's solve through
``parallel.sharded_padded.make_sharded_df_solver`` on one rank of an NCCL
group (world size 1; the plan shards six levels, L = 320 at 257^3:
K28-K32), ``sharded``, and the fused solve, ``fused``; with
``--sharded2d``: phase 12b, the same through
``parallel.sharded2d_padded.make_sharded2d_padded_df_solver`` on a 1x1
mesh (the plan shards four levels, Li = Lj = 272 at 257^3: K37-K41, then
K2-K4 in the replicated 17^3 tail), ``sharded2d``, and ``fused``. Both
modes run on a checkout of any version: what a parent lacks (a one-pass
stage, its plan's arguments) is skipped.
"""

from __future__ import annotations

import argparse
import json
import re
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

HERE = Path(__file__).resolve()
THIS_ROOT = HERE.parents[2]


# the chrome export's categories of device work: kernels, copies, fills
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def short_name(name):
    """A kernel's function name from the trace's, with its template
    arguments where it has them (``rect_stage_kernel<2, true, false>``,
    from a demangled name, ``<2, true, false>`` or ``<(int)2, (bool)1,
    (bool)0>``, or from a mangled one's Li2E, Lb1E, ...)."""
    found = re.search(r"([a-z_]+_kernel)(?![a-z_])(<[^<>]*>|I(?:L[a-z]+\d+E)+E)?", name)
    if not found:
        return name[:60]
    args = found.group(2) or ""
    if args.startswith("I"):
        args = "<" + ", ".join(v if t != "b" else ("true" if v == "1" else "false")
                               for t, v in re.findall(r"L([a-z]+)(\d+)E", args)) + ">"
    args = args.replace("(bool)1", "true").replace("(bool)0", "false").replace("(int)", "")
    return found.group(1) + args


def kernel_intervals(fn, guard_s=0.0):
    """The device kernels (and copies and fills) of one call of fn, from a
    torch.profiler trace: (start us, end us, name, shape) sorted by start,
    a kernel by its function's name (with its template arguments, as
    ``<2, true, false>``, where the name has them, demangled or not), its
    shape the grid and the shared memory from the trace's chrome export (() where the export holds no
    device events, and the times then from the profiler's events). With
    ``guard_s``, the trace idles that long, the device drained, before fn
    and after it, so that kernel records that come late or whose device
    timestamps stray from the host's clock stay inside the profiler's
    window. Defined here, not imported from the package, so that it serves
    a checkout of any version."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        if guard_s:
            torch.cuda.synchronize()
            time.sleep(guard_s)
        fn()
        torch.cuda.synchronize()
        if guard_s:
            time.sleep(guard_s)

    with tempfile.TemporaryDirectory() as tmp:
        path = Path(tmp) / "trace.json"
        prof.export_chrome_trace(str(path))
        events = json.loads(path.read_text()).get("traceEvents", [])
    out = [(e["ts"], e["ts"] + e["dur"], short_name(e["name"]),
            tuple(e.get("args", {}).get("grid", ())) + (e.get("args", {}).get("shared memory"),))
           for e in events if e.get("cat") in DEVICE_CATS and "dur" in e]
    if not out:
        out = [(e.time_range.start, e.time_range.end, short_name(e.name), ())
               for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    return sorted(out)


def device_trace(fn, guard_s=0.0):
    """(busy ms, kernels, by_name, span ms) of one call of fn: the union
    of the device's kernel intervals, their count, each kernel name's
    summed ms and count, and the span from the first kernel's start to
    the last one's end; (None, 0, {}, None) when the trace holds no device
    events. ``guard_s`` as in ``kernel_intervals``."""
    return _summary(kernel_intervals(fn, guard_s))


def _summary(intervals):
    if not intervals:
        return None, 0, {}, None
    by_name = {}
    for a, b, name, *_ in intervals:
        ms, count = by_name.get(name, (0.0, 0))
        by_name[name] = (ms + (b - a) / 1e3, count + 1)
    busy, lo, hi = 0.0, intervals[0][0], intervals[0][1]
    for a, b, *_ in intervals[1:]:
        if a > hi:
            busy, lo = busy + hi - lo, a
        hi = max(hi, b)
    span = (hi - intervals[0][0]) / 1e3
    return (busy + hi - lo) / 1e3, len(intervals), by_name, span


def idle_before(intervals):
    """Each kernel name's summed device idle time just before its kernels
    start (ms): where the device waited for that kernel, the host's
    launch or the SM's reconfiguration."""
    out, hi = {}, None
    for a, b, name, *_ in intervals:
        if hi is not None and a > hi:
            out[name] = out.get(name, 0.0) + (a - hi) / 1e3
        hi = b if hi is None else max(hi, b)
    return out


# the smoothing stages' kernels: the one-pass forms (rect.cuh, split.cuh;
# rect_stage_kernel, split_stage_kernel, fold_stage_kernel,
# mixed_stage_kernel and msplit_stage_kernel by their ZERO argument, below)
# and the first forms' head kernels, each with the half-sweep kernels that
# may continue its call (a half-sweep that follows none heads a call of
# its own; after a continuing kernel, those FIRST_FORM names for it, else
# itself) and, for the mixed-BC forms, the BC-pass kernel that ends it (the
# fold's first-form K17 head is the half-sweep kernel with its FromZero
# argument true; the full tier's first-form K14 head is K2's from-zero
# kernel, followed by the mixed half-sweeps; the msplit tier's first-form
# K24 head is its red correction, not a half-sweep (HEAD_SWEEPS), followed
# by the black correction's half-sweep and three more)
STAGE_KERNELS = {"rect_prolong_stage_kernel": "K4", "split_prolong_stage_kernel": "K10",
                 "rb_half_sweep_from_zero_kernel": "K2", "prolong_correct_black_kernel": "K4",
                 "rb_half_sweep_kernel": "K1", "split_half_sweep_from_zero_kernel": "K8",
                 "split_half_sweep_kernel": "K7", "fold_prolong_stage_kernel": "K19",
                 "mixed_fold_prolong_correct_black_kernel": "K19",
                 "mixed_prolong_stage_kernel": "K15", "mixed_prolong_correct_black_kernel": "K15",
                 "mixed_half_sweep_kernel": "K13", "msplit_prolong_stage_kernel": "K24",
                 "msplit_prolong_correct_red_kernel": "K24",
                 "msplit_half_sweep_from_zero_kernel": "K22", "msplit_half_sweep_kernel": "K21",
                 "seg_mixed_half_sweep_kernel": "K34", "seg_half_sweep_from_zero_kernel": "K29",
                 "mixed_seg_stage_kernel": "K35", "mixed_seg_prolong_stage_kernel": "K36",
                 "seg_mixed_prolong_correct_black_kernel": "K36",
                 "seg_half_sweep_kernel": "K28", "seg_prolong_correct_black_kernel": "K31",
                 "seg_prolong_stage_kernel": "K31", "seg_smooth_stage_kernel": "K28",
                 "seg_smooth_from_zero_stage_kernel": "K29"}
# the i-sharded Dirichlet kernels' (i, j) twins: the same templates on the 2D
# accessor (their names' template arguments hold Seg2: Seg2StageArgs for the
# one-pass K40), or "K28|K37" where the trace drops the arguments
SEG2D_TWINS = {"K28": "K37", "K29": "K38", "K30": "K39", "K31": "K40"}
FIRST_FORM = {"rb_half_sweep_from_zero_kernel": ("rb_half_sweep_kernel",
                                                 "mixed_half_sweep_kernel"),
              "prolong_correct_black_kernel": ("rb_half_sweep_kernel",),
              "rb_half_sweep_kernel": ("rb_half_sweep_kernel",),
              "split_half_sweep_from_zero_kernel": ("split_half_sweep_kernel",),
              "split_half_sweep_kernel": ("split_half_sweep_kernel",),
              "mixed_fold_half_sweep_kernel": ("mixed_fold_half_sweep_kernel",),
              "mixed_fold_prolong_correct_black_kernel": ("mixed_fold_half_sweep_kernel",),
              "mixed_half_sweep_kernel": ("mixed_half_sweep_kernel",),
              "mixed_prolong_correct_black_kernel": ("mixed_half_sweep_kernel",),
              "msplit_half_sweep_from_zero_kernel": ("msplit_half_sweep_kernel",),
              "msplit_half_sweep_kernel": ("msplit_half_sweep_kernel",),
              "msplit_prolong_correct_red_kernel": ("msplit_prolong_correct_black_kernel",),
              "msplit_prolong_correct_black_kernel": ("msplit_half_sweep_kernel",),
              "seg_half_sweep_from_zero_kernel": ("seg_half_sweep_kernel",
                                                  "seg_mixed_half_sweep_kernel"),
              "seg_mixed_half_sweep_kernel": ("seg_mixed_half_sweep_kernel",),
              "seg_mixed_prolong_correct_black_kernel": ("seg_mixed_half_sweep_kernel",),
              "seg_half_sweep_kernel": ("seg_half_sweep_kernel",),
              "seg_prolong_correct_black_kernel": ("seg_half_sweep_kernel",)}
HEAD_SWEEPS = {"msplit_prolong_correct_red_kernel": 0}  # half-sweeps a head counts (else 1)
BC_PASS = {"mixed_fold_half_sweep_kernel": "mixed_fold_bc_pass_kernel",
           "mixed_half_sweep_kernel": "mixed_bc_pass_kernel",
           "msplit_half_sweep_kernel": "msplit_bc_pass_kernel",
           "seg_mixed_half_sweep_kernel": "seg_mixed_bc_pass_kernel"}
# a from-zero head followed by a mixed-BC half-sweep is the first form of another
# stage: K2's with K13's half-sweeps is K14's, K29's with K34's K35's
RELABEL = {("K2", "mixed_half_sweep_kernel"): "K14",
           ("K29", "seg_mixed_half_sweep_kernel"): "K35"}


def _seg_label(base, args, table):
    """The label of an i-sharded Dirichlet kernel (K28-K31) from ``table``,
    or its (i, j) twin's (K37-K40) where its template arguments hold Seg2;
    "K28|K37" where the trace dropped them."""
    label = table.get(base)
    twin = SEG2D_TWINS.get(label)
    if twin is None:
        return label
    if not args:
        return f"{label}|{twin}"
    return twin if "Seg2" in args else label


def stage_label(name):
    """The stage ("K1", ...) whose call a kernel of that name starts, or
    None. rect_stage_kernel<NITER, ZERO, BOX> is K2 where ZERO is true, K1
    where false; split_stage_kernel<NITER, VEC, ZERO> K8 and K7 likewise
    (a checkout whose split kernel has no ZERO argument runs it as K7
    only); "K1|K2" where the trace drops the arguments.
    fold_stage_kernel<NITER, ZERO, BOX> is K17 where ZERO is true, else
    K16 (or a later launch of a K16, K17 or K19 call, n_iter > 2, which
    ``stage_calls`` joins to it); mixed_stage_kernel likewise K14 and K13
    (or a later launch of a K13, K14 or K15 call; a checkout before K13's
    stage runs it only as such); msplit_stage_kernel<NITER, VEC,
    ZERO> likewise K22 and K21 (or a later launch of a K21, K22 or K24
    call; a checkout before K21's stage runs it only as such); the first
    form's
    mixed_fold_half_sweep_kernel<FromZero> heads K17 where true, K16 where
    false or without arguments. The i-sharded electrospray's:
    mixed_seg_stage_kernel<NITER, ZERO, BOX> is K35 where ZERO is true, K34
    where false (a checkout whose kernel has no ZERO argument, <NITER, BOX>,
    runs it as K35 only; "K34|K35" where the trace drops the arguments),
    mixed_seg_prolong_stage_kernel K36 (their one-pass stages); the first
    forms' seg_mixed_half_sweep_kernel heads
    K34, seg_mixed_prolong_correct_black_kernel K36, and K29's
    seg_half_sweep_from_zero_kernel K35 where K34's half-sweeps follow it
    (``stage_calls``). The i-sharded Dirichlet solve's:
    seg_half_sweep_kernel heads K28, seg_half_sweep_from_zero_kernel K29,
    seg_prolong_correct_black_kernel K31's first form, each followed by its
    half-sweeps, and the one-pass stages seg_smooth_stage_kernel (K28),
    seg_smooth_from_zero_stage_kernel (K29) and seg_prolong_stage_kernel
    (K31); each is its (i, j) twin (K37, K38, K40) where its template
    arguments hold Seg2."""
    base, _, args = name.partition("<")
    if base in ("seg_half_sweep_kernel", "seg_half_sweep_from_zero_kernel",
                "seg_prolong_correct_black_kernel", "seg_prolong_stage_kernel",
                "seg_smooth_stage_kernel", "seg_smooth_from_zero_stage_kernel"):
        return _seg_label(base, args, STAGE_KERNELS)
    args = [a.strip() for a in args.rstrip(">").split(",")] if args else []
    if base == "rect_stage_kernel":
        return ("K2" if args[1] == "true" else "K1") if len(args) > 1 else "K1|K2"
    if base == "split_stage_kernel":
        return "K8" if args[2:] == ["true"] else "K7"
    if base == "msplit_stage_kernel":
        return "K22" if args[2:] == ["true"] else "K21" if len(args) > 2 else "K21|K22"
    if base == "fold_stage_kernel":
        return ("K17" if args[1] == "true" else "K16") if len(args) > 1 else "K16|K17"
    if base == "mixed_stage_kernel":
        return ("K14" if args[1] == "true" else "K13") if len(args) > 1 else "K13|K14"
    if base == "mixed_seg_stage_kernel":
        if len(args) == 3:
            return "K35" if args[1] == "true" else "K34"
        return "K35" if args else "K34|K35"
    if base == "mixed_fold_half_sweep_kernel":
        return "K17" if args == ["true"] else "K16"
    return STAGE_KERNELS.get(base)


# the one-pass mixed stages (K16, K17, K19; K13, K14, K15; K21, K22, K24): a
# call of n_smooth > 2 goes on with launches of the loaded stage,
# fold_stage_kernel (mixed_stage_kernel, msplit_stage_kernel) with ZERO
# false, labelled K16 (K13, K21)
ONE_PASS_CHAINS = {"K16": ("fold_stage_kernel", "fold_prolong_stage_kernel"),
                   "K13": ("mixed_stage_kernel", "mixed_prolong_stage_kernel"),
                   "K21": ("msplit_stage_kernel", "msplit_prolong_stage_kernel")}


def stage_calls(intervals, sizes, n_smooth=2):
    """Each smoothing stage call's device time: a call in a first form is
    its head kernel and the half-sweeps that follow it, 2 n_smooth kernels
    in all, and a mixed-BC form's BC pass after them (K2's from-zero head
    followed by the mixed half-sweeps is K14's first form); in the one-pass
    form its one kernel (K24's first form: its red correction, the black
    correction's half-sweep, three half-sweeps and the BC pass), a mixed
    stage's (fold, full layout, split pair) ceil(n_smooth / 2) launches, the
    loaded stage's after the first; K29's from-zero head followed by K34's half-sweeps is K35's
    first form. ``sizes`` maps (kernel name without its arguments, shape) to
    the level's n (a shape without its shared memory where the trace has
    none). Returns
    {"K4 n=257": [calls, summed ms, median ms a call], ...}."""
    groups, sweep = [], None  # sweep: the half-sweep kernels that may continue the last call
    for a, b, name, grid in intervals:
        base = name.split("<")[0]
        label = stage_label(name)
        if sweep and base in sweep and groups[-1][3] < 2 * n_smooth:
            relabel = RELABEL.get((groups[-1][0][1], base))
            if relabel:
                groups[-1][0] = (groups[-1][0][0], relabel)
            groups[-1][2].append((b - a) / 1e3)
            groups[-1][3] += 1
            sweep = FIRST_FORM.get(base, (base,))
        elif sweep and base == BC_PASS.get(sweep[0]) and groups[-1][3] == 2 * n_smooth:
            groups[-1][2].append((b - a) / 1e3)
            groups[-1][3] += 1
            sweep = None
        elif (label in ONE_PASS_CHAINS and not sweep and groups
              and groups[-1][0][0] in ONE_PASS_CHAINS[label]
              and groups[-1][3] < -(-n_smooth // 2)):  # a one-pass call's next launch
            groups[-1][2].append((b - a) / 1e3)
            groups[-1][3] += 1
        elif label:
            groups.append([(base, label), grid, [(b - a) / 1e3], HEAD_SWEEPS.get(base, 1)])
            sweep = FIRST_FORM.get(base)
        else:
            sweep = None
    out = {}
    for (base, label), grid, parts, _ in groups:
        n = sizes.get((base, grid), sizes.get((base, grid[:-1]), grid))
        out.setdefault(f"{label} n={n}", []).append(sum(parts))
    return {key: [len(v), round(sum(v), 4), round(statistics.median(v), 4)]
            for key, v in sorted(out.items())}


# the restriction kernels, a launch a call: the first forms (one thread a
# coarse point) and the streaming stage (restrict.cuh)
RESTRICT_KERNELS = {"residual_restrict_kernel": "K3", "split_residual_restrict_kernel": "K9",
                    "residual_restrict_fold_kernel": "K18", "rect_restrict_kernel": "K3",
                    "split_restrict_kernel": "K9", "fold_restrict_kernel": "K18",
                    "residual_restrict_msplit_kernel": "K23", "msplit_restrict_kernel": "K23",
                    "seg_residual_restrict_kernel": "K30", "seg_restrict_kernel": "K30"}


def restrict_calls(intervals, sizes):
    """Each K3, K9, K18, K23, K30 and K39 call's device time by level (K39: K30's
    kernels on Seg2: the first form's seg_residual_restrict_kernel<mg::Seg2>
    and the stage's seg_restrict_kernel<mg::Seg2, C>), ``sizes`` as
    stage_calls' (``_stage_sizes``): {"K3 n=257": [calls, summed ms, median
    ms a call], ...}."""
    out = {}
    for a, b, name, grid in intervals:
        base, _, args = name.partition("<")
        label = _seg_label(base, args, RESTRICT_KERNELS)
        if label:
            n = sizes.get((base, grid), sizes.get((base, grid[:-1]), grid))
            out.setdefault(f"{label} n={n}", []).append((b - a) / 1e3)
    return {key: [len(v), round(sum(v), 4), round(statistics.median(v), 4)]
            for key, v in sorted(out.items())}


# the double-float residual-and-norm kernels, each call its partials kernel
# and the sum of the partials after it: K5's, and K32's (K41's where the
# template arguments hold Seg2) first form, one thread a point, and stage
NORM_KERNELS = {"residual_df_partials_kernel": "K5", "seg_residual_df_partials_kernel": "K32",
                "df_stage_kernel": "K32"}


def norm_calls(intervals):
    """Each K5, K32 and K41 call's device time, its partials kernel and the
    sum_partials_kernel after it ("K32|K41" where the trace dropped the
    template arguments): {"K32": [calls, summed ms, median ms a call],
    ...}."""
    out, call = {}, None
    for a, b, name, *_ in intervals:
        base, _, args = name.partition("<")
        label = NORM_KERNELS.get(base)
        if label == "K32":
            label = "K32|K41" if not args else "K41" if "Seg2" in args else "K32"
        if label:
            call = [label, (b - a) / 1e3]
        elif base == "sum_partials_kernel" and call:
            out.setdefault(call[0], []).append(call[1] + (b - a) / 1e3)
            call = None
    return {key: [len(v), round(sum(v), 4), round(statistics.median(v), 4)]
            for key, v in sorted(out.items())}


def _stage_sizes(hier, sms):
    """(kernel name, shape) -> n for the stage and restriction kernels of
    each level, the shape the grid and the shared memory and, for a trace
    without the latter, the grid alone: the one-pass stages and the
    streaming restriction from their plans (where the package has them;
    the split ones at every level, though only the finest runs them), the
    first forms from their one thread a point (a slot on a split level, a
    coarse point for K3, K9 and K18)."""
    from multigrid_parallel_tpu_torch.ops import pallas_split as ps

    out = {}

    def add(name, blocks, smem):
        out[(name, (blocks, 1, 1, smem))] = n
        out[(name, (blocks, 1, 1))] = n

    for n in hier.sizes:
        for name in ("rb_half_sweep_from_zero_kernel", "prolong_correct_black_kernel",
                     "rb_half_sweep_kernel"):
            add(name, -(-n ** 3 // 256), 0)
        for name in ("mixed_fold_half_sweep_kernel", "mixed_fold_prolong_correct_black_kernel"):
            add(name, -(-n * n * (n - 2) // 256), 0)
        for name in ("mixed_half_sweep_kernel", "mixed_prolong_correct_black_kernel"):
            add(name, -(-n ** 3 // 256), 0)
        for name in ("split_half_sweep_from_zero_kernel", "split_half_sweep_kernel",
                     "msplit_half_sweep_from_zero_kernel", "msplit_half_sweep_kernel",
                     "msplit_prolong_correct_red_kernel"):
            add(name, -(-n * n * ((n - 1) // 2) // 256), 0)
        for name, prolong, rect in (("rect_stage_kernel", False, True),
                                    ("rect_prolong_stage_kernel", True, True),
                                    ("fold_stage_kernel", False, True),
                                    ("fold_prolong_stage_kernel", True, True),
                                    ("mixed_stage_kernel", False, True),
                                    ("mixed_prolong_stage_kernel", True, True),
                                    ("split_stage_kernel", False, False),
                                    ("split_prolong_stage_kernel", True, False),
                                    ("msplit_stage_kernel", False, None),
                                    ("msplit_prolong_stage_kernel", True, None)):
            try:  # rect None: the msplit plan
                plan = (ps._stage_plan(n, 2, sms, prolong=prolong, msplit=True) if rect is None
                        else ps._stage_plan(n, 2, sms, prolong=prolong, rect=rect))
            except (TypeError, AttributeError):  # a checkout without that one-pass stage
                continue
            add(name, plan.blocks, plan.smem)
        if n < 5:
            continue
        nc = (n + 1) // 2
        for name in ("residual_restrict_kernel", "split_residual_restrict_kernel"):
            add(name, -(-nc ** 3 // 256), 0)
        for name in ("residual_restrict_fold_kernel", "residual_restrict_msplit_kernel"):
            add(name, -(-nc * nc * (nc - 2) // 256), 0)
        for name, split, fold in (("rect_restrict_kernel", False, False),
                                  ("split_restrict_kernel", True, False),
                                  ("msplit_restrict_kernel", True, False),
                                  ("fold_restrict_kernel", False, True)):
            try:
                plan = (ps._restrict_plan(n, sms, split, fold) if fold
                        else ps._restrict_plan(n, sms, split))
            except (TypeError, AttributeError):  # a checkout without that streaming stage
                continue
            add(name, plan.blocks, plan.smem)
    return out


def _seg_sizes(hier, sms, plan):
    """(kernel name, shape) -> n for the i-sharded stage and restriction
    kernels on rank 0 of ``plan`` (a ShardPlan; depth d at L =
    plan.local_planes(d), halos of 4 planes a side), the electrospray's and
    the Dirichlet solve's, as _stage_sizes: the first forms' one thread a
    point of the rows they span (K28's and K34's half-sweeps L + 6, K29's,
    K31's and K36's heads L + 8; K30 a coarse point of its L / 2 planes),
    the one-pass stages from their plans of the planes they tile, and K30's
    streaming stage from its plan of rank 0's interior rows (where the
    package has them)."""
    from multigrid_parallel_tpu_torch.ops import pallas_sharded as px
    from multigrid_parallel_tpu_torch.ops import pallas_split as ps

    out = {}

    def add(name, blocks, smem):
        out[(name, (blocks, 1, 1, smem))] = n
        out[(name, (blocks, 1, 1))] = n

    for depth in range(plan.n_sharded):
        n, L = hier.sizes[hier.num_levels - 1 - depth], plan.local_planes(depth)
        nc = (n + 1) // 2
        add("seg_mixed_half_sweep_kernel", -(-(L + 6) * n * n // 256), 0)
        add("seg_half_sweep_kernel", -(-(L + 6) * n * n // 256), 0)
        add("seg_prolong_correct_black_kernel", -(-(L + 8) * n * n // 256), 0)
        add("seg_half_sweep_from_zero_kernel", -(-(L + 8) * n * n // 256), 0)
        add("seg_mixed_prolong_correct_black_kernel", -(-(L + 8) * n * n // 256), 0)
        add("seg_residual_restrict_kernel", -(-(L // 2) * nc * nc // 256), 0)
        try:  # a checkout without K30's streaming stage
            rows, _ = px.seg_restrict_extents(n, 0, L)
            stage = ps._restrict_plan(n, sms, seg_rows=rows)
            add("seg_restrict_kernel", stage.blocks, stage.smem)
        except (TypeError, AttributeError):
            pass
        # K28's, K29's and K31's one-pass stages take K35's and K36's plans: the same planes
        for names, prolong in ((("mixed_seg_stage_kernel", "seg_smooth_stage_kernel",
                                 "seg_smooth_from_zero_stage_kernel"), False),
                               (("mixed_seg_prolong_stage_kernel", "seg_prolong_stage_kernel"),
                                True)):
            try:  # a checkout without the one-pass segment stages
                stage = ps._stage_plan(n, 2, sms, prolong=prolong, rect=True,
                                       seg_planes=min(L, n))
            except TypeError:
                continue
            for name in names:
                add(name, stage.blocks, stage.smem)
    return out


def _seg2d_sizes(hier, sms, plan):
    """(kernel name, shape) -> n for the (i, j) stage and restriction
    kernels on block (0, 0) of ``plan`` (a ShardPlan2D; depth d of the 2D
    tier at Li = plan.local_i(d), Lj = plan.local_j(d), halos of 4 a side),
    as _seg_sizes: the first forms' one thread a point of the rows and
    columns they span (K37's half-sweeps (Li + 6) (Lj + 6) n, K38's and
    K40's heads (Li + 8) (Lj + 8) n; K39 a coarse point of its (Li / 2, Lj /
    2) block), K37's, K38's and K40's one-pass stages from their plans of
    the planes and rows they tile and K39's streaming stage from its plan
    of the block's interior rows and columns (where the package has
    them)."""
    from multigrid_parallel_tpu_torch.ops import pallas_sharded as px
    from multigrid_parallel_tpu_torch.ops import pallas_split as ps

    out = {}

    def add(name, blocks, smem):
        out[(name, (blocks, 1, 1, smem))] = n
        out[(name, (blocks, 1, 1))] = n

    for depth in range(plan.n_sharded):
        n, li, lj = hier.sizes[hier.num_levels - 1 - depth], plan.local_i(depth), plan.local_j(depth)
        nc = (n + 1) // 2
        add("seg_half_sweep_kernel", -(-(li + 6) * (lj + 6) * n // 256), 0)
        for name in ("seg_half_sweep_from_zero_kernel", "seg_prolong_correct_black_kernel"):
            add(name, -(-(li + 8) * (lj + 8) * n // 256), 0)
        add("seg_residual_restrict_kernel", -(-(li // 2) * (lj // 2) * nc // 256), 0)
        try:  # a checkout without K39's streaming stage
            rows, cols = px.seg_restrict_extents(n, 0, li, 0, lj)
            stage = ps._restrict_plan(n, sms, seg_rows=rows, seg_cols=cols)
            add("seg_restrict_kernel", stage.blocks, stage.smem)
        except (TypeError, AttributeError):
            pass
        for names, prolong in ((("seg_smooth_stage_kernel", "seg_smooth_from_zero_stage_kernel"),
                                False), (("seg_prolong_stage_kernel",), True)):
            try:  # a checkout without K40's one-pass stage
                stage = ps._stage_plan(n, 2, sms, prolong=prolong, rect=True,
                                       seg_planes=min(li, n), seg_cols=min(lj, n))
            except TypeError:
                break
            for name in names:
                add(name, stage.blocks, stage.smem)
    return out


def _sharded_dirichlet(dev, two_d, sms):
    """The one-rank i-sharded (``two_d``: (i, j)-sharded, a 1x1 mesh)
    Dirichlet 257^3 solve (world size 1 on a free localhost port, started
    here) and the fused solve: (hierarchy, solves, unpacks, sizes of the
    sharded kernels)."""
    import torch.distributed as dist

    import multigrid_parallel_tpu_torch as mg
    from multigrid_parallel_tpu_torch import cycles_padded as cp
    from multigrid_parallel_tpu_torch.ops import pallas3d as pk
    from multigrid_parallel_tpu_torch.parallel import sharded as sh
    from multigrid_parallel_tpu_torch.parallel.launch import _free_port

    dist.init_process_group("nccl", init_method=f"tcp://localhost:{_free_port()}",
                            world_size=1, rank=0)
    prob = mg.poisson_3d_quadratic()
    hier = mg.Hierarchy(ndim=3, coarse_n=5, num_levels=7)
    cfg = mg.CycleConfig(n_smooth=2)
    init = cp.ref_init_norm(prob, hier, dev)
    kw = dict(rel_tol=1e-8, max_cycles=40, inner_cycles=4, init_norm=init)
    if two_d:
        from multigrid_parallel_tpu_torch.parallel import sharded2d as s2
        from multigrid_parallel_tpu_torch.parallel import sharded2d_padded as s2p

        mesh2 = s2.make_mesh_2d(1, 1)
        run, plan = s2p.make_sharded2d_padded_df_solver(hier, cfg, mesh2, None, **kw)
        if (plan.n_sharded, plan.local_i(0), plan.local_j(0)) != (4, 272, 272):
            raise RuntimeError(f"not the production plan: {plan}")
        state = s2p.setup_df_problem_sharded2d_padded(prob, hier, mesh2, plan)
        label, sizes = "sharded2d", _seg2d_sizes(hier, sms, plan)
        unpack = lambda out: s2p.unpad_solution2d(  # noqa: E731
            s2.gather_global2d(out[0], mesh2), s2.gather_global2d(out[1], mesh2), hier)
    else:
        from multigrid_parallel_tpu_torch.parallel import sharded_padded as spp

        mesh = sh.make_mesh(1)
        run, plan = spp.make_sharded_df_solver(hier, cfg, mesh, **kw)
        if (plan.n_sharded, plan.local_planes(0)) != (6, 320):
            raise RuntimeError(f"not the production plan: {plan}")
        state = spp.setup_df_problem_sharded_padded(prob, hier, mesh, plan)
        label, sizes = "sharded", _seg_sizes(hier, sms, plan)
        unpack = lambda out: spp.unpad_solution(  # noqa: E731
            sh.gather_global(out[0], mesh), sh.gather_global(out[1], mesh), hier)
    fused = cp.make_on_device_df_solver(hier, cfg, fused=True, device=dev, **kw)
    fused_state = cp.setup_df_problem(prob, hier, dev)
    return (hier, {label: lambda: run(*state), "fused": lambda: fused(*fused_state)},
            {label: unpack, "fused": lambda out: pk.df_to_f64(out[0], out[1])}, sizes)


def _sharded_electrospray(dev):
    """The one-rank sharded electrospray solve (world size 1 on a free
    localhost port, started here) and the full tier: (hierarchy, solves,
    unpacks, sharded plan)."""
    import torch.distributed as dist

    import multigrid_parallel_tpu_torch as mg
    from multigrid_parallel_tpu_torch import mixed_padded as mp
    from multigrid_parallel_tpu_torch.mixed_bc import MixedBCSolver
    from multigrid_parallel_tpu_torch.parallel import sharded as sh
    from multigrid_parallel_tpu_torch.parallel import sharded_mixed_padded as smp
    from multigrid_parallel_tpu_torch.parallel.launch import _free_port

    dist.init_process_group("nccl", init_method=f"tcp://localhost:{_free_port()}",
                            world_size=1, rank=0)
    mesh = sh.make_mesh(1)
    es = mg.electrospray_problem()
    hier = mg.Hierarchy(ndim=3, coarse_n=5, num_levels=7, length=es.length)
    solver = MixedBCSolver(es, hier, n_smooth=2, gamma=2, gamma_min_n=65, device=mesh.device)
    kw = dict(rel_tol=1e-8, max_cycles=100, inner_cycles=1)
    sharded, plan = smp.make_sharded_mixed_padded_df_solver(solver, mesh, **kw)
    if (plan.n_sharded, plan.local_planes(0)) != (6, 320):
        raise RuntimeError(f"not the production plan: {plan}")
    sharded_state = smp.setup_mixed_df_problem_sharded(solver, mesh, plan)
    full = mp.make_mixed_padded_df_solver(solver, **kw)
    full_state = mp.setup_mixed_df_problem(solver)
    solves = {"sharded": lambda: sharded(*sharded_state), "full": lambda: full(*full_state)}
    return (hier, solves,
            {"sharded": lambda out: smp.unpack_mixed_solution_sharded(
                sh.gather_global(out[0], mesh), sh.gather_global(out[1], mesh), hier),
             "full": lambda out: mp.unpack_mixed_solution(out[0], out[1], hier)}, plan)


def _solves(electrospray: bool, dev, inner_cycles: int = 1):
    """(hierarchy, {label: solve}, {label: unpack}) of the paths traced:
    the split and the fused Dirichlet solves, or the electrospray's full,
    fold and split tiers (``inner_cycles`` finest-level cycles an outer
    step); unpack takes a solve's output to its f64 solution."""
    import multigrid_parallel_tpu_torch as mg
    from multigrid_parallel_tpu_torch.ops import pallas3d as pk

    if electrospray:
        from multigrid_parallel_tpu_torch import mixed_padded as mp
        from multigrid_parallel_tpu_torch.mixed_bc import MixedBCSolver

        es = mg.electrospray_problem()
        hier = mg.Hierarchy(ndim=3, coarse_n=5, num_levels=7, length=es.length)
        solver = MixedBCSolver(es, hier, n_smooth=2, gamma=2, gamma_min_n=65, device=dev)
        kw = dict(rel_tol=1e-8, max_cycles=100, inner_cycles=inner_cycles)
        full = mp.make_mixed_padded_df_solver(solver, **kw)
        full_state = mp.setup_mixed_df_problem(solver)
        fold = mp.make_mixed_fold_df_solver(solver, **kw)
        fold_state = mp.setup_mixed_fold_df_problem(solver)
        split = mp.make_mixed_split_df_solver(solver, **kw)
        split_state = mp.setup_mixed_split_df_problem(solver)
        return (hier, {"full": lambda: full(*full_state), "fold": lambda: fold(*fold_state),
                       "split": lambda: split(*split_state)},
                {"full": lambda out: mp.unpack_mixed_solution(out[0], out[1], hier),
                 "fold": lambda out: mp.unpack_mixed_fold_solution(out[0], out[1], solver),
                 "split": lambda out: mp.unpack_mixed_split_solution(*out[:4], solver)})
    from multigrid_parallel_tpu_torch import cycles_padded as cp
    from multigrid_parallel_tpu_torch import cycles_split as cs

    prob = mg.poisson_3d_quadratic()
    hier = mg.Hierarchy(ndim=3, coarse_n=5, num_levels=7)
    cfg = mg.CycleConfig(n_smooth=2)
    init = cp.ref_init_norm(prob, hier, dev)
    kw = dict(rel_tol=1e-8, max_cycles=40, inner_cycles=4, init_norm=init, device=dev)
    split = cs.make_split_df_solver(hier, cfg, **kw)
    split_state = cs.setup_split_df_problem(prob, hier, dev)
    fused = cp.make_on_device_df_solver(hier, cfg, fused=True, **kw)
    fused_state = cp.setup_df_problem(prob, hier, dev)
    return (hier, {"split": lambda: split(*split_state), "fused": lambda: fused(*fused_state)},
            {"split": lambda out: cs.unsplit_solution(*out[:4], prob, hier),
             "fused": lambda out: pk.df_to_f64(out[0], out[1])})


def _child(root: Path, walls: int, traces: int, electrospray: bool, save: Path,
           sharded: bool = False, dirichlet: str = None, inner_cycles: int = 1) -> None:
    sys.path[0] = str(root)  # the script's own directory: the ROOT's package instead
    import torch

    import multigrid_parallel_tpu_torch as mg
    from multigrid_parallel_tpu_torch.ops import _build

    if Path(mg.__file__).resolve().parents[1] != root:
        raise RuntimeError(f"imported {mg.__file__}, not the package under {root}")
    _build.build()
    _build.load()
    dev = torch.device("cuda")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    if sharded:
        hier, solves, unpack, plan = _sharded_electrospray(dev)
        sizes = {**_stage_sizes(hier, sms), **_seg_sizes(hier, sms, plan)}
    elif dirichlet:
        hier, solves, unpack, seg = _sharded_dirichlet(dev, dirichlet == "sharded2d", sms)
        sizes = {**_stage_sizes(hier, sms), **seg}
    else:
        hier, solves, unpack = _solves(electrospray, dev, inner_cycles)
        sizes = _stage_sizes(hier, sms)
    result = {"root": str(root)}
    for label, solve in solves.items():
        solve()
        out = solve()
        result[label] = {"outer_steps": int(out[-1])}
        if save is not None:
            torch.save(unpack[label](out).cpu(), save / f"{label}.pt")
    torch.cuda.synchronize()
    times = {label: [] for label in solves}
    for rep in range(walls):
        for label in solves if rep % 2 == 0 else reversed(list(solves)):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            solves[label]()
            torch.cuda.synchronize()
            times[label].append(1e3 * (time.perf_counter() - t0))
    for label, solve in solves.items():
        runs = []
        for _ in range(traces):
            intervals = kernel_intervals(solve)
            runs.append(_summary(intervals) + (idle_before(intervals),
                                               stage_calls(intervals, sizes),
                                               restrict_calls(intervals, sizes),
                                               norm_calls(intervals)))
        runs.sort(key=lambda r: float("inf") if r[0] is None else r[0])
        busy, n_kernels, by_name, span, idle, calls, restricts, norms = runs[len(runs) // 2]
        top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:16]
        result[label].update({
            "wall_ms_median": statistics.median(times[label]),
            "wall_ms_all": [round(t, 3) for t in times[label]],
            "busy_ms": busy, "kernels": n_kernels, "span_ms": span,
            "idle_share": None if busy is None else 1 - busy / span,
            "busy_ms_all": [r[0] for r in runs],
            "by_name": {name: [round(ms, 4), count, round(idle.get(name, 0.0), 4)]
                        for name, (ms, count) in top},
            "stage_calls": calls,
            "restrict_calls": restricts,
            "norm_calls": norms,
        })
    print(json.dumps(result), flush=True)
    if sharded or dirichlet:
        import torch.distributed as dist

        dist.destroy_process_group()


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("roots", nargs="*", type=Path, default=[THIS_ROOT])
    parser.add_argument("--rounds", type=int, default=2)
    parser.add_argument("--walls", type=int, default=9)
    parser.add_argument("--traces", type=int, default=3)
    mode = parser.add_mutually_exclusive_group()
    mode.add_argument("--electrospray", action="store_true",
                      help="trace the electrospray's full, fold and split tiers instead")
    mode.add_argument("--sharded-electrospray", action="store_true",
                      help="trace the one-rank i-sharded electrospray solve and the full tier")
    mode.add_argument("--sharded", action="store_true",
                      help="trace the one-rank i-sharded Dirichlet solve and the fused one")
    mode.add_argument("--sharded2d", action="store_true",
                      help="trace the 1x1 (i, j)-sharded Dirichlet solve and the fused one")
    parser.add_argument("--inner-cycles", type=int, default=1,
                        help="with --electrospray: finest-level cycles an outer step (2 runs "
                             "the msplit tier's K21 and the other tiers' revisit stages)")
    parser.add_argument("--child", type=Path, help=argparse.SUPPRESS)
    parser.add_argument("--save", type=Path, help=argparse.SUPPRESS)
    args = parser.parse_args(argv)
    if args.child is not None:
        dirichlet = "sharded" if args.sharded else "sharded2d" if args.sharded2d else None
        _child(args.child.resolve(), args.walls, args.traces, args.electrospray, args.save,
               args.sharded_electrospray, dirichlet, args.inner_cycles)
        return 0
    try:
        card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True, text=True)
        print(f"[card] {card.stdout.strip() or card.stderr.strip()}", flush=True)
    except OSError as err:
        print(f"[card] nvidia-smi: {err}", flush=True)
    roots = [r.resolve() for r in args.roots]
    with tempfile.TemporaryDirectory() as tmp:
        saved = [Path(tmp) / str(i) for i in range(len(roots))]
        for rnd in range(args.rounds):
            for i in range(len(roots)) if rnd % 2 == 0 else reversed(range(len(roots))):
                save = ["--save", str(saved[i])] if rnd == 0 else []
                saved[i].mkdir(exist_ok=True)
                run = subprocess.run([sys.executable, str(HERE), "--child", str(roots[i]),
                                      "--walls", str(args.walls), "--traces", str(args.traces)]
                                     + ["--electrospray"] * args.electrospray
                                     + ["--sharded-electrospray"] * args.sharded_electrospray
                                     + ["--sharded"] * args.sharded
                                     + ["--sharded2d"] * args.sharded2d
                                     + ["--inner-cycles", str(args.inner_cycles)]
                                     + save,
                                     cwd=roots[i], capture_output=True, text=True)
                lines = run.stdout.strip().splitlines()
                if run.returncode or not lines:
                    print(run.stdout[-4000:], run.stderr[-4000:], sep="\n", file=sys.stderr)
                    return run.returncode or 1
                print(f"[round {rnd}] {lines[-1]}", flush=True)
        _compare_solutions(saved)
    return 0


def _compare_solutions(saved):
    """Each path's solution from round 0 of every ROOT against the first
    ROOT's: max|u - u_first| (V for the electrospray), 0 where bit for bit
    equal."""
    import torch

    for path in sorted(saved[0].glob("*.pt")):
        first = torch.load(path)
        for other in saved[1:]:
            u = torch.load(other / path.name)
            print(f"[solution {path.stem}] root {other.name} vs root 0: max|u - u_0| = "
                  f"{float((u - first).abs().max()):.6e}, bitwise_equal={torch.equal(u, first)}",
                  flush=True)


if __name__ == "__main__":
    sys.exit(main())
