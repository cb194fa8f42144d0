"""Trace the split-colour and the fused double-float 257^3 solves of one or
more checkouts of the port, in turns on one card: two versions of the
split-colour kernels compared within one call, with the fused solve,
which runs none of them, as the control.

    python -m multigrid_parallel_tpu_torch.utils.split_trace [ROOT ...] [--rounds R]

Each ROOT is a directory that holds a ``multigrid_parallel_tpu_torch``
package (default: this checkout). Round r runs every ROOT once, each in a
process of its own (this file run as a script, the ROOT's package first
on the path), in the order given on even rounds and reversed on odd ones:
A B, B A, ... A process builds its checkout's kernels, solves each path
twice to warm up, times ``--walls`` solves of each (host clock,
interleaved, alternating which goes first), then takes ``--traces``
torch.profiler traces of each solve and prints one JSON line: per path
the outer steps, the median wall, and from the trace with the median busy
time the device busy time (the union of kernel intervals), the kernel
count, the span from the first kernel to the last, the idle share of that
span, each kernel name's summed ms, count and the device idle time
just before its kernels (``idle_before``; a stage kernel's name carries
its template arguments, which tell K1 from K2 and K7 from K8), and each
smoothing stage call's device time by level (``stage_calls``: K1, K2, K4,
K7, K8 and K10, the one-pass form's kernel, or a first form's head
kernel and the half-sweeps that follow it). The parent prints the lines
as they come and the card's name and power limit.

The problem is ``chip_smoke.py``'s main path: the quadratic Dirichlet
problem at 257^3 (coarse_n 5, 7 levels), n_smooth 2, 4 inner V-cycles an
outer step, rel_tol 1e-8 of the reference initial norm.
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


def kernel_intervals(fn):
    """The device kernels (and copies and fills) of one call of fn, from a
    torch.profiler trace: (start us, end us, name, shape) sorted by start,
    a kernel by its function's name (with its template arguments, as
    ``<2, true, false>``, where the name has them, demangled or not), its
    shape the grid and the shared memory from the trace's chrome export (() where the export holds no
    device events, and the times then from the profiler's events). Defined
    here, not imported from the package, so that it serves a checkout of
    any version."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()

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


def device_trace(fn):
    """(busy ms, kernels, by_name, span ms) of one call of fn: the union
    of the device's kernel intervals, their count, each kernel name's
    summed ms and count, and the span from the first kernel's start to
    the last one's end; (None, 0, {}, None) when the trace holds no device
    events."""
    return _summary(kernel_intervals(fn))


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
# rect_stage_kernel and split_stage_kernel by their ZERO argument, below)
# and the first forms' head kernels, each with the half-sweep kernel that
# continues its call (a half-sweep that follows none heads a call of its own)
STAGE_KERNELS = {"rect_prolong_stage_kernel": "K4", "split_prolong_stage_kernel": "K10",
                 "rb_half_sweep_from_zero_kernel": "K2", "prolong_correct_black_kernel": "K4",
                 "rb_half_sweep_kernel": "K1", "split_half_sweep_from_zero_kernel": "K8",
                 "split_half_sweep_kernel": "K7"}
FIRST_FORM = {"rb_half_sweep_from_zero_kernel": "rb_half_sweep_kernel",
              "prolong_correct_black_kernel": "rb_half_sweep_kernel",
              "rb_half_sweep_kernel": "rb_half_sweep_kernel",
              "split_half_sweep_from_zero_kernel": "split_half_sweep_kernel",
              "split_half_sweep_kernel": "split_half_sweep_kernel"}


def stage_label(name):
    """The stage ("K1", ...) whose call a kernel of that name starts, or
    None. rect_stage_kernel<NITER, ZERO, BOX> is K2 where ZERO is true, K1
    where false; split_stage_kernel<NITER, VEC, ZERO> K8 and K7 likewise
    (a checkout whose split kernel has no ZERO argument runs it as K7
    only); "K1|K2" where the trace drops the arguments."""
    base, _, args = name.partition("<")
    args = [a.strip() for a in args.rstrip(">").split(",")] if args else []
    if base == "rect_stage_kernel":
        return ("K2" if args[1] == "true" else "K1") if len(args) > 1 else "K1|K2"
    if base == "split_stage_kernel":
        return "K8" if args[2:] == ["true"] else "K7"
    return STAGE_KERNELS.get(base)


def stage_calls(intervals, sizes, n_smooth=2):
    """Each smoothing stage call's device time: a call in a first form is
    its head kernel and the half-sweeps that follow it, 2 n_smooth kernels
    in all; in the one-pass form its one kernel. ``sizes`` maps (kernel
    name without its arguments, shape) to the level's n (a shape without
    its shared memory where the trace has none). Returns {"K4 n=257":
    [calls, summed ms, median ms a call], ...}."""
    groups, sweep = [], None  # sweep: the half-sweep kernel that continues the last call
    for a, b, name, grid in intervals:
        base = name.split("<")[0]
        label = stage_label(name)
        if base == sweep and groups[-1][3] < 2 * n_smooth:
            groups[-1][2].append((b - a) / 1e3)
            groups[-1][3] += 1
        elif label:
            groups.append([(base, label), grid, [(b - a) / 1e3], 1])
            sweep = FIRST_FORM.get(base)
        else:
            sweep = None
    out = {}
    for (base, label), grid, parts, _ in groups:
        n = sizes.get((base, grid), sizes.get((base, grid[:-1]), grid))
        out.setdefault(f"{label} n={n}", []).append(sum(parts))
    return {key: [len(v), round(sum(v), 4), round(statistics.median(v), 4)]
            for key, v in sorted(out.items())}


def _stage_sizes(hier, sms):
    """(kernel name, shape) -> n for the stage kernels of each level, the
    shape the grid and the shared memory and, for a trace without the
    latter, the grid alone: the one-pass ones from their plans (where the
    package has them; the split ones at every level, though only the
    finest runs them), the first forms from their one thread a point (a
    slot on a split level)."""
    from multigrid_parallel_tpu_torch.ops import pallas_split as ps

    out = {}

    def add(name, blocks, smem):
        out[(name, (blocks, 1, 1, smem))] = n
        out[(name, (blocks, 1, 1))] = n

    for n in hier.sizes:
        for name in ("rb_half_sweep_from_zero_kernel", "prolong_correct_black_kernel",
                     "rb_half_sweep_kernel"):
            add(name, -(-n ** 3 // 256), 0)
        for name in ("split_half_sweep_from_zero_kernel", "split_half_sweep_kernel"):
            add(name, -(-n * n * ((n - 1) // 2) // 256), 0)
        for name, prolong, rect in (("rect_stage_kernel", False, True),
                                    ("rect_prolong_stage_kernel", True, True),
                                    ("split_stage_kernel", False, False),
                                    ("split_prolong_stage_kernel", True, False)):
            try:
                plan = ps._stage_plan(n, 2, sms, prolong=prolong, rect=rect)
            except (TypeError, AttributeError):  # a checkout without that one-pass stage
                continue
            add(name, plan.blocks, plan.smem)
    return out


def _child(root: Path, walls: int, traces: int) -> None:
    sys.path[0] = str(root)  # the script's own directory: the ROOT's package instead
    import torch

    import multigrid_parallel_tpu_torch as mg
    from multigrid_parallel_tpu_torch import cycles_padded as cp
    from multigrid_parallel_tpu_torch import cycles_split as cs
    from multigrid_parallel_tpu_torch.ops import _build

    if Path(mg.__file__).resolve().parents[1] != root:
        raise RuntimeError(f"imported {mg.__file__}, not the package under {root}")
    _build.build()
    _build.load()
    dev = torch.device("cuda")
    prob = mg.poisson_3d_quadratic()
    hier = mg.Hierarchy(ndim=3, coarse_n=5, num_levels=7)
    cfg = mg.CycleConfig(n_smooth=2)
    init = cp.ref_init_norm(prob, hier, dev)
    kw = dict(rel_tol=1e-8, max_cycles=40, inner_cycles=4, init_norm=init, device=dev)
    split = cs.make_split_df_solver(hier, cfg, **kw)
    split_state = cs.setup_split_df_problem(prob, hier, dev)
    fused = cp.make_on_device_df_solver(hier, cfg, fused=True, **kw)
    fused_state = cp.setup_df_problem(prob, hier, dev)
    solves = {"split": lambda: split(*split_state), "fused": lambda: fused(*fused_state)}
    sizes = _stage_sizes(hier, torch.cuda.get_device_properties(0).multi_processor_count)
    result = {"root": str(root)}
    for label, solve in solves.items():
        solve()
        result[label] = {"outer_steps": int(solve()[-1])}
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
                                               stage_calls(intervals, sizes)))
        runs.sort(key=lambda r: float("inf") if r[0] is None else r[0])
        busy, n_kernels, by_name, span, idle, calls = runs[len(runs) // 2]
        top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:16]
        result[label].update({
            "wall_ms_median": statistics.median(times[label]),
            "busy_ms": busy, "kernels": n_kernels, "span_ms": span,
            "idle_share": None if busy is None else 1 - busy / span,
            "busy_ms_all": [r[0] for r in runs],
            "by_name": {name: [round(ms, 4), count, round(idle.get(name, 0.0), 4)]
                        for name, (ms, count) in top},
            "stage_calls": calls,
        })
    print(json.dumps(result), flush=True)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("roots", nargs="*", type=Path, default=[THIS_ROOT])
    parser.add_argument("--rounds", type=int, default=2)
    parser.add_argument("--walls", type=int, default=9)
    parser.add_argument("--traces", type=int, default=3)
    parser.add_argument("--child", type=Path, help=argparse.SUPPRESS)
    args = parser.parse_args(argv)
    if args.child is not None:
        _child(args.child.resolve(), args.walls, args.traces)
        return 0
    try:
        card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True, text=True)
        print(f"[card] {card.stdout.strip() or card.stderr.strip()}", flush=True)
    except OSError as err:
        print(f"[card] nvidia-smi: {err}", flush=True)
    roots = [r.resolve() for r in args.roots]
    for rnd in range(args.rounds):
        for root in roots if rnd % 2 == 0 else roots[::-1]:
            run = subprocess.run([sys.executable, str(HERE), "--child", str(root),
                                  "--walls", str(args.walls), "--traces", str(args.traces)],
                                 cwd=root, capture_output=True, text=True)
            lines = run.stdout.strip().splitlines()
            if run.returncode or not lines:
                print(run.stdout[-4000:], run.stderr[-4000:], sep="\n", file=sys.stderr)
                return run.returncode or 1
            print(f"[round {rnd}] {lines[-1]}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
