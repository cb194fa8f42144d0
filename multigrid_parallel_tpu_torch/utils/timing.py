"""Per-level, per-stage timing (counterpart of
``multigrid_parallel_tpu.utils.timing``).

The timing_info.h table: call counts and wall time per stage, for the 7
stages of mg_3d.h:136-140 at each level, gathered two ways:

  * ``TimingInfo`` + ``profile_cycle``: each V-cycle stage of the
    reference cycle (``cycles._descend``) as its own call, the device
    synchronised around it, timed on the host clock;
  * ``profile_padded_stages``: the hand kernels of the double-float
    solver's correction cycle (K2, K1, K3, K4 at every level above the
    coarsest) and of its outer step (K5, K6) at their production shapes,
    timed with CUDA events;
  * ``profile_splitcolor_stage``: one RB-GS smoothing stage at 257^3 as
    the rect kernel (K1) and its per-sweep form, the packed split-colour
    kernel (K42), the pair kernel (K7) and its per-sweep form, and a
    same-bytes copy floor, interleaved.
"""

from __future__ import annotations

import statistics
import time
from typing import Callable, List

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory (NVIDIA data sheet)

# The reference's stage names, verbatim (mg_3d.h:136-137).
STAGE_NAMES = (
    "Smoother1",
    "CalcResidual1",
    "Restrict Residual",
    "Recurse, Direct Solve",
    "Prolongate&Correct",
    "Smoother2",
    "CalcResidual2",
)


class TimingInfo:
    """Call counts and cumulative wall time per stage (timing_info.h:6-12)."""

    def __init__(self, stage_names=STAGE_NAMES):
        self.stage_names = tuple(stage_names)
        self.num_calls = [0] * len(self.stage_names)
        self.time_taken = [0.0] * len(self.stage_names)

    def reset(self):
        # resetTimingInfo (timing_info.h:34-38)
        self.num_calls = [0] * len(self.stage_names)
        self.time_taken = [0.0] * len(self.stage_names)

    def record(self, stage: int, seconds: float):
        self.num_calls[stage] += 1
        self.time_taken[stage] += seconds

    def table(self) -> str:
        # printTimingInfo layout (timing_info.h:40-47)
        lines = [f"{'Stage':<24}{'numCalls':>10}{'timeTaken(s)':>16}"]
        for name, calls, t in zip(self.stage_names, self.num_calls, self.time_taken):
            lines.append(f"{name:<24}{calls:>10}{t:>16.6f}")
        return "\n".join(lines)

    def __repr__(self):
        return f"TimingInfo({dict(zip(self.stage_names, self.time_taken))})"


def _sync(out) -> None:
    """Wait for the device work behind ``out`` (a tensor or a tuple of
    them): the port's block_until_ready."""
    tensors = out if isinstance(out, (tuple, list)) else (out,)
    for t in tensors:
        if isinstance(t, torch.Tensor) and t.is_cuda:
            torch.cuda.synchronize(t.device)
            return


def timed_call(info: TimingInfo, stage: int, fn: Callable, *args):
    """Run fn, wait for its result, and record the wall time for ``stage``."""
    t0 = time.perf_counter()
    out = fn(*args)
    _sync(out)
    info.record(stage, time.perf_counter() - t0)
    return out


def profile_cycle(hier, coarse_solve, cfg, u, f, infos: List[TimingInfo]):
    """One V-cycle with per-level per-stage timing into ``infos`` (one
    TimingInfo per level, coarsest first, like tInfo in mg_3d.h:26).
    Returns (u', ||r||). The stages run one by one with the device
    synchronised after each, so the times are true per-stage times."""
    from multigrid_parallel_tpu_torch.cycles import _ops, _smooth

    ops = _ops(hier.ndim)

    def go(u, f, level):
        info = infos[level]
        if level == 0:
            return timed_call(info, 3, coarse_solve, f)
        h = hier.spacing(level)
        u = timed_call(info, 0, lambda u, f: _smooth(ops, cfg, u, f, h, True), u, f)
        r = timed_call(info, 1, lambda u, f: ops.residual(u, f, h), u, f)
        fc = timed_call(info, 2, ops.restrict_full_weighting, r)
        t0 = time.perf_counter()
        ec0 = torch.zeros((hier.sizes[level - 1],) * hier.ndim, dtype=u.dtype, device=u.device)
        ec = go(ec0, fc, level - 1)
        info.record(3, time.perf_counter() - t0)
        u = timed_call(info, 4, ops.prolong_correct, ec, u)
        u = timed_call(info, 5, lambda u, f: _smooth(ops, cfg, u, f, h, False), u, f)
        norm = timed_call(info, 6, lambda u, f: ops.residual_norm(u, f, h), u, f)
        return u if level < hier.num_levels - 1 else (u, norm)

    return go(u, f, hier.num_levels - 1)


def _call_s(fn, on_cuda: bool) -> float:
    """Seconds of one call of fn: its device time between two CUDA events,
    or on the CPU its host time."""
    if not on_cuda:
        t0 = time.perf_counter()
        fn()
        return time.perf_counter() - t0
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / 1e3


def profile_padded_stages(hier, cfg, reps: int = 20, device="cuda"):
    """Per-call times of the double-float solver's kernels at each level
    of ``hier``: the stages the solver (``cycles_padded``, fused) runs.

    For every level above the coarsest, top down: K2 (the pre-smoother
    from zero), K1 (a smoother from a given field), K3 (residual +
    restriction) and K4 (prolongation + correction + post-smoother); then
    the outer step at the finest level: K5 and K6. Inputs are seeded
    normal fields. On a CUDA device each row is the median over ``reps``
    calls of the CUDA-event time of one call (device time only); with
    ``device="cpu"`` the plain versions run and the host clock times them.

    Returns (rows, latency_s): rows of (label, seconds per call), labelled
    as the JAX function labels them, and the median host time of a tiny
    launch and synchronise, the overhead the event times leave out. The
    JAX function's TPU parameters (VMEM block sizes, the fused-XLA level
    cap, the k-trim layout, the chain-slope mode against the TPU's
    dispatch latency) have no counterpart here."""
    from multigrid_parallel_tpu_torch.ops import pallas3d as pk

    dev = torch.device(device)
    on_cuda = dev.type == "cuda"
    if on_cuda and not torch.cuda.is_available():
        raise RuntimeError("profile_padded_stages: no CUDA device")
    rng = np.random.default_rng(0)

    def field(n, scale=1.0):
        return torch.from_numpy((scale * rng.standard_normal((n, n, n))).astype(np.float32)).to(dev)

    def sync():
        if on_cuda:
            torch.cuda.synchronize(dev)

    def median_s(fn):
        fn()  # warm-up
        sync()
        return statistics.median(_call_s(fn, on_cuda) for _ in range(reps))

    tiny = torch.zeros(8, device=dev)
    lat = []
    for _ in range(reps):
        t0 = time.perf_counter()
        torch.sum(tiny).item()
        lat.append(time.perf_counter() - t0)

    rows = []
    half = 2 * cfg.n_smooth
    for level in range(hier.num_levels - 1, 0, -1):
        n, h = hier.sizes[level], hier.spacing(level)
        e, r = field(n), field(n)
        ec = field(hier.sizes[level - 1])
        rows.append((f"L{level} ({n}³) smoother (from-zero, {half} half)",
                     median_s(lambda: pk.rb_smooth_from_zero_fused(r, h, cfg.n_smooth))))
        rows.append((f"L{level} ({n}³) smoother (pipelined, {half} half)",
                     median_s(lambda: pk.rb_smooth_fused(e, r, h, cfg.n_smooth, red_first=False))))
        rows.append((f"L{level} ({n}³) residual+restrict fused",
                     median_s(lambda: pk.residual_restrict_fused(e, r, h))))
        rows.append((f"L{level} ({n}³) prolong+correct+post-smooth fused",
                     median_s(lambda: pk.prolong_smooth_fused(ec, e, r, h, cfg.n_smooth))))
    n_top = hier.finest_n
    h_top = hier.spacing(hier.num_levels - 1)
    uh, ul, fh, fl, d = field(n_top), field(n_top, 1e-8), field(n_top), field(n_top, 0.0), field(n_top)
    rows.append((f"outer ({n_top}³) EFT residual+norm fused",
                 median_s(lambda: pk.residual_df_norm_fused(uh, ul, fh, fl, h_top))))
    rows.append((f"outer ({n_top}³) df-add+EFT residual+norm fused",
                 median_s(lambda: pk.df_step_residual_norm_fused(uh, ul, d, fh, fl, h_top))))
    return rows, statistics.median(lat)



def split_stage_bytes(n: int, red_first: bool, prolong=False, from_zero=False,
                      packed=False) -> int:
    """The bytes a K7 stage call (K10's, ``prolong``, black first; K8's,
    ``from_zero``; K42's, ``packed``: the pair joined along j, plane q of
    each colour 2 n S floats after plane q - 1) at n^3 must move, counted
    in the card's 32-byte sectors: the fresh pair written, the second
    colour read whole; of the first half-sweep's colour only the slots
    that no half-sweep updates (the boundary rows and dead slots, which
    the output keeps); of each colour's f its live slots; K10's coarse
    correction read whole. K8 reads no pair: only the f's and the written
    pair count."""
    from multigrid_parallel_tpu_torch.ops import pallas_split as ps

    _, live_r, live_b = ps._masks(n, "cpu")
    every = torch.ones_like(live_r)

    def sectors(red, black):
        parts = [torch.cat([red, black], dim=1)] if packed else [red, black]
        total = 0
        for mask in parts:
            flat = mask.reshape(-1)
            flat = torch.cat([flat, flat.new_zeros(-flat.numel() % 8)])
            total += int(flat.view(-1, 8).any(1).sum())
        return total

    red_kept = red_first and not prolong  # the first half-sweep's colour is red
    read = (sectors(~live_r, every) if red_kept else sectors(every, ~live_b))
    total = sectors(every, every) + (0 if from_zero else read) + sectors(live_r, live_b)
    return 32 * total + (4 * ((n + 1) // 2) ** 3 if prolong else 0)


def profile_splitcolor_stage(n: int = 257, n_iter: int = 2, reps: int = 20, device="cuda"):
    """One red-first RB-GS smoothing stage of n_iter iterations at n^3 in
    three layouts, and a floor: the counterpart of
    scripts/splitcolor_bench.py.

    The stages, timed round by round in turn: the rect stage (K1,
    ``pallas3d.rb_smooth_fused``, one one-pass launch, on the (n, n, n)
    cube), the rect stage in K1's per-sweep form
    (``pallas3d.rb_smooth_fused_per_sweep``, one launch a half-sweep), the
    packed split-colour stage (K42, ``pallas_splitcolor.
    rb_smooth_split_fused``, one one-pass launch, on (n, 2 n, (n - 1) //
    2)), the packed stage in K42's per-sweep form (``pallas_splitcolor.
    rb_smooth_split_fused_per_sweep``), the pair stage (K7,
    ``pallas_split.rb_smooth_split``, one one-pass launch), the pair stage
    in K7's per-sweep form (``pallas_split.rb_smooth_split_per_sweep``, one
    launch a half-sweep) and ``torch.add(u2, f2, out=w)``, which reads u2
    and f2 and writes one array of their size: the bytes of a one-pass
    stage (the script's identity-DMA floor). Inputs are seeded as the
    script seeds them: ``default_rng(0)``, standard-normal interiors of u
    and then f, zero boundaries. Each per-sweep form updates its own copy
    of u in place, call after call; K1, K42 and K7 smooth theirs into a
    fresh one, the next call's input. On a CUDA device each row is
    the median over ``reps`` rounds of the CUDA-event time of one call,
    after one warm-up call each; with ``device="cpu"`` the plain versions
    run and the host clock times them. The script's chain-slope mode
    (against the TPU's dispatch latency) has no counterpart here.

    Returns rows of (label, seconds per call, bytes a one-pass call moves
    (u and f read once, u written once), that byte count over the H100's
    3.35 TB/s in seconds)."""
    from multigrid_parallel_tpu_torch.ops import pallas3d as pk
    from multigrid_parallel_tpu_torch.ops import pallas_split as ps
    from multigrid_parallel_tpu_torch.ops import pallas_splitcolor as psc

    dev = torch.device(device)
    on_cuda = dev.type == "cuda"
    if on_cuda and not torch.cuda.is_available():
        raise RuntimeError("profile_splitcolor_stage: no CUDA device")
    h = 1.0 / (n - 1)
    rng = np.random.default_rng(0)
    cubes = []
    for _ in range(2):
        x = np.zeros((n, n, n), np.float32)
        x[1:-1, 1:-1, 1:-1] = rng.standard_normal((n - 2,) * 3)
        cubes.append(torch.from_numpy(x).to(dev))
    u, f = cubes
    u2, f2 = psc.pack_split(u), psc.pack_split(f)
    rhs = ps.pack_split(f)
    cube = [u.clone()]
    packed = [u2.clone()]
    pair = list(ps.pack_split(u))
    per_sweep = ps.pack_split(u)
    w = torch.empty_like(u2)

    def k1():
        cube[0] = pk.rb_smooth_fused(cube[0], f, h, n_iter, red_first=True)

    def k42():
        packed[0] = psc.rb_smooth_split_fused(packed[0], f2, h, n_iter, n, red_first=True)

    def k7():
        pair[:] = ps.rb_smooth_split(*pair, *rhs, h, n_iter, True)
    stages = (
        (f"rect stage (K1, {2 * n_iter} half-sweeps, one launch)", k1, (u, f, u)),
        (f"rect stage, one launch a half-sweep (K1's per-sweep form, {2 * n_iter} launches)",
         lambda: pk.rb_smooth_fused_per_sweep(u, f, h, n_iter, red_first=True), (u, f, u)),
        (f"packed stage (K42, {2 * n_iter} half-sweeps, one launch)", k42, (u2, f2, u2)),
        (f"packed stage, one launch a half-sweep (K42's per-sweep form, {2 * n_iter} "
         "launches)",
         lambda: psc.rb_smooth_split_fused_per_sweep(u2, f2, h, n_iter, n, red_first=True),
         (u2, f2, u2)),
        (f"pair stage (K7, {2 * n_iter} half-sweeps, one launch)",
         k7, (*pair, *rhs, *pair)),
        (f"pair stage, one launch a half-sweep (K7's per-sweep form, {2 * n_iter} launches)",
         lambda: ps.rb_smooth_split_per_sweep(*per_sweep, *rhs, h, n_iter, True),
         (*per_sweep, *rhs, *per_sweep)),
        ("same-bytes floor (torch.add(u2, f2, out=w))",
         lambda: torch.add(u2, f2, out=w), (u2, f2, w)),
    )

    for _, fn, _ in stages:  # warm-up
        fn()
    if on_cuda:
        torch.cuda.synchronize(dev)
    times = [[] for _ in stages]
    for _ in range(reps):
        for ts, (_, fn, _) in zip(times, stages):
            ts.append(_call_s(fn, on_cuda))
    rows = []
    for ts, (label, _, io) in zip(times, stages):
        nbytes = sum(t.numel() * t.element_size() for t in io)
        rows.append((label, statistics.median(ts), nbytes, nbytes / HBM_BYTES_PER_S))
    return rows
