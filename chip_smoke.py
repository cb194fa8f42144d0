#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port's main path (multigrid_parallel_tpu_torch): the
double-float defect-correction solve of 3D Poisson at 257^3 (coarse_n 5,
7 levels, quadratic Dirichlet data, f = 0) to relative residual 1e-8
against the whole-cube ||f||, 4 f32 correction V-cycles per outer step,
2 RB-GS sweeps before and after; in its unfused configuration (K1, K2, R,
matrix-product transfers, K5), its fused one (the default: K1, K2, K3,
K4, K6, with K5 for the initial residual), fused with the full-multigrid
bootstrap, the f64-outer mixed solver on the fused cycle, and the
split-colour solver (the finest level on red / black pairs: K7-K12; the
levels below on the fused cycle: K1-K4). Phases, each of which fails the
run:

  1. build the hand-written CUDA kernels from ops/csrc (one nvcc per
     source, all started together; sm_90a);
  2. hold each kernel against its plain PyTorch version on the card at
     65^3 and 257^3 (numpy-seeded inputs; the split kernels on pairs
     packed from zero-boundary cubes) and time both (CUDA events, median
     of 20);
  3. solve 33^3 on the CPU (plain versions) and on the card (kernels),
     unfused, fused, fused with FMG and split: same outer-step count,
     solutions within 1e-8;
  4. solve 257^3 on each path with every launch count reset just before
     and read just after, then check the outer-step count, the final
     relative residual, the error against the analytic solution and that
     the path launched exactly its kernels; time each solve (warm-up,
     median of 5); the split solution against the fused one;
  5. time the split and fused 257^3 solves interleaved run by run in
     this one call (host wall and CUDA-event span, 9 each).

Prints a {"kernels": [...]} line (each kernel's launches summed over the
257^3 runs of phase 4), the card's name and power limit, and as its last
line {"ok": true, "device": {...}}. Exits non-zero, printing no result,
when there is no CUDA device or any check fails.
"""

import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

REL_TOL = 1e-8
FIELD_ULPS = 4      # fields: expected bitwise equal; allowed 4 ulp of the max
NORM_RTOL = 1e-5    # ||r||^2: kernel and plain sum in different orders
ERR_TOL = 1e-8      # L2 error against the analytic solution at 257^3
SOURCES = {
    "rb_smooth_fused": ("multigrid_parallel_tpu_torch/ops/csrc/rb_smooth.cu",
                        "multigrid_parallel_tpu/ops/pallas3d.py:515"),
    "rb_smooth_from_zero_fused": ("multigrid_parallel_tpu_torch/ops/csrc/rb_smooth.cu",
                                  "multigrid_parallel_tpu/ops/pallas3d.py:412"),
    "residual_fused": ("multigrid_parallel_tpu_torch/ops/csrc/residual.cu",
                       "multigrid_parallel_tpu/ops/pallas3d.py:626"),
    "residual_df_norm_fused": ("multigrid_parallel_tpu_torch/ops/csrc/residual_df_norm.cu",
                               "multigrid_parallel_tpu/ops/pallas3d.py:1245"),
    "residual_restrict_fused": ("multigrid_parallel_tpu_torch/ops/csrc/residual_restrict.cu",
                                "multigrid_parallel_tpu/ops/pallas3d.py:872"),
    "prolong_smooth_fused": ("multigrid_parallel_tpu_torch/ops/csrc/prolong_smooth.cu",
                             "multigrid_parallel_tpu/ops/pallas3d.py:1075"),
    "df_step_residual_norm_fused": ("multigrid_parallel_tpu_torch/ops/csrc/df_step.cu",
                                    "multigrid_parallel_tpu/ops/pallas3d.py:1426"),
    "rb_smooth_split": ("multigrid_parallel_tpu_torch/ops/csrc/rb_smooth_split.cu",
                        "multigrid_parallel_tpu/ops/pallas_split.py:406"),
    "rb_smooth_split_from_zero": ("multigrid_parallel_tpu_torch/ops/csrc/rb_smooth_split.cu",
                                  "multigrid_parallel_tpu/ops/pallas_split.py:434"),
    "residual_restrict_split": ("multigrid_parallel_tpu_torch/ops/csrc/residual_restrict_split.cu",
                                "multigrid_parallel_tpu/ops/pallas_split.py:573"),
    "prolong_smooth_split": ("multigrid_parallel_tpu_torch/ops/csrc/prolong_smooth_split.cu",
                             "multigrid_parallel_tpu/ops/pallas_split.py:746"),
    "df_step_split": ("multigrid_parallel_tpu_torch/ops/csrc/df_split.cu",
                      "multigrid_parallel_tpu/ops/pallas_split.py:830"),
    "residual_df_norm_split": ("multigrid_parallel_tpu_torch/ops/csrc/df_split.cu",
                               "multigrid_parallel_tpu/ops/pallas_split.py:879"),
}
# kernels each 257^3 path must launch (every other kernel: no launch)
_CYCLE = ("rb_smooth_fused", "rb_smooth_from_zero_fused")
_FUSED_CYCLE = _CYCLE + ("residual_restrict_fused", "prolong_smooth_fused")
_FUSED_DF = _FUSED_CYCLE + ("residual_df_norm_fused", "df_step_residual_norm_fused")
PATH_KERNELS = {
    "unfused": _CYCLE + ("residual_fused", "residual_df_norm_fused"),
    "fused": _FUSED_DF,
    "fmg_fused": _FUSED_DF,
    "mixed_pallas": _FUSED_CYCLE,  # its f64 outer residual is plain torch
    # the finest level on pairs, the levels below on the fused cycle. Those
    # are always entered from a zero correction (gamma 1), so the K1
    # half-sweep kernel runs there only inside K2 and K4, counted as theirs.
    "split": ("rb_smooth_from_zero_fused", "residual_restrict_fused", "prolong_smooth_fused",
              "rb_smooth_split", "rb_smooth_split_from_zero", "residual_restrict_split",
              "prolong_smooth_split", "df_step_split", "residual_df_norm_split"),
}
INTERLEAVED = 9  # split and fused 257^3 solves, each, in phase 5


def check(cond, msg):
    if not cond:
        raise RuntimeError(f"check failed: {msg}")


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip()


def time_ms(fn, reps=20):
    """Median device time of fn over reps runs (CUDA events), after a warm-up."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def field_err(got, want):
    err = float((got.double() - want.double()).abs().max())
    tol = FIELD_ULPS * float(np.spacing(np.float32(want.abs().max().item())))
    return err, tol, bool(torch.equal(got, want))


def compare_kernels(pk, ps, dev):
    """Phase 2: each kernel against its plain version at 65^3 and 257^3."""
    results = {name: {"max_abs_err": 0.0} for name in SOURCES}

    def record(name, n, label, got, want, t_kernel=None, t_plain=None):
        err, tol, exact = field_err(got, want)
        print(f"[kernel] {name:26s} n={n:3d} {label:14s} max_abs_err={err:.3e} "
              f"(tol {tol:.3e}) bitwise_equal={exact}"
              + (f" kernel_ms={t_kernel:.4f} plain_ms={t_plain:.4f}" if t_kernel else ""))
        check(err <= tol, f"{name} n={n} {label}: {err} > {tol}")
        results[name]["max_abs_err"] = max(results[name]["max_abs_err"], err)
        if t_kernel is not None:
            results[name]["ms"], results[name]["plain_ms"] = t_kernel, t_plain

    for n in (65, 257):
        h = 1.0 / (n - 1)
        rng = np.random.default_rng(n)
        u, f = (torch.from_numpy(rng.standard_normal((n, n, n)).astype(np.float32)).to(dev)
                for _ in range(2))
        for red_first in (True, False):
            label = "red_first" if red_first else "black_first"
            want = pk.rb_smooth_plain(u, f, h, 2, red_first)
            got = pk.rb_smooth_fused(u.clone(), f, h, 2, red_first)
            torch.cuda.synchronize()
            times = ()
            if red_first:
                uk = u.clone()
                times = (time_ms(lambda: pk.rb_smooth_fused(uk, f, h, 2, True)),
                         time_ms(lambda: pk.rb_smooth_plain(u, f, h, 2, True)))
            record("rb_smooth_fused", n, label, got, want, *times)

            want = pk.rb_smooth_from_zero_plain(f, h, 2, red_first)
            got = pk.rb_smooth_from_zero_fused(f, h, 2, red_first)
            times = ()
            if red_first:
                times = (time_ms(lambda: pk.rb_smooth_from_zero_fused(f, h, 2, True)),
                         time_ms(lambda: pk.rb_smooth_from_zero_plain(f, h, 2, True)))
            record("rb_smooth_from_zero_fused", n, label, got, want, *times)

        times = (time_ms(lambda: pk.residual_fused(u, f, h)),
                 time_ms(lambda: pk.residual_plain(u, f, h)))
        record("residual_fused", n, "", pk.residual_fused(u, f, h),
               pk.residual_plain(u, f, h), *times)

        # a double-float state near a solution, where K5 runs
        c = np.arange(n) * h
        x, y, z = np.meshgrid(c, c, c, indexing="ij")
        u64 = x * x - 2 * y * y + z * z + 1e-9 * rng.standard_normal((n, n, n))
        f64 = 1e-6 * rng.standard_normal((n, n, n))
        state = [t.to(dev) for x64 in (u64, f64)
                 for t in pk.df_split(torch.from_numpy(x64))]
        r, nrm2 = pk.residual_df_norm_fused(*state, h)
        r_ref, nrm2_ref = pk.residual_df_norm_plain(*state, h)
        rel = abs(float(nrm2) - float(nrm2_ref)) / float(nrm2_ref)
        print(f"[kernel] residual_df_norm_fused     n={n:3d} norm2={float(nrm2):.9e} "
              f"plain={float(nrm2_ref):.9e} rel_diff={rel:.3e} (tol {NORM_RTOL:g})")
        check(rel <= NORM_RTOL, f"residual_df_norm_fused n={n}: norm rel diff {rel}")
        times = (time_ms(lambda: pk.residual_df_norm_fused(*state, h)),
                 time_ms(lambda: pk.residual_df_norm_plain(*state, h)))
        record("residual_df_norm_fused", n, "r", r, r_ref, *times)
        check(torch.equal(r, r_ref), f"residual_df_norm_fused n={n}: r not bitwise equal")

        # K3 on the random (u, f) as (e, r)
        times = (time_ms(lambda: pk.residual_restrict_fused(u, f, h)),
                 time_ms(lambda: pk.residual_restrict_plain(u, f, h)))
        record("residual_restrict_fused", n, "", pk.residual_restrict_fused(u, f, h),
               pk.residual_restrict_plain(u, f, h), *times)

        # K4: a coarse correction interpolated into (u, f) as (e, r)
        nc = (n + 1) // 2
        ec = torch.from_numpy(rng.standard_normal((nc, nc, nc)).astype(np.float32)).to(dev)
        for n_iter in (1, 2):
            times = ()
            if n_iter == 2:  # the main path's n_smooth
                times = (time_ms(lambda: pk.prolong_smooth_fused(ec, u, f, h, 2)),
                         time_ms(lambda: pk.prolong_smooth_plain(ec, u, f, h, 2)))
            record("prolong_smooth_fused", n, f"n_iter={n_iter}",
                   pk.prolong_smooth_fused(ec, u, f, h, n_iter),
                   pk.prolong_smooth_plain(ec, u, f, h, n_iter), *times)

        # K6: the K5 state plus a small correction
        d = torch.from_numpy(1e-6 * rng.standard_normal((n, n, n)).astype(np.float32)).to(dev)
        args = (state[0], state[1], d, state[2], state[3], h)
        got = pk.df_step_residual_norm_fused(*args)
        want = pk.df_step_residual_norm_plain(*args)
        rel = abs(float(got[3]) - float(want[3])) / float(want[3])
        print(f"[kernel] df_step_residual_norm_fused n={n:3d} norm2={float(got[3]):.9e} "
              f"plain={float(want[3]):.9e} rel_diff={rel:.3e} (tol {NORM_RTOL:g})")
        check(rel <= NORM_RTOL, f"df_step_residual_norm_fused n={n}: norm rel diff {rel}")
        times = (time_ms(lambda: pk.df_step_residual_norm_fused(*args)),
                 time_ms(lambda: pk.df_step_residual_norm_plain(*args)))
        for label, g, w in zip(("u_hi", "u_lo"), got, want):
            record("df_step_residual_norm_fused", n, label, g, w)
        record("df_step_residual_norm_fused", n, "r", got[2], want[2], *times)

        # K7-K12 on pairs packed from zero-boundary cubes (dead slots and
        # boundary rows 0, the pair invariant), the colours held one by one
        def record_pair(name, label, got, want, times=()):
            for colour, g, w in zip(("red", "black"), got, want):
                record(name, n, f"{label}{colour}", g, w, *(times if colour == "black" else ()))

        inner = torch.zeros((n, n, n), dtype=torch.bool, device=dev)
        inner[1:-1, 1:-1, 1:-1] = True
        e2, r2, d2 = (ps.pack_split(torch.where(inner, x, torch.zeros_like(x)))
                      for x in (u, f, d))
        for red_first in (True, False):
            label = "red_first_" if red_first else "black_first_"
            want = ps.rb_smooth_split_plain(*e2, *r2, h, 2, red_first)
            got = ps.rb_smooth_split(e2[0].clone(), e2[1].clone(), *r2, h, 2, red_first)
            times = ()
            if red_first:
                ek = tuple(x.clone() for x in e2)
                times = (time_ms(lambda: ps.rb_smooth_split(*ek, *r2, h, 2, True)),
                         time_ms(lambda: ps.rb_smooth_split_plain(*e2, *r2, h, 2, True)))
            record_pair("rb_smooth_split", label, got, want, times)
            times = ()
            if red_first:
                times = (time_ms(lambda: ps.rb_smooth_split_from_zero(*r2, h, 2, True)),
                         time_ms(lambda: ps.rb_smooth_split_from_zero_plain(*r2, h, 2, True)))
            record_pair("rb_smooth_split_from_zero", label,
                        ps.rb_smooth_split_from_zero(*r2, h, 2, red_first),
                        ps.rb_smooth_split_from_zero_plain(*r2, h, 2, red_first), times)
        times = (time_ms(lambda: ps.residual_restrict_split(*e2, *r2, h)),
                 time_ms(lambda: ps.residual_restrict_split_plain(*e2, *r2, h)))
        record("residual_restrict_split", n, "", ps.residual_restrict_split(*e2, *r2, h),
               ps.residual_restrict_split_plain(*e2, *r2, h), *times)
        for n_iter in (1, 2):
            times = ()
            if n_iter == 2:
                times = (time_ms(lambda: ps.prolong_smooth_split(ec, *e2, *r2, h, 2)),
                         time_ms(lambda: ps.prolong_smooth_split_plain(ec, *e2, *r2, h, 2)))
            record_pair("prolong_smooth_split", f"n_iter={n_iter}_",
                        ps.prolong_smooth_split(ec, *e2, *r2, h, n_iter),
                        ps.prolong_smooth_split_plain(ec, *e2, *r2, h, n_iter), times)
        split_state = [x for t in state for x in ps.pack_split(t)]
        for name, args in (("residual_df_norm_split", split_state),
                           ("df_step_split", split_state[:4] + list(d2) + split_state[4:])):
            kernel, plain = getattr(ps, name), getattr(ps, name + "_plain")
            got, want = kernel(*args, h), plain(*args, h)
            rel = abs(float(got[-1]) - float(want[-1])) / float(want[-1])
            print(f"[kernel] {name:26s} n={n:3d} norm2={float(got[-1]):.9e} "
                  f"plain={float(want[-1]):.9e} rel_diff={rel:.3e} (tol {NORM_RTOL:g})")
            check(rel <= NORM_RTOL, f"{name} n={n}: norm rel diff {rel}")
            times = (time_ms(lambda: kernel(*args, h)), time_ms(lambda: plain(*args, h)))
            if name == "df_step_split":
                record_pair(name, "u_hi_", got[0:2], want[0:2])
                record_pair(name, "u_lo_", got[2:4], want[2:4])
            record_pair(name, "r_", got[-3:-1], want[-3:-1], times)
    return results


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's kernels run only on one",
              file=sys.stderr)
        return 1
    import multigrid_parallel_tpu_torch as mg
    from multigrid_parallel_tpu_torch import cycles_padded as cp
    from multigrid_parallel_tpu_torch import cycles_split as cs
    from multigrid_parallel_tpu_torch.cycles import setup_problem
    from multigrid_parallel_tpu_torch.hierarchy import evaluate_on_grid
    from multigrid_parallel_tpu_torch.ops import _build
    from multigrid_parallel_tpu_torch.ops import pallas3d as pk
    from multigrid_parallel_tpu_torch.ops import pallas_split as ps

    dev = torch.device("cuda")
    card = card_line()
    print(f"[card] {card} | torch {torch.__version__} cuda {torch.version.cuda} "
          f"| {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")

    # 1. build
    t0 = time.perf_counter()
    lib_path = _build.build()
    _build.load()
    print(f"[build] {time.perf_counter() - t0:.2f} s -> {lib_path.name}")

    # 2. kernels against their plain versions
    results = compare_kernels(pk, ps, dev)

    cfg = mg.CycleConfig(n_smooth=2)
    prob = mg.poisson_3d_quadratic()

    def df_path(hier, init, d, split=False, **kw):
        """(solve, to_cube): solve() runs the double-float solve from its
        setup and returns its outputs, (..., norm, n_outer); to_cube maps
        them to the f64 (n, n, n) solution."""
        if split:
            run = cs.make_split_df_solver(hier, cfg, rel_tol=REL_TOL, max_cycles=40,
                                          inner_cycles=4, init_norm=init, device=d)
            state = cs.setup_split_df_problem(prob, hier, d)
            return (lambda: run(*state)), (lambda out: cs.unsplit_solution(*out[:4], prob, hier))
        run = cp.make_on_device_df_solver(hier, cfg, rel_tol=REL_TOL, max_cycles=40,
                                          inner_cycles=4, init_norm=init, device=d, **kw)
        state = cp.setup_df_problem(prob, hier, d)
        return (lambda: run(*state)), (lambda out: pk.df_to_f64(*out[:2]))

    df_configs = {"unfused": dict(fused=False), "fused": dict(fused=True),
                  "fmg_fused": dict(fused=True, use_fmg=True), "split": dict(split=True)}

    # 3. small solves: card (kernels) against CPU (plain versions)
    hier33 = mg.Hierarchy(ndim=3, coarse_n=5, num_levels=4)
    init33 = cp.ref_init_norm(prob, hier33)
    for label, kw in df_configs.items():
        small = {}
        for d in ("cpu", "cuda"):
            solve, to_cube = df_path(hier33, init33, d, **kw)
            out = solve()
            small[d] = (to_cube(out).cpu(), out[-1], float(out[-2]))
        du = float((small["cpu"][0] - small["cuda"][0]).abs().max())
        print(f"[solve 33^3 {label}] cpu steps={small['cpu'][1]} norm={small['cpu'][2]:.6e} | "
              f"cuda steps={small['cuda'][1]} norm={small['cuda'][2]:.6e} | max|du|={du:.3e}")
        check(small["cpu"][1] == small["cuda"][1], f"33^3 {label}: outer-step count cpu != cuda")
        check(du <= 1e-8, f"33^3 {label}: solutions differ by {du}")

    # 4. the main path: 257^3, each configuration
    hier = mg.Hierarchy(ndim=3, coarse_n=5, num_levels=7)
    n = hier.finest_n
    init = cp.ref_init_norm(prob, hier, dev)
    exact = evaluate_on_grid(prob.analytic, hier, hier.num_levels - 1, dev)
    mixed_state = setup_problem(prob, hier, dev)
    f_norm = float(torch.sqrt(torch.sum(mixed_state[1] ** 2)))
    mixed = cp.make_on_device_mixed_solver_pallas(hier, cfg, rel_tol=REL_TOL, max_cycles=40,
                                                  inner_cycles=2, device=dev)
    paths = {label: df_path(hier, init, dev, **kw) + (init,) for label, kw in df_configs.items()}
    paths["mixed_pallas"] = (lambda: mixed(*mixed_state)), (lambda out: out[0]), f_norm
    launches = dict.fromkeys(SOURCES, 0)
    solved = {}
    for label, (solve, to_cube, ref_norm) in paths.items():
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        pk.reset_launches()
        ps.reset_launches()
        t0 = time.perf_counter()
        out = solve()
        torch.cuda.synchronize()
        first_s = time.perf_counter() - t0
        counts = {**pk.LAUNCHES, **ps.LAUNCHES}
        u, nrm, it = to_cube(out), float(out[-2]), out[-1]
        err = float(torch.sqrt(torch.sum((u - exact) ** 2)))
        print(f"[solve {n}^3 {label}] outer_steps={it} final_norm={nrm:.6e} "
              f"init_norm={ref_norm:.6e} rel={nrm / ref_norm:.3e} err_l2_vs_analytic={err:.3e} "
              f"finite={bool(torch.isfinite(u).all())} shape={tuple(u.shape)}")
        print(f"[launches {n}^3 {label}] {json.dumps(counts)}")
        check(tuple(u.shape) == (n, n, n) and bool(torch.isfinite(u).all()),
              f"{label}: solution not finite")
        check(it < 40 and nrm <= REL_TOL * ref_norm,
              f"{label} not converged: {nrm} > {REL_TOL} * {ref_norm}")
        check(err <= ERR_TOL, f"{label}: error vs analytic {err} > {ERR_TOL}")
        for name in SOURCES:
            ran = counts[name] > 0
            check(ran == (name in PATH_KERNELS[label]),
                  f"{label}: kernel {name} launched {counts[name]} times in the {n}^3 solve")
            launches[name] += counts[name]
        walls = []
        for _ in range(5):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = solve()
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
            check(out[-1] == it, f"{label}: outer-step count changed between runs")
        print(f"[wall {n}^3 {label}] first_run_s={first_s:.4f} "
              f"median_of_5_s={statistics.median(walls):.4f} "
              f"runs_s={[round(w, 4) for w in walls]} peak_mem_GiB="
              f"{torch.cuda.max_memory_allocated() / 2**30:.2f} card: {card}")
        solved[label] = (u, it)

    for label in ("unfused", "split"):
        du = float((solved[label][0] - solved["fused"][0]).abs().max())
        print(f"[{label} vs fused {n}^3] outer_steps {solved[label][1]} vs "
              f"{solved['fused'][1]} max|du|={du:.3e}")
        check(solved[label][1] == solved["fused"][1],
              f"{label} and fused outer-step counts differ")
        check(du <= 1e-8, f"{label} and fused solutions differ by {du}")

    # 5. split against fused, interleaved run by run (alternating which goes first)
    walls = {"split": [], "fused": []}
    spans = {"split": [], "fused": []}
    for rep in range(INTERLEAVED):
        for label in ("split", "fused") if rep % 2 == 0 else ("fused", "split"):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            start.record()
            paths[label][0]()
            end.record()
            torch.cuda.synchronize()
            walls[label].append(1e3 * (time.perf_counter() - t0))
            spans[label].append(start.elapsed_time(end))
    med = {k: statistics.median(v) for k, v in walls.items()}
    med_span = {k: statistics.median(v) for k, v in spans.items()}
    print(f"[interleaved {n}^3 split vs fused] runs={INTERLEAVED} each | wall median ms: "
          f"split={med['split']:.3f} fused={med['fused']:.3f} "
          f"split/fused={med['split'] / med['fused']:.3f} | event span median ms: "
          f"split={med_span['split']:.3f} fused={med_span['fused']:.3f} | pairs (split, fused) "
          f"ms={[(round(a, 3), round(b, 3)) for a, b in zip(walls['split'], walls['fused'])]} "
          f"| card: {card}")

    kernels = [
        {"name": name, "route": "cuda", "source": src, "replaces": rep,
         "launches": launches[name], "max_abs_err": results[name]["max_abs_err"],
         "ms": results[name]["ms"], "plain_ms": results[name]["plain_ms"]}
        for name, (src, rep) in SOURCES.items()
    ]
    print(json.dumps({"kernels": kernels}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
