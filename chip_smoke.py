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
bootstrap, and the f64-outer mixed solver on the fused cycle. Phases,
each of which fails the run:

  1. build the hand-written CUDA kernels from ops/csrc (one nvcc per
     source, all started together; sm_90a);
  2. hold each kernel against its plain PyTorch version on the card at
     65^3 and 257^3 (numpy-seeded inputs) and time both (CUDA events,
     median of 20);
  3. solve 33^3 on the CPU (plain versions) and on the card (kernels),
     unfused, fused and fused with FMG: same outer-step count, solutions
     within 1e-8;
  4. solve 257^3 on each path with every launch count reset just before
     and read just after, then check the outer-step count, the final
     relative residual, the error against the analytic solution and that
     every kernel of the path ran (and R did not in the fused ones); time
     each solve (warm-up, median of 5).

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
}


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


def compare_kernels(pk, dev):
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
    return results


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's kernels run only on one",
              file=sys.stderr)
        return 1
    import multigrid_parallel_tpu_torch as mg
    from multigrid_parallel_tpu_torch import cycles_padded as cp
    from multigrid_parallel_tpu_torch.cycles import setup_problem
    from multigrid_parallel_tpu_torch.hierarchy import evaluate_on_grid
    from multigrid_parallel_tpu_torch.ops import _build
    from multigrid_parallel_tpu_torch.ops import pallas3d as pk

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
    results = compare_kernels(pk, dev)

    cfg = mg.CycleConfig(n_smooth=2)
    prob = mg.poisson_3d_quadratic()

    # 3. small solves: card (kernels) against CPU (plain versions)
    hier33 = mg.Hierarchy(ndim=3, coarse_n=5, num_levels=4)
    init33 = cp.ref_init_norm(prob, hier33)
    for label, kw in (("unfused", dict(fused=False)), ("fused", dict(fused=True)),
                      ("fmg_fused", dict(fused=True, use_fmg=True))):
        small = {}
        for d in ("cpu", "cuda"):
            run = cp.make_on_device_df_solver(hier33, cfg, rel_tol=REL_TOL, inner_cycles=4,
                                              init_norm=init33, device=d, **kw)
            u_hi, u_lo, nrm, it = run(*cp.setup_df_problem(prob, hier33, d))
            small[d] = (pk.df_to_f64(u_hi, u_lo).cpu(), it, float(nrm))
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
    df_state = cp.setup_df_problem(prob, hier, dev)
    mixed_state = setup_problem(prob, hier, dev)
    f_norm = float(torch.sqrt(torch.sum(mixed_state[1] ** 2)))

    def df_path(**kw):
        run = cp.make_on_device_df_solver(hier, cfg, rel_tol=REL_TOL, max_cycles=40,
                                          inner_cycles=4, init_norm=init, device=dev, **kw)

        def go():
            u_hi, u_lo, nrm, it = run(*df_state)
            return pk.df_to_f64(u_hi, u_lo), float(nrm), it
        return go, init

    def mixed_path():
        run = cp.make_on_device_mixed_solver_pallas(hier, cfg, rel_tol=REL_TOL, max_cycles=40,
                                                    inner_cycles=2, device=dev)

        def go():
            u, nrm, it = run(*mixed_state)
            return u, float(nrm), it
        return go, f_norm

    paths = {"unfused": df_path(fused=False), "fused": df_path(fused=True),
             "fmg_fused": df_path(fused=True, use_fmg=True), "mixed_pallas": mixed_path()}
    launches = dict.fromkeys(SOURCES, 0)
    solved = {}
    for label, (go, ref_norm) in paths.items():
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        pk.reset_launches()
        t0 = time.perf_counter()
        u, nrm, it = go()
        torch.cuda.synchronize()
        first_s = time.perf_counter() - t0
        counts = dict(pk.LAUNCHES)
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
            out = go()
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
            check(out[2] == it, f"{label}: outer-step count changed between runs")
        print(f"[wall {n}^3 {label}] first_run_s={first_s:.4f} "
              f"median_of_5_s={statistics.median(walls):.4f} "
              f"runs_s={[round(w, 4) for w in walls]} peak_mem_GiB="
              f"{torch.cuda.max_memory_allocated() / 2**30:.2f} card: {card}")
        solved[label] = (u, it)

    du = float((solved["fused"][0] - solved["unfused"][0]).abs().max())
    print(f"[fused vs unfused {n}^3] outer_steps {solved['fused'][1]} vs "
          f"{solved['unfused'][1]} max|du|={du:.3e}")
    check(solved["fused"][1] == solved["unfused"][1], "fused and unfused outer-step counts differ")
    check(du <= 1e-8, f"fused and unfused solutions differ by {du}")

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
