"""CLI mirroring the reference drivers (counterpart of
``python -m multigrid_parallel_tpu``).

Positional signature of the reference (``<coarse grid pts per side>
<num levels> <GS iterations>``, mg_3d.h:109-118; test_mg_3d.c), with
flags for the capabilities the reference selects at compile time
(problem choice, FMG, VTK output, tolerance, smoother), and ``--device``
(default cuda) where the JAX CLI reads JAX_PLATFORMS.

    python -m multigrid_parallel_tpu_torch 5 7 2              # = ./test_mg_3d 5 7 2
    python -m multigrid_parallel_tpu_torch 5 4 2 --fmg        # mg_dirichlet_analytic useFMG
    python -m multigrid_parallel_tpu_torch 5 9 2 --ndim 1     # = ./mg_1d
    python -m multigrid_parallel_tpu_torch 5 4 2 --device cpu
"""

from __future__ import annotations

import argparse
import sys
import time


def _parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="multigrid_parallel_tpu_torch",
        description="geometric multigrid Poisson solver (PyTorch + CUDA)",
    )
    p.add_argument("coarse_n", type=int, help="coarse grid points per side")
    p.add_argument("num_levels", type=int, help="number of multigrid levels")
    p.add_argument("gs_iter", type=int, help="smoothing sweeps per stage")
    p.add_argument("--ndim", type=int, default=3, choices=(1, 3))
    p.add_argument("--problem", default="quadratic", choices=("quadratic", "trig", "cos1d"))
    p.add_argument("--tol", type=float, default=1e-8,
                   help="relative residual tolerance (test_mg_3d.c:19)")
    p.add_argument("--max-cycles", type=int, default=100)
    p.add_argument("--fmg", action="store_true",
                   help="FMG bootstrap (mg_dirichlet_analytic.c:771-806)")
    p.add_argument("--smoother", default="rb", choices=("rb", "jacobi", "lex"))
    p.add_argument("--gamma", type=int, default=1,
                   help="recursion count per level: 1=V-cycle, 2=W-cycle")
    p.add_argument("--mixed", action="store_true",
                   help="f32 V-cycle + f64 defect correction")
    p.add_argument("--f32", action="store_true", help="pure float32")
    p.add_argument("--vtk", metavar="FILE", default=None,
                   help="write the error field as legacy VTK (postprocess.h)")
    p.add_argument("--profile", action="store_true",
                   help="per-level per-stage timing table (timing_info.h)")
    p.add_argument("--study", action="store_true",
                   help="standalone smoother convergence study "
                        "(test_rb_gs_3d.c / test_gs_3d.c)")
    p.add_argument("--electrospray", action="store_true",
                   help="mixed-BC electrospray potential problem (mg_3d_bkup.c)")
    p.add_argument("--band", type=int, nargs=2, default=None, metavar=("WIDTH", "ITERS"),
                   help="electrospray boundary-band relaxation (the docs/MIXED_BC.md "
                        "convergence fix, e.g. --band 2 2; combine with --gamma 2)")
    p.add_argument("--split", action="store_true",
                   help="electrospray split-colour kernel tier: the finest level in "
                        "red/black pairs over the k-fold sub-hierarchy (with "
                        "--electrospray --gamma 2)")
    p.add_argument("--fold", action="store_true",
                   help="electrospray k-fold kernel tier (with --electrospray --gamma 2)")
    p.add_argument("--gamma-min", type=int, default=0, metavar="N",
                   help="W-cycle depth cap: gamma revisits only on sub-levels of size "
                        ">= N (0 = full W-cycle). Applies to both the Dirichlet "
                        "(CycleConfig) and --electrospray paths; a no-op unless "
                        "--gamma > 1")
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                   help="where the fields live and the solve runs (default cuda)")
    p.add_argument("--quiet", action="store_true")
    return p


def main(argv=None):
    p = _parser()
    args = p.parse_args(argv)

    import torch

    from multigrid_parallel_tpu_torch import (
        CycleConfig,
        Hierarchy,
        MultigridSolver,
        poisson_1d_cos,
        poisson_3d_quadratic,
        poisson_3d_trig,
        solve,
        solve_mixed,
    )

    if args.device == "cuda" and not torch.cuda.is_available():
        p.error("--device cuda: no CUDA device (pass --device cpu)")
    dev = torch.device(args.device)
    dtype = torch.float32 if args.f32 else torch.float64

    if args.study:
        from multigrid_parallel_tpu_torch.studies import smoother_study

        res = smoother_study(num_levels=args.num_levels, coarse_n=args.coarse_n,
                             smoother=args.smoother, max_iters=5000, rel_tol=args.tol,
                             verbose=not args.quiet, dtype=dtype, device=dev)
        print(f"iters: {res.n_iters}  converged: {res.converged}  "
              f"final ResidRatio: {res.final_ratio:.6f}  "
              f"wall: {res.wall_time_s:.3f} s")
        return

    if args.electrospray:
        if args.fmg:
            p.error("--fmg is not supported with --electrospray "
                    "(MixedBCSolver has no FMG bootstrap)")
        from multigrid_parallel_tpu_torch import mixed_padded as mp
        from multigrid_parallel_tpu_torch.mixed_bc import MixedBCSolver
        from multigrid_parallel_tpu_torch.models.electrospray import electrospray_problem

        prob = electrospray_problem()
        hier = Hierarchy(ndim=3, coarse_n=args.coarse_n, num_levels=args.num_levels,
                         length=prob.length, dtype=dtype)
        bw, bi = args.band if args.band else (0, 0)
        ms = MixedBCSolver(prob, hier, n_smooth=args.gs_iter, gamma=args.gamma,
                           boundary_band_width=bw, boundary_band_iters=bi,
                           gamma_min_n=args.gamma_min, device=dev)
        t0 = time.perf_counter()
        if args.split:
            # the split-colour kernel tier: the finest level in red/black
            # pairs over the k-fold sub-hierarchy
            run = mp.make_mixed_split_df_solver(ms, rel_tol=args.tol,
                                                max_cycles=args.max_cycles, inner_cycles=1)
            hr, hb, lr, lb, _norm, it = run(*mp.setup_mixed_split_df_problem(ms))
            u = mp.unpack_mixed_split_solution(hr, hb, lr, lb, ms)
            n_cycles_out = int(it)
        elif args.fold:
            # the k-fold kernel tier
            run = mp.make_mixed_fold_df_solver(ms, rel_tol=args.tol,
                                               max_cycles=args.max_cycles, inner_cycles=1)
            u_hi, u_lo, _norm, it = run(*mp.setup_mixed_fold_df_problem(ms))
            u = mp.unpack_mixed_fold_solution(u_hi, u_lo, ms)
            n_cycles_out = int(it)
        elif args.mixed:
            # f64 outer loop, f32 inner cycles
            u, _norm, n_cycles_out, _init = ms.solve_on_device(rel_tol=args.tol,
                                                               max_cycles=args.max_cycles)
        else:
            u, norms, _init = ms.solve(rel_tol=args.tol, max_cycles=args.max_cycles,
                                       verbose=not args.quiet)
            n_cycles_out = len(norms)
        if u.is_cuda:
            torch.cuda.synchronize(u.device)
        print(f"cycles: {n_cycles_out}   wall time: {time.perf_counter() - t0:.4f} s")
        if args.vtk:
            from multigrid_parallel_tpu_torch.utils import write_vtk

            write_vtk(args.vtk, u, hier.finest_spacing)
            print(f"wrote {args.vtk}")
        return

    problem = {
        "quadratic": poisson_3d_quadratic,
        "trig": poisson_3d_trig,
        "cos1d": poisson_1d_cos,
    }[args.problem if args.ndim == 3 else "cos1d"]()

    if args.profile:
        s = MultigridSolver(args.coarse_n, args.num_levels, args.gs_iter, problem=problem,
                            dtype=dtype, smoother=args.smoother, device=dev)
        s.setup_boundary_conditions()
        init = s.get_initial_residual()
        t0 = time.perf_counter()
        norm, old = init, init
        for it in range(args.max_cycles):
            norm = s.lin_solve_profiled()
            if not args.quiet:
                print(f"iter {it:3d}  resid {norm:.6e}  ResidRatio {norm / old:.4f}")
            old = norm
            if norm <= args.tol * init:
                break
        wall = time.perf_counter() - t0
        s.print_timing_info()
        err = s.error_vs_analytic()
        u = s.u
        n_cycles = it + 1
    else:
        hier = Hierarchy(ndim=problem.ndim, coarse_n=args.coarse_n,
                         num_levels=args.num_levels, length=problem.length, dtype=dtype)
        cfg = CycleConfig(n_smooth=args.gs_iter, smoother=args.smoother,
                          gamma=args.gamma, gamma_min_n=args.gamma_min)
        solver_fn = solve_mixed if args.mixed else solve
        res = solver_fn(problem, hier, cfg, rel_tol=args.tol, max_cycles=args.max_cycles,
                        verbose=not args.quiet, use_fmg=args.fmg, device=dev)
        wall, err, u, n_cycles = res.wall_time_s, res.error_norm, res.u, res.n_cycles
        if not res.converged:
            print(f"WARNING: not converged after {res.n_cycles} cycles", file=sys.stderr)

    print(f"cycles: {n_cycles}   wall time: {wall:.4f} s")
    if err is not None:
        print(f"error vs analytic (L2): {err:.6e}")

    if args.vtk and problem.ndim == 3:
        from multigrid_parallel_tpu_torch.hierarchy import evaluate_on_grid
        from multigrid_parallel_tpu_torch.utils import write_vtk

        hier = Hierarchy(ndim=3, coarse_n=args.coarse_n, num_levels=args.num_levels,
                         length=problem.length, dtype=dtype)
        if problem.analytic is not None:
            exact = evaluate_on_grid(problem.analytic, hier, args.num_levels - 1, dev)
            # the error field, as the reference driver writes (diff2.vtk,
            # test_mg_3d.c:99)
            field = u.cpu().numpy() - exact.cpu().numpy()
        else:
            field = u
        write_vtk(args.vtk, field, hier.finest_spacing)
        print(f"wrote {args.vtk}")


if __name__ == "__main__":
    main()
