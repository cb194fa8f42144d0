"""Start a torch.distributed group of ranks on this host and run one SPMD
function on every rank; plus the port's twin of the JAX package's
multi-device dry run (``__graft_entry__.dryrun_multichip``).

    from multigrid_parallel_tpu_torch.parallel.launch import launch
    results = launch(fn, 4, arg, backend="gloo", device="cpu")

``fn(mesh, *args)`` must be a module-level function (the ranks are
spawned processes that import it by name); its return value comes back,
per rank, with every tensor moved to the CPU. Each launch:

  * spawns its ranks (``multiprocessing`` "spawn": no fork after CUDA
    starts, and a child imports only torch, the port and ``fn``'s module);
  * rendezvouses them at ``tcp://localhost:<port>``, a free port picked
    per launch, so concurrent launches do not meet;
  * waits at most ``timeout`` seconds: then it kills the ranks and raises
    TimeoutError, and a rank that raises fails the launch at once (the
    others are killed) with its traceback.

Device and backend: the default is the card, ``device="cuda"`` with
``backend="nccl"``, rank r on ``cuda:(r % device_count)``. NCCL refuses
two ranks on one GPU, so more ranks than cards need ``backend="gloo"``,
whose halos travel through host memory (every kernel still runs on the
card). The CPU tests pass ``device="cpu", backend="gloo"``.

    python -m multigrid_parallel_tpu_torch.parallel.launch 4 --backend gloo --device cpu
"""

from __future__ import annotations

import argparse
import datetime
import multiprocessing as mp
import socket
import tempfile
import time
import traceback
from pathlib import Path

import torch
import torch.distributed as dist


def _free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _to_cpu(obj):
    if isinstance(obj, torch.Tensor):
        return obj.detach().cpu()
    if isinstance(obj, dict):
        return {k: _to_cpu(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to_cpu(v) for v in obj)
    return obj


def _rank_main(fn, args, rank, n_ranks, port, backend, device, timeout, out_dir):
    out = Path(out_dir)
    try:
        torch.set_num_threads(1)  # the ranks share the host's cores
        from multigrid_parallel_tpu_torch.parallel.sharded import make_mesh

        if torch.device(device).type == "cuda" and torch.cuda.is_available():
            torch.cuda.set_device(rank % torch.cuda.device_count())
        dist.init_process_group(backend, init_method=f"tcp://localhost:{port}",
                                world_size=n_ranks, rank=rank,
                                timeout=datetime.timedelta(seconds=timeout))
        try:
            result = fn(make_mesh(n_ranks, device=device), *args)
        finally:
            dist.destroy_process_group()
        torch.save(_to_cpu(result), out / f"rank{rank}.pt")
    except BaseException:  # noqa: BLE001 - every failure goes back to the parent
        (out / f"rank{rank}.err").write_text(traceback.format_exc())
        raise SystemExit(1)


def launch(fn, n_ranks: int, *args, backend: str = "nccl", device: str = "cuda",
           timeout: float = 120.0):
    """Run ``fn(mesh, *args)`` on ``n_ranks`` spawned ranks of a fresh
    process group; returns the ranks' results, rank 0 first. Raises
    TimeoutError after ``timeout`` seconds (the ranks are killed) and
    RuntimeError with the traceback of a rank that raised."""
    if backend == "nccl":
        count = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if n_ranks > count:
            raise ValueError(f"nccl with {n_ranks} ranks on {count} GPU(s): NCCL refuses two "
                             "ranks on one device; use backend='gloo'")
    ctx = mp.get_context("spawn")
    port = _free_port()
    with tempfile.TemporaryDirectory(prefix="mg_launch_") as tmp:
        procs = [ctx.Process(target=_rank_main, daemon=True,
                             args=(fn, args, rank, n_ranks, port, backend, device, timeout,
                                   tmp))
                 for rank in range(n_ranks)]
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout
        failed, timed_out = None, False
        try:
            while True:
                codes = [p.exitcode for p in procs]
                if all(c == 0 for c in codes):
                    break
                failed = next((r for r, c in enumerate(codes) if c not in (None, 0)), None)
                if failed is not None:
                    break
                if time.monotonic() > deadline:
                    timed_out = True
                    break
                time.sleep(0.02)
        finally:
            for p in procs:
                if p.is_alive():
                    p.kill()
                p.join()
        if failed is not None:
            err = Path(tmp) / f"rank{failed}.err"
            msg = err.read_text() if err.exists() else f"exit code {procs[failed].exitcode}"
            raise RuntimeError(f"rank {failed} of {n_ranks} failed:\n{msg}")
        if timed_out:
            raise TimeoutError(f"{n_ranks} ranks did not finish in {timeout} s; killed")
        return [torch.load(Path(tmp) / f"rank{r}.pt", weights_only=False)
                for r in range(n_ranks)]


# ------------------------------------------------------------ the dry run


def _dryrun_ranks(mesh):
    """The JAX _dryrun_impl (__graft_entry__.py:25-137) on this rank: two
    steps of the double-float df cycle and one f64 V-cycle at 17^3, the
    kernel-path whole solve at 33^3 (plan with min_local 2, the kernels
    forced on from 17^3 up); where the rank count is even and >= 4, the
    (i, j) decomposition on an (n / 2, 2) mesh: the plain double-float
    solve at 17^3 and the kernel-path solve at 33^3 (the kernels forced on
    from 17^3 up), both to rel_tol 1e-6 in at most 8 outer steps; and the
    electrospray kernel-path solve at 33^3 (W-cycles, rel_tol 1e-5 of the
    initial residual, two inner cycles, the kernels forced on from 17^3
    up). Returns rank 0's summary line (None elsewhere)."""
    import multigrid_parallel_tpu_torch as mg
    from multigrid_parallel_tpu_torch.parallel import sharded as sh
    from multigrid_parallel_tpu_torch.parallel import sharded_padded as spp

    prob = mg.poisson_3d_quadratic()
    hier = mg.Hierarchy(ndim=3, coarse_n=5, num_levels=3)  # 17^3
    cfg = mg.CycleConfig(n_smooth=2)

    # the double-float defect cycle (EFT outer residual) on plain ops
    cycle, plan = sh.make_sharded_df_cycle(hier, cfg, mesh)
    u_hi, u_lo, f_hi, f_lo = sh.setup_df_problem_sharded(prob, hier, mesh, plan)
    u_hi, u_lo, norm = cycle(u_hi, u_lo, f_hi, f_lo)
    norm = float(norm)
    assert norm > 0.0, norm
    u_hi, u_lo, norm2 = cycle(u_hi, u_lo, f_hi, f_lo)
    assert float(norm2) < norm, (float(norm2), norm)

    # the f64 sharded cycle (the reference-parity path)
    cycle64, plan64 = sh.make_sharded_cycle(hier, cfg, mesh)
    u, f = sh.setup_problem_sharded(prob, hier, mesh, plan64)
    u, norm64 = cycle64(u, f)
    assert float(norm64) > 0.0

    # the kernel path: the whole solve to tolerance on the sharded kernels
    hier_p = mg.Hierarchy(ndim=3, coarse_n=5, num_levels=4)  # 33^3
    plan_p = sh.plan_sharding(hier_p, mesh.n_dev, min_local=2)
    run_p, plan_p = spp.make_sharded_df_solver(hier_p, cfg, mesh, plan_p, rel_tol=1e-6,
                                               max_cycles=8, inner_cycles=2, jnp_level_max=9)
    st = spp.setup_df_problem_sharded_padded(prob, hier_p, mesh, plan_p)
    init_p = float(torch.sqrt(sh._all_reduce_sum(mesh, torch.sum(st[2].double() ** 2))))
    _, _, norm_p, n_outer_p = run_p(*st)
    assert float(norm_p) <= 1e-6 * init_p, (float(norm_p), init_p)

    # the (i, j) mesh decomposition when the rank count factorizes
    msg2d = "2d skipped (the rank count is not even and >= 4)"
    if mesh.n_dev >= 4 and mesh.n_dev % 2 == 0:
        from multigrid_parallel_tpu_torch.parallel import sharded2d as s2
        from multigrid_parallel_tpu_torch.parallel import sharded2d_padded as s2p

        nx, ny = mesh.n_dev // 2, 2
        mesh2 = s2.make_mesh_2d(nx, ny, device=mesh.device)
        run2, plan2 = s2.make_sharded2d_df_solver(hier, cfg, mesh2, rel_tol=1e-6, max_cycles=8,
                                                  inner_cycles=2)
        st2 = s2.setup_df_problem_sharded2d(prob, hier, mesh2, plan2)
        init2 = float(torch.sqrt(sh._all_reduce_sum(mesh2, torch.sum(st2[2].double() ** 2))))
        _, _, n2d, n_outer2 = run2(*st2)
        assert float(n2d) <= 1e-6 * init2, (float(n2d), init2)
        # the kernel path on the (i, j) mesh, the 2D kernels forced on
        run2p, plan2p = s2p.make_sharded2d_padded_df_solver(hier_p, cfg, mesh2, rel_tol=1e-6,
                                                            max_cycles=8, inner_cycles=2,
                                                            jnp_level_max=9)
        st2p = s2p.setup_df_problem_sharded2d_padded(prob, hier_p, mesh2, plan2p)
        init2p = float(torch.sqrt(sh._all_reduce_sum(mesh2, torch.sum(st2p[2].double() ** 2))))
        _, _, n2p, n_outer2p = run2p(*st2p)
        assert float(n2p) <= 1e-6 * init2p, (float(n2p), init2p)
        msg2d = (f"2d({nx}x{ny}) df solve converged to {float(n2d):.3e} in {n_outer2} outer "
                 f"steps, 2d-padded 33^3 plan={plan2p} tiers="
                 f"{s2p.tier_map(hier_p, cfg, plan2p, 9)} converged to {float(n2p):.3e} in "
                 f"{n_outer2p} outer steps")

    # the electrospray (mixed-BC) kernel path at 33^3, W-cycle: its norm is
    # relative to the initial residual (f = 0), as MixedBCSolver.solve's
    from multigrid_parallel_tpu_torch.mixed_bc import MixedBCSolver
    from multigrid_parallel_tpu_torch.ops import stencils_3d as ops3
    from multigrid_parallel_tpu_torch.parallel import sharded_mixed_padded as smp

    prob_m = mg.electrospray_problem()
    hier_m = mg.Hierarchy(ndim=3, coarse_n=5, num_levels=4, length=prob_m.length)
    sol_m = MixedBCSolver(prob_m, hier_m, n_smooth=2, gamma=2, device=mesh.device)
    u0_m, f_m = sol_m.initial_state()
    init_m = float(ops3.residual_norm(u0_m, f_m, hier_m.spacing(hier_m.num_levels - 1)))
    run_m, plan_m = smp.make_sharded_mixed_padded_df_solver(sol_m, mesh, rel_tol=1e-5,
                                                            max_cycles=20, inner_cycles=2,
                                                            jnp_level_max=9)
    _, _, norm_m, n_outer_m = run_m(*smp.setup_mixed_df_problem_sharded(sol_m, mesh, plan_m))
    assert float(norm_m) <= 1e-5 * init_m, (float(norm_m), init_m)
    assert n_outer_m < 20, n_outer_m
    if mesh.rank != 0:
        return None
    return (f"dryrun_multichip OK: {mesh.n_dev} ranks ({mesh.backend}, {mesh.device}), "
            f"plan={plan}, df residual {norm:.3e} -> {float(norm2):.3e}, "
            f"f64 cycle residual {float(norm64):.3e}, kernel-path sharded solve 33^3 "
            f"plan={plan_p} converged to {float(norm_p):.3e} in {n_outer_p} outer steps, "
            f"{msg2d}, mixed-BC kernel-path sharded 33^3 plan={plan_m} converged to "
            f"{float(norm_m):.3e} (init {init_m:.3e}, rel {float(norm_m) / init_m:.1e}) in "
            f"{n_outer_m} outer steps")


def dryrun_multichip(n_devices: int, backend: str = "nccl", device: str = "cuda",
                     timeout: float = 300.0) -> str:
    """Run the sharded paths on ``n_devices`` ranks of a fresh group and
    return the summary line (the port's twin of the JAX package's
    ``__graft_entry__.dryrun_multichip``): the i-sharded and electrospray
    paths, and the (i, j) paths on an (n / 2, 2) mesh where the rank count
    is even and >= 4."""
    return launch(_dryrun_ranks, n_devices, backend=backend, device=device,
                  timeout=timeout)[0]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("n_ranks", type=int)
    ap.add_argument("--backend", default="nccl", choices=("nccl", "gloo"))
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--timeout", type=float, default=300.0)
    a = ap.parse_args(argv)
    print(dryrun_multichip(a.n_ranks, a.backend, a.device, a.timeout))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
