"""multigrid_parallel_tpu_torch: the PyTorch + CUDA port of
``multigrid_parallel_tpu`` for NVIDIA Hopper GPUs.

It covers the reference driver surface: the f64 V-cycle solve
(``solve``, ``solve_mixed``, ``solve_on_device``,
``solve_on_device_mixed``, in 3D and 1D), the ``MultigridSolver``
facade with checkpoints, the smoother study (``studies``), the timing,
VTK and debug utilities, the cascadic 1D driver (``cascade``) and the
CLI (``python -m multigrid_parallel_tpu_torch``). Beside it: the
double-float 3D Poisson solve (``cycles_padded.make_on_device_df_solver``,
fused and unfused, with the FMG bootstrap), its split-colour form
(``cycles_split.make_split_df_solver``), the f64-outer mixed solver, and
the electrospray mixed-BC problem (``mixed_bc.MixedBCSolver`` and its
fused-kernel tiers ``mixed_padded.make_mixed_padded_df_solver``,
``make_mixed_fold_df_solver`` (the k-fold layout) and
``make_mixed_split_df_solver`` (the finest level on red / black pairs)),
and the i-sharded distributed Dirichlet solve on ``torch.distributed``
(``parallel.sharded``, ``parallel.sharded_padded``; ranks started by
``parallel.launch``), on thirty-four hand-written CUDA kernels
(``ops/csrc``); the JAX package
stays the reference it is tested against. The package imports torch and
never jax. Entry points put their fields on the CUDA device unless the
caller names another (``device="cpu"`` runs the kernels' plain versions).
"""

from multigrid_parallel_tpu_torch.cycles import (
    CycleConfig,
    SolveResult,
    fmg_initialize,
    solve,
    solve_mixed,
    solve_on_device,
    solve_on_device_mixed,
    v_cycle,
)
from multigrid_parallel_tpu_torch import parallel
from multigrid_parallel_tpu_torch.hierarchy import Hierarchy, level_sizes
from multigrid_parallel_tpu_torch.models import (
    ElectrosprayProblem,
    Problem,
    electrospray_problem,
    poisson_1d_cos,
    poisson_3d_quadratic,
    poisson_3d_trig,
)
from multigrid_parallel_tpu_torch.solver import MultigridSolver

__all__ = [
    "CycleConfig",
    "ElectrosprayProblem",
    "Hierarchy",
    "MultigridSolver",
    "Problem",
    "SolveResult",
    "electrospray_problem",
    "fmg_initialize",
    "level_sizes",
    "parallel",
    "poisson_1d_cos",
    "poisson_3d_quadratic",
    "poisson_3d_trig",
    "solve",
    "solve_mixed",
    "solve_on_device",
    "solve_on_device_mixed",
    "v_cycle",
]
