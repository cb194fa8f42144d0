"""multigrid_parallel_tpu_torch: the PyTorch + CUDA port of
``multigrid_parallel_tpu`` for NVIDIA Hopper GPUs.

It covers the double-float 3D Poisson solve
(``cycles_padded.make_on_device_df_solver``, fused and unfused, with
the FMG bootstrap), its split-colour form
(``cycles_split.make_split_df_solver``), the f64-outer mixed solver, and
the electrospray mixed-BC problem (``mixed_bc.MixedBCSolver`` and its
fused-kernel tiers ``mixed_padded.make_mixed_padded_df_solver``,
``make_mixed_fold_df_solver`` (the k-fold layout) and
``make_mixed_split_df_solver`` (the finest level on red / black pairs))
on twenty-six hand-written CUDA kernels (``ops/csrc``); the JAX package stays
the reference it is tested against. The package imports torch and never
jax. Entry points put their fields on the CUDA device unless the caller
names another (``device="cpu"`` runs the kernels' plain versions).
"""

from multigrid_parallel_tpu_torch.cycles import CycleConfig
from multigrid_parallel_tpu_torch.hierarchy import Hierarchy
from multigrid_parallel_tpu_torch.models import (
    ElectrosprayProblem,
    Problem,
    electrospray_problem,
    poisson_3d_quadratic,
    poisson_3d_trig,
)

__all__ = [
    "CycleConfig",
    "ElectrosprayProblem",
    "Hierarchy",
    "Problem",
    "electrospray_problem",
    "poisson_3d_quadratic",
    "poisson_3d_trig",
]
