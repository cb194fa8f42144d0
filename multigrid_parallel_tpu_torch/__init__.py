"""multigrid_parallel_tpu_torch: the PyTorch + CUDA port of
``multigrid_parallel_tpu`` for NVIDIA Hopper GPUs.

It covers the double-float 3D Poisson solve
(``cycles_padded.make_on_device_df_solver``, fused and unfused, with
the FMG bootstrap), its split-colour form
(``cycles_split.make_split_df_solver``) and the f64-outer mixed solver
on thirteen hand-written CUDA kernels (``ops/csrc``); the JAX package
stays the reference it is tested against. The package imports torch and
never jax.
"""

from multigrid_parallel_tpu_torch.cycles import CycleConfig
from multigrid_parallel_tpu_torch.hierarchy import Hierarchy
from multigrid_parallel_tpu_torch.models import Problem, poisson_3d_quadratic, poisson_3d_trig

__all__ = [
    "CycleConfig",
    "Hierarchy",
    "Problem",
    "poisson_3d_quadratic",
    "poisson_3d_trig",
]
