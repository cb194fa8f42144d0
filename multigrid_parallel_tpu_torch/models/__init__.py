"""Problem definitions. The 1D and electrospray problems come with their
solver paths in later slices."""

from multigrid_parallel_tpu_torch.models.poisson import (
    Problem,
    poisson_3d_quadratic,
    poisson_3d_trig,
)

__all__ = ["Problem", "poisson_3d_quadratic", "poisson_3d_trig"]
