"""Problem definitions."""

from multigrid_parallel_tpu_torch.models.electrospray import (
    ElectrosprayProblem,
    electrospray_problem,
)
from multigrid_parallel_tpu_torch.models.poisson import (
    Problem,
    poisson_1d_cos,
    poisson_3d_quadratic,
    poisson_3d_trig,
)

__all__ = [
    "ElectrosprayProblem",
    "Problem",
    "electrospray_problem",
    "poisson_1d_cos",
    "poisson_3d_quadratic",
    "poisson_3d_trig",
]
