"""Problem definitions. The 1D problems come with their solver path in a
later slice."""

from multigrid_parallel_tpu_torch.models.electrospray import (
    ElectrosprayProblem,
    electrospray_problem,
)
from multigrid_parallel_tpu_torch.models.poisson import (
    Problem,
    poisson_3d_quadratic,
    poisson_3d_trig,
)

__all__ = [
    "ElectrosprayProblem",
    "Problem",
    "electrospray_problem",
    "poisson_3d_quadratic",
    "poisson_3d_trig",
]
