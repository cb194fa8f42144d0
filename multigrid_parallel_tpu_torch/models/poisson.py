"""Poisson problem definitions (torch counterparts of
``multigrid_parallel_tpu.models.poisson``).

Sign convention (matches the reference throughout): we solve

    lap(u) = f      on the interior,
    u = g           on the boundary (Dirichlet),

with the 2nd-order central 7-point (3D) / 3-point (1D) stencil. The reference smoother
update ``v[p] = (sum of neighbors - h^2 f[p]) / 6`` (mg_3d.h:438-443) and
residual ``f - (1/h^2)(sum - 6 v)`` (mg_3d.h:819-821) are both written
for this convention.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Optional

import torch


@dataclasses.dataclass(frozen=True)
class Problem:
    """A PDE problem on [0, length]^ndim with uniform grids.

    Attributes:
      ndim: 1 or 3.
      length: physical domain side (the reference's ``GRID_LENGTH``,
        test_mg_3d.c:4).
      bc: boundary-value function, called with ``ndim`` broadcastable
        coordinate tensors, returns boundary values g.
      rhs: forcing function f (same calling convention).
      analytic: exact solution if known (the validation oracle of every
        reference driver, e.g. test_mg_3d.c:79-97); None otherwise.
      name: short identifier.
    """

    ndim: int
    length: float
    bc: Callable[..., torch.Tensor]
    rhs: Callable[..., torch.Tensor]
    analytic: Optional[Callable[..., torch.Tensor]] = None
    name: str = "problem"


def _quadratic(x, y, z):
    # Reference BCFunc: u(x,y,z) = x^2 - 2 y^2 + z^2 (mg_3d.h:89-90).
    # Harmonic and quadratic, so the 7-point stencil is exact: the
    # discrete solution equals the analytic one to solver tolerance.
    return x * x - 2.0 * y * y + z * z


def _zero_rhs(x, y, z):
    shape = torch.broadcast_shapes(x.shape, y.shape, z.shape)
    return torch.zeros(shape, dtype=x.dtype, device=x.device)


def poisson_3d_quadratic(length: float = 1.0) -> Problem:
    """The reference's main 3D test problem (mg_3d.h:89-94, f == 0)."""
    return Problem(
        ndim=3,
        length=length,
        bc=_quadratic,
        rhs=_zero_rhs,
        analytic=_quadratic,
        name="poisson3d_quadratic",
    )


def poisson_3d_trig(length: float = 1.0) -> Problem:
    """u = sin(pi x) sin(pi y) sin(pi z), f = lap u = -3 pi^2 u: a
    non-trivial RHS with genuine O(h^2) discretization error."""

    def u(x, y, z):
        return (torch.sin(math.pi * x) * torch.sin(math.pi * y)
                * torch.sin(math.pi * z))

    def f(x, y, z):
        return -3.0 * (math.pi**2) * u(x, y, z)

    return Problem(ndim=3, length=length, bc=u, rhs=f, analytic=u, name="poisson3d_trig")


def poisson_1d_cos(length: float = 1.0) -> Problem:
    """The 1D reference problem: u'' = cos(x) on [0, 1] (mg_1d.c:151-152).

    Analytic solution -cos(x) + x (cos(1) - 1) + 1, which is 0 at both
    endpoints (homogeneous Dirichlet, mg_1d.c:186-192)."""

    def analytic(x):
        return -torch.cos(x) + x * (math.cos(1.0) - 1.0) + 1.0

    return Problem(ndim=1, length=length, bc=analytic, rhs=torch.cos,
                   analytic=analytic, name="poisson1d_cos")
