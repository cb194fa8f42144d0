"""Electrospray-thruster potential problem (mixed Dirichlet/Neumann BCs);
a copy of ``multigrid_parallel_tpu.models.electrospray``, which imports
nothing of JAX but belongs to the JAX package.

The original physics target of the reference (mg_3d_bkup.c:12-18): the
electrostatic potential between a capillary emitter and an extractor plate,

  * domain: cube of side 3e-4 m,
  * X=0 face: capillary disk of radius 1.326e-5 m held at 0 V (Dirichlet);
    the rest of the face is homogeneous Neumann,
  * X=L face: extractor annulus with radii 1e-4..1.4e-4 m at -1350 V
    (Dirichlet); the rest is homogeneous Neumann,
  * Y/Z faces: homogeneous Neumann.

The reference enforces Neumann *inside the smoother* by copying the updated
interior value onto the adjacent boundary node ("this way we ensure residual
is zero on boundary node", mg_3d_bkup.c:84-133). The port, like the JAX
package, copies the interior planes onto the boundary planes after each
sweep (``ops.stencils_3d.apply_neumann_copy``).
"""

from __future__ import annotations

import dataclasses

import numpy as np

# Physical constants of the reference problem (mg_3d_bkup.c:12-18).
GRID_LENGTH = 3e-4
CAPILLARY_RADIUS = 1.326e-5
CAPILLARY_VOLTAGE = 0.0
EXTRACTOR_INNER_RADIUS = 1e-4
EXTRACTOR_OUTER_RADIUS = 1.4e-4
EXTRACTOR_VOLTAGE = -1350.0


@dataclasses.dataclass(frozen=True)
class ElectrosprayProblem:
    """Mixed-BC problem spec. Not a plain `Problem`: BCs are mask-based.

    ``boundary_masks(N)`` gives the pinned nodes and their voltages on an
    N^3 grid; every other boundary node is homogeneous Neumann (enforced
    by the copy-from-interior rule of mg_3d_bkup.c:84-133).
    """

    length: float = GRID_LENGTH
    name: str = "electrospray"

    def boundary_masks(self, n: int):
        """Return (dirichlet_mask, dirichlet_values) as numpy (n,n,n) arrays
        (bool and f64).

        Matches the face geometry of mg_3d_bkup.c:739-828: radius measured
        from the face center in the (y, z) plane.
        """
        h = self.length / (n - 1)
        yy, zz = np.meshgrid(np.arange(n) * h, np.arange(n) * h, indexing="ij")
        cy = cz = self.length / 2.0
        rr = (yy - cy) ** 2 + (zz - cz) ** 2

        mask = np.zeros((n, n, n), dtype=bool)
        vals = np.zeros((n, n, n), dtype=np.float64)

        capillary = rr <= CAPILLARY_RADIUS**2
        mask[0] = capillary
        vals[0] = np.where(capillary, CAPILLARY_VOLTAGE, 0.0)

        annulus = (rr >= EXTRACTOR_INNER_RADIUS**2) & (rr <= EXTRACTOR_OUTER_RADIUS**2)
        mask[n - 1] = annulus
        vals[n - 1] = np.where(annulus, EXTRACTOR_VOLTAGE, 0.0)
        return mask, vals


def electrospray_problem() -> ElectrosprayProblem:
    return ElectrosprayProblem()
