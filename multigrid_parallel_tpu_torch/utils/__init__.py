"""Helpers around the solver: per-stage timing, the VTK writer,
checkpoints, debug printers, and state conversion to and from the JAX
package's layout."""

from multigrid_parallel_tpu_torch.utils.timing import STAGE_NAMES, TimingInfo
from multigrid_parallel_tpu_torch.utils.vtk import write_vtk

__all__ = ["TimingInfo", "STAGE_NAMES", "write_vtk"]
