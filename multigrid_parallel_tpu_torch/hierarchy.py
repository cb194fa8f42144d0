"""Grid hierarchy: sizes, spacings, and coordinate/boundary setup.

PyTorch counterpart of ``multigrid_parallel_tpu.hierarchy``. Level 0 is
the *coarsest*; level ``l`` has ``(coarse_n - 1) * 2**l + 1`` points per
side; the finest spacing is ``length / (finest_n - 1)`` and doubles per
coarsening step (mg_3d.h:30-48, 107-144, 1302-1303). The hierarchy is a
plain immutable value: fields are tensors owned by the caller, placed on
the device the caller names.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch


def is_power_of_two(n: int) -> bool:
    # Reference bit trick (mg_3d.h:104-105).
    return n > 0 and (n & (n - 1)) == 0


def level_sizes(coarse_n: int, num_levels: int) -> Tuple[int, ...]:
    """Points per side at each level, coarsest first (mg_3d.h:38-41)."""
    if not is_power_of_two(coarse_n - 1):
        # Same precondition as the reference assert (mg_3d.h:123).
        raise ValueError(f"coarse_n - 1 must be a power of two, got {coarse_n}")
    if num_levels < 1:
        raise ValueError("num_levels must be >= 1")
    return tuple((coarse_n - 1) * (1 << l) + 1 for l in range(num_levels))


@dataclasses.dataclass(frozen=True)
class Hierarchy:
    """Static description of a multigrid hierarchy (no tensors).

    Attributes:
      ndim: spatial dimension (1 or 3).
      coarse_n: points per side on the coarsest level.
      num_levels: number of levels.
      length: physical domain side.
      dtype: working dtype of the cycle (a ``torch.dtype``).
    """

    ndim: int
    coarse_n: int
    num_levels: int
    length: float = 1.0  # the reference's GRID_LENGTH default (test_mg_3d.c:4)
    dtype: torch.dtype = torch.float64

    def __post_init__(self):
        level_sizes(self.coarse_n, self.num_levels)  # validate

    @property
    def sizes(self) -> Tuple[int, ...]:
        return level_sizes(self.coarse_n, self.num_levels)

    @property
    def finest_n(self) -> int:
        # finestOneSideNum = (coarseN-1) * 2^(levels-1) + 1 (mg_3d.h:127)
        return self.sizes[-1]

    @property
    def finest_spacing(self) -> float:
        # spacing = GRID_LENGTH / (finest - 1) (mg_3d.h:143)
        return self.length / (self.finest_n - 1)

    def spacing(self, level: int) -> float:
        # h doubles per coarsening (mg_3d.h:1303)
        return self.length / (self.sizes[level] - 1)

    def coords_1d(self, level: int) -> np.ndarray:
        n = self.sizes[level]
        return np.arange(n) * self.spacing(level)

    def zeros(self, level: int, device="cuda") -> torch.Tensor:
        return torch.zeros((self.sizes[level],) * self.ndim, dtype=self.dtype, device=device)


def boundary_mask(n: int, ndim: int) -> np.ndarray:
    """Boolean mask of boundary nodes of an n^ndim grid."""
    m = np.zeros((n,) * ndim, dtype=bool)
    for ax in range(ndim):
        idx_lo = [slice(None)] * ndim
        idx_lo[ax] = 0
        m[tuple(idx_lo)] = True
        idx_hi = [slice(None)] * ndim
        idx_hi[ax] = n - 1
        m[tuple(idx_hi)] = True
    return m


def evaluate_on_grid(fn, hier: Hierarchy, level: int, device="cuda") -> torch.Tensor:
    """Evaluate fn(x[, y, z]) on the full level grid, as a contiguous
    tensor of ``hier.dtype`` on ``device``."""
    c = torch.as_tensor(hier.coords_1d(level), dtype=hier.dtype, device=device)
    if hier.ndim == 1:
        vals = fn(c)
    else:
        vals = fn(c[:, None, None], c[None, :, None], c[None, None, :])
    shape = (hier.sizes[level],) * hier.ndim
    return torch.broadcast_to(vals, shape).to(hier.dtype).contiguous()


def apply_boundary(arr: torch.Tensor, values: torch.Tensor) -> torch.Tensor:
    """Overwrite the boundary of `arr` with `values` (interior untouched):
    setupBoundaryConditions (mg_3d.h:1147-1239) as one masked select."""
    n = arr.shape[0]
    mask = torch.as_tensor(boundary_mask(n, arr.ndim), device=arr.device)
    return torch.where(mask, values.to(arr.dtype), arr)
