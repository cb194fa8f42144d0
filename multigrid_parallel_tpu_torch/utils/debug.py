"""Debug grid/matrix pretty-printers (counterpart of
``multigrid_parallel_tpu.utils.debug``).

Port of the reference's printGrid3D / printMatrix (mg_3d.h:51-87): one
"LEVEL i" block per i-plane, k rows printed top-down (k = N-1 first),
j as columns, so a side-by-side diff against reference stdout lines up.
They take tensors on any device or numpy arrays; the *_str variants
return the string, the print wrappers write to stdout.
"""

from __future__ import annotations

import numpy as np
import torch


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def format_grid_3d(grid) -> str:
    """mg_3d.h:51-72 layout for an (n, n, n) array."""
    a = _np(grid)
    if a.ndim != 3:
        raise ValueError(f"expected a 3D array, got shape {a.shape}")
    n = a.shape[0]
    lines = []
    for i in range(n):
        lines.append(f"LEVEL {i}")
        for k in range(n - 1, -1, -1):
            lines.append(" ".join(f"{a[i, j, k]:10.5g}" for j in range(n)))
        lines.append("")
    return "\n".join(lines)


def format_matrix(mat) -> str:
    """mg_3d.h:74-87 layout for a square (m, m) matrix."""
    a = _np(mat)
    if a.ndim != 2:
        raise ValueError(f"expected a 2D array, got shape {a.shape}")
    return "\n".join(
        " ".join(f"{a[i, j]:10.5f}" for j in range(a.shape[1]))
        for i in range(a.shape[0])
    )


def print_grid_3d(grid) -> None:
    print(format_grid_3d(grid))


def print_matrix(mat) -> None:
    print(format_matrix(mat))
