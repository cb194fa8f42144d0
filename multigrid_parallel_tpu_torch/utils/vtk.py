"""Legacy ASCII VTK structured-grid writer (postprocess.h:5-47 parity);
counterpart of ``multigrid_parallel_tpu.utils.vtk``.

Writes the file layout the reference produces for ParaView: header,
explicit DATASET STRUCTURED_GRID point coordinates, then POINT_DATA
scalars. Two backends, as in the JAX package:

  * the repository's native C++ writer (native/vtk_writer.cpp, built as
    native/build/libmgtpu_native.so), loaded with ctypes;
  * a pure-Python writer, used when the library is missing or fails.

Both write the same text, so a field gives the same file as the JAX
package's writer.
"""

from __future__ import annotations

import ctypes
import functools
import os
from pathlib import Path

import numpy as np
import torch


@functools.lru_cache(maxsize=None)
def _load_native():
    """The native writer, or None when its library is missing or does not
    load."""
    lib = Path(__file__).resolve().parents[2] / "native" / "build" / "libmgtpu_native.so"
    if not lib.exists():
        return None
    try:
        dll = ctypes.CDLL(str(lib))
    except OSError:
        return None
    dll.mgtpu_write_vtk.argtypes = [ctypes.c_char_p, ctypes.POINTER(ctypes.c_double),
                                    ctypes.c_double, ctypes.c_int]
    dll.mgtpu_write_vtk.restype = ctypes.c_int
    return dll


def write_vtk(file_name: str, grid, h: float, n: int | None = None) -> None:
    """Write an n^3 scalar field as legacy ASCII VTK (postprocess.h:5-47).

    ``grid`` is a tensor (any device) or array-like of shape (n, n, n);
    ``h`` the grid spacing."""
    if isinstance(grid, torch.Tensor):
        grid = grid.detach().cpu().numpy()
    data = np.asarray(grid, dtype=np.float64)
    if n is None:
        n = data.shape[0]
    if data.shape != (n, n, n):
        raise ValueError(f"expected cube ({n},)*3, got {data.shape}")

    native = _load_native()
    if native is not None:
        flat = np.ascontiguousarray(data.reshape(-1))
        rc = native.mgtpu_write_vtk(os.fsencode(file_name),
                                    flat.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
                                    ctypes.c_double(h), ctypes.c_int(n))
        if rc == 0:
            return
        # fall through to the Python writer on failure

    with open(file_name, "w") as fh:
        # header block (postprocess.h:13-21)
        fh.write("# vtk DataFile Version 2.0\n")
        fh.write("Multigrid output data\n")
        fh.write("ASCII\n")
        fh.write("DATASET STRUCTURED_GRID\n")
        fh.write(f"DIMENSIONS {n} {n} {n}\n")
        fh.write(f"POINTS {n * n * n} double\n")
        # point coordinates, k fastest (postprocess.h:22-34: i outer, j,
        # k inner, x = i h, y = j h, z = k h)
        coords = np.arange(n) * h
        x = np.repeat(coords, n * n)
        y = np.tile(np.repeat(coords, n), n)
        z = np.tile(coords, n * n)
        np.savetxt(fh, np.column_stack([x, y, z]), fmt="%.10g %.10g %.10g")
        # scalars (postprocess.h:37-44)
        fh.write(f"POINT_DATA {n * n * n}\n")
        fh.write("SCALARS OutputData double 1\n")
        fh.write("LOOKUP_TABLE default\n")
        np.savetxt(fh, data.reshape(-1), fmt="%.10g")
