"""Carry solver state between the JAX package and the port.

The solver has no weights: its state is the fields. The JAX package
keeps them lane-padded as (n, rup(n, 8), rup(n, 128)) arrays with the
live cube at [:n, :n, :n] and zeros elsewhere; the port keeps plain
contiguous (n, n, n) tensors. Both sides meet as numpy arrays, so
neither package imports the other.
"""

from __future__ import annotations

import numpy as np
import torch


def _rup(x: int, m: int) -> int:
    return -(-x // m) * m


def jax_padded_shape(n: int):
    """The JAX package's full (untrimmed) padded layout of an n^3 field."""
    return (n, _rup(n, 8), _rup(n, 128))


def from_jax_layout(x, n: int, device="cpu") -> torch.Tensor:
    """Padded numpy array (or anything np.asarray takes) -> (n, n, n)
    contiguous tensor of the same dtype on ``device``."""
    a = np.asarray(x)
    if a.shape != jax_padded_shape(n):
        raise ValueError(f"expected shape {jax_padded_shape(n)}, got {a.shape}")
    return torch.from_numpy(np.array(a[:, :n, :n])).to(device)


def from_jax_state(u_hi, u_lo, f_hi, f_lo, n: int, device="cpu"):
    """The JAX package's padded double-float state
    (``cycles_padded.setup_df_problem``, trim=False) -> the port's four
    (n, n, n) f32 tensors."""
    return tuple(from_jax_layout(x, n, device) for x in (u_hi, u_lo, f_hi, f_lo))


def to_jax_layout(x: torch.Tensor, n: int) -> np.ndarray:
    """(n, n, n) tensor -> zero-padded numpy array in the JAX package's
    (n, rup(n, 8), rup(n, 128)) layout."""
    if tuple(x.shape) != (n, n, n):
        raise ValueError(f"expected an ({n}, {n}, {n}) field, got {tuple(x.shape)}")
    a = x.detach().cpu().numpy()
    out = np.zeros(jax_padded_shape(n), dtype=a.dtype)
    out[:, :n, :n] = a
    return out
