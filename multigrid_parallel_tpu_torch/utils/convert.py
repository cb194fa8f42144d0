"""Carry solver state between the JAX package and the port.

The solver has no weights: its state is the fields. The JAX package
keeps them lane-padded as (n, rup(n, 8), rup(n, 128)) arrays with the
live cube at [:n, :n, :n] and zeros elsewhere, as split-colour pairs or
as k-fold fields (below); the port keeps plain contiguous (n, n, n)
tensors, (n, n, (n - 1) // 2) pairs and (n, n, n - 2) fold fields. The
mixed-BC solver adds its pin planes, its coarse LU factor and, on the
split-colour tier, its (2, 2, n, (n - 1) // 2) parity packs. An
i-sharded field is one global array in JAX and one block per rank in the
port. Both sides
meet as numpy arrays, so neither package imports the other.
"""

from __future__ import annotations

import numpy as np
import torch


def _rup(x: int, m: int) -> int:
    return -(-x // m) * m


def jax_padded_shape(n: int):
    """The JAX package's full (untrimmed) padded layout of an n^3 field."""
    return (n, _rup(n, 8), _rup(n, 128))


def from_jax_layout(x, n: int, device="cuda") -> torch.Tensor:
    """Padded numpy array (or anything np.asarray takes) -> (n, n, n)
    contiguous tensor of the same dtype on ``device``."""
    a = np.asarray(x)
    if a.shape != jax_padded_shape(n):
        raise ValueError(f"expected shape {jax_padded_shape(n)}, got {a.shape}")
    return torch.from_numpy(np.array(a[:, :n, :n])).to(device)


def from_jax_state(u_hi, u_lo, f_hi, f_lo, n: int, device="cuda"):
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


# Split-colour pairs (ops.pallas_split): the JAX package keeps each colour
# as (n, rup(n, 8), rup((n - 1) // 2, 128)) with the live slots at
# [:, :n, :(n - 1) // 2] and zeros elsewhere; the port as (n, n, (n - 1) // 2).


def jax_split_shape(n: int):
    """One colour of the JAX package's split pair."""
    return (n, _rup(n, 8), _rup((n - 1) // 2, 128))


def from_jax_split(xr, xb, n: int, device="cuda"):
    """The JAX package's split pair (numpy or anything np.asarray takes)
    -> the port's (red, black) pair of contiguous tensors on ``device``."""
    out = []
    for x in (xr, xb):
        a = np.asarray(x)
        if a.shape != jax_split_shape(n):
            raise ValueError(f"expected shape {jax_split_shape(n)}, got {a.shape}")
        out.append(torch.from_numpy(np.array(a[:, :n, : (n - 1) // 2])).to(device))
    return out[0], out[1]


def from_jax_pin_planes(pin, n: int, device="cuda") -> torch.Tensor:
    """The JAX package's mixed-BC pin planes
    (``pallas_mixed.dirichlet_pin_planes``, (2, rup(n, 8), rup(n, 128)))
    -> the port's (2, n, n) f32 tensor on ``device``."""
    a = np.asarray(pin)
    want = (2,) + jax_padded_shape(n)[1:]
    if a.shape != want:
        raise ValueError(f"expected shape {want}, got {a.shape}")
    return torch.from_numpy(np.array(a[:, :n, :n])).to(device)


# k-fold fields (ops.pallas_mixed_fold): the JAX package keeps them as
# (n, rup(n, 8), rup(n - 2, 128)) with the live slots at [:, :n, :n - 2];
# the port as (n, n, n - 2). Its fold pin and sign planes are
# (2, rup(n, 8), rup(n - 2, 128)); the port's (2, n, n - 2).


def jax_fold_shape(n: int):
    """The JAX package's k-fold layout of an n^3 field."""
    return (n, _rup(n, 8), _rup(n - 2, 128))


def from_jax_fold(x, n: int, device="cuda") -> torch.Tensor:
    """The JAX package's fold field (numpy or anything np.asarray takes)
    -> the port's contiguous (n, n, n - 2) tensor on ``device``."""
    a = np.asarray(x)
    if a.shape != jax_fold_shape(n):
        raise ValueError(f"expected shape {jax_fold_shape(n)}, got {a.shape}")
    return torch.from_numpy(np.array(a[:, :n, : n - 2])).to(device)


def to_jax_fold(x: torch.Tensor, n: int) -> np.ndarray:
    """The port's (n, n, n - 2) fold field -> zero-padded numpy array in
    the JAX package's fold layout."""
    if tuple(x.shape) != (n, n, n - 2):
        raise ValueError(f"expected an {(n, n, n - 2)} fold field, got {tuple(x.shape)}")
    a = x.detach().cpu().numpy()
    out = np.zeros(jax_fold_shape(n), dtype=a.dtype)
    out[:, :n, : n - 2] = a
    return out


def from_jax_fold_planes(planes, n: int, device="cuda") -> torch.Tensor:
    """The JAX package's fold pin or sign planes
    (``pallas_mixed_fold.fold_pin_planes`` / ``fold_edge_sign_planes``)
    -> the port's (2, n, n - 2) tensor on ``device``."""
    a = np.asarray(planes)
    want = (2,) + jax_fold_shape(n)[1:]
    if a.shape != want:
        raise ValueError(f"expected shape {want}, got {a.shape}")
    return torch.from_numpy(np.array(a[:, :n, : n - 2])).to(device)


def from_jax_coarse_lu(lu, piv):
    """The JAX ``MixedBCSolver``'s host factor (``_lu_host``,
    ``_piv_host``: scipy's ``lu_factor``, 0-based pivots) -> the port's
    (``torch.linalg.lu_factor``: LAPACK's 1-based int32 pivots), as CPU
    tensors. The factor itself is the same LAPACK getrf output."""
    lu = np.asarray(lu, dtype=np.float64)
    piv = np.asarray(piv)
    if lu.ndim != 2 or lu.shape[0] != lu.shape[1] or piv.shape != lu.shape[:1]:
        raise ValueError(f"expected an (m, m) factor and (m,) pivots, got {lu.shape}, {piv.shape}")
    return torch.from_numpy(lu.copy()), torch.from_numpy(piv.astype(np.int32) + 1)


def jax_msplit_packs_shape(n: int):
    """The JAX package's mixed split parity packs (``pallas_mixed_split.
    msplit_pin_packs`` / ``msplit_plane_packs``): [p][face] planes of one
    colour's padded (j, slot) shape."""
    return (2, 2) + jax_split_shape(n)[1:]


def from_jax_msplit_packs(packs, n: int, device="cuda") -> torch.Tensor:
    """The JAX package's mixed split packs -> the port's (2, 2, n,
    (n - 1) // 2) tensor on ``device``."""
    a = np.asarray(packs)
    if a.shape != jax_msplit_packs_shape(n):
        raise ValueError(f"expected shape {jax_msplit_packs_shape(n)}, got {a.shape}")
    return torch.from_numpy(np.array(a[:, :, :n, : (n - 1) // 2])).to(device)


def to_jax_msplit_packs(packs: torch.Tensor, n: int) -> np.ndarray:
    """The port's (2, 2, n, (n - 1) // 2) packs -> zero-padded numpy array
    in the JAX package's pack layout."""
    if tuple(packs.shape) != (2, 2, n, (n - 1) // 2):
        raise ValueError(f"expected {(2, 2, n, (n - 1) // 2)} packs, got {tuple(packs.shape)}")
    a = packs.detach().cpu().numpy()
    out = np.zeros(jax_msplit_packs_shape(n), dtype=a.dtype)
    out[:, :, :n, : (n - 1) // 2] = a
    return out


# i-sharded fields (parallel.sharded, parallel.sharded_padded): the JAX
# package keeps a sharded field as ONE global array of n_dev * L planes
# (the n valid ones, then zero pad planes), lane-padded to (rup(n, 8),
# rup(n, 128)) on the kernel path and (n, n) on the plain path; the port
# keeps each rank's (L, n, n) block on that rank.


def from_jax_sharded(x_global, n: int, plan, rank: int, device="cuda") -> torch.Tensor:
    """A JAX sharded global array (numpy or anything np.asarray takes),
    (plan.padded_planes(0), SJ, SK) lane-padded or (..., n, n) -> this
    rank's contiguous (L, n, n) block on ``device``."""
    a = np.asarray(x_global)
    L = plan.local_planes(0)
    if (a.ndim != 3 or a.shape[0] != plan.n_dev * L
            or a.shape[1:] not in ((n, n), jax_padded_shape(n)[1:])):
        raise ValueError(f"expected a ({plan.n_dev * L}, {n}, {n}) or lane-padded sharded "
                         f"array, got {a.shape}")
    return torch.from_numpy(np.array(a[rank * L:(rank + 1) * L, :n, :n])).to(device)


def to_jax_sharded(blocks, n: int, lanes: bool = True) -> np.ndarray:
    """The ranks' (L, n, n) blocks, rank 0 first -> the JAX package's
    global array (n_dev * L planes), zero-padded to its lanes when
    ``lanes`` (the kernel path) and (n, n) otherwise (the plain path)."""
    a = np.concatenate([b.detach().cpu().numpy() for b in blocks])
    if a.ndim != 3 or a.shape[1:] != (n, n):
        raise ValueError(f"expected (L, {n}, {n}) blocks, got {a.shape}")
    if not lanes:
        return a
    out = np.zeros((a.shape[0],) + jax_padded_shape(n)[1:], dtype=a.dtype)
    out[:, :n, :n] = a
    return out


def from_jax_sharded_df(hi, lo, n: int, plan, rank: int, device="cuda"):
    """A JAX sharded double-float pair -> this rank's (hi, lo) blocks."""
    return (from_jax_sharded(hi, n, plan, rank, device),
            from_jax_sharded(lo, n, plan, rank, device))


def to_jax_sharded_df(hi_blocks, lo_blocks, n: int, lanes: bool = True):
    """The ranks' double-float blocks -> the JAX package's sharded pair."""
    return to_jax_sharded(hi_blocks, n, lanes), to_jax_sharded(lo_blocks, n, lanes)


def to_jax_split(xr: torch.Tensor, xb: torch.Tensor, n: int):
    """The port's (red, black) pair -> zero-padded numpy arrays in the
    JAX package's split layout."""
    out = []
    for x in (xr, xb):
        if tuple(x.shape) != (n, n, (n - 1) // 2):
            raise ValueError(f"expected an {(n, n, (n - 1) // 2)} colour, got {tuple(x.shape)}")
        a = x.detach().cpu().numpy()
        padded = np.zeros(jax_split_shape(n), dtype=a.dtype)
        padded[:, :n, : (n - 1) // 2] = a
        out.append(padded)
    return out[0], out[1]
