"""3D multigrid stencil ops as plain torch tensor code: the port's f64
oracles, and the plain versions behind the CUDA kernels of
``ops.pallas3d``.

Counterpart of ``multigrid_parallel_tpu.ops.stencils_3d``. Each op
reproduces the arithmetic of the corresponding C kernel in mg_3d.h as
whole-array tensor ops:

  * red-black Gauss-Seidel half-sweeps -> masked whole-array updates.
    Within one colour sweep every update reads only opposite-colour
    neighbours, so the masked update is exactly the sequential C loop
    (mg_3d.h:640-781).
  * lexicographic Gauss-Seidel (mg_3d.h:546-637) -> one update per
    hyperplane i + j + k = s, in increasing s (see gauss_seidel_lex).
  * residual -> one stencil expression (mg_3d.h:794-842).
  * full-weighting restriction -> three separable 3-tap matrix products,
    injection on boundary faces (mg_3d.h:844-998); the strided-slice
    transcription of the C loops is kept as an oracle.
  * trilinear prolongate-and-correct -> three separable interpolation
    matrix products (mg_3d.h:1000-1145), with its parity-class oracle.

The masks are built once per (n, device) and shared: callers only read
them.

Scalars (h) are python floats, so they adopt the tensor dtype: the same
code runs f32 (the kernels' plain versions) and f64 (the oracles).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

# Colour convention (mg_3d.h:669, 693): RED = nodes with (i+j+k) odd
# (the red loop starts k at 1+(i+j)%2), BLACK = (i+j+k) even.
RED, BLACK = 1, 0


@functools.lru_cache(maxsize=None)
def _masks(n: int, device):
    """(red_interior, black_interior, interior) boolean masks, n^3, built
    once per (n, device) as the JAX package caches its numpy masks."""
    idx = torch.arange(n, device=device)
    par = (idx[:, None, None] + idx[None, :, None] + idx[None, None, :]) % 2
    inner = (idx >= 1) & (idx <= n - 2)
    interior = inner[:, None, None] & inner[None, :, None] & inner[None, None, :]
    return (par == RED) & interior, (par == BLACK) & interior, interior


def zero_boundary(x: torch.Tensor) -> torch.Tensor:
    """Zero all boundary nodes. Used on coarse-level corrections, whose
    boundary is exactly zero in exact arithmetic (identity boundary rows
    x zero RHS, mg_3d.h:185) but picks up O(eps) noise from the pivoted
    coarse solve."""
    _, _, interior = _masks(x.shape[0], x.device)
    return torch.where(interior, x, torch.zeros_like(x))


def apply_neumann_copy(u: torch.Tensor) -> torch.Tensor:
    """Homogeneous-Neumann enforcement by copying the adjacent interior
    plane onto each boundary plane (the mg_3d_bkup.c:84-133 rule), as a
    new tensor. Faces go x, then y, then z, so later faces win at edges
    and corners: afterwards a boundary node holds u[c(i), c(j), c(k)],
    with c mapping 0 -> 1, n-1 -> n-2 and every interior index to itself.
    Every face is Neumann (the JAX function's per-face ``neumann_masks``
    has no caller in either package)."""
    n = u.shape[0]
    u = u.clone()
    u[0] = u[1]
    u[n - 1] = u[n - 2]
    u[:, 0] = u[:, 1]
    u[:, n - 1] = u[:, n - 2]
    u[:, :, 0] = u[:, :, 1]
    u[:, :, n - 1] = u[:, :, n - 2]
    return u


def neighbor_sum(u: torch.Tensor) -> torch.Tensor:
    """Sum of the 6 face neighbours in the reference's addition order
    (i-1)+(i+1)+(j-1)+(j+1)+(k-1)+(k+1) (mg_3d.h:439-441). Wrapped roll
    values land only on boundary rows, which no caller uses."""
    return (
        torch.roll(u, 1, 0)
        + torch.roll(u, -1, 0)
        + torch.roll(u, 1, 1)
        + torch.roll(u, -1, 1)
        + torch.roll(u, 1, 2)
        + torch.roll(u, -1, 2)
    )


def _half_sweep(u, f, h: float, color_mask) -> torch.Tensor:
    """One RB-GS colour sweep: u <- (nbr_sum - h^2 f) * (1/6) on
    `color_mask` (smoothenAtIndex, mg_3d.h:438-443)."""
    h2 = h * h
    upd = (neighbor_sum(u) - h2 * f) * (1.0 / 6.0)
    return torch.where(color_mask, upd, u)


def rb_smooth(u: torch.Tensor, f: torch.Tensor, h: float, n_iter: int,
              red_first: bool = True) -> torch.Tensor:
    """Red-black Gauss-Seidel sweeps: ``red_first=True`` is the reference
    preSmoother (mg_3d.h:640-709), ``False`` the postSmoother
    (mg_3d.h:711-781)."""
    red, black, _ = _masks(u.shape[0], u.device)
    first, second = (red, black) if red_first else (black, red)
    for _ in range(n_iter):
        u = _half_sweep(u, f, h, first)
        u = _half_sweep(u, f, h, second)
    return u


def jacobi_smooth(u: torch.Tensor, f: torch.Tensor, h: float, n_iter: int,
                  omega: float = 2.0 / 3.0) -> torch.Tensor:
    """Weighted-Jacobi smoother (the parallel-trivial alternative to
    RB-GS): u <- (1 - omega) u + omega (nbr_sum - h^2 f) / 6 on the
    interior, all points at once."""
    _, _, interior = _masks(u.shape[0], u.device)
    h2 = h * h
    for _ in range(n_iter):
        upd = (neighbor_sum(u) - h2 * f) * (1.0 / 6.0)
        u = torch.where(interior, (1.0 - omega) * u + omega * upd, u)
    return u


@functools.lru_cache(maxsize=None)
def _lex_planes(n: int, device):
    """The interior points of an n^3 grid grouped by hyperplane i + j + k
    = s, in increasing s: per plane a (7, m) tensor of flat indices, the
    points themselves, then their neighbours in nbr_sum order."""
    idx = np.arange(1, n - 1)
    i, j, k = (a.ravel() for a in np.meshgrid(idx, idx, idx, indexing="ij"))
    flat = (i * n + j) * n + k
    s = i + j + k
    nn = n * n
    planes = []
    for plane in range(3, 3 * (n - 2) + 1):
        p = flat[s == plane]
        planes.append(torch.as_tensor(
            np.stack([p, p - nn, p + nn, p - n, p + n, p - 1, p + 1]), device=device))
    return planes


def gauss_seidel_lex(u: torch.Tensor, f: torch.Tensor, h: float, n_iter: int) -> torch.Tensor:
    """Lexicographic Gauss-Seidel (mg_3d.h:546-637): n_iter sweeps over
    the interior in (i, j, k) order, each point updated from the latest
    values, as a new tensor.

    A point's lower neighbours (i-1, j-1, k-1) lie on the hyperplane
    i + j + k = s - 1 and its upper ones on s + 1, so sweeping the planes
    in increasing s, every point of a plane at once, reads exactly what
    the sequential loop reads: the updated values below, the old ones
    above. The neighbour addition order is kept, so the result equals the
    sequential sweep bit for bit (one plane a step, 3 (n - 2) - 2 steps a
    sweep, where a per-point loop takes (n - 2)^3)."""
    n = u.shape[0]
    h2 = h * h
    flat = u.clone().reshape(-1)
    ff = f.reshape(-1)
    planes = _lex_planes(n, u.device)
    for _ in range(n_iter):
        for idx in planes:
            nb = flat[idx[1:]]
            s = nb[0] + nb[1] + nb[2] + nb[3] + nb[4] + nb[5]
            flat[idx[0]] = (s - h2 * ff[idx[0]]) * (1.0 / 6.0)
    return flat.reshape(n, n, n)


def update_edge_values(u: torch.Tensor) -> torch.Tensor:
    """Cosmetic smoothing of the cube's 12 edges and 8 corners
    (mg_3d.h:304-429), as a new tensor: edges = average of the 2 adjacent
    face neighbours, corners = average of the 3 adjacent edge neighbours.
    Used with the lexicographic smoother, as in the reference
    (mg_3d.h:635, 1423)."""
    n = u.shape[0]
    s = slice(1, n - 1)
    u = u.clone()

    def inner(x):
        return 1 if x == 0 else n - 2

    for i in (0, n - 1):
        for j in (0, n - 1):
            u[i, j, s] = 0.5 * (u[inner(i), j, s] + u[i, inner(j), s])
        for k in (0, n - 1):
            u[i, s, k] = 0.5 * (u[inner(i), s, k] + u[i, s, inner(k)])
    for j in (0, n - 1):
        for k in (0, n - 1):
            u[s, j, k] = 0.5 * (u[s, inner(j), k] + u[s, j, inner(k)])
    for i in (0, n - 1):
        for j in (0, n - 1):
            for k in (0, n - 1):
                u[i, j, k] = (u[inner(i), j, k] + u[i, inner(j), k] + u[i, j, inner(k)]) / 3.0
    return u


def residual(u: torch.Tensor, f: torch.Tensor, h: float) -> torch.Tensor:
    """r = f - (1/h^2)(nbr_sum - 6 u) on the interior, 0 on the boundary
    (calculateResidual, mg_3d.h:794-842)."""
    _, _, interior = _masks(u.shape[0], u.device)
    inv_h2 = 1.0 / (h * h)
    r = f - inv_h2 * (neighbor_sum(u) - 6.0 * u)
    return torch.where(interior, r, torch.zeros_like(r))


def residual_norm(u: torch.Tensor, f: torch.Tensor, h: float) -> torch.Tensor:
    """||r||_2 over the interior (the vcycle return value, mg_3d.h:1354)."""
    r = residual(u, f, h)
    return torch.sqrt(torch.sum(r * r))


@functools.lru_cache(maxsize=None)
def _restrict_matrix_np(nf: int) -> np.ndarray:
    """(nc, nf) separable full-weighting matrix: interior rows the 3-tap
    [1/4, 1/2, 1/4] stencil at stride 2, end rows injection. The 27-point
    table of mg_3d.h:851-872 is the tensor product of three of these."""
    nc = (nf + 1) // 2
    s = np.zeros((nc, nf))
    s[0, 0] = 1.0
    s[nc - 1, nf - 1] = 1.0
    for ic in range(1, nc - 1):
        s[ic, 2 * ic - 1 : 2 * ic + 2] = (0.25, 0.5, 0.25)
    return s


@functools.lru_cache(maxsize=None)
def _prolong_matrix_np(nc: int) -> np.ndarray:
    """(nf, nc) linear-interpolation matrix: even fine rows copy the
    coincident coarse point, odd rows average the two neighbours. The
    tensor product of three is the trilinear kernel of mg_3d.h:1000-1145."""
    nf = 2 * nc - 1
    p = np.zeros((nf, nc))
    p[2 * np.arange(nc), np.arange(nc)] = 1.0
    p[2 * np.arange(nc - 1) + 1, np.arange(nc - 1)] = 0.5
    p[2 * np.arange(nc - 1) + 1, np.arange(nc - 1) + 1] = 0.5
    return p


def restrict_full_weighting(r: torch.Tensor) -> torch.Tensor:
    """Fine (Nf^3) -> coarse (Nc^3), Nc = (Nf+1)/2: 27-point full
    weighting on the interior (mg_3d.h:961-995), injection of the
    coincident fine value on the six faces (mg_3d.h:879-958)."""
    s = torch.as_tensor(_restrict_matrix_np(r.shape[0]), dtype=r.dtype,
                        device=r.device)
    t = torch.einsum("ai,ijk->ajk", s, r)
    t = torch.einsum("bj,ajk->abk", s, t)
    t = torch.einsum("ck,abk->abc", s, t)
    # the separable end rows alone would 2D-filter the tangential axes
    t[0] = r[0, ::2, ::2]
    t[-1] = r[-1, ::2, ::2]
    t[:, 0] = r[::2, 0, ::2]
    t[:, -1] = r[::2, -1, ::2]
    t[:, :, 0] = r[::2, ::2, 0]
    t[:, :, -1] = r[::2, ::2, -1]
    return t


def prolong_correct(ec: torch.Tensor, ef: torch.Tensor) -> torch.Tensor:
    """ef + trilinear_interp(ec), all fine nodes (mg_3d.h:1000-1145)."""
    p = torch.as_tensor(_prolong_matrix_np(ec.shape[0]), dtype=ec.dtype,
                        device=ec.device)
    t = torch.einsum("ia,abc->ibc", p, ec)
    t = torch.einsum("jb,ibc->ijc", p, t)
    t = torch.einsum("kc,ijc->ijk", p, t)
    return ef + t


# Full-weighting nodal weights (mg_3d.h:851-872): 1/8 centre, 1/16 faces,
# 1/32 edges, 1/64 corners, by offset (di, dj, dk) in {-1, 0, 1}^3.
_FW_WEIGHTS = {
    (di, dj, dk): (1.0 / 8.0) * (0.5 ** (abs(di) + abs(dj) + abs(dk)))
    for di in (-1, 0, 1)
    for dj in (-1, 0, 1)
    for dk in (-1, 0, 1)
}


def restrict_full_weighting_slices(r: torch.Tensor) -> torch.Tensor:
    """Strided-slice form of restrict_full_weighting (the direct
    transcription of the C loops, kept as a cross-check oracle)."""
    nf = r.shape[0]
    out = r[::2, ::2, ::2].clone()
    core = None
    for (di, dj, dk), w in _FW_WEIGHTS.items():
        sl = r[2 + di:nf - 2 + di:2, 2 + dj:nf - 2 + dj:2, 2 + dk:nf - 2 + dk:2]
        term = w * sl
        core = term if core is None else core + term
    out[1:-1, 1:-1, 1:-1] = core
    return out


def prolong_correct_slices(ec: torch.Tensor, ef: torch.Tensor) -> torch.Tensor:
    """Parity-class strided-slice form of prolong_correct (cross-check
    oracle; the addition order per point follows the C corner tables)."""
    c = ec
    ef = ef.clone()
    # (even, even, even): coincident copy (mg_3d.h:1137-1138)
    ef[::2, ::2, ::2] += c
    # one odd axis: midpoint of 2 coarse neighbours (mg_3d.h:1101-1134)
    ef[1::2, ::2, ::2] += 0.5 * (c[:-1, :, :] + c[1:, :, :])
    ef[::2, 1::2, ::2] += 0.5 * (c[:, :-1, :] + c[:, 1:, :])
    ef[::2, ::2, 1::2] += 0.5 * (c[:, :, :-1] + c[:, :, 1:])
    # two odd axes: face-centre average of 4 (mg_3d.h:1053-1097)
    ef[::2, 1::2, 1::2] += 0.25 * (c[:, :-1, :-1] + c[:, 1:, :-1] + c[:, :-1, 1:] + c[:, 1:, 1:])
    ef[1::2, ::2, 1::2] += 0.25 * (c[:-1, :, :-1] + c[1:, :, :-1] + c[:-1, :, 1:] + c[1:, :, 1:])
    ef[1::2, 1::2, ::2] += 0.25 * (c[:-1, :-1, :] + c[:-1, 1:, :] + c[1:, :-1, :] + c[1:, 1:, :])
    # three odd axes: cube-centre average of 8 (mg_3d.h:1023-1049)
    ef[1::2, 1::2, 1::2] += 0.125 * (
        c[:-1, :-1, :-1] + c[:-1, :-1, 1:] + c[:-1, 1:, :-1] + c[:-1, 1:, 1:]
        + c[1:, :-1, :-1] + c[1:, :-1, 1:] + c[1:, 1:, :-1] + c[1:, 1:, 1:]
    )
    return ef
