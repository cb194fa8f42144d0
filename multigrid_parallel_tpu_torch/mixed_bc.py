"""Mixed Dirichlet/Neumann multigrid: the electrospray solver (counterpart
of ``multigrid_parallel_tpu.mixed_bc``), as plain torch on an explicit
device.

The reference's original physics target (mg_3d_bkup.c) solves the
electrostatic potential with *mixed* boundary conditions: a few boundary
patches pinned (capillary disk, extractor annulus) and homogeneous
Neumann everywhere else, enforced inside the smoother by copying the
updated adjacent interior value onto the boundary node (mg_3d_bkup.c:
84-133). As in the JAX package:

  * the smoother is the masked RB-GS half-sweep followed by the Neumann
    face copy and the Dirichlet re-pin (``_apply_bcs``); the C code's
    in-sweep copies and this post-sweep form share the same fixed point;
  * the correction equation inherits the BC structure with zero
    Dirichlet values, so every coarse level pins its patches to zero;
  * the coarsest level solves a dense mixed-BC matrix: interior rows the
    1/h^2 7-point Laplacian, Dirichlet rows identity, Neumann rows
    u[b] - u[src] = 0 with src the face-copy source of
    ``ops.stencils_3d.apply_neumann_copy`` (z > y > x priority).

The coarse factor is ``torch.linalg.lu_factor`` of the f64 matrix on the
host (LAPACK's 1-based pivots; ``utils.convert.from_jax_coarse_lu``
converts the JAX package's scipy factor), kept in ``_lu_host`` /
``_piv_host`` and cast to the working dtype and device where a solve is
built. The outer loops are host loops with one scalar readback per
cycle or outer step, where the JAX package jits a ``lax.while_loop``.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from multigrid_parallel_tpu_torch.hierarchy import Hierarchy
from multigrid_parallel_tpu_torch.models.electrospray import ElectrosprayProblem
from multigrid_parallel_tpu_torch.ops import stencils_3d as ops3


def _neumann_source_index(i, j, k, n):
    """Copy-source of a boundary node, matching apply_neumann_copy's
    face application order (x, then y, then z faces — later overwrites
    win, so z has priority at edges/corners)."""
    if k == 0:
        return (i, j, 1)
    if k == n - 1:
        return (i, j, n - 2)
    if j == 0:
        return (i, 1, k)
    if j == n - 1:
        return (i, n - 2, k)
    if i == 0:
        return (1, j, k)
    return (n - 2, j, k)


def build_mixed_coarse_matrix(n: int, h: float, dirichlet_mask: np.ndarray) -> np.ndarray:
    """Dense (n^3, n^3) f64 mixed-BC operator (see module docstring)."""
    nn = n * n
    total = n**3
    a = np.zeros((total, total))
    inv_h2 = 1.0 / (h * h)
    for i in range(n):
        for j in range(n):
            for k in range(n):
                p = nn * i + n * j + k
                on_boundary = i in (0, n - 1) or j in (0, n - 1) or k in (0, n - 1)
                if not on_boundary:
                    a[p, p] = -6.0 * inv_h2
                    for off in (nn, -nn, n, -n, 1, -1):
                        a[p, p + off] = inv_h2
                elif dirichlet_mask[i, j, k]:
                    a[p, p] = 1.0
                else:
                    si, sj, sk = _neumann_source_index(i, j, k, n)
                    a[p, p] = 1.0
                    a[p, nn * si + n * sj + sk] = -1.0
    return a


@dataclasses.dataclass
class MixedBCSolver:
    """Multigrid solver for the electrospray mixed-BC Poisson problem.

    Mirrors the mg_3d_bkup.c driver: V-cycles with RB-GS smoothing and
    in-smoother BC enforcement, converging the interior residual. Fields
    live on ``device``, in ``hier.dtype`` (f64) for the host cycle.
    """

    problem: ElectrosprayProblem
    hier: Hierarchy
    n_smooth: int = 2
    gamma: int = 1  # W-cycle when 2 (coarse corrections revisited)
    # Extra RB relaxation restricted to the planes within
    # ``boundary_band_width`` of any face, after each smoothing stage: it
    # kills the copy-BC boundary error layer the coarse grids cannot
    # represent, and shares the smoother's fixed point (docs/MIXED_BC.md;
    # 0 = off = the reference-shaped cycle).
    boundary_band_width: int = 0
    boundary_band_iters: int = 0
    # W-cycle depth cap: gamma revisits apply only to sub-levels of size
    # >= gamma_min_n (0 = full W-cycle; level 0 is never revisited).
    gamma_min_n: int = 0
    device: str | torch.device = "cuda"

    def __post_init__(self):
        self._masks = []
        for lvl in range(self.hier.num_levels):
            mask, vals = self.problem.boundary_masks(self.hier.sizes[lvl])
            self._masks.append((torch.as_tensor(mask, device=self.device),
                                torch.as_tensor(vals, dtype=self.hier.dtype,
                                                device=self.device)))
        n0 = self.hier.sizes[0]
        a = build_mixed_coarse_matrix(n0, self.hier.spacing(0),
                                      self.problem.boundary_masks(n0)[0])
        self._lu_host, self._piv_host = torch.linalg.lu_factor(torch.from_numpy(a))
        # the transfers' einsums must be full f32 on the card, as JAX's are
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False

    # -- BC application ------------------------------------------------

    def _coarse_solver(self, dtype):
        """solve(f) -> x of the coarsest mixed system, with the current
        host factor cast to ``dtype`` on the device."""
        lu = self._lu_host.to(device=self.device, dtype=dtype)
        piv = self._piv_host.to(device=self.device)

        def solve(f):
            return torch.linalg.lu_solve(lu, piv, f.reshape(-1, 1)).reshape(f.shape)

        return solve

    def _apply_bcs(self, u, lvl: int, zero_dirichlet: bool):
        mask, vals = self._masks[lvl]
        u = ops3.apply_neumann_copy(u)
        pin = torch.zeros_like(u) if zero_dirichlet else vals.to(u.dtype)
        return torch.where(mask, pin, u)

    @staticmethod
    def _band_mask_np(n: int, w: int):
        idx = np.arange(n)
        return (
            (idx[:, None, None] <= w) | (idx[:, None, None] >= n - 1 - w)
            | (idx[None, :, None] <= w) | (idx[None, :, None] >= n - 1 - w)
            | (idx[None, None, :] <= w) | (idx[None, None, :] >= n - 1 - w)
        )

    def _smooth(self, u, f, lvl: int, n_iter: int, red_first, zero_dirichlet):
        h = self.hier.spacing(lvl)
        red, black, _ = ops3._masks(u.shape[0], u.device)
        colors = (red, black) if red_first else (black, red)
        for _ in range(n_iter):
            for cmask in colors:
                u = ops3._half_sweep(u, f, h, cmask)
                u = self._apply_bcs(u, lvl, zero_dirichlet)
        if self.boundary_band_iters > 0:
            near = torch.as_tensor(self._band_mask_np(u.shape[0], self.boundary_band_width),
                                   device=u.device)
            for _ in range(self.boundary_band_iters):
                for cmask in colors:
                    u = ops3._half_sweep(u, f, h, cmask & near)
                    u = self._apply_bcs(u, lvl, zero_dirichlet)
        return u

    # -- cycle ----------------------------------------------------------

    def _revisits(self, lvl: int) -> int:
        """W-cycle revisits of the correction at level ``lvl``."""
        if lvl > 0 and self.hier.sizes[lvl] >= self.gamma_min_n:
            return self.gamma - 1
        return 0

    def _descend(self, u, f, lvl: int, zero_dirichlet: bool, coarse_solve):
        if lvl == 0:
            x = coarse_solve(f)
            # correction solves pin Dirichlet nodes to zero exactly
            mask, _ = self._masks[0]
            return torch.where(mask, torch.zeros_like(x), x) if zero_dirichlet else x
        h = self.hier.spacing(lvl)
        u = self._smooth(u, f, lvl, self.n_smooth, True, zero_dirichlet)
        fc = ops3.restrict_full_weighting(ops3.residual(u, f, h))
        ec = torch.zeros_like(fc)
        for _ in range(1 + self._revisits(lvl - 1)):
            ec = self._descend(ec, fc, lvl - 1, True, coarse_solve)
        u = ops3.prolong_correct(ec, u)
        u = self._apply_bcs(u, lvl, zero_dirichlet)
        return self._smooth(u, f, lvl, self.n_smooth, False, zero_dirichlet)

    # -- driver -----------------------------------------------------------

    def initial_state(self):
        lvl = self.hier.num_levels - 1
        n = self.hier.sizes[lvl]
        f = torch.zeros((n, n, n), dtype=self.hier.dtype, device=self.device)  # charge-free
        u = self._apply_bcs(torch.zeros_like(f), lvl, zero_dirichlet=False)
        return u, f

    def solve(self, rel_tol: float = 1e-8, max_cycles: int = 60, verbose=False):
        """V- (or W-) cycles on the full problem in ``hier.dtype`` until
        ||r|| <= rel_tol * ||r0||. Returns (u, norms, init)."""
        u, f = self.initial_state()
        lvl = self.hier.num_levels - 1
        h = self.hier.spacing(lvl)
        coarse_solve = self._coarse_solver(self.hier.dtype)
        init = float(ops3.residual_norm(u, f, h))
        norms = []
        for it in range(max_cycles):
            u = self._descend(u, f, lvl, False, coarse_solve)
            n = float(ops3.residual_norm(u, f, h))
            norms.append(n)
            if verbose:
                print(f"cycle {it:3d}  resid {n:.6e}")
            if n <= rel_tol * init:
                break
        return u, norms, init

    # -- f64 outer / f32 inner ---------------------------------------------

    def make_on_device_solver(self, rel_tol: float = 1e-8, max_cycles: int = 100,
                              inner_cycles: int = 1):
        """Build ``run(u0, f) -> (u, norm, n_outer)``: f64 solution and
        defect residual in an outer loop; each outer step runs
        ``inner_cycles`` f32 correction cycles on the defect normalized by
        its norm (zero-Dirichlet masks at every level, Neumann copies after
        each half-sweep), adds the scaled correction in f64 and re-enforces
        the BCs exactly. Stop rule of the JAX function: ``tol = rel_tol *
        ||r0||`` in f64, ``while nrm > tol and it < max_cycles``."""
        f32 = torch.float32
        lvl_top = self.hier.num_levels - 1
        h_top = self.hier.spacing(lvl_top)
        coarse32 = self._coarse_solver(f32)
        mask_top, vals_top = self._masks[lvl_top]

        def descend32(e, fdef, lvl):
            return self._descend(e, fdef, lvl, True, coarse32)

        def residual(u, f):
            r = ops3.residual(u, f, h_top)
            return r, torch.sqrt(torch.sum(r * r))

        def run(u0, f):
            u = u0
            r, nrm = residual(u, f)
            tol = rel_tol * float(nrm)
            it = 0
            while nrm.item() > tol and it < max_cycles:
                safe = torch.clamp(nrm, min=1e-300)
                r32 = (r / safe).to(f32)
                e = torch.zeros_like(r32)
                for _ in range(inner_cycles):
                    e = descend32(e, r32, lvl_top)
                u = u + safe * e.to(u.dtype)
                u = torch.where(mask_top, vals_top, ops3.apply_neumann_copy(u))
                r, nrm = residual(u, f)
                it += 1
            return u, nrm, it

        return run

    def solve_on_device(self, rel_tol: float = 1e-8, max_cycles: int = 100,
                        inner_cycles: int = 1):
        """The f64-outer solve from the initial state. Returns (u,
        final_norm, n_outer, init)."""
        run = self.make_on_device_solver(rel_tol, max_cycles, inner_cycles)
        u0, f = self.initial_state()
        init = float(ops3.residual_norm(u0, f, self.hier.spacing(self.hier.num_levels - 1)))
        u, norm, n_outer = run(u0, f)
        return u, float(norm), int(n_outer), init
