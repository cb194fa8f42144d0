"""2D-mesh domain decomposition on torch.distributed: the i and j axes
split over an (nx, ny) grid of ranks (counterpart of
``multigrid_parallel_tpu.parallel.sharded2d``).

The 1D i-axis decomposition (sharded.py) runs out of planes as the mesh
grows (1025 planes / 64 devices = 16, and coarser levels vanish). This
module shards BOTH i and j over a 2D grid of the ranks of one
``torch.distributed`` group:

  * halo exchange: one i-plane with the ranks above and below, one
    j-column with the ranks left and right (``dist.batch_isend_irecv``,
    the JAX ``lax.ppermute`` over each mesh axis; the 7-point stencil
    needs no corner halos);
  * parity masks from global (i, j) offsets: both local extents are kept
    even, so block origins preserve the global red/black colouring;
  * coarsening halves both local extents (plane/column-aligned parents:
    local + 1 halo each, as in the 1D plan);
  * the k axis stays whole;
  * below a local-extent threshold, gather over both axes and run the
    replicated single-device recursion (the ``omp single`` analogue).

Rank r sits at mesh coordinates (r // ny, r % ny), the JAX package's
``np.asarray(devices).reshape(nx, ny)`` order. A level with n valid
points a side is stored padded to (nx * Li, ny * Lj, n); each rank holds
its (Li, Lj, n) block, pad rows and columns zero and masked. The norm's
psum over both mesh axes is one ``all_reduce`` over the group; the
gathers go through the whole group (``all_gather``) and are sliced, so no
sub-group is created.

SPMD: each factory returns ``step`` (or ``run``), the function every rank
calls on its own blocks, where the JAX package returns a ``shard_map``-ped
function of the global arrays.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Tuple

import numpy as np
import torch

from multigrid_parallel_tpu_torch.cycles import CycleConfig, _descend, setup_problem
from multigrid_parallel_tpu_torch.hierarchy import Hierarchy
from multigrid_parallel_tpu_torch.ops import pallas3d as pk
from multigrid_parallel_tpu_torch.ops import stencils_3d as ops3
from multigrid_parallel_tpu_torch.parallel.sharded import (
    _all_gather,
    _all_reduce_sum,
    _coarse_solver,
    _sendrecv,
    make_mesh,
)


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


@dataclasses.dataclass(frozen=True)
class ShardPlan2D:
    """Static 2D sharding description (see sharded.ShardPlan)."""

    nx: int
    ny: int
    axes: Tuple[str, str]
    n_sharded: int
    fine_local_i: int
    fine_local_j: int

    def local_i(self, depth: int) -> int:
        return self.fine_local_i >> depth

    def local_j(self, depth: int) -> int:
        return self.fine_local_j >> depth

    def padded_i(self, depth: int) -> int:
        return self.nx * self.local_i(depth)

    def padded_j(self, depth: int) -> int:
        return self.ny * self.local_j(depth)


def plan_sharding_2d(
    hier: Hierarchy, nx: int, ny: int, axes=("x", "y"), min_local: int = 4
) -> ShardPlan2D:
    n_sharded = 1
    while n_sharded < hier.num_levels - 1 and (
        min(
            hier.sizes[hier.num_levels - 1 - n_sharded] // nx,
            hier.sizes[hier.num_levels - 1 - n_sharded] // ny,
        )
        >= min_local
    ):
        n_sharded += 1
    align = 1 << n_sharded
    fi = _round_up(-(-hier.finest_n // nx), align)
    fj = _round_up(-(-hier.finest_n // ny), align)
    return ShardPlan2D(
        nx=nx, ny=ny, axes=tuple(axes), n_sharded=n_sharded,
        fine_local_i=fi, fine_local_j=fj,
    )


@dataclasses.dataclass(frozen=True)
class Mesh2D:
    """This rank's handle on an initialised torch.distributed group seen
    as an (nx, ny) grid (the JAX package's 2D ``Mesh``): its rank at
    coordinates (ix, iy) = (rank // ny, rank % ny), the group's backend
    and the rank's device."""

    rank: int
    nx: int
    ny: int
    backend: str
    device: torch.device

    @property
    def n_dev(self) -> int:
        return self.nx * self.ny

    @property
    def ix(self) -> int:
        return self.rank // self.ny

    @property
    def iy(self) -> int:
        return self.rank % self.ny

    @property
    def staged(self) -> bool:
        """Whether halos and reductions of CUDA tensors go through host
        memory (gloo moves CPU tensors)."""
        return self.backend == "gloo" and self.device.type == "cuda"


def make_mesh_2d(nx: int, ny: int, device="cuda") -> Mesh2D:
    """The handle of this rank in the initialised default process group of
    nx * ny ranks, seen as an (nx, ny) grid; the device rule of
    sharded.make_mesh (``device="cuda"``, the default, takes
    ``cuda:(rank % device_count)``)."""
    m = make_mesh(nx * ny, device=device)
    return Mesh2D(rank=m.rank, nx=nx, ny=ny, backend=m.backend, device=m.device)


# ----------------------------------------------------------- transport


def _exchange_i(mesh: Mesh2D, to_next: torch.Tensor, to_prev: torch.Tensor):
    """ppermute over mesh axis 0: ``to_next`` (this rank's last rows) to
    the rank below (ix + 1), ``to_prev`` (its first rows) to the rank above;
    returns (from_prev, from_next), zeros at the chain ends."""
    return _sendrecv(mesh, to_next, to_prev, mesh.rank - mesh.ny if mesh.ix > 0 else None,
                     mesh.rank + mesh.ny if mesh.ix < mesh.nx - 1 else None)


def _exchange_j(mesh: Mesh2D, to_next: torch.Tensor, to_prev: torch.Tensor):
    """ppermute over mesh axis 1 (columns): as _exchange_i with the ranks
    left (iy - 1) and right (iy + 1)."""
    return _sendrecv(mesh, to_next, to_prev, mesh.rank - 1 if mesh.iy > 0 else None,
                     mesh.rank + 1 if mesh.iy < mesh.ny - 1 else None)


def _halo_i(x, mesh: Mesh2D):
    lo, hi = _exchange_i(mesh, x[-1:], x[:1])
    return torch.cat([lo, x, hi], dim=0)


def _halo_j(x, mesh: Mesh2D):
    lo, hi = _exchange_j(mesh, x[:, -1:], x[:, :1])
    return torch.cat([lo, x, hi], dim=1)


def gather_global2d(x_local: torch.Tensor, mesh: Mesh2D) -> torch.Tensor:
    """The (nx * Li, ny * Lj, ...) global array of the ranks' blocks, on
    every rank (what the JAX package's 2D-sharded global array holds)."""
    li, lj = x_local.shape[:2]
    parts = _all_gather(mesh, x_local).reshape(mesh.nx, mesh.ny, li, lj, *x_local.shape[2:])
    return parts.transpose(1, 2).reshape(mesh.nx * li, mesh.ny * lj, *x_local.shape[2:])


def _rank_block(x_rep: torch.Tensor, mesh: Mesh2D, li: int, lj: int) -> torch.Tensor:
    """This rank's (li, lj) block of a replicated level, zero padded to
    (nx li, ny lj) (the JAX pad + dynamic_slice)."""
    pad_i, pad_j = mesh.nx * li - x_rep.shape[0], mesh.ny * lj - x_rep.shape[1]
    x_pad = torch.nn.functional.pad(x_rep, (0, 0, 0, max(pad_j, 0), 0, max(pad_i, 0)))
    return x_pad[mesh.ix * li:(mesh.ix + 1) * li, mesh.iy * lj:(mesh.iy + 1) * lj].contiguous()


def _gij(mesh: Mesh2D, li: int, lj: int):
    """Global (i, j) of this rank's first row and column at local extents
    (li, lj)."""
    return mesh.ix * li, mesh.iy * lj


def _masks2d(mesh: Mesh2D, li: int, lj: int, n_valid: int, color: Optional[int]):
    gi0, gj0 = _gij(mesh, li, lj)
    ii = (torch.arange(li, device=mesh.device) + gi0).reshape(li, 1, 1)
    jj = (torch.arange(lj, device=mesh.device) + gj0).reshape(1, lj, 1)
    kk = torch.arange(n_valid, device=mesh.device).reshape(1, 1, n_valid)
    interior = (
        (ii >= 1) & (ii <= n_valid - 2) & (jj >= 1) & (jj <= n_valid - 2)
        & (kk >= 1) & (kk <= n_valid - 2)
    )
    if color is None:
        return interior
    return interior & (((ii + jj + kk) % 2) == color)


def _nbr_sum2d(u, mesh: Mesh2D):
    ei = _halo_i(u, mesh)
    ej = _halo_j(u, mesh)
    return (
        ei[:-2]
        + ei[2:]
        + ej[:, :-2]
        + ej[:, 2:]
        + torch.roll(u, 1, 2)
        + torch.roll(u, -1, 2)
    )


# ---------------------------------------------------------------- local ops


def rb_smooth_local2d(u, f, h, n_iter, n_valid, mesh: Mesh2D, red_first=True):
    h2 = h * h
    colors = (ops3.RED, ops3.BLACK) if red_first else (ops3.BLACK, ops3.RED)
    li, lj = u.shape[0], u.shape[1]
    masks = {c: _masks2d(mesh, li, lj, n_valid, c) for c in set(colors)}
    for _ in range(n_iter):
        for c in colors:
            upd = (_nbr_sum2d(u, mesh) - h2 * f) * (1.0 / 6.0)
            u = torch.where(masks[c], upd, u)
    return u


def residual_local2d(u, f, h, n_valid, mesh: Mesh2D):
    inv_h2 = 1.0 / (h * h)
    r = f - inv_h2 * (_nbr_sum2d(u, mesh) - 6.0 * u)
    mask = _masks2d(mesh, u.shape[0], u.shape[1], n_valid, None)
    return torch.where(mask, r, torch.zeros_like(r))


def _tap3_halo(ext, axis: int):
    """Coarse local c <- 0.25 / 0.5 / 0.25 of 1-halo-extended rows 2c, 2c + 1,
    2c + 2 along ``axis`` (block offsets stay even across coarsenings, so
    parents are always ext-local)."""
    x = ext.movedim(axis, 0)
    out = 0.25 * x[0:-2:2] + 0.5 * x[1:-1:2] + 0.25 * x[2::2]
    return out.movedim(0, axis)


def _interp_halo(ext, axis: int):
    """Fine local g <- coarse g / 2 (even g) or the mean of coarse g // 2
    and g // 2 + 1 (odd g), from a right-halo-extended coarse axis."""
    x = ext.movedim(axis, 0)
    even, odd = x[:-1], 0.5 * (x[:-1] + x[1:])
    out = torch.stack([even, odd], dim=1).reshape(-1, *x.shape[1:])
    return out.movedim(0, axis)


def restrict_local2d(r, n_valid_f, mesh: Mesh2D):
    """(Li, Lj, nf) -> (Li/2, Lj/2, nc): the k taps as a full-width matrix
    product, then j and i local 3-taps over one-deep halo exchanges;
    coarse boundary and pad points zeroed."""
    nc = (n_valid_f + 1) // 2
    sk = torch.as_tensor(ops3._restrict_matrix_np(n_valid_f), dtype=r.dtype, device=r.device)
    t = torch.einsum("ck,ijk->ijc", sk, r)
    t = _tap3_halo(_halo_j(t, mesh), 1)
    t = _tap3_halo(_halo_i(t, mesh), 0)
    mask = _masks2d(mesh, t.shape[0], t.shape[1], nc, None)
    return torch.where(mask, t, torch.zeros_like(t))


def prolong_correct_local2d(ec, ef, n_valid_c, mesh: Mesh2D):
    """Coarse (Li/2, Lj/2, nc) correction added into fine (Li, Lj, nf):
    the k taps as a full-width matrix product, j and i interpolation over
    right halos (from the next rank of each axis); contributions to pad
    rows and columns zeroed."""
    nf = 2 * n_valid_c - 1
    pkm = torch.as_tensor(ops3._prolong_matrix_np(n_valid_c), dtype=ec.dtype, device=ec.device)
    t = torch.einsum("kc,ijc->ijk", pkm, ec)
    _, right = _exchange_j(mesh, t[:, -1:], t[:, :1])
    t = _interp_halo(torch.cat([t, right], dim=1), 1)
    _, below = _exchange_i(mesh, t[-1:], t[:1])
    fine = _interp_halo(torch.cat([t, below], dim=0), 0)
    gi0, gj0 = _gij(mesh, fine.shape[0], fine.shape[1])
    ii = (torch.arange(fine.shape[0], device=ec.device) + gi0).reshape(-1, 1, 1)
    jj = (torch.arange(fine.shape[1], device=ec.device) + gj0).reshape(1, -1, 1)
    valid = (ii <= nf - 1) & (jj <= nf - 1)
    return ef + torch.where(valid, fine, torch.zeros_like(fine))


# ------------------------------------------------------------- the cycle


def _to_rep(x, mesh: Mesh2D, n: int):
    """Gather both axes and cut to the n valid rows and columns."""
    return gather_global2d(x, mesh)[:n, :n]


def _correction2d(f_local, hier, cfg, plan, coarse_solve, level, depth, mesh: Mesh2D,
                  e_init=None):
    n_valid = hier.sizes[level]
    h = hier.spacing(level)

    if depth == plan.n_sharded:
        f_rep = _to_rep(f_local, mesh, n_valid)
        e0 = torch.zeros_like(f_rep) if e_init is None else _to_rep(e_init, mesh, n_valid)
        sub = dataclasses.replace(hier, num_levels=level + 1)
        e_rep = _descend(ops3, sub, cfg, coarse_solve, e0, f_rep, level, correction=True)
        return _rank_block(e_rep, mesh, plan.local_i(depth), plan.local_j(depth))

    u = torch.zeros_like(f_local) if e_init is None else e_init
    u = rb_smooth_local2d(u, f_local, h, cfg.n_smooth, n_valid, mesh, True)
    r = residual_local2d(u, f_local, h, n_valid, mesh)
    fc = restrict_local2d(r, n_valid, mesh)
    ec = _recurse2d(fc, hier, cfg, plan, coarse_solve, level - 1, depth + 1, mesh)
    u = prolong_correct_local2d(ec, u, hier.sizes[level - 1], mesh)
    return rb_smooth_local2d(u, f_local, h, cfg.n_smooth, n_valid, mesh, False)


def _recurse2d(fc, hier, cfg, plan, coarse_solve, level, depth, mesh: Mesh2D):
    """gamma visits of the coarse correction (W-cycle when gamma > 1)."""
    ec = _correction2d(fc, hier, cfg, plan, coarse_solve, level, depth, mesh)
    if level > 0 and hier.sizes[level] >= cfg.gamma_min_n:
        for _ in range(cfg.gamma - 1):
            ec = _correction2d(fc, hier, cfg, plan, coarse_solve, level, depth, mesh,
                               e_init=ec)
    return ec


def _plan(hier: Hierarchy, mesh: Mesh2D, plan: Optional[ShardPlan2D]) -> ShardPlan2D:
    if plan is None:
        return plan_sharding_2d(hier, mesh.nx, mesh.ny)
    if (plan.nx, plan.ny) != (mesh.nx, mesh.ny):
        raise ValueError(f"plan for a {plan.nx}x{plan.ny} mesh on a {mesh.nx}x{mesh.ny} one")
    return plan


def make_sharded2d_cycle(hier: Hierarchy, cfg: CycleConfig, mesh: Mesh2D,
                         plan: Optional[ShardPlan2D] = None) -> Tuple[Callable, ShardPlan2D]:
    """(step, plan): step(u, f) -> (u', norm), the rank's part of one
    V-cycle in hier.dtype on (i, j)-sharded blocks (norm equal on every
    rank)."""
    plan = _plan(hier, mesh, plan)
    coarse_solve = _coarse_solver(hier, cfg, hier.dtype, mesh)
    level = hier.num_levels - 1
    n_valid = hier.sizes[level]
    h = hier.spacing(level)

    def step(u, f):
        u = rb_smooth_local2d(u, f, h, cfg.n_smooth, n_valid, mesh, True)
        r = residual_local2d(u, f, h, n_valid, mesh)
        fc = restrict_local2d(r, n_valid, mesh)
        ec = _recurse2d(fc, hier, cfg, plan, coarse_solve, level - 1, 1, mesh)
        u = prolong_correct_local2d(ec, u, hier.sizes[level - 1], mesh)
        u = rb_smooth_local2d(u, f, h, cfg.n_smooth, n_valid, mesh, False)
        r = residual_local2d(u, f, h, n_valid, mesh)
        # one reduction over both mesh axes
        return u, torch.sqrt(_all_reduce_sum(mesh, torch.sum(r * r)))

    return step, plan


def residual_df_local2d(u_hi, u_lo, f_hi, f_lo, h: float, n_valid: int, mesh: Mesh2D):
    """The compensated (EFT) residual of the double-float solution on the
    local block (the arithmetic of ops.pallas3d._eft_residual), one-deep
    halos over both mesh axes, zero off the interior and on pad points."""
    def halo_nbrs(u):
        ei = _halo_i(u, mesh)
        ej = _halo_j(u, mesh)
        return [ei[:-2], ei[2:], ej[:, :-2], ej[:, 2:], torch.roll(u, 1, 2), torch.roll(u, -1, 2)]

    r = pk._eft_residual(f_hi, f_lo, u_hi, halo_nbrs(u_hi), u_lo, halo_nbrs(u_lo), 1.0 / (h * h))
    mask = _masks2d(mesh, u_hi.shape[0], u_hi.shape[1], n_valid, None)
    return torch.where(mask, r, torch.zeros_like(r))


def _build_df_locals(hier: Hierarchy, cfg: CycleConfig, plan: ShardPlan2D, mesh: Mesh2D):
    """Shared pieces of the 2D double-float drivers: (residual_df_local,
    inner_vcycle) on local blocks."""
    f32 = torch.float32
    hier32 = dataclasses.replace(hier, dtype=f32)
    coarse32 = _coarse_solver(hier, cfg, f32, mesh)
    level = hier.num_levels - 1
    n_valid = hier.sizes[level]
    h = hier.spacing(level)

    def residual_df_local(u_hi, u_lo, f_hi, f_lo):
        return residual_df_local2d(u_hi, u_lo, f_hi, f_lo, h, n_valid, mesh)

    def inner_vcycle(e, r32):
        e = rb_smooth_local2d(e, r32, h, cfg.n_smooth, n_valid, mesh, True)
        rr = residual_local2d(e, r32, h, n_valid, mesh)
        fc = restrict_local2d(rr, n_valid, mesh)
        ec = _recurse2d(fc, hier32, cfg, plan, coarse32, level - 1, 1, mesh)
        e = prolong_correct_local2d(ec, e, hier.sizes[level - 1], mesh)
        return rb_smooth_local2d(e, r32, h, cfg.n_smooth, n_valid, mesh, False)

    return residual_df_local, inner_vcycle


def _norm(mesh: Mesh2D, r):
    return torch.sqrt(_all_reduce_sum(mesh, torch.sum(r * r)))


def make_sharded2d_df_cycle(hier: Hierarchy, cfg: CycleConfig, mesh: Mesh2D,
                            plan: Optional[ShardPlan2D] = None,
                            inner_cycles: int = 1) -> Tuple[Callable, ShardPlan2D]:
    """All-f32 double-float cycle on the 2D mesh: the solution is a (hi,
    lo) f32 pair, the outer residual the compensated EFT form (the
    arithmetic of ops.pallas3d._eft_residual), the inner correction
    V-cycle plain f32; ``inner_cycles`` f32 V-cycles run on the same
    normalized defect before the double-float update.

    step(u_hi, u_lo, f_hi, f_lo) -> (u_hi', u_lo', norm)."""
    plan = _plan(hier, mesh, plan)
    residual_df_local, inner_vcycle = _build_df_locals(hier, cfg, plan, mesh)

    def step(u_hi, u_lo, f_hi, f_lo):
        r = residual_df_local(u_hi, u_lo, f_hi, f_lo)
        safe = torch.clamp(_norm(mesh, r), min=1e-30)
        r32 = r / safe
        e = torch.zeros_like(r32)
        for _ in range(inner_cycles):
            e = inner_vcycle(e, r32)
        u_hi, u_lo = pk.df_add(u_hi, u_lo, safe * e)
        return u_hi, u_lo, _norm(mesh, residual_df_local(u_hi, u_lo, f_hi, f_lo))

    return step, plan


def make_sharded2d_df_solver(
    hier: Hierarchy,
    cfg: CycleConfig = CycleConfig(),
    mesh: Optional[Mesh2D] = None,
    plan: Optional[ShardPlan2D] = None,
    rel_tol: float = 1e-8,
    max_cycles: int = 40,
    inner_cycles: int = 4,
) -> Tuple[Callable, ShardPlan2D]:
    """(run, plan): run(u_hi, u_lo, f_hi, f_lo) -> (u_hi, u_lo, norm,
    n_outer), the whole solve to tolerance on the (i, j) mesh on plain ops
    (the 2D twin of sharded_padded.make_sharded_df_solver): double-float
    solution, EFT outer residual with one all-reduced norm,
    ``inner_cycles`` f32 V-cycles per outer defect step; a host loop with
    the JAX stop rule (``tol = f32(rel_tol) * ||f_hi||``, ``while nrm > tol
    and it < max_cycles``)."""
    if mesh is None:
        raise ValueError("mesh is required")
    plan = _plan(hier, mesh, plan)
    residual_df_local, inner_vcycle = _build_df_locals(hier, cfg, plan, mesh)

    def run(u_hi, u_lo, f_hi, f_lo):
        init = np.float32(_norm(mesh, f_hi).item())
        tol = float(np.float32(rel_tol) * init)
        r = residual_df_local(u_hi, u_lo, f_hi, f_lo)
        nrm = _norm(mesh, r)
        it = 0
        while it < max_cycles and nrm.item() > tol:
            # no normalize / scale-back: the V-cycle is linear in r
            e = torch.zeros_like(r)
            for _ in range(inner_cycles):
                e = inner_vcycle(e, r)
            u_hi, u_lo = pk.df_add(u_hi, u_lo, e)
            r = residual_df_local(u_hi, u_lo, f_hi, f_lo)
            nrm = _norm(mesh, r)
            it += 1
        return u_hi, u_lo, nrm, it

    return run, plan


# ------------------------------------------------------------------ setup


def _blocks(x, mesh: Mesh2D, plan: ShardPlan2D):
    return _rank_block(x, mesh, plan.local_i(0), plan.local_j(0))


def setup_df_problem_sharded2d(problem, hier: Hierarchy, mesh: Mesh2D, plan: ShardPlan2D):
    """Double-float (hi, lo) 2D-sharded setup: this rank's (u_hi, u_lo,
    f_hi, f_lo) blocks, on mesh.device."""
    u64, f64 = setup_problem(problem, hier, mesh.device)
    return tuple(_blocks(x, mesh, plan) for x64 in (u64, f64) for x in pk.df_split(x64))


def setup_problem_sharded2d(problem, hier: Hierarchy, mesh: Mesh2D, plan: ShardPlan2D):
    """(u0, f) of this rank: its blocks of the padded fields (reference
    setup semantics, see cycles.setup_problem), on mesh.device."""
    u0, f = setup_problem(problem, hier, mesh.device)
    return _blocks(u0, mesh, plan), _blocks(f, mesh, plan)


def unpad2d(u, hier: Hierarchy):
    """The valid points of a gathered (nx Li, ny Lj, n) global array."""
    return u[: hier.finest_n, : hier.finest_n]

