"""Sharded multigrid on torch.distributed: the i axis split over the
ranks of a process group, with halo exchange (counterpart of
``multigrid_parallel_tpu.parallel.sharded``).

The reference's OpenMP i-slab decomposition (SURVEY.md §2.8): every
stencil kernel there is worksharing over the outer i loop, with halos
implicit in shared memory. Here the i axis is split over the ranks of a
``torch.distributed`` group, halos are neighbour send / receive pairs
(``dist.batch_isend_irecv``, the JAX ``lax.ppermute``), the norm
reduction an ``all_reduce`` (the JAX ``psum``), and the shrinking coarse
levels gather to replicated compute on every rank (``all_gather``), the
analogue of the reference's serial ``omp single`` coarsest solve
(mg_3d.h:1262-1277).

SPMD: each factory returns ``step``, the function every rank calls on its
own (L, n, n) blocks, where the JAX package returns a ``shard_map``-ped
function of the global arrays.

Layout contract (as in the JAX package):
  * a level with N valid planes is stored padded to ``n_dev * L`` planes
    (pad planes are zero and masked out of every update);
  * ``L`` (local planes per rank at the finest level) is a multiple of
    ``2**s``, s = the number of sharded coarsenings, so every sharded
    coarsening halves the local plane count and rank offsets stay even;
  * j and k are not sharded.

Transport: the halo planes and the reductions go through the group's
backend. With ``nccl`` they stay on the card. With ``gloo`` and CUDA
tensors (several ranks sharing one GPU, which NCCL refuses) they are
staged through host memory; every kernel still runs on the card.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Tuple

import torch
import torch.distributed as dist

from multigrid_parallel_tpu_torch.cycles import CycleConfig, _descend, setup_problem
from multigrid_parallel_tpu_torch.hierarchy import Hierarchy
from multigrid_parallel_tpu_torch.ops import coarse as coarse_ops
from multigrid_parallel_tpu_torch.ops import pallas3d as pk
from multigrid_parallel_tpu_torch.ops import stencils_3d as ops3


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


@dataclasses.dataclass(frozen=True)
class ShardPlan:
    """Static description of the i-axis sharding across the hierarchy.

    Depths 0..n_sharded-1 (finest first) run with sharded kernels; the
    restriction out of depth n_sharded-1 lands on depth n_sharded, which
    is gathered to replicated (and everything coarser stays replicated).
    ``fine_local`` is a multiple of 2**n_sharded so every sharded
    coarsening halves the local plane count exactly.
    """

    n_dev: int
    axis: str
    n_sharded: int  # how many of the finest levels run with sharded kernels
    fine_local: int  # L at the finest level (multiple of 2**n_sharded)

    def local_planes(self, depth: int) -> int:
        """L at `depth` sharded coarsenings below the finest level."""
        return self.fine_local >> depth

    def padded_planes(self, depth: int) -> int:
        return self.n_dev * self.local_planes(depth)


def plan_sharding(
    hier: Hierarchy, n_dev: int, axis: str = "x", min_local: int = 4
) -> ShardPlan:
    """Shard as many fine levels as keep >= min_local planes per device.

    The coarsest level is always replicated (it holds the dense direct
    solve — the analogue of the reference's `omp single` section)."""
    n_sharded = 1
    while (
        n_sharded < hier.num_levels - 1
        and (hier.sizes[hier.num_levels - 1 - n_sharded] // n_dev) >= min_local
    ):
        n_sharded += 1
    fine_local = _round_up(-(-hier.finest_n // n_dev), 1 << n_sharded)
    return ShardPlan(n_dev=n_dev, axis=axis, n_sharded=n_sharded, fine_local=fine_local)


@dataclasses.dataclass(frozen=True)
class Mesh:
    """This rank's handle on an initialised torch.distributed group (the
    JAX package's 1D ``Mesh``): its rank, the world size, the group's
    backend and the rank's device."""

    rank: int
    n_dev: int
    backend: str
    device: torch.device

    @property
    def staged(self) -> bool:
        """Whether halos and reductions of CUDA tensors go through host
        memory (gloo moves CPU tensors)."""
        return self.backend == "gloo" and self.device.type == "cuda"


def make_mesh(n_dev: int, device="cuda") -> Mesh:
    """The handle of this rank in the initialised default process group
    of ``n_dev`` ranks. ``device="cuda"`` (the default) takes
    ``cuda:(rank % device_count)``; a group whose ranks share one GPU
    must be a ``gloo`` group (NCCL refuses two ranks on one device), and
    ``nccl`` with more ranks than cards raises."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs an initialised torch.distributed process group "
                           "(see parallel.launch.launch)")
    world, rank = dist.get_world_size(), dist.get_rank()
    if world != n_dev:
        raise ValueError(f"the process group has {world} ranks, not {n_dev}")
    backend = str(dist.get_backend())
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("device 'cuda' asked for, but torch sees no CUDA device")
        count = torch.cuda.device_count()
        if backend == "nccl" and world > count:
            raise ValueError(f"nccl with {world} ranks on {count} GPU(s): NCCL refuses two "
                             "ranks on one device; use backend='gloo'")
        if dev.index is None:
            dev = torch.device("cuda", rank % count)
    elif backend == "nccl":
        raise ValueError(f"nccl moves CUDA tensors, not {dev.type} ones")
    return Mesh(rank=rank, n_dev=world, backend=backend, device=dev)


# ----------------------------------------------------------- transport


def _exchange(mesh: Mesh, to_right: torch.Tensor, to_left: torch.Tensor):
    """The two ppermutes of a halo exchange: ``to_right`` (this rank's
    last planes) becomes the left halo of rank + 1, ``to_left`` (its first
    planes) the right halo of rank - 1. Returns (from_left, from_right),
    shaped like to_right and to_left; the chain ends receive zeros.

    Every request is waited on before returning, so a kernel may then
    write the planes that were sent (gloo reads a send buffer
    asynchronously). Staged (gloo with CUDA tensors): the blocking
    device-to-host copies wait for the stream that wrote the planes."""
    to_right, to_left = to_right.contiguous(), to_left.contiguous()
    if mesh.staged:
        to_right, to_left = to_right.cpu(), to_left.cpu()
    from_left, from_right = torch.zeros_like(to_right), torch.zeros_like(to_left)
    ops = []
    if mesh.rank > 0:
        ops += [dist.P2POp(dist.isend, to_left, mesh.rank - 1),
                dist.P2POp(dist.irecv, from_left, mesh.rank - 1)]
    if mesh.rank < mesh.n_dev - 1:
        ops += [dist.P2POp(dist.isend, to_right, mesh.rank + 1),
                dist.P2POp(dist.irecv, from_right, mesh.rank + 1)]
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    if mesh.staged:
        from_left, from_right = from_left.to(mesh.device), from_right.to(mesh.device)
    return from_left, from_right


def _all_reduce_sum(mesh: Mesh, x: torch.Tensor) -> torch.Tensor:
    """lax.psum: the sum of x over the ranks, on every rank."""
    y = x.cpu() if mesh.staged else x.clone()
    dist.all_reduce(y, op=dist.ReduceOp.SUM)
    return y.to(mesh.device) if mesh.staged else y


def _all_gather(mesh: Mesh, x: torch.Tensor) -> torch.Tensor:
    """lax.all_gather(tiled=True) along axis 0, on every rank."""
    y = x.contiguous().cpu() if mesh.staged else x.contiguous()
    parts = [torch.empty_like(y) for _ in range(mesh.n_dev)]
    dist.all_gather(parts, y)
    out = torch.cat(parts)
    return out.to(mesh.device) if mesh.staged else out


def gather_global(x_local: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The (n_dev * L, ...) global array of the ranks' blocks, on every
    rank (what the JAX package's sharded global array holds)."""
    return _all_gather(mesh, x_local)


def _rank_slice(x_rep: torch.Tensor, mesh: Mesh, local: int) -> torch.Tensor:
    """This rank's ``local`` planes of a replicated level, zero padded to
    n_dev * local planes (the JAX pad + dynamic_slice)."""
    pad = mesh.n_dev * local - x_rep.shape[0]
    x_pad = torch.nn.functional.pad(x_rep, (0, 0, 0, 0, 0, pad))
    return x_pad[mesh.rank * local:(mesh.rank + 1) * local].contiguous()


# ---------------------------------------------------------------- local ops


def _halo_extend(x, mesh: Mesh):
    """(L, n, n) -> (L+2, n, n) with one neighbor plane on each side.

    Ranks at the chain ends receive zeros — harmless, because the global
    boundary planes there are Dirichlet (never updated) or padding
    (masked).
    """
    from_left, from_right = _exchange(mesh, x[-1:], x[:1])
    return torch.cat([from_left, x, from_right])


def _global_row(mesh: Mesh, local: int):
    """Global plane indices of this rank's block, shape (local, 1, 1)."""
    return (torch.arange(local, device=mesh.device) + mesh.rank * local).reshape(local, 1, 1)


def _masks(mesh: Mesh, local: int, n_valid: int, color: Optional[int]):
    """Interior (and optional color) mask for a (local, n, n) block.

    Interior = global plane in [1, n_valid-2] x j,k in [1, n_valid-2];
    pad planes (g >= n_valid) excluded. Parity is on GLOBAL (i+j+k)
    (mg_3d.h:669/693).
    """
    g = _global_row(mesh, local)
    idx = torch.arange(n_valid, device=mesh.device)
    jj, kk = idx.reshape(1, -1, 1), idx.reshape(1, 1, -1)
    interior = (
        (g >= 1) & (g <= n_valid - 2)
        & (jj >= 1) & (jj <= n_valid - 2)
        & (kk >= 1) & (kk <= n_valid - 2)
    )
    if color is None:
        return interior
    return interior & ((g + jj + kk) % 2 == color)


def _valid_row_mask(mesh: Mesh, local: int, n_valid: int):
    return _global_row(mesh, local) <= n_valid - 1


def _neighbor_sum_local(ext, u):
    # i neighbors from the halo-extended block, j/k neighbors local.
    return (
        ext[:-2]
        + ext[2:]
        + torch.roll(u, 1, 1)
        + torch.roll(u, -1, 1)
        + torch.roll(u, 1, 2)
        + torch.roll(u, -1, 2)
    )


def half_sweep_local(u, f, h: float, color: int, n_valid: int, mesh: Mesh):
    """One RB color sweep on the local block (smoothenAtIndex semantics,
    mg_3d.h:438-443), a halo exchange replacing shared memory."""
    ext = _halo_extend(u, mesh)
    upd = (_neighbor_sum_local(ext, u) - (h * h) * f) * (1.0 / 6.0)
    return torch.where(_masks(mesh, u.shape[0], n_valid, color), upd, u)


def rb_smooth_local(u, f, h, n_iter, n_valid, mesh: Mesh, red_first=True):
    colors = (ops3.RED, ops3.BLACK) if red_first else (ops3.BLACK, ops3.RED)
    for _ in range(n_iter):
        for c in colors:
            u = half_sweep_local(u, f, h, c, n_valid, mesh)
    return u


def residual_local(u, f, h: float, n_valid: int, mesh: Mesh):
    """Interior residual on the local block (mg_3d.h:794-842), zero
    elsewhere (including pad planes)."""
    ext = _halo_extend(u, mesh)
    r = f - (1.0 / (h * h)) * (_neighbor_sum_local(ext, u) - 6.0 * u)
    return torch.where(_masks(mesh, u.shape[0], n_valid, None), r, torch.zeros_like(r))


def residual_df_local(u_hi, u_lo, f_hi, f_lo, h: float, n_valid: int, mesh: Mesh):
    """The compensated (EFT) residual of the double-float solution on the
    local block (the arithmetic of ops.pallas3d._eft_residual), zero off
    the interior and on pad planes."""
    def halo_nbrs(u):
        ext = _halo_extend(u, mesh)
        return [ext[:-2], ext[2:], torch.roll(u, 1, 1), torch.roll(u, -1, 1),
                torch.roll(u, 1, 2), torch.roll(u, -1, 2)]

    r = pk._eft_residual(f_hi, f_lo, u_hi, halo_nbrs(u_hi), u_lo, halo_nbrs(u_lo),
                         1.0 / (h * h))
    return torch.where(_masks(mesh, u_hi.shape[0], n_valid, None), r, torch.zeros_like(r))


def norm_sq_local(r, mesh: Mesh):
    return _all_reduce_sum(mesh, torch.sum(r * r))


def restrict_local(r, n_valid_f: int, mesh: Mesh):
    """(L, nf, nf) -> (L/2, nc, nc) full-weighting restriction.

    j/k: separable 3-tap matrix product (ops.stencils_3d._restrict_matrix_np);
    i: plane combination over a 1-plane halo. Coarse boundary/pad entries
    zeroed — the restriction input is always a residual (zero boundary),
    so this matches the reference's injection faces (mg_3d.h:879-958).
    """
    nc = (n_valid_f + 1) // 2
    s = torch.as_tensor(ops3._restrict_matrix_np(n_valid_f), dtype=r.dtype, device=r.device)
    t = torch.einsum("bj,tjk->tbk", s, r)
    t = torch.einsum("ck,tbk->tbc", s, t)
    ext = _halo_extend(t, mesh)  # (L+2, nc, nc)
    coarse = 0.25 * ext[0:-2:2] + 0.5 * ext[1:-1:2] + 0.25 * ext[2::2]
    mask = _masks(mesh, coarse.shape[0], nc, None)
    return torch.where(mask, coarse, torch.zeros_like(coarse))


def prolong_correct_local(ec, ef, n_valid_c: int, mesh: Mesh):
    """(Lc, nc, nc) coarse correction -> added into (L=2Lc, nf, nf) fine.

    j/k: separable interpolation matrix product; i: even planes copy the
    coincident coarse plane, odd planes average (coarse right halo from
    the next rank). Trilinear semantics of mg_3d.h:1000-1145.
    """
    nf = 2 * n_valid_c - 1
    p = torch.as_tensor(ops3._prolong_matrix_np(n_valid_c), dtype=ec.dtype, device=ec.device)
    t = torch.einsum("jb,tbc->tjc", p, ec)
    t = torch.einsum("kc,tjc->tjk", p, t)
    _, from_right = _exchange(mesh, t[-1:], t[:1])
    ext = torch.cat([t, from_right])  # (Lc+1, nf, nf)
    even = ext[:-1]
    odd = 0.5 * (ext[:-1] + ext[1:])
    fine = torch.stack([even, odd], dim=1).reshape(-1, *t.shape[1:])
    # Zero contributions to pad planes so they stay exactly zero.
    mask = _valid_row_mask(mesh, fine.shape[0], nf)
    return ef + torch.where(mask, fine, torch.zeros_like(fine))


# ------------------------------------------------------------- the cycle


def _sharded_correction(f_local, hier: Hierarchy, cfg: CycleConfig, plan: ShardPlan,
                        coarse_solve, level: int, depth: int, mesh: Mesh, e_init=None):
    """Solve the correction equation at `level` (zero initial guess, or
    ``e_init`` on a gamma/W-cycle revisit) with the finest
    `plan.n_sharded` levels sharded; deeper levels replicated.

    Stage order matches vcycle (mg_3d.h:1242-1362).
    """
    n_valid = hier.sizes[level]
    h = hier.spacing(level)

    if depth == plan.n_sharded:
        # Gather to replicated and run the single-device recursion — the
        # analogue of the reference's `omp single` coarse section.
        f_rep = _all_gather(mesh, f_local)[:n_valid]
        sub = dataclasses.replace(hier, num_levels=level + 1)
        if e_init is None:
            e0 = torch.zeros_like(f_rep)
        else:
            e0 = _all_gather(mesh, e_init)[:n_valid]
        e_rep = _descend(ops3, sub, cfg, coarse_solve, e0, f_rep, level, correction=True)
        # Back to sharded: each rank takes its plane slice.
        return _rank_slice(e_rep, mesh, plan.local_planes(depth))

    u = torch.zeros_like(f_local) if e_init is None else e_init
    u = rb_smooth_local(u, f_local, h, cfg.n_smooth, n_valid, mesh, True)
    r = residual_local(u, f_local, h, n_valid, mesh)
    fc = restrict_local(r, n_valid, mesh)
    ec = _recurse_sharded(fc, hier, cfg, plan, coarse_solve, level - 1, depth + 1, mesh)
    u = prolong_correct_local(ec, u, hier.sizes[level - 1], mesh)
    return rb_smooth_local(u, f_local, h, cfg.n_smooth, n_valid, mesh, False)


def _recurse_sharded(fc, hier, cfg, plan, coarse_solve, level, depth, mesh):
    """gamma visits of the coarse correction (W-cycle when gamma > 1);
    the coarsest level is always visited once (direct solve is exact)."""
    ec = _sharded_correction(fc, hier, cfg, plan, coarse_solve, level, depth, mesh)
    if level > 0 and hier.sizes[level] >= cfg.gamma_min_n:
        for _ in range(cfg.gamma - 1):
            ec = _sharded_correction(fc, hier, cfg, plan, coarse_solve, level, depth, mesh,
                                     e_init=ec)
    return ec


def sharded_v_cycle_local(u_local, f_local, hier: Hierarchy, cfg: CycleConfig,
                          plan: ShardPlan, coarse_solve, mesh: Mesh):
    """One V-cycle on the sharded finest level (u carries the BCs).

    Returns (u_local', residual 2-norm, a 0-d tensor equal on every rank)."""
    level = hier.num_levels - 1
    n_valid = hier.sizes[level]
    h = hier.spacing(level)

    u = rb_smooth_local(u_local, f_local, h, cfg.n_smooth, n_valid, mesh, True)
    r = residual_local(u, f_local, h, n_valid, mesh)
    fc = restrict_local(r, n_valid, mesh)
    ec = _recurse_sharded(fc, hier, cfg, plan, coarse_solve, level - 1, 1, mesh)
    u = prolong_correct_local(ec, u, hier.sizes[level - 1], mesh)
    u = rb_smooth_local(u, f_local, h, cfg.n_smooth, n_valid, mesh, False)
    r = residual_local(u, f_local, h, n_valid, mesh)
    return u, torch.sqrt(norm_sq_local(r, mesh))


def _coarse_solver(hier: Hierarchy, cfg: CycleConfig, dtype, mesh: Mesh):
    return coarse_ops.make_coarse_solver(hier.coarse_n, hier.spacing(0), dtype, mesh.device,
                                         cfg.coarse_method, ndim=hier.ndim)


def make_sharded_cycle(hier: Hierarchy, cfg: CycleConfig, mesh: Mesh,
                       plan: Optional[ShardPlan] = None) -> Tuple[Callable, ShardPlan]:
    """(step, plan): step(u_local, f_local) -> (u_local', norm), the
    rank's part of one V-cycle in hier.dtype on i-sharded blocks."""
    if plan is None:
        plan = plan_sharding(hier, mesh.n_dev)
    coarse_solve = _coarse_solver(hier, cfg, hier.dtype, mesh)

    def step(u_local, f_local):
        return sharded_v_cycle_local(u_local, f_local, hier, cfg, plan, coarse_solve, mesh)

    return step, plan


def make_sharded_mixed_cycle(hier: Hierarchy, cfg: CycleConfig, mesh: Mesh,
                             plan: Optional[ShardPlan] = None) -> Tuple[Callable, ShardPlan]:
    """Mixed-precision sharded cycle: f64 state/residual, f32 V-cycle
    (see cycles.make_mixed_cycle). step(u, f) -> (u', norm)."""
    if plan is None:
        plan = plan_sharding(hier, mesh.n_dev)
    f32 = torch.float32
    hier32 = dataclasses.replace(hier, dtype=f32)
    coarse32 = _coarse_solver(hier, cfg, f32, mesh)
    level = hier.num_levels - 1
    n_valid = hier.sizes[level]
    h = hier.spacing(level)

    def step(u, f):
        r = residual_local(u, f, h, n_valid, mesh)
        nrm = torch.sqrt(norm_sq_local(r, mesh))
        safe = torch.clamp(nrm, min=1e-300)
        r32 = (r / safe).to(f32)
        u32 = rb_smooth_local(torch.zeros_like(r32), r32, h, cfg.n_smooth, n_valid, mesh, True)
        rr = residual_local(u32, r32, h, n_valid, mesh)
        fc = restrict_local(rr, n_valid, mesh)
        ec = _recurse_sharded(fc, hier32, cfg, plan, coarse32, level - 1, 1, mesh)
        u32 = prolong_correct_local(ec, u32, hier.sizes[level - 1], mesh)
        u32 = rb_smooth_local(u32, r32, h, cfg.n_smooth, n_valid, mesh, False)
        u = u + safe * u32.to(u.dtype)
        r_after = residual_local(u, f, h, n_valid, mesh)
        return u, torch.sqrt(norm_sq_local(r_after, mesh))

    return step, plan


def make_sharded_df_cycle(hier: Hierarchy, cfg: CycleConfig, mesh: Mesh,
                          plan: Optional[ShardPlan] = None,
                          inner_cycles: int = 1) -> Tuple[Callable, ShardPlan]:
    """Sharded all-f32 double-float cycle: like make_sharded_mixed_cycle
    but with no f64 anywhere — the solution is a (hi, lo) f32 pair and
    the outer residual is the compensated EFT evaluation (the arithmetic
    of ops.pallas3d._eft_residual, in plain tensor ops).

    ``inner_cycles`` runs several f32 correction V-cycles on the same
    normalized defect before the double-float update.

    step(u_hi, u_lo, f_hi, f_lo) -> (u_hi', u_lo', norm).
    """
    if plan is None:
        plan = plan_sharding(hier, mesh.n_dev)
    f32 = torch.float32
    hier32 = dataclasses.replace(hier, dtype=f32)
    coarse32 = _coarse_solver(hier, cfg, f32, mesh)
    level = hier.num_levels - 1
    n_valid = hier.sizes[level]
    h = hier.spacing(level)

    def inner_vcycle(e, r32):
        e = rb_smooth_local(e, r32, h, cfg.n_smooth, n_valid, mesh, True)
        rr = residual_local(e, r32, h, n_valid, mesh)
        fc = restrict_local(rr, n_valid, mesh)
        ec = _recurse_sharded(fc, hier32, cfg, plan, coarse32, level - 1, 1, mesh)
        e = prolong_correct_local(ec, e, hier.sizes[level - 1], mesh)
        return rb_smooth_local(e, r32, h, cfg.n_smooth, n_valid, mesh, False)

    def step(u_hi, u_lo, f_hi, f_lo):
        r = residual_df_local(u_hi, u_lo, f_hi, f_lo, h, n_valid, mesh)
        nrm = torch.sqrt(norm_sq_local(r, mesh))
        safe = torch.clamp(nrm, min=1e-30)
        r32 = r / safe
        e = torch.zeros_like(r32)
        for _ in range(inner_cycles):
            e = inner_vcycle(e, r32)
        u_hi, u_lo = pk.df_add(u_hi, u_lo, safe * e)
        r_after = residual_df_local(u_hi, u_lo, f_hi, f_lo, h, n_valid, mesh)
        return u_hi, u_lo, torch.sqrt(norm_sq_local(r_after, mesh))

    return step, plan


# ------------------------------------------------------------------ setup


def setup_problem_sharded(problem, hier: Hierarchy, mesh: Mesh, plan: ShardPlan):
    """(u0, f) of this rank: its blocks of the padded fields (reference
    setup semantics — see cycles.setup_problem), on mesh.device."""
    u0, f = setup_problem(problem, hier, mesh.device)
    L = plan.local_planes(0)
    return _rank_slice(u0, mesh, L), _rank_slice(f, mesh, L)


def setup_df_problem_sharded(problem, hier: Hierarchy, mesh: Mesh, plan: ShardPlan):
    """Double-float (hi, lo) sharded setup: this rank's (u_hi, u_lo, f_hi,
    f_lo) blocks."""
    u64, f64 = setup_problem(problem, hier, mesh.device)
    L = plan.local_planes(0)
    return tuple(_rank_slice(x, mesh, L) for x64 in (u64, f64) for x in pk.df_split(x64))


def unpad(u_padded, hier: Hierarchy):
    """The valid planes of a gathered (n_dev * L, n, n) global array."""
    return u_padded[: hier.finest_n]
