"""The double-float defect-correction solver and its f32 correction
V-cycle (counterpart of ``multigrid_parallel_tpu.cycles_padded``).

The module keeps its JAX name so a reader finds each counterpart, but
the port's layout has NO padding: every field is a plain contiguous
(n, n, n) tensor, where the JAX package stores (n, rup(n,8), rup(n,128))
lane-padded arrays (and trims or folds k to save lanes — TPU layout work
with no counterpart here).

Everything inside the V-cycle computes CORRECTIONS (zero-boundary
fields): restriction inputs are residuals and every level boundary is
pinned to zero (mg_3d.h:879-958 injection of zero faces; identity
boundary rows x zero RHS, mg_3d.h:185).

The V-cycle is the JAX ``_make_descend`` in its UNFUSED branch, the one
it takes whenever the TPU planners decline a fusion: RB stage (K1/K2),
residual (R), separable restriction, coarse recursion, separable
prolongation + correction, RB stage (K1), and outside the cycle
``df_add`` + the EFT residual with its norm (K5). On the TPU at 257³ the
planners take the fused branches instead (K3 residual+restrict, K4
prolong+smooth, K6 df_add+residual+norm); those fusions only keep a
field out of device memory and come to the port as later kernels. On
a CUDA device every level above the coarsest runs the hand kernels (the
JAX package's jnp crossover at 33³ measured TPU launch overhead and is
not carried over); CPU tensors take the plain versions.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from multigrid_parallel_tpu_torch.cycles import CycleConfig, setup_problem
from multigrid_parallel_tpu_torch.hierarchy import Hierarchy
from multigrid_parallel_tpu_torch.ops import coarse as coarse_ops
from multigrid_parallel_tpu_torch.ops import pallas3d as pk
from multigrid_parallel_tpu_torch.ops import stencils_3d as ops3


@functools.lru_cache(maxsize=None)
def _restrict_matrix(nf: int, dtype: torch.dtype, device: torch.device):
    """(nc, nf) 3-tap restriction matrix; rows 0 and nc-1 (injection in
    the f64 oracle) are zero: correction boundaries are zero by
    construction."""
    s = ops3._restrict_matrix_np(nf).copy()
    s[0, 0] = s[-1, -1] = 0.0
    return torch.as_tensor(s, dtype=dtype, device=device)


@functools.lru_cache(maxsize=None)
def _prolong_matrix(nc: int, dtype: torch.dtype, device: torch.device):
    """(nf, nc) linear-interpolation matrix."""
    return torch.as_tensor(ops3._prolong_matrix_np(nc), dtype=dtype, device=device)


def restrict_padded(r: torch.Tensor, nf: int) -> torch.Tensor:
    """(nf, nf, nf) residual -> (nc, nc, nc) coarse RHS: full weighting
    on the interior, zero boundary (correction semantics). Three
    separable 3-tap matrix products, j then k then i as in the JAX
    package; full f32 (the solver turns TF32 off)."""
    s = _restrict_matrix(nf, r.dtype, r.device)
    t = torch.matmul(s, r)                       # j: (nf, nc, nf)
    t = torch.matmul(t, s.T)                     # k: (nf, nc, nc)
    nc = s.shape[0]
    return torch.matmul(s, t.reshape(nf, nc * nc)).reshape(nc, nc, nc)  # i


def prolong_correct_padded(ec: torch.Tensor, ef: torch.Tensor, nc: int) -> torch.Tensor:
    """ef + trilinear interpolation of ec (correction fields), separable
    matrix products j, k, i as in the JAX package."""
    p = _prolong_matrix(nc, ec.dtype, ec.device)
    nf = p.shape[0]
    t = torch.matmul(p, ec)                      # j: (nc, nf, nc)
    t = torch.matmul(t, p.T)                     # k: (nc, nf, nf)
    t = torch.matmul(p, t.reshape(nc, nf * nf)).reshape(nf, nf, nf)  # i
    return ef + t


def _make_descend(hier32: Hierarchy, cfg: CycleConfig, coarse_solve):
    """Build descend(e, r, level, from_zero) -> e': one correction
    V-cycle from ``level`` down.

    ``cfg.gamma`` > 1 revisits each coarse correction (W-cycle); the
    coarsest level is always visited once and ``cfg.gamma_min_n`` caps
    the revisits to sub-levels of at least that size."""
    n_smooth = cfg.n_smooth

    def _recurse(descend, rc, level):
        ec = descend(None, rc, level, from_zero=True)
        if level > 0 and hier32.sizes[level] >= cfg.gamma_min_n:
            for _ in range(cfg.gamma - 1):
                ec = descend(ec, rc, level)
        return ec

    def descend(e, r, level, from_zero=False):
        """One correction V-cycle level; e=None with from_zero=True means
        a zero initial guess (no zeros field is materialized). A given e
        is updated in place by the smoother."""
        n = hier32.sizes[level]
        if level == 0:
            return ops3.zero_boundary(coarse_solve(r))
        h = hier32.spacing(level)
        if from_zero:
            e = pk.rb_smooth_from_zero_fused(r, h, n_smooth, red_first=True)
        else:
            e = pk.rb_smooth_fused(e, r, h, n_smooth, red_first=True)
        rc = restrict_padded(pk.residual_fused(e, r, h), n)
        ec = _recurse(descend, rc, level - 1)
        e = prolong_correct_padded(ec, e, hier32.sizes[level - 1])
        return pk.rb_smooth_fused(e, r, h, n_smooth, red_first=False)

    return descend


def make_padded_correction_cycle(hier32: Hierarchy, cfg: CycleConfig, device="cpu"):
    """Build cycle(e, r, from_zero=False) -> e': one V-cycle on the
    correction equation A e = r at the finest level (f32 fields on
    ``device``); a given e is updated in place."""
    coarse_solve = coarse_ops.make_coarse_solver(
        hier32.coarse_n, hier32.spacing(0), hier32.dtype, device, cfg.coarse_method
    )
    descend = _make_descend(hier32, cfg, coarse_solve)
    level = hier32.num_levels - 1

    def cycle(e, r, from_zero=False):
        return descend(e, r, level, from_zero=from_zero)

    return cycle


def make_on_device_df_solver(
    hier: Hierarchy,
    cfg: CycleConfig = CycleConfig(),
    rel_tol: float = 1e-8,
    max_cycles: int = 40,
    inner_cycles: int = 4,
    init_norm: float = None,
    device="cpu",
):
    """run(u_hi, u_lo, f_hi, f_lo) -> (u_hi, u_lo, norm, n_outer): the
    all-f32 double-float solver. The solution is a double-float pair
    (two f32), the outer defect residual is the compensated EFT kernel
    (K5), and each outer step runs ``inner_cycles`` f32 correction
    V-cycles on the defect.

    The outer loop is a host loop with one scalar readback per outer
    step, with the JAX package's stop rule: ``init`` and ``tol =
    f32(rel_tol) * init`` in f32, the initial residual before the loop,
    ``while nrm > tol and it < max_cycles``. ``init_norm`` is the
    reference's ||f||-whole-cube constant (``ref_init_norm``); it
    defaults to ||f_hi|| computed from the inputs.
    """
    if cfg.smoother != "rb":
        raise ValueError(f"the double-float solver smooths with 'rb', got {cfg.smoother!r}")
    # the transfers must be full f32, as JAX's Precision.HIGHEST is
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    hier32 = dataclasses.replace(hier, dtype=torch.float32)
    inner = make_padded_correction_cycle(hier32, cfg, device)
    h = hier.spacing(hier.num_levels - 1)

    def residual(u_hi, u_lo, f_hi, f_lo):
        r, nrm2 = pk.residual_df_norm_fused(u_hi, u_lo, f_hi, f_lo, h)
        return r, torch.sqrt(nrm2)

    def run(u_hi, u_lo, f_hi, f_lo):
        if init_norm is not None:
            init = np.float32(init_norm)
        else:
            init = np.float32(torch.sqrt(torch.sum(f_hi * f_hi)).item())
        tol = float(np.float32(rel_tol) * init)
        r, nrm = residual(u_hi, u_lo, f_hi, f_lo)
        it = 0
        while it < max_cycles and nrm.item() > tol:
            e = inner(None, r, from_zero=True)
            for _ in range(inner_cycles - 1):
                e = inner(e, r)
            u_hi, u_lo = pk.df_add(u_hi, u_lo, e)
            r, nrm = residual(u_hi, u_lo, f_hi, f_lo)
            it += 1
        return u_hi, u_lo, nrm, it

    return run


def setup_df_problem(problem, hier: Hierarchy, device="cpu"):
    """(u_hi, u_lo, f_hi, f_lo) double-float (n, n, n) f32 setup with the
    reference semantics of cycles.setup_problem, evaluated in hier.dtype
    (full layout: the JAX package's trim=False)."""
    u64, f64 = setup_problem(problem, hier, device)
    u_hi, u_lo = pk.df_split(u64)
    f_hi, f_lo = pk.df_split(f64)
    return u_hi, u_lo, f_hi, f_lo


def ref_init_norm(problem, hier: Hierarchy, device="cpu") -> float:
    """||f||_2 over the WHOLE finest cube, boundary Dirichlet values
    included — the reference's initial-residual convention
    (mg_3d.h:1430-1433)."""
    _, f64 = setup_problem(problem, hier, device)
    return float(torch.sqrt(torch.sum(f64 * f64)))
