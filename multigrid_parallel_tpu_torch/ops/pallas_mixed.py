"""The mixed-BC (electrospray) smoothing kernels of the full-layout
correction cycle, hand-written in CUDA for Hopper, with their plain
PyTorch versions, the Dirichlet pin planes and the BC pass.

Counterpart of ``multigrid_parallel_tpu.ops.pallas_mixed`` (its single-
device kernels; the sharded ``*_ext`` / ``*_halo`` ones come with the
distribution slice). Wrapper, the Pallas kernel it replaces in
multigrid_parallel_tpu/ops/pallas_mixed.py, and its CUDA source in
ops/csrc/ (both share mixed.cuh):

  K13 mixed_rb_smooth_fused            mixed_rb_smooth_fused            mixed_rb_smooth.cu
  K14 mixed_rb_smooth_from_zero_fused  mixed_rb_smooth_from_zero_fused  mixed_rb_smooth.cu
  K15 mixed_prolong_smooth_fused       mixed_prolong_smooth_fused       mixed_prolong_smooth.cu

The boundary condition of the correction equation: homogeneous Neumann
on every face, enforced by the BC pass (``apply_bcs_padded``: face
copies in x, y, z order, then the pin), except the Dirichlet patches of
the x = 0 and x = n-1 faces, pinned to zero. Their masks are the (2, n,
n) f32 0/1 ``pin`` planes of ``dirichlet_pin_planes``.

The kernels fold the copy-BC into the stencil (a face-adjacent
neighbour reads the reader's own value, or 0 at a pinned x-face node)
and end each stage with one BC pass, as the Pallas kernels do. The plain
versions are written in the COPY form instead: a half-sweep, then a BC
pass, after every half-sweep (``mixed_padded._mixed_smooth_padded_jnp``
in the JAX package). The two agree bit for bit on BC-consistent input,
which is what the cycle hands over (the zero field, or a stage's
output); so comparing a kernel with its plain version on the card checks
the fold too. Random test inputs go through a BC pass first.

A wrapper takes the plain version for tensors on the CPU, launches its
kernel for CUDA tensors (float32, contiguous, cubic fields; pin (2, n,
n)), and raises for anything else: no fallback from the kernel to the
plain version. Each kernel launch adds one to its entry in ``LAUNCHES``
(every half-sweep and BC pass of a stage counts as a launch of the
stage's kernel).
"""

from __future__ import annotations

import numpy as np
import torch

from multigrid_parallel_tpu_torch.ops import pallas3d as pk
from multigrid_parallel_tpu_torch.ops import stencils_3d as ops3
from multigrid_parallel_tpu_torch.ops.pallas3d import _check, _colors, _lib, _stream
from multigrid_parallel_tpu_torch.ops.stencils_3d import BLACK, RED

KERNELS = (
    "mixed_rb_smooth_fused",
    "mixed_rb_smooth_from_zero_fused",
    "mixed_prolong_smooth_fused",
)
# kernel launches per wrapper, since the last reset_launches()
LAUNCHES = dict.fromkeys(KERNELS, 0)


def reset_launches() -> None:
    for name in KERNELS:
        LAUNCHES[name] = 0


def dirichlet_pin_planes(problem, n: int, device="cuda") -> torch.Tensor:
    """(2, n, n) f32 pin mask (1.0 at the Dirichlet patch nodes of the
    x = 0 / x = n-1 faces) on ``device``, from the problem's f64 geometry
    (``boundary_masks``), so the kernels' patch membership matches it
    exactly."""
    mask, _ = problem.boundary_masks(n)
    # The kernels pin Dirichlet nodes only on the two x faces; a patch
    # anywhere else would be silently treated as Neumann.
    if np.any(np.asarray(mask)[1 : n - 1]):
        raise ValueError(
            "pallas_mixed supports Dirichlet patches on the i=0/i=n-1 "
            "faces only; this problem has patch nodes on other faces"
        )
    out = np.stack([mask[0], mask[n - 1]]).astype(np.float32)
    return torch.from_numpy(out).to(device)


def apply_bcs_padded(e, pin, vals=None):
    """The BC pass (plain torch): whole-face Neumann copies in x, y, z
    order (``ops.stencils_3d.apply_neumann_copy``), then the Dirichlet pin
    of the x faces. ``pin``: (2, n, n) 0/1 patch masks; ``vals``: the
    (2, n, n) patch values, or None for the zero pin of a correction.
    Returns a new tensor (the JAX name is kept; the port has no padding)."""
    n = e.shape[0]
    e = ops3.apply_neumann_copy(e)
    v0 = torch.zeros_like(e[0]) if vals is None else vals[0]
    v1 = torch.zeros_like(e[0]) if vals is None else vals[1]
    e[0] = torch.where(pin[0] > 0.5, v0, e[0])
    e[n - 1] = torch.where(pin[1] > 0.5, v1, e[n - 1])
    return e


def _on_cuda(pin, *fields, coarse=None) -> bool:
    """pallas3d's field checks, plus the pin planes: (2, n, n) on the
    fields' device (float32 and contiguous on CUDA)."""
    on_cuda = pk._on_cuda(*fields, coarse=coarse)
    n = fields[0].shape[0]
    if pin.device != fields[0].device:
        raise ValueError(f"pin planes on {pin.device}, fields on {fields[0].device}")
    if tuple(pin.shape) != (2, n, n):
        raise ValueError(f"expected (2, {n}, {n}) pin planes, got {tuple(pin.shape)}")
    if on_cuda and (pin.dtype != torch.float32 or not pin.is_contiguous()):
        raise TypeError("CUDA kernels take contiguous float32 pin planes")
    return on_cuda


# -------------------------------------------------- K13 / K14: mixed RB-GS


def mixed_rb_smooth_plain(e, r, pin, h: float, n_iter: int, red_first: bool = True):
    """Plain version of K13 in the copy form: each half-sweep followed by
    the zero-pin BC pass. Returns a new field."""
    red, black, _ = ops3._masks(e.shape[0], e.device)
    colors = (red, black) if red_first else (black, red)
    for _ in range(n_iter):
        for cmask in colors:
            e = apply_bcs_padded(ops3._half_sweep(e, r, h, cmask), pin)
    return e


def mixed_rb_smooth_from_zero_plain(r, pin, h: float, n_iter: int, red_first: bool = True):
    """Plain version of K14: K13 from a zero initial guess."""
    return mixed_rb_smooth_plain(torch.zeros_like(r), r, pin, h, n_iter, red_first)


def _half_sweeps_and_bc_pass(u, r, pin, h2, colors, name):
    """Launch K13's in-place half-sweeps of ``colors``, then its BC pass,
    each counted as a launch of ``name``."""
    lib, stream, n = _lib(), _stream(), u.shape[0]
    for c in colors:
        _check(lib.mg_mixed_half_sweep(u.data_ptr(), r.data_ptr(), pin.data_ptr(), n, h2,
                                       c, stream), name)
        LAUNCHES[name] += 1
    _check(lib.mg_mixed_bc_pass(u.data_ptr(), pin.data_ptr(), n, stream), name)
    LAUNCHES[name] += 1


def mixed_rb_smooth_fused(e, r, pin, h: float, n_iter: int, red_first: bool = True):
    """n_iter mixed-BC RB-GS iterations on the correction e (red first =
    pre-smoothing, black first = post-smoothing), ending with the BC pass.

    Updates ``e`` IN PLACE and returns it (on both devices): the CUDA form
    is 2 * n_iter half-sweep launches and one BC-pass launch. ``e`` must
    be BC-consistent (the cycle's fields are)."""
    if not _on_cuda(pin, e, r):
        return e.copy_(mixed_rb_smooth_plain(e, r, pin, h, n_iter, red_first))
    _half_sweeps_and_bc_pass(e, r, pin, h * h, list(_colors(red_first)) * n_iter,
                             "mixed_rb_smooth_fused")
    return e


def mixed_rb_smooth_from_zero_fused(r, pin, h: float, n_iter: int, red_first: bool = True):
    """mixed_rb_smooth_fused from an implicit zero initial guess, as a
    fresh field: the first half-sweep reads only r (K2's from-zero launch:
    the folded reads of a zero field are zero too) and writes every point."""
    if not _on_cuda(pin, r):
        return mixed_rb_smooth_from_zero_plain(r, pin, h, n_iter, red_first)
    lib, n, h2 = _lib(), r.shape[0], h * h
    out = torch.empty_like(r)
    first, second = _colors(red_first)
    _check(lib.mg_rb_half_sweep_from_zero(out.data_ptr(), r.data_ptr(), n, h2, first,
                                          _stream()), "mixed_rb_smooth_from_zero_fused")
    LAUNCHES["mixed_rb_smooth_from_zero_fused"] += 1
    _half_sweeps_and_bc_pass(out, r, pin, h2, [second] + list(_colors(red_first)) * (n_iter - 1),
                             "mixed_rb_smooth_from_zero_fused")
    return out


# ------------------------------ K15: mixed prolongation + correction + smooth


def mixed_prolong_smooth_plain(ec, e, r, pin, h: float, n_iter: int):
    """Plain version of K15: e + trilinear interpolation of ec (coarse
    boundary included; j, then k, then i), the BC pass, then the black-
    first copy-form stage."""
    t = ec
    for axis in (1, 2, 0):
        t = pk._interp_axis(t, axis)
    return mixed_rb_smooth_plain(apply_bcs_padded(e + t, pin), r, pin, h, n_iter,
                                 red_first=False)


def mixed_prolong_smooth_fused(ec, e, r, pin, h: float, n_iter: int):
    """The black-first mixed stage of e + P ec as a fresh field (e is left
    as it is): the post-smoothing stage of a mixed V-cycle level. The CUDA
    form is one K15 launch (correction + first black half-sweep), then
    2 * n_iter - 1 K13 half-sweeps and the BC pass, all counted as K15
    launches."""
    if n_iter < 1:
        raise ValueError(f"n_iter must be >= 1, got {n_iter}")
    if not _on_cuda(pin, e, r, coarse=ec):
        return mixed_prolong_smooth_plain(ec, e, r, pin, h, n_iter)
    n, h2 = e.shape[0], h * h
    out = torch.empty_like(e)
    _check(_lib().mg_mixed_prolong_correct_black(
        out.data_ptr(), ec.data_ptr(), e.data_ptr(), r.data_ptr(), pin.data_ptr(), n, h2,
        _stream()), "mixed_prolong_smooth_fused")
    LAUNCHES["mixed_prolong_smooth_fused"] += 1
    _half_sweeps_and_bc_pass(out, r, pin, h2, [RED] + [BLACK, RED] * (n_iter - 1),
                             "mixed_prolong_smooth_fused")
    return out
