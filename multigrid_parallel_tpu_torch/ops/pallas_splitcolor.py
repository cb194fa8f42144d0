"""The packed split-colour RB-GS smoothing stage, hand-written in CUDA for
Hopper, with its plain PyTorch version and the packed layout's pack /
unpack.

Counterpart of ``multigrid_parallel_tpu.ops.pallas_splitcolor``. Wrapper,
the Pallas kernel it replaces in multigrid_parallel_tpu/ops/
pallas_splitcolor.py, and its CUDA source in ops/csrc/ (on split.cuh):

  K42 rb_smooth_split_fused      rb_smooth_split_fused        rb_smooth_splitcolor.cu

As in JAX, no solve path calls it: its caller is the stage bench
(``utils.timing.profile_splitcolor_stage``, the counterpart of
scripts/splitcolor_bench.py), which times it against the rect stage
(K1) and the pair stage (K7), each beside its per-sweep form.

K42 is K7's one-pass stage (split.cuh, ``stage_body`` with PACKED) on
the packed array, on K7's plan (``pallas_split._stage_plan``): one launch
a call at n_iter <= 2 into a FRESH array, the input left as it is
(ceil(n_iter / 2) launches in all). Its first form,
``rb_smooth_split_fused_per_sweep``, one launch a half-sweep in place,
stays as the stage bench's per-sweep row.

The layout. A field is ONE contiguous tensor of shape
``split_shape(n) = (n, 2 n, (n - 1) // 2)``: the split pair of
``ops.pallas_split`` concatenated along j, red rows [0, n), black rows
[n, 2 n) (colour 0 = red, as in JAX). Slot kk of colour c in row (i, j)
holds the fine point k = 2 kk + 1 + ((i + j + c) mod 2): the pair's slot
map, so the pair's masks (``pallas_split._masks``) and its dead-slot
invariant hold unchanged. The TPU's array is (n, 2 rup(n, 8),
rup((n - 1) // 2, 128)); its sublane and lane padding has no counterpart
here (``utils.convert.from_jax_splitcolor`` carries state across).

Only the n - 2 interior k's are stored, so the stage is right only for
fields whose k = 0 and k = n - 1 faces are zero (corrections), as in
JAX; the first and last interior k read the dead slot or a zero past the
end of the row there.

The neighbour sum follows the Pallas splitcolor order, i - 1, i + 1,
j - 1, j + 1 left to right, then the two k-neighbours summed first and
added as one term (pallas_splitcolor.py:133-141). That is not the pair
kernels' order (``pallas_split._nbr_sum``, one term at a time), so K42
agrees with K7 and K1 to a few ulp, and with its own plain version bit
for bit.

A wrapper takes the plain version for tensors on the CPU, launches its
kernel for CUDA tensors (float32, contiguous, in the packed shape), and
raises for anything else: no fallback from the kernel to the plain
version. Each stage launch adds one to its entry in ``LAUNCHES``; the
first form's launches (one a half-sweep) count in ``PER_SWEEP_LAUNCHES``.
"""

from __future__ import annotations

import torch

from multigrid_parallel_tpu_torch.ops import pallas_split as ps
from multigrid_parallel_tpu_torch.ops.pallas3d import _check, _colors, _lib, _stream
from multigrid_parallel_tpu_torch.ops.stencils_3d import RED

KERNELS = ("rb_smooth_split_fused",)
# kernel launches per wrapper, since the last reset_launches()
LAUNCHES = dict.fromkeys(KERNELS, 0)
# the per-sweep form of K42, counted apart from K42's launches
PER_SWEEP_LAUNCHES = {"rb_smooth_split_fused_per_sweep": 0}


def reset_launches() -> None:
    for name in KERNELS:
        LAUNCHES[name] = 0
    PER_SWEEP_LAUNCHES["rb_smooth_split_fused_per_sweep"] = 0


def split_shape(n: int):
    """(n, 2 n, (n - 1) // 2): the packed array, red rows then black rows."""
    return (n, 2 * n, (n - 1) // 2)


def pack_split(x: torch.Tensor) -> torch.Tensor:
    """(n, n, n) cube -> packed (n, 2 n, (n - 1) // 2) array: the pair of
    ``pallas_split.pack_split`` (dead slots 0, k faces dropped) joined
    along j. For setup and tests only."""
    return torch.cat(ps.pack_split(x), dim=1)


def unpack_split(u2: torch.Tensor) -> torch.Tensor:
    """Packed array -> (n, n, n) cube with zero k = 0 and k = n - 1 faces."""
    n = u2.shape[0]
    return ps.unpack_split(u2[:, :n], u2[:, n:])


def _on_cuda(u2: torch.Tensor, f2: torch.Tensor, n: int) -> bool:
    """False for CPU tensors (plain path); True for CUDA tensors that the
    kernel takes; raises for anything else."""
    if n < 3 or n % 2 == 0:
        raise ValueError(f"the packed layout needs an odd n >= 3, got n = {n}")
    for x in (u2, f2):
        if tuple(x.shape) != split_shape(n):
            raise ValueError(f"expected shape {split_shape(n)}, got {tuple(x.shape)}")
    if u2.device != f2.device:
        raise ValueError(f"fields on different devices: {u2.device}, {f2.device}")
    if u2.dtype != f2.dtype or not u2.dtype.is_floating_point:
        raise TypeError(f"fields of one floating dtype expected, got {u2.dtype}, {f2.dtype}")
    if u2.device.type == "cpu":
        return False
    if u2.device.type != "cuda":
        raise ValueError(f"no kernel for device {u2.device}")
    if u2.dtype != torch.float32:
        raise TypeError(f"the CUDA kernel takes float32, got {u2.dtype}")
    if not (u2.is_contiguous() and f2.is_contiguous()):
        raise ValueError("the CUDA kernel takes contiguous fields")
    if u2.numel() >= 2 ** 31:
        raise ValueError(f"n = {n} overflows the kernel's int32 slot index")
    return True


def _half_sweep(dst, src, f, h: float, lower, live):
    """One colour's half-sweep in the splitcolor order: the four i / j
    terms left to right, then (src[kk] + its other k-neighbour)."""
    t = ps._nbrs(src, lower)
    s = (((t[0] + t[1]) + t[2]) + t[3]) + (t[4] + t[5])
    return torch.where(live, (s - (h * h) * f) * (1.0 / 6.0), dst)


def rb_smooth_split_fused_plain(u2, f2, h: float, n_iter: int, red_first: bool = True):
    """Plain version of K42: returns the smoothed packed array (u2
    untouched)."""
    n = u2.shape[0]
    r, b, fr, fb = u2[:, :n], u2[:, n:], f2[:, :n], f2[:, n:]
    red_odd, live_r, live_b = ps._masks(n, u2.device)
    for _ in range(n_iter):
        for c in _colors(red_first):
            if c == RED:
                r = _half_sweep(r, b, fr, h, red_odd, live_r)
            else:
                b = _half_sweep(b, r, fb, h, ~red_odd, live_b)
    return torch.cat([r, b], dim=1)


def rb_smooth_split_fused(u2, f2, h: float, n_iter: int, n: int, red_first: bool = True):
    """n_iter red-black GS iterations on a packed split-colour array,
    red first (preSmoother ordering) or black first, each half-sweep
    updating only its colour's live slots, as a FRESH array: u2 is left as
    it is (on both devices).

    The positional arguments are the JAX function's; its ``block_i`` (the
    VMEM slab the TPU streams) has no counterpart. The CUDA form is one
    one-pass launch of K7's stage on the packed array for n_iter <= 2,
    ceil(n_iter / 2) in all, each later one on the array so far."""
    if n_iter < 1:
        raise ValueError(f"n_iter must be >= 1, got {n_iter}")
    if not _on_cuda(u2, f2, n):
        return rb_smooth_split_fused_plain(u2, f2, h, n_iter, red_first)
    lib, stream, h2 = _lib(), _stream(), h * h
    for chunk in ps._stage_chunks(n_iter):
        out = torch.empty_like(u2)
        _check(lib.mg_splitcolor_stage(out.data_ptr(), u2.data_ptr(), f2.data_ptr(), n, h2,
                                       int(red_first), *ps._plan_args(n, chunk, u2.device),
                                       stream), "rb_smooth_split_fused")
        LAUNCHES["rb_smooth_split_fused"] += 1
        u2 = out
    return u2


def rb_smooth_split_fused_per_sweep(u2, f2, h: float, n_iter: int, n: int,
                                    red_first: bool = True):
    """K42's first CUDA form, kept as the stage bench's per-sweep row: one
    launch a half-sweep, 2 n_iter launches, each a pass over the other
    colour, f and the active colour. Updates u2 IN PLACE and returns it;
    the plain version on the CPU. Its launches count in
    ``PER_SWEEP_LAUNCHES``."""
    if not _on_cuda(u2, f2, n):
        return u2.copy_(rb_smooth_split_fused_plain(u2, f2, h, n_iter, red_first))
    lib, stream, h2 = _lib(), _stream(), h * h
    for _ in range(n_iter):
        for c in _colors(red_first):
            _check(lib.mg_splitcolor_half_sweep(u2.data_ptr(), f2.data_ptr(), n, h2, c, stream),
                   "rb_smooth_split_fused_per_sweep")
            PER_SWEEP_LAUNCHES["rb_smooth_split_fused_per_sweep"] += 1
    return u2
