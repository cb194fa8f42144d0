"""The kernels of the i-sharded distributed solve, hand-written in CUDA for
Hopper, with their plain PyTorch versions.

Counterpart of ``multigrid_parallel_tpu.ops.pallas_sharded``: K1-K5 and R
on one rank's block of an i-sharded field. The JAX package has two forms
of each: ``*_ext`` takes an extended copy (L + 2 halo planes) and
``*_halo`` the local block plus two small halo buffers, stitched in the
kernel by DMA. Here both forms launch ONE kernel on a segmented block
(``ops/csrc/seg.cuh``): three pointers (left halo, body, right halo) read
as one field of rows [-kl, L + kr), so an ext tensor goes in as three
contiguous views of its buffer and a halo triple as it is, with no copy.
Wrapper (ext and halo forms), Pallas kernel it replaces in
multigrid_parallel_tpu/ops/pallas_sharded.py, and CUDA source in
ops/csrc/:

  K28 rb_smooth_ext / _halo                 :209 / :881   rb_smooth_seg.cu
  K29 rb_smooth_from_zero_ext / _halo       :231 / :902   rb_smooth_seg.cu
  K30 residual_restrict_ext / _halo         :495 / :964   residual_restrict_seg.cu
  K31 prolong_smooth_ext / _halo            :641 / :1078  prolong_smooth_seg.cu
  K32 residual_df_norm_ext / _halo          :365 / :922   residual_df_norm_seg.cu
  K33 residual_ext                          :250          residual.cu (2nd entry)

Geometry, as in the JAX package: the global i axis (n valid planes,
padded to n_dev * L) is sharded and j, k are not; fields are plain
(rows, n, n) tensors (no lane padding). ``gi0`` is the GLOBAL plane index
of the first halo row (rank * L - halo, negative on rank 0), a Python int
or a 0-d / 1-element int tensor. Interior masks and colours use global
indices (RED = global (i + j + k) odd); pad planes (global i >= n) are
never updated. A halo triple is (local, lh, rhc): ``lh`` the left
neighbour's last planes, ``rhc`` the right neighbour's first planes after
``tail`` local tail planes (the JAX ``_halo_parts`` composite; the tail is
read off the shape, so 0 is fine). Chain ends hold zeros. Each function
returns the rank's L owned planes (or its Lc coarse planes), which equal
the single-device kernel's rows of the whole field bit for bit.

``block_i`` is accepted and ignored: it is a VMEM tile, and VMEM planning
does not carry over; the JAX ``*_block_i`` planners are not ported.

Like the single-device wrappers (``ops.pallas3d``): a CPU tensor takes
the plain version, a CUDA tensor (float32, contiguous) the kernel, and
anything else raises; there is no fallback. The smoothing wrappers
update their ``u`` segment IN PLACE (body and halo buffers, which are
scratch afterwards) and return the body; the others return fresh tensors.
Each kernel launch adds one to ``LAUNCHES`` (K29's and K31's K28
half-sweeps count as theirs; K32's partials-and-sum pair counts once).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from multigrid_parallel_tpu_torch.ops import pallas3d as pk
from multigrid_parallel_tpu_torch.ops import stencils_3d as ops3
from multigrid_parallel_tpu_torch.ops.stencils_3d import BLACK, RED

KERNELS = (
    "rb_smooth_seg",            # K28
    "rb_smooth_from_zero_seg",  # K29
    "residual_restrict_seg",    # K30
    "prolong_smooth_seg",       # K31
    "residual_df_norm_seg",     # K32
    "residual_seg",             # K33
)
# kernel launches per kernel, since the last reset_launches()
LAUNCHES = dict.fromkeys(KERNELS, 0)


def reset_launches() -> None:
    for name in KERNELS:
        LAUNCHES[name] = 0


def halo_ok(L: int, bi: int, halo: int) -> bool:
    """The JAX halo kernels' eligibility (a block of bi planes, even, at
    least the halo; L == bi or L >= bi + halo). Kept for callers that
    plan as the JAX package does: the port's kernels take any L >= the
    halo."""
    return (bi > 0 and bi % 2 == 0 and L % 2 == 0 and bi >= halo
            and (L == bi or L >= bi + halo))


# ------------------------------------------------------------- segments


class _Seg(NamedTuple):
    """One field's rows [-kl, L + kr): lh (kl planes), body (L), rh (its
    planes from r_off on)."""

    lh: torch.Tensor
    body: torch.Tensor
    rh: torch.Tensor
    r_off: int

    def rows(self, kl: int, kr: int) -> torch.Tensor:
        """The plain (kl + L + kr, m, m) slab of rows [-kl, L + kr)."""
        return torch.cat([self.lh[self.lh.shape[0] - kl:], self.body,
                          self.rh[self.r_off:self.r_off + kr]])

    @property
    def kl(self) -> int:
        return self.lh.shape[0]


def _seg(x3, kl: int, kr: int, L: int, composite: bool = True) -> _Seg:
    """A (local, lh, rhc) triple as a segment with at least kl / kr halo
    planes; ``composite``: rhc may start with local tail planes (the JAX
    rule), which are skipped; else rhc is the plain halo."""
    local, lh, rh = x3
    if local.shape[0] != L:
        raise ValueError(f"expected L = {L} local planes, got {local.shape[0]}")
    r_off = rh.shape[0] - kr if composite else 0
    if lh.shape[0] < kl or r_off < 0 or rh.shape[0] - r_off < kr:
        raise ValueError(f"halo buffers of {lh.shape[0]} / {rh.shape[0]} planes do not hold "
                         f"a {kl} / {kr} plane halo")
    return _Seg(lh[lh.shape[0] - kl:], local, rh, r_off)  # lh: exactly its last kl planes


def _ext_parts(x, k: int, L: int):
    """An ext tensor (L + 2k rows) as its (local, lh, rh) views (no copy)."""
    if x.shape[0] != L + 2 * k:
        raise ValueError(f"expected {L + 2 * k} ext planes (L = {L}, halo {k}), "
                         f"got {x.shape[0]}")
    return x[k:k + L], x[:k], x[k + L:]


def _gi0_int(gi0) -> int:
    if isinstance(gi0, torch.Tensor):
        return int(gi0.reshape(-1)[0].item())
    return int(np.asarray(gi0).reshape(-1)[0])


def _on_cuda(*groups) -> bool:
    """groups: (tensors, m): each tensor (rows, m, m). False on the CPU
    (plain path); True for float32 contiguous CUDA tensors on one device;
    raises for anything else."""
    tensors = [t for ts, _ in groups for t in ts]
    dev = tensors[0].device
    if any(t.device != dev for t in tensors):
        raise ValueError(f"tensors on different devices: {[t.device for t in tensors]}")
    if dev.type == "cpu":
        return False
    if dev.type != "cuda":
        raise ValueError(f"no kernel for device {dev}")
    for ts, m in groups:
        for t in ts:
            if t.dtype != torch.float32:
                raise TypeError(f"CUDA kernels take float32, got {t.dtype}")
            if t.dim() != 3 or tuple(t.shape[1:]) != (m, m) or m < 3:
                raise ValueError(f"expected (rows, {m}, {m}) planes, got {tuple(t.shape)}")
            if not t.is_contiguous():
                raise ValueError("CUDA kernels take contiguous tensors")
            if t.numel() >= 2 ** 31:
                raise ValueError("a segment overflows the kernels' int32 point index")
    return True


def _segs_on_cuda(n: int, *segs: _Seg, coarse: _Seg = None) -> bool:
    groups = [([t for s in segs for t in (s.lh, s.body, s.rh)], n)]
    if coarse is not None:
        groups.append(([coarse.lh, coarse.body, coarse.rh], (n + 1) // 2))
    return _on_cuda(*groups)


def _ptrs(s: _Seg):
    return s.lh.data_ptr(), s.body.data_ptr(), s.rh.data_ptr(), s.r_off


# ------------------------------------------------- plain slab arithmetic


def _slab_masks(g_first: int, rows: int, n: int, device):
    """(interior, parity) of a slab of ``rows`` planes whose first is
    global plane g_first: interior on global indices, parity (g + j + k)
    mod 2 (non-negative for negative g)."""
    g = torch.arange(rows, device=device) + g_first
    idx = torch.arange(n, device=device)
    inner = (idx >= 1) & (idx <= n - 2)
    inner_g = (g >= 1) & (g <= n - 2)
    interior = inner_g[:, None, None] & inner[None, :, None] & inner[None, None, :]
    parity = (g[:, None, None] + idx[None, :, None] + idx[None, None, :]) % 2
    return interior, parity


def _rb_stage_slab(u, f, g_first: int, h: float, n_iter: int, n: int, red_first: bool):
    """n_iter RB iterations on a slab (ops3's half-sweep arithmetic); its
    first and last planes, which lack a neighbour, are never updated."""
    interior, parity = _slab_masks(g_first, u.shape[0], n, u.device)
    interior[0] = False
    interior[-1] = False
    red, black = interior & (parity == RED), interior & (parity == BLACK)
    first, second = (red, black) if red_first else (black, red)
    for _ in range(n_iter):
        u = ops3._half_sweep(u, f, h, first)
        u = ops3._half_sweep(u, f, h, second)
    return u


# ------------------------------------------------------- K28: RB stage


def rb_smooth_halo_plain(u3, f3, gi0, h: float, n_iter: int, n: int, L: int,
                         red_first: bool = True):
    """Plain version of K28: the stage on the slab of rows [-H, L + H),
    H = 2 n_iter; returns the L owned planes (u3 untouched)."""
    hh = 2 * n_iter
    u, f = _seg(u3, hh, hh, L), _seg(f3, hh, hh, L)
    out = _rb_stage_slab(u.rows(hh, hh), f.rows(hh, hh), _gi0_int(gi0), h, n_iter, n,
                         red_first)
    return out[hh:hh + L]


def rb_smooth_halo(u3, f3, gi0, h: float, n_iter: int, n: int, L: int,
                   red_first: bool = True, block_i: int = 8):
    """All 2 * n_iter RB half-sweeps of a smoothing stage on a rank's
    block from (local, lh, rhc) triples with a 2 * n_iter plane halo. The
    CUDA form is 2 * n_iter K28 launches in place on u3; returns u3's
    local block (updated in place on both devices)."""
    del block_i
    hh = 2 * n_iter
    u, f = _seg(u3, hh, hh, L), _seg(f3, hh, hh, L)
    if not _segs_on_cuda(n, u, f):
        return u.body.copy_(rb_smooth_halo_plain(u3, f3, gi0, h, n_iter, n, L, red_first))
    lib, stream, g0 = pk._lib(), pk._stream(), _gi0_int(gi0) + hh
    for _ in range(n_iter):
        for c in pk._colors(red_first):
            pk._check(lib.mg_seg_half_sweep(*_ptrs(u), *_ptrs(f), hh, L, hh, n, g0, h * h, c,
                                         stream), "rb_smooth_halo")
            LAUNCHES["rb_smooth_seg"] += 1
    return u.body


def rb_smooth_ext(u_ext, f_ext, gi0, h: float, n_iter: int, n: int, L: int,
                  red_first: bool = True, block_i: int = 8):
    """rb_smooth_halo on ext tensors (L + 4 n_iter planes): the same
    launches on their views; returns the L owned planes, a view of u_ext
    (updated in place; its halo planes are scratch afterwards)."""
    hh = 2 * n_iter
    return rb_smooth_halo(_ext_parts(u_ext, hh, L), _ext_parts(f_ext, hh, L), gi0, h,
                          n_iter, n, L, red_first, block_i)


# ------------------------------------------- K29: RB stage from zero


def rb_smooth_from_zero_halo_plain(f3, gi0, h: float, n_iter: int, n: int, L: int,
                                   red_first: bool = True):
    """Plain version of K29: the K28 plain stage from a zero slab."""
    hh = 2 * n_iter
    f = _seg(f3, hh, hh, L).rows(hh, hh)
    out = _rb_stage_slab(torch.zeros_like(f), f, _gi0_int(gi0), h, n_iter, n, red_first)
    return out[hh:hh + L]


def rb_smooth_from_zero_halo(f3, gi0, h: float, n_iter: int, n: int, L: int,
                             red_first: bool = True, block_i: int = 8):
    """rb_smooth_halo from an implicit zero initial guess: a fresh (L, n,
    n) block. The CUDA form's first launch reads only f and writes the
    body and two H-plane scratch buffers; then 2 n_iter - 1 K28 launches,
    all counted as K29's."""
    del block_i
    hh = 2 * n_iter
    f = _seg(f3, hh, hh, L)
    if not _segs_on_cuda(n, f):
        return rb_smooth_from_zero_halo_plain(f3, gi0, h, n_iter, n, L, red_first)
    lib, stream, g0 = pk._lib(), pk._stream(), _gi0_int(gi0) + hh
    out = _Seg(f.body.new_empty((hh, n, n)), torch.empty_like(f.body),
               f.body.new_empty((hh, n, n)), 0)
    first, second = pk._colors(red_first)
    pk._check(lib.mg_seg_half_sweep_from_zero(*_ptrs(out)[:3], *_ptrs(f), hh, L, hh, n, g0,
                                           h * h, first, stream), "rb_smooth_from_zero_halo")
    LAUNCHES["rb_smooth_from_zero_seg"] += 1
    for c in [second] + list(pk._colors(red_first)) * (n_iter - 1):
        pk._check(lib.mg_seg_half_sweep(*_ptrs(out), *_ptrs(f), hh, L, hh, n, g0, h * h, c,
                                     stream), "rb_smooth_from_zero_halo")
        LAUNCHES["rb_smooth_from_zero_seg"] += 1
    return out.body


def rb_smooth_from_zero_ext(f_ext, gi0, h: float, n_iter: int, n: int, L: int,
                            red_first: bool = True, block_i: int = 8):
    """rb_smooth_from_zero_halo on an ext tensor (L + 4 n_iter planes)."""
    return rb_smooth_from_zero_halo(_ext_parts(f_ext, 2 * n_iter, L), gi0, h, n_iter, n, L,
                                    red_first, block_i)


# -------------------------------------------------------- K33: residual


def residual_ext_plain(u_ext, f_ext, gi0, h: float, n: int, L: int):
    """Plain version of K33: R's arithmetic on the owned rows."""
    f_body = _ext_parts(f_ext, 1, L)[0]
    interior, _ = _slab_masks(_gi0_int(gi0) + 1, L, n, f_body.device)
    nb = ops3.neighbor_sum(u_ext)[1:-1]
    r = f_body - (1.0 / (h * h)) * (nb - 6.0 * u_ext[1:-1])
    return torch.where(interior, r, torch.zeros_like(r))


def residual_ext(u_ext, f_ext, gi0, h: float, n: int, L: int, block_i: int = 8):
    """Interior residual on a rank's block from ext tensors with a 1-plane
    halo (L + 2 planes): a fresh (L, n, n) tensor, zero off the global
    interior. One K33 launch on the card."""
    del block_i
    u = _seg(_ext_parts(u_ext, 1, L), 1, 1, L)
    f_body = _ext_parts(f_ext, 1, L)[0]
    if not _on_cuda(([u.lh, u.body, u.rh, f_body], n)):
        return residual_ext_plain(u_ext, f_ext, gi0, h, n, L)
    r = torch.empty_like(f_body)
    pk._check(pk._lib().mg_seg_residual(r.data_ptr(), *_ptrs(u), f_body.data_ptr(), L, n,
                                     _gi0_int(gi0) + 1, 1.0 / (h * h), pk._stream()),
           "residual_ext")
    LAUNCHES["residual_seg"] += 1
    return r


# ---------------------------------- K32: df residual + partial norm


def residual_df_norm_halo_plain(uhi3, ulo3, fhi3, flo3, gi0, h: float, n: int, L: int):
    """Plain version of K32: K5's EFT residual on the owned rows (i
    neighbours from the 1-plane halos) and its partial ||r||^2, summed in
    f64 and returned in r's dtype."""
    uh = _seg(uhi3, 1, 1, L).rows(1, 1)
    ul = _seg(ulo3, 1, 1, L).rows(1, 1)

    def nbrs(ext):
        body = ext[1:-1]
        return [ext[:-2], ext[2:], torch.roll(body, 1, 1), torch.roll(body, -1, 1),
                torch.roll(body, 1, 2), torch.roll(body, -1, 2)]

    r = pk._eft_residual(fhi3[0], flo3[0], uh[1:-1], nbrs(uh), ul[1:-1], nbrs(ul),
                         1.0 / (h * h))
    interior, _ = _slab_masks(_gi0_int(gi0) + 1, L, n, r.device)
    r = torch.where(interior, r, torch.zeros_like(r))
    r64 = r.to(torch.float64)
    return r, torch.sum(r64 * r64).to(r.dtype)


def residual_df_norm_halo(uhi3, ulo3, fhi3, flo3, gi0, h: float, n: int, L: int,
                          block_i: int = 8):
    """(r_local (L, n, n), partial ||r||^2 0-d): the compensated residual
    of the double-float solution on a rank's block from triples with
    1-plane halos (f's halos are not read); the caller all-reduces the
    partial across the ranks. One K32 launch (partials, then their sum)."""
    del block_i
    uh, ul = _seg(uhi3, 1, 1, L), _seg(ulo3, 1, 1, L)
    fh, fl = fhi3[0], flo3[0]
    if not _on_cuda(([uh.lh, uh.body, uh.rh, ul.lh, ul.body, ul.rh, fh, fl], n)):
        return residual_df_norm_halo_plain(uhi3, ulo3, fhi3, flo3, gi0, h, n, L)
    lib = pk._lib()
    r = torch.empty_like(fh)
    nrm2 = torch.empty((), dtype=torch.float32, device=fh.device)
    partials = torch.empty(lib.mg_seg_residual_df_norm_partials(L, n), dtype=torch.float64,
                           device=fh.device)
    pk._check(lib.mg_seg_residual_df_norm(
        r.data_ptr(), nrm2.data_ptr(), partials.data_ptr(), *_ptrs(uh), *_ptrs(ul),
        fh.data_ptr(), fl.data_ptr(), L, n, _gi0_int(gi0) + 1, 1.0 / (h * h), pk._stream()),
        "residual_df_norm_halo")
    LAUNCHES["residual_df_norm_seg"] += 1
    return r, nrm2


def residual_df_norm_ext(uhi_ext, ulo_ext, fhi_ext, flo_ext, gi0, h: float, n: int, L: int,
                         block_i: int = 8):
    """residual_df_norm_halo on ext tensors with a 1-plane halo."""
    return residual_df_norm_halo(*(_ext_parts(x, 1, L)
                                   for x in (uhi_ext, ulo_ext, fhi_ext, flo_ext)),
                                 gi0, h, n, L, block_i)


# ------------------------------------- K30: residual + restriction


def _rr_segs(u3, f3, L: int, composite: bool):
    kr = u3[2].shape[0] if not composite else 2
    return _seg(u3, 2, kr, L, composite), _seg(f3, 2, kr, L, composite), kr


def residual_restrict_halo_plain(u3, f3, gi0, h: float, n: int, Lc: int):
    """Plain version of K30: R on fine rows [-1, L - 1] (its halo rows from
    the segments), then K3's plain 3-tap order: i, then j, then k; zero
    off the global coarse interior."""
    L = 2 * Lc
    e, f, _ = _rr_segs(u3, f3, L, composite=False)
    g_first = _gi0_int(gi0)                      # global of slab row 0 (local -2)
    e_s, f_s = e.rows(2, 1), f.rows(2, 1)        # rows [-2, L]
    interior, _ = _slab_masks(g_first, L + 3, n, e_s.device)
    res = f_s - (1.0 / (h * h)) * (ops3.neighbor_sum(e_s) - 6.0 * e_s)
    res = torch.where(interior, res, torch.zeros_like(res))
    t = pk._tap3(res[1:2 * Lc:2], res[2:2 * Lc + 1:2], res[3:2 * Lc + 2:2])  # i
    for axis in (1, 2):
        t = pk._restrict_axis(t, axis)
    nc = (n + 1) // 2
    out = torch.zeros((Lc, nc, nc), dtype=t.dtype, device=t.device)
    out[:, 1:-1, 1:-1] = t
    cg = torch.arange(Lc, device=t.device) + (g_first + 2) // 2
    keep = ((cg >= 1) & (cg <= nc - 2))[:, None, None]
    return torch.where(keep, out, torch.zeros_like(out))


def residual_restrict_halo(u3, f3, gi0, h: float, n: int, Lc: int, block_i: int = 8):
    """Fused residual + full-weighting restriction on a rank's block:
    (local, lh, rh) triples, lh 2 planes, rh a PLAIN right halo (>= 1
    plane, no composite tail, as the JAX kernel takes it); gi0 = rank * L
    - 2. Returns the rank's (Lc, nc, nc) coarse planes, Lc = L / 2. One K30
    launch on the card."""
    del block_i
    L = 2 * Lc
    e, f, kr = _rr_segs(u3, f3, L, composite=False)
    if kr < 1:
        raise ValueError("the restriction needs a right halo of at least 1 plane")
    if not _segs_on_cuda(n, e, f):
        return residual_restrict_halo_plain(u3, f3, gi0, h, n, Lc)
    nc = (n + 1) // 2
    out = e.body.new_empty((Lc, nc, nc))
    pk._check(pk._lib().mg_seg_residual_restrict(
        out.data_ptr(), *_ptrs(e), *_ptrs(f), 2, L, kr, n, _gi0_int(gi0) + 2, 1.0 / (h * h),
        pk._stream()), "residual_restrict_halo")
    LAUNCHES["residual_restrict_seg"] += 1
    return out


def residual_restrict_ext(u_ext, f_ext, gi0, h: float, n: int, Lc: int, block_i: int = 8):
    """residual_restrict_halo on ext tensors with a 2-plane fine halo
    (2 Lc + 4 planes)."""
    L = 2 * Lc
    return residual_restrict_halo(_ext_parts(u_ext, 2, L), _ext_parts(f_ext, 2, L), gi0, h,
                                  n, Lc, block_i)


# ------------------------- K31: prolongation + correction + RB stage


def _ps_segs(ec3, e3, r3, n_iter: int, L: int, kl_c: int):
    hh = 2 * n_iter
    c = _seg(ec3, kl_c, n_iter + 1, L // 2)
    return c, _seg(e3, hh, hh, L), _seg(r3, hh, hh, L)


def prolong_smooth_halo_plain(ec3, e3, r3, gi0, h: float, n_iter: int, n: int, L: int):
    """Plain version of K31: e + trilinear interpolation of ec (j, then
    k, then i, as K4's plain version) on fine rows [-H, L + H), then the
    black-first K28 plain stage; returns the L owned planes."""
    hh = 2 * n_iter
    c, e, r = _ps_segs(ec3, e3, r3, n_iter, L, n_iter)
    t = c.rows(n_iter, n_iter + 1)           # coarse rows [-n_iter, Lc + n_iter]
    for axis in (1, 2, 0):
        t = pk._interp_axis(t, axis)         # fine rows [-H, L + H]
    u = e.rows(hh, hh) + t[:L + 2 * hh]
    out = _rb_stage_slab(u, r.rows(hh, hh), _gi0_int(gi0), h, n_iter, n, red_first=False)
    return out[hh:hh + L]


def prolong_smooth_halo(ec3, e3, r3, gi0, h: float, n_iter: int, n: int, L: int,
                        block_i: int = 8):
    """post_smooth(e + trilinear(ec), r) on a rank's block: fine triples
    with H = 2 n_iter halos (composite tails read off the shapes), the
    coarse triple with n_iter planes left and n_iter + 1 right (after its
    composite tail); gi0 = rank * L - H. A fresh (L, n, n) block (e is
    left as it is). The CUDA form is one K31 launch (correction + first
    black half-sweep into a fresh segment) and 2 n_iter - 1 K28 launches,
    all counted as K31's."""
    del block_i
    return _prolong_smooth(ec3, e3, r3, gi0, h, n_iter, n, L, n_iter)


def _prolong_smooth(ec3, e3, r3, gi0, h, n_iter, n, L, kl_c):
    if n_iter < 1:
        raise ValueError(f"n_iter must be >= 1, got {n_iter}")
    hh = 2 * n_iter
    c, e, r = _ps_segs(ec3, e3, r3, n_iter, L, kl_c)
    if not _segs_on_cuda(n, e, r, coarse=c):
        # the plain slab reads the coarse rows [-n_iter, Lc + n_iter]
        return prolong_smooth_halo_plain((c.body, c.lh[c.kl - n_iter:], c.rh[c.r_off:]),
                                         e3, r3, gi0, h, n_iter, n, L)
    lib, stream, g0 = pk._lib(), pk._stream(), _gi0_int(gi0) + hh
    out = _Seg(e.body.new_empty((hh, n, n)), torch.empty_like(e.body),
               e.body.new_empty((hh, n, n)), 0)
    pk._check(lib.mg_seg_prolong_correct_black(
        *_ptrs(out)[:3], *_ptrs(c), c.kl, c.rh.shape[0] - c.r_off, *_ptrs(e),
        *_ptrs(r), hh, L, n, g0, h * h, stream), "prolong_smooth_halo")
    LAUNCHES["prolong_smooth_seg"] += 1
    for color in [RED] + [BLACK, RED] * (n_iter - 1):
        pk._check(lib.mg_seg_half_sweep(*_ptrs(out), *_ptrs(r), hh, L, hh, n, g0, h * h, color,
                                     stream), "prolong_smooth_halo")
        LAUNCHES["prolong_smooth_seg"] += 1
    return out.body


def prolong_smooth_ext(ec_ext, e_ext, r_ext, gi0, h: float, n_iter: int, n: int, L: int,
                       block_i: int = 8):
    """prolong_smooth_halo on ext tensors: e_ext, r_ext with a 2 n_iter
    fine halo, ec_ext with an n_iter + 1 coarse halo on both sides."""
    del block_i
    hh, kc = 2 * n_iter, n_iter + 1
    return _prolong_smooth(_ext_parts(ec_ext, kc, L // 2), _ext_parts(e_ext, hh, L),
                           _ext_parts(r_ext, hh, L), gi0, h, n_iter, n, L, kc)
