"""The split-colour kernels of the finest level of the double-float
Poisson solve, hand-written in CUDA for Hopper, with their plain PyTorch
versions, the pair layout and its pack / unpack.

Counterpart of ``multigrid_parallel_tpu.ops.pallas_split``. Wrapper, the
Pallas kernel it replaces in multigrid_parallel_tpu/ops/pallas_split.py,
and its CUDA source in ops/csrc/ (all share split.cuh):

  K7  rb_smooth_split            rb_smooth_split              rb_smooth_split.cu
  K8  rb_smooth_split_from_zero  rb_smooth_split_from_zero    rb_smooth_split.cu
  K9  residual_restrict_split    residual_restrict_split      residual_restrict_split.cu, restrict.cuh
  K10 prolong_smooth_split       prolong_smooth_split         prolong_smooth_split.cu
  K11 df_step_split              df_step_split                df_split.cu
  K12 residual_df_norm_split     residual_df_norm_split       df_split.cu

The layout. A field is a (red, black) PAIR of contiguous tensors of shape
``split_shape(n) = (n, n, (n - 1) // 2)``: slot kk of a colour in row
(i, j) holds the fine point k = 2 kk + 1 + p, with p = (i + j) mod 2 for
red and 1 - that for black (RED = (i + j + k) odd). The (n - 1) // 2 slots
are exactly the interior odd (or even) k's of a row, so only the k = 0 and
k = n - 1 faces go unstored (zero for corrections; folded into the RHS for
the solution, ``cycles_split.setup_split_df_problem``), and the colour that
holds a row's even k's has its last slot dead. The TPU's pair is
(n, rup(n, 8), rup((n - 1) // 2, 128)); its sublane and lane padding has
no counterpart here.

Invariant, as on the TPU: slots that hold no interior point (the dead
slot of every row and, for corrections, the i / j boundary rows) are
exactly 0. ``pack_split`` makes it so, the half-sweeps and residuals
write only live interior slots (or 0), and the prolongation adds its
correction there only. The k-neighbour reads at the first and last
interior k rely on it.

A colour's i +- 1 and j +- 1 neighbours are the other colour at the same
slot; its two k-neighbours are the other colour at {kk - 1, kk} on rows
where its k's are odd and {kk, kk + 1} elsewhere. Neighbour sums follow
the Pallas split order, i - 1, i + 1, j - 1, j + 1, the shared slot kk,
then the row's other one, which is not the rect kernels' order: a split
kernel agrees with its rect twin to a few ulp, and with its own plain
version bit for bit.

A wrapper takes the plain version for tensors on the CPU, launches its
kernel for CUDA tensors (float32, contiguous, in the split shape; the
coarse field of K9 / K10 (nc, nc, nc), nc = (n + 1) / 2), and raises for
anything else: no fallback from the kernel to the plain version. Each
kernel launch adds one to its entry in ``LAUNCHES`` (the launch of K11 or
K12 is the pair of per-block partials and their sum; the K7 stage
launches that K8 and K10 run past n_iter = 2 count as theirs).

K7, K8 and K10 are one-pass stage kernels: one launch runs all 2 n_iter
<= 4 half-sweeps of a stage on tiles in shared memory (``_stage_plan``
cuts the level into blocks) and writes a fresh pair; K8's tile starts as
zeros. K9 is the streaming restriction stage that K3 shares
(restrict.cuh; the plan ``_restrict_plan``): one launch a call, each fine
residual computed once.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from multigrid_parallel_tpu_torch.ops import pallas3d as pk
from multigrid_parallel_tpu_torch.ops.pallas3d import _check, _colors, _lib, _stream
from multigrid_parallel_tpu_torch.ops.stencils_3d import BLACK, RED

KERNELS = (
    "rb_smooth_split",
    "rb_smooth_split_from_zero",
    "residual_restrict_split",
    "prolong_smooth_split",
    "df_step_split",
    "residual_df_norm_split",
)
# kernel launches per wrapper, since the last reset_launches()
LAUNCHES = dict.fromkeys(KERNELS, 0)


def reset_launches() -> None:
    for name in KERNELS:
        LAUNCHES[name] = 0
    PER_SWEEP_LAUNCHES["rb_smooth_split_per_sweep"] = 0


def split_shape(n: int):
    """(n, n, (n - 1) // 2): one colour's tensor shape."""
    return (n, n, (n - 1) // 2)


# ------------------------------------------------------------ layout


def _slot_k(n: int, device):
    """(k_red, k_black): the fine k that each slot holds, (n, n, S)."""
    idx = torch.arange(n, device=device)
    q = (idx[:, None, None] + idx[None, :, None]) % 2
    kk = torch.arange((n - 1) // 2, device=device)[None, None, :]
    return 2 * kk + 1 + q, 2 * kk + 2 - q


def _masks(n: int, device):
    """(red_odd, live_r, live_b): the rows whose red k's are odd ((i + j)
    even; there the red k-neighbours are black {kk - 1, kk} and the black
    ones red {kk, kk + 1}), (n, n, 1); and each colour's live interior
    slots, (n, n, S): the points a half-sweep updates."""
    idx = torch.arange(n, device=device)
    inner = (idx >= 1) & (idx <= n - 2)
    rows = inner[:, None, None] & inner[None, :, None]
    red_odd = (idx[:, None, None] + idx[None, :, None]) % 2 == 0
    k_r, k_b = _slot_k(n, device)
    return red_odd, rows & (k_r <= n - 2), rows & (k_b <= n - 2)


def pack_split(x: torch.Tensor):
    """(n, n, n) cube -> (red, black) pair: slot kk of a colour takes
    x[i, j, 2 kk + 1 + p]; the dead slots are 0 and the k = 0 and n - 1
    faces are dropped. Torch indexing, for setup and tests only: the cycle
    never converts layouts."""
    n = x.shape[0]
    if tuple(x.shape) != (n, n, n):
        raise ValueError(f"expected an (n, n, n) cube, got {tuple(x.shape)}")
    out = []
    for k in _slot_k(n, x.device):
        k = k.expand(split_shape(n))  # k <= n - 1
        vals = torch.gather(x, 2, k)
        out.append(torch.where(k <= n - 2, vals, torch.zeros_like(vals)))
    return out[0], out[1]


def unpack_split(xr: torch.Tensor, xb: torch.Tensor) -> torch.Tensor:
    """(red, black) pair -> (n, n, n) cube with zero k = 0 and k = n - 1
    faces (the dead slots are dropped)."""
    n = xr.shape[0]
    out = torch.zeros((n, n, n), dtype=xr.dtype, device=xr.device)
    for x, k in zip((xr, xb), _slot_k(n, xr.device)):
        k = k.expand(split_shape(n))  # a dead slot's k is n - 1: it scatters 0 there
        out.scatter_(2, k, torch.where(k <= n - 2, x, torch.zeros_like(x)))
    return out


def _on_cuda(*fields: torch.Tensor, coarse: torch.Tensor = None) -> bool:
    """False for CPU tensors (plain path); True for CUDA tensors that the
    kernels take; raises for anything else. ``fields`` are one level's
    split tensors, ``split_shape(n)`` with n odd; ``coarse``, if given, is
    a rect field of the next coarser level, (nc, nc, nc), nc = (n + 1) / 2."""
    n = fields[0].shape[0]
    if n < 3 or n % 2 == 0:
        raise ValueError(f"a split level has an odd size n >= 3, got n = {n}")
    want = [(x, split_shape(n)) for x in fields]
    if coarse is not None:
        want.append((coarse, ((n + 1) // 2,) * 3))
    for x, shape in want:
        if tuple(x.shape) != shape:
            raise ValueError(f"expected shape {shape}, got {tuple(x.shape)}")
    tensors = [x for x, _ in want]
    dev, dtype = tensors[0].device, tensors[0].dtype
    if any(x.device != dev for x in tensors):
        raise ValueError(f"fields on different devices: {[x.device for x in tensors]}")
    if any(x.dtype != dtype for x in tensors) or not dtype.is_floating_point:
        raise TypeError(f"fields of one floating dtype expected, got {[x.dtype for x in tensors]}")
    if dev.type == "cpu":
        return False
    if dev.type != "cuda":
        raise ValueError(f"no kernel for device {dev}")
    if dtype != torch.float32:
        raise TypeError(f"CUDA kernels take float32, got {dtype}")
    if not all(x.is_contiguous() for x in tensors):
        raise ValueError("CUDA kernels take contiguous fields")
    if n * n * split_shape(n)[2] >= 2 ** 31:
        raise ValueError(f"n = {n} overflows the kernels' int32 slot index")
    return True


# ---------------------------------------------------- split neighbours


def _nbrs(src: torch.Tensor, lower: torch.Tensor):
    """The six neighbours, in the Pallas split order, of every slot of the
    colour whose k-neighbours are {kk - 1, kk} on rows ``lower`` and
    {kk, kk + 1} elsewhere, read from the other colour ``src``; zero past
    either end of a row. Wrapped i / j rolls land on boundary rows only."""
    zero = torch.zeros_like(src[:, :, :1])
    below = torch.cat([zero, src[:, :, :-1]], dim=2)
    above = torch.cat([src[:, :, 1:], zero], dim=2)
    return [
        torch.roll(src, 1, 0), torch.roll(src, -1, 0),
        torch.roll(src, 1, 1), torch.roll(src, -1, 1),
        src, torch.where(lower, below, above),
    ]


def _nbr_sum(src, lower):
    terms = _nbrs(src, lower)
    s = terms[0]
    for t in terms[1:]:
        s = s + t
    return s


def _half_sweep(dst, src, f, h: float, lower, live):
    """One colour's RB-GS half-sweep: (nbr_sum - h^2 f) * (1/6) on its
    live interior slots."""
    upd = (_nbr_sum(src, lower) - (h * h) * f) * (1.0 / 6.0)
    return torch.where(live, upd, dst)


# ---------------------------------------------------------- K7 / K8: RB-GS


def rb_smooth_split_plain(er, eb, fr, fb, h: float, n_iter: int, red_first: bool = True):
    """Plain version of K7: returns the smoothed pair (er, eb untouched)."""
    red_odd, live_r, live_b = _masks(er.shape[0], er.device)
    for _ in range(n_iter):
        for c in _colors(red_first):
            if c == RED:
                er = _half_sweep(er, eb, fr, h, red_odd, live_r)
            else:
                eb = _half_sweep(eb, er, fb, h, ~red_odd, live_b)
    return er, eb


def rb_smooth_split_from_zero_plain(fr, fb, h: float, n_iter: int, red_first: bool = True):
    """Plain version of K8: K7 from a zero initial pair."""
    return rb_smooth_split_plain(torch.zeros_like(fr), torch.zeros_like(fb), fr, fb, h,
                                 n_iter, red_first)


# ------------------------------------- the one-pass stage (K7, K8, K10)

SMEM_MAX = 232_448   # shared memory a Hopper block may take (opt-in), bytes
SM_SMEM = 233_472    # an SM's shared memory; each block also reserves 1,024 B
STAGE_MIN_PLANES = 16  # planes a block owns at least (its i halo is 2 n_iter a side)
STAGE_K_HALO = 4       # slots a k tile reads past its own on each side (>= 2 n_iter)
STAGE_MAX_THREADS = 640  # the stage kernels' launch bound (split.cuh, kStageMaxThreads)
RECT_ROW_PAD = 4         # tile columns before slot 0 of a whole rect row (rect.cuh, kRowPad)
RECT_BOX_MAX_N = 129     # rect levels up to this size take the box schedule (rect.cuh, box_body)
RECT_MAX_THREADS = 576   # the rect stage kernels' launch bound (rect.cuh, kStageMaxThreads)
RECT_REGISTERS = 112     # registers a thread of theirs may take under it (65,536 an SM)
SEG_MAX_THREADS = 512    # K31's, K35's, K36's and K40's launch bound (rect.cuh, kSegStageMaxThreads)
SEG_REGISTERS = 128      # registers a thread of theirs may take under it
MSPLIT_STEPS_MAX_N = 65  # msplit levels up to this size take the fewest-steps plan (_steps_plan)


class StagePlan(NamedTuple):
    """How one launch of a stage kernel (split.cuh or rect.cuh, stage_body)
    cuts a split level (or, ``rect``, a plain one, its rows held as two
    colours of n // 2 slots): blocks own boxes of ``bi`` planes x ``bj``
    rows x ``bk`` slots of both colours, tiles numbered k fastest, then j,
    then i, and read ``halo`` = 2 n_iter planes and rows (K26's: 2 n_iter
    + 1) and ``k_halo`` slots (0 when a block holds whole rows) past their
    box on each side,
    clipped to the field. ``smem`` is the bytes of shared memory a block
    takes: a ring of tile planes for each colour (``_stage_smem``), or,
    ``box``, all bi + 2 halo planes of its loaded box (rect.cuh, box_body:
    the half-sweeps one after another, not as a wavefront)."""
    n: int
    n_iter: int
    halo: int
    k_halo: int
    bi: int
    bj: int
    bk: int
    threads: int
    smem: int
    rect: bool = False
    box: bool = False
    planes: int = None  # a segment stage's planes (_stage_plan's seg_planes), else n
    cols: int = None    # an (i, j) segment stage's rows j (_stage_plan's seg_cols), else n

    @property
    def tiles(self):
        """(planes, rows, slots): the number of boxes along each axis."""
        s = _slots(self.n, self.rect)
        return (-(-(self.planes or self.n) // self.bi), -(-(self.cols or self.n) // self.bj),
                -(-s // self.bk))

    @property
    def blocks(self) -> int:
        ni, nj, nk = self.tiles
        return ni * nj * nk


def _stage_smem(n_iter: int, bj: int, width: int, prolong: bool = False,
                rect: bool = False, box_bi: int = 0, resid: bool = False) -> int:
    """Shared-memory bytes of a block of bj rows of ``width`` slots: for
    each colour a ring of 2 H + 3 tile planes of bj + 2 H rows, H = 2 n_iter
    (split.cuh, stage_depth), or, for a box of ``box_bi`` planes, its bi +
    2 H planes; K10 (``prolong``) adds a ring of 3 coarse planes of (bj +
    2 H) / 2 + 2 rows of width + 1 values (prolong_smooth_split.cu), K4
    (``prolong`` and ``rect``) of width + 4, the box's (bi + 2 H) / 2 + 2
    planes of them (prolong_smooth.cu). K26 (``resid``, rect) has halos of
    H + 1 (bj + 2 H + 2 rows, a box's bi + 2 H + 2 planes) and rings of 2 H
    + 5 planes (rect.cuh, RESID). The launchers compute the same bytes
    (split.cuh and rect.cuh, stage_smem_bytes; coarse_rows, coarse_width
    and coarse_planes) and reject a plan that differs: a change to a ring
    is made in both."""
    halo = 2 * n_iter + resid
    planes, coarse = ((box_bi + 2 * halo, (box_bi + 2 * halo) // 2 + 2) if box_bi
                      else (4 * n_iter + 3 + 2 * resid, 3))
    coarse_width = width + (4 if rect else 1)
    extra = coarse * ((bj + 2 * halo) // 2 + 2) * coarse_width * 4 if prolong else 0
    return 2 * planes * (bj + 2 * halo) * width * 4 + extra


def _stage_width(n: int, bk: int, k_halo: int, rect: bool = False) -> int:
    """Slots of a tile row: a k tile with its halos, or a whole row (of a
    rect level, its slots rounded up to 4 and 4 more before slot 0, the
    last of which holds k = 0: rect.cuh, tile_width)."""
    if k_halo:
        return bk + 2 * k_halo
    s = _slots(n, rect)
    return -(-s // 4) * 4 + RECT_ROW_PAD if rect else s


def _row_lanes(swept: int) -> int:
    """Lanes a rect stage gives a tile row whose sweep spans ``swept``
    slots: the fewest, a power of 2 up to 32, that cover its 4-slot groups
    in one pass (rect.cuh, row_lanes); a warp sweeps 32 / that rows at
    once."""
    lanes = 1
    while lanes < 32 and 4 * lanes < swept:
        lanes *= 2
    return lanes


def _slots(n: int, rect: bool = False) -> int:
    """Slots of a colour in a row: (n - 1) // 2 on a split level, n // 2 on
    a rect one (where the colour holding the even k's also holds k = 0)."""
    return n // 2 if rect else split_shape(n)[2]


@functools.lru_cache(maxsize=None)
def _stage_plan(n: int, n_iter: int, sms: int, prolong: bool = False,
                rect: bool = False, msplit: bool = False, seg_planes: int = None,
                seg_cols: int = None, resid: bool = False) -> StagePlan:
    """The plan of one stage launch of n_iter (1 or 2) iterations on an n^3
    split level (``rect``: a plain level, K2's and K4's stage) for a card of
    ``sms`` SMs, within ``SMEM_MAX`` bytes of shared memory a block: a rect
    level up to ``RECT_BOX_MAX_N`` takes the box (``_box_plan``), every
    other the wavefront (``_wave_plan``). Over the
    k tilings (whole rows, or any count of tiles of a multiple of 4 slots
    with a ``STAGE_K_HALO`` halo) and the row counts that fit, the plan
    whose estimated time is least: the tile slots read per slot owned (rows
    and slots with their halos, planes with the wavefront's 6 n_iter),
    times the share of idle lanes (a warp sweeps a row, 4 slots a lane
    where rows are a multiple of 4 slots, else 1), times the blocks the
    busiest of ``sms`` SMs runs, over the blocks. i is cut into chunks of at
    least ``STAGE_MIN_PLANES`` planes, as many as fill one wave at the
    occupancy that the shared memory and threads allow (at most 2 blocks
    an SM). A warp a tile row, at most ``STAGE_MAX_THREADS`` threads. K10's
    and K4's plans (``prolong``) count their coarse ring. A rect plan's
    tile rows are 16-byte aligned whatever n is, its warps sweep 32 /
    ``_row_lanes`` rows at once, at most ``RECT_MAX_THREADS`` threads, and
    it tiles k only where whole rows fit fewer than 8 rows a block. The
    msplit stages (K22, K24: ``msplit``, the split layout) take K7's and
    K10's plans, and on a level up to ``MSPLIT_STEPS_MAX_N`` the
    fewest-steps plan (``_steps_plan``). ``seg_planes``: the plan of a
    segment stage (K31, K35, K36, K40) that tiles that many planes of the
    level (one rank's, the schedule still chosen by n), its ``tiles``
    counting them along i, within the kernels' ``SEG_MAX_THREADS``;
    ``seg_cols`` (K40, with ``seg_planes``): that many rows j too (an (i, j)
    rank's columns), its row tiles cut from them. ``resid`` (K26, with
    ``rect``): K1's stage that also writes the residual, its halos 2 n_iter
    + 1 (``halo``; a k tile's ``k_halo`` that rounded up to 4) and its
    rings two planes deeper (``_stage_smem``)."""
    if n_iter not in (1, 2):
        raise ValueError(f"a stage launch runs 1 or 2 iterations, got {n_iter}")
    if seg_planes is not None and (not rect or seg_planes < 1):
        raise ValueError(f"seg_planes = {seg_planes}: a rect plan of one plane or more")
    if seg_cols is not None and (seg_planes is None or seg_cols < 1):
        raise ValueError(f"seg_cols = {seg_cols}: a segment plan of one row or more")
    if resid and (not rect or prolong or seg_planes is not None):
        raise ValueError("resid: K26's plan, a rect stage on the whole level")
    if rect and n <= RECT_BOX_MAX_N:
        return _box_plan(n, n_iter, sms, prolong, seg_planes, seg_cols, resid)
    if msplit and n <= MSPLIT_STEPS_MAX_N:
        return _steps_plan(n, n_iter, sms, prolong)
    return _wave_plan(n, n_iter, sms, prolong, rect, seg_planes, seg_cols, resid)


def _steps_plan(n: int, n_iter: int, sms: int, prolong: bool) -> StagePlan:
    """``_stage_plan``'s plan for the msplit stages on a small split level:
    the wavefront on whole rows, bi planes x bj rows a block, the pair whose
    estimated time is least, fewer threads on a tie. A block takes bi + 3 H
    + 1 steps (H = 2 n_iter), each of two barriers however little it holds,
    its warps sweeping a tile row each (more where the rows outnumber
    ``STAGE_MAX_THREADS`` / 32), and blocks that share an SM share its
    time: the estimate is the steps, times the tile rows a warp sweeps,
    times the waves of blocks over ``sms`` SMs. On the small levels the
    steps, not the halos' reads that ``_wave_plan`` counts, set the time
    (``utils.stage_plans --msplit``: PERF.md)."""
    s, halo = split_shape(n)[2], 2 * n_iter
    best = None
    for bi in _evened(n):
        for bj in _evened(n):
            smem = _stage_smem(n_iter, bj, s, prolong)
            if smem > SMEM_MAX:
                continue
            rows = min(n, bj + 2 * halo)
            warps = min(STAGE_MAX_THREADS // 32, rows)
            blocks = -(-n // bi) * -(-n // bj)
            est = -(-blocks // sms) * (bi + 3 * halo + 1) * -(-rows // warps)
            if best is None or (est, warps) < best[0]:
                best = ((est, warps), StagePlan(n, n_iter, halo, 0, bi, bj, s, 32 * warps, smem))
    return best[1]


def _wave_plan(n: int, n_iter: int, sms: int, prolong: bool, rect: bool,
               seg_planes: int = None, seg_cols: int = None, resid: bool = False) -> StagePlan:
    """``_stage_plan``'s wavefront plan (every split level, rect levels
    past ``RECT_BOX_MAX_N``), or a segment stage's of ``seg_planes`` (and
    ``seg_cols`` rows), or K26's (``resid``)."""
    m, mj = seg_planes or n, seg_cols or n
    max_threads, registers = ((SEG_MAX_THREADS, SEG_REGISTERS) if seg_planes
                              else (RECT_MAX_THREADS, RECT_REGISTERS))
    s = _slots(n, rect)
    halo = 2 * n_iter + resid
    best = None
    for nk in range(1, max(1, s // 4) + 1):
        if nk == 1:
            bk, k_halo = s, 0
        elif rect and best is not None and best[1].bj >= 8:
            break  # rect: k tiles only where whole rows fit few rows a block
        else:
            bk = -(-(-(-s // nk)) // 4) * 4
            if bk >= s or -(-s // bk) != nk:
                continue
            k_halo = max(STAGE_K_HALO, -(-halo // 4) * 4)
            if bk < k_halo:  # a tile's halo reaches past the tile before it only
                continue
        width = _stage_width(n, bk, k_halo, rect)
        swept = width - RECT_ROW_PAD if rect and not k_halo else width  # slots a sweep spans
        lanes = _row_lanes(swept) if rect else 32  # a tile row's lanes (32 / lanes rows a warp)
        lane_slots = 4 * lanes if rect else 128 if s % 4 == 0 else 32  # slots a row's pass sweeps
        waste = -(-swept // lane_slots) * lane_slots / swept
        for bj in range(1, mj + 1):
            smem = _stage_smem(n_iter, bj, width, prolong, rect, resid=resid)
            if smem > SMEM_MAX:
                break
            nj = -(-mj // bj)
            if -(-mj // nj) != bj:  # only evened-out row tiles
                continue
            rows = min(n, bj + 2 * halo)
            nthreads = 32 * max(1, min((max_threads if rect else STAGE_MAX_THREADS) // 32,
                                       -(-rows * lanes // 32)))
            per_sm = min(2, SM_SMEM // (smem + 1024), 2048 // nthreads,
                         65536 // (nthreads * registers) if rect else 2)
            if per_sm < 1:
                break
            ni = max(1, min(-(-m // STAGE_MIN_PLANES), per_sm * sms // (nj * nk)))
            bi = -(-m // ni)
            ni = -(-m // bi)
            blocks = ni * nj * nk
            read = rows / bj * min(s, width) / bk * (bi + 2 * halo + 2 * n_iter) / bi
            est = read * waste * -(-blocks // sms) / blocks
            if best is None or est < best[0] * (1 - 1e-9):
                best = (est, StagePlan(n, n_iter, halo, k_halo, bi, bj, bk, nthreads, smem,
                                       rect, planes=seg_planes, cols=seg_cols))
    return best[1]


BOX_ROW_LATENCY = 10  # a warp's pass over its tile rows, in units of one tile row's work


def _box_plan(n: int, n_iter: int, sms: int, prolong: bool,
              seg_planes: int = None, seg_cols: int = None, resid: bool = False) -> StagePlan:
    """The box plan of a small rect level (rect.cuh, box_body): whole rows,
    bi planes x bj rows a block, the pair whose estimated time is least
    (more blocks on a tie), within ``SMEM_MAX``. A block of the field's
    middle makes a pass over its loaded tile rows, one over each
    half-sweep's region (the loaded box shrunk by s, clipped to the
    interior) and one to store, its warps sweeping 32 / lanes rows at once
    (``_row_lanes``): a pass takes the longer of its warps' chain
    (``BOX_ROW_LATENCY``) and the row work of the blocks that share an SM,
    in waves of the blocks the SMs hold at once. ``seg_planes``: a segment
    stage's plan of that many planes (and ``seg_cols`` rows); ``resid``:
    K26's, its halos one deeper."""
    s, halo, m, mj = _slots(n, True), 2 * n_iter + resid, seg_planes or n, seg_cols or n
    max_threads, registers = ((SEG_MAX_THREADS, SEG_REGISTERS) if seg_planes
                              else (RECT_MAX_THREADS, RECT_REGISTERS))
    width = _stage_width(n, s, 0, True)
    per_warp = 32 // _row_lanes(s)
    evened = _evened(mj)
    best = None
    for bi in _evened(m):
        for bj in evened:
            smem = _stage_smem(n_iter, bj, width, prolong, True, box_bi=bi, resid=resid)
            if smem > SMEM_MAX:
                continue
            loaded = min(n, bi + 2 * halo) * min(n, bj + 2 * halo)
            warps = max(1, min(max_threads // 32, -(-loaded // per_warp)))
            per_sm = min(16, SM_SMEM // (smem + 1024), 65536 // (32 * warps * registers))
            blocks = -(-m // bi) * -(-mj // bj)
            waves = -(-blocks // (per_sm * sms))
            sharing = min(per_sm, -(-blocks // sms))
            regions = [min(n - 2, bi + 2 * (halo - lvl)) * min(n - 2, bj + 2 * (halo - lvl))
                       for lvl in range(1, 2 * n_iter + 1)]
            passes = [loaded] + regions + [bi * bj]
            est = waves * sum(max(BOX_ROW_LATENCY * -(-rows // (warps * per_warp)),
                                  rows * sharing / per_warp) for rows in passes)
            if best is None or (est, -blocks) < best[0]:
                best = ((est, -blocks), StagePlan(n, n_iter, halo, 0, bi, bj, s, 32 * warps,
                                                  smem, True, True, seg_planes, seg_cols))
    return best[1]


@functools.lru_cache(maxsize=None)
def _sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _stage_chunks(n_iter: int):
    """The iterations of each one-pass launch of an n_iter stage: 2 each,
    and 1 last when n_iter is odd."""
    return [2] * (n_iter // 2) + [1] * (n_iter % 2)


@functools.lru_cache(maxsize=None)
def _plan_args_on(n: int, n_iter: int, index: int, prolong: bool, rect: bool, msplit: bool,
                  seg_planes: int, seg_cols: int = None, resid: bool = False):
    plan = _stage_plan(n, n_iter, _sms(index), prolong=prolong, rect=rect, msplit=msplit,
                       seg_planes=seg_planes, seg_cols=seg_cols, resid=resid)
    args = (n_iter, plan.bi, plan.bj, plan.bk, plan.k_halo, plan.threads, plan.smem)
    return args + (int(plan.box),) if rect else args


def _plan_args(n: int, n_iter: int, device, prolong: bool = False, rect: bool = False,
               msplit: bool = False, seg_planes: int = None, seg_cols: int = None,
               resid: bool = False):
    """The launcher's n_iter and plan arguments on ``device`` (the rect
    launchers' with the plan's box flag last; ``seg_planes``, ``seg_cols``,
    ``resid``: _stage_plan's)."""
    index = device.index if device.index is not None else torch.cuda.current_device()
    return _plan_args_on(n, n_iter, index, prolong, rect, msplit, seg_planes, seg_cols, resid)


def _stage_launch(lib, er, eb, fr, fb, h2, n_iter, red_first, stream, name):
    """One K7 stage launch (K8's, where er and eb are None: a zero initial
    pair) into a fresh pair, counted as ``name``'s."""
    n = fr.shape[0]
    out_r, out_b = torch.empty_like(fr), torch.empty_like(fb)
    plan = _plan_args(n, n_iter, fr.device)
    if er is None:
        err = lib.mg_split_stage_from_zero(out_r.data_ptr(), out_b.data_ptr(), fr.data_ptr(),
                                           fb.data_ptr(), n, h2, int(red_first), *plan, stream)
    else:
        err = lib.mg_split_stage(out_r.data_ptr(), out_b.data_ptr(), er.data_ptr(),
                                 eb.data_ptr(), fr.data_ptr(), fb.data_ptr(), n, h2,
                                 int(red_first), *plan, stream)
    _check(err, name)
    LAUNCHES[name] += 1
    return out_r, out_b


def rb_smooth_split(er, eb, fr, fb, h: float, n_iter: int, red_first: bool = True):
    """n_iter red-black GS iterations on a split pair (red first =
    preSmoother ordering, mg_3d.h:640-709; black first = postSmoother,
    mg_3d.h:711-781), as a fresh pair: er, eb are left as they are (on
    both devices). The CUDA form is one one-pass launch a call for n_iter
    <= 2, ceil(n_iter / 2) in all."""
    if n_iter < 1:
        raise ValueError(f"n_iter must be >= 1, got {n_iter}")
    if not _on_cuda(er, eb, fr, fb):
        return rb_smooth_split_plain(er, eb, fr, fb, h, n_iter, red_first)
    lib, stream, h2 = _lib(), _stream(), h * h
    for chunk in _stage_chunks(n_iter):
        er, eb = _stage_launch(lib, er, eb, fr, fb, h2, chunk, red_first, stream,
                               "rb_smooth_split")
    return er, eb


# the per-sweep form of K7, counted apart from K7's launches
PER_SWEEP_LAUNCHES = {"rb_smooth_split_per_sweep": 0}


def rb_smooth_split_per_sweep(er, eb, fr, fb, h: float, n_iter: int, red_first: bool = True):
    """K7's first CUDA form, kept as the stage bench's yardstick: one
    launch a half-sweep, 2 n_iter launches, each a pass over the other
    colour, f and the active colour. Updates er and eb IN PLACE and returns
    them; the plain version on the CPU. Its launches count in
    ``PER_SWEEP_LAUNCHES``."""
    if not _on_cuda(er, eb, fr, fb):
        r, b = rb_smooth_split_plain(er, eb, fr, fb, h, n_iter, red_first)
        return er.copy_(r), eb.copy_(b)
    lib, stream, n, h2 = _lib(), _stream(), er.shape[0], h * h
    pair, rhs = {RED: er, BLACK: eb}, {RED: fr, BLACK: fb}
    for _ in range(n_iter):
        for c in _colors(red_first):
            _check(lib.mg_split_half_sweep(pair[c].data_ptr(), pair[1 - c].data_ptr(),
                                           rhs[c].data_ptr(), n, h2, c, stream),
                   "rb_smooth_split_per_sweep")
            PER_SWEEP_LAUNCHES["rb_smooth_split_per_sweep"] += 1
    return er, eb


def rb_smooth_split_from_zero(fr, fb, h: float, n_iter: int, red_first: bool = True):
    """rb_smooth_split from an implicit zero initial pair, as a fresh pair
    (dead slots and boundary rows 0). The CUDA form is one one-pass launch
    of K7's stage from a zero tile for n_iter <= 2 (nothing is read but f);
    ceil(n_iter / 2) in all, each later one a K7 stage launch on the pair
    so far, all counted as K8 launches."""
    if n_iter < 1:
        raise ValueError(f"n_iter must be >= 1, got {n_iter}")
    if not _on_cuda(fr, fb):
        return rb_smooth_split_from_zero_plain(fr, fb, h, n_iter, red_first)
    lib, stream, h2 = _lib(), _stream(), h * h
    er = eb = None
    for chunk in _stage_chunks(n_iter):
        er, eb = _stage_launch(lib, er, eb, fr, fb, h2, chunk, red_first, stream,
                               "rb_smooth_split_from_zero")
    return er, eb


# ---------- the streaming restriction stage (K3, K9, K18, K23, K30 and K39)

RESTRICT_MAX_ROWS = 8     # coarse rows a block owns at most (restrict.cuh, kMaxRows)
RESTRICT_MAX_CHUNKS = 2   # chunks of 32 groups of 4 points a fine row at most (kMaxChunks)
RESTRICT_PAD = 4          # tile columns of e before a row's first point (kPad)
RESTRICT_REGISTERS = 56   # registers a thread takes (__launch_bounds__(544, 2))
# The cost model's constants, fitted to the stage's device times on an H100
# (utils/stage_plans.py --restrict): a step's latency, and the bytes an
# SM's blocks copy a microsecond.
RESTRICT_STEP_US = 0.9
RESTRICT_SM_BYTES_PER_US = 20e3
# K18 (pallas_mixed_fold.residual_restrict_fold) takes the stage on fold
# levels of at least this size and its first form, one thread a coarse
# point, below: on a small level a launch is latency, and the stage's
# prologue and 2 bci + 1 barrier steps cost more than the loads they save.
# Device ms a launch (utils/stage_plans.py --restrict, median of 20; one
# NVIDIA H100 80GB HBM3 at 700 W), first form against the stage on its
# plan: 9^3 0.0031 / 0.0043, 17^3 0.0041 / 0.0043, 33^3 0.0036 / 0.0045,
# 65^3 0.0039 / 0.0062, 129^3 0.0149 / 0.0168, 257^3 0.1020 / 0.0786,
# 513^3 0.7770 / 0.5689.
FOLD_RESTRICT_STAGE_MIN_N = 257
# K23 (pallas_mixed_split.residual_restrict_msplit) takes the stage, on K9's
# plan, on split levels of at least this size and its first form, one thread
# a coarse point, below, for the same reason. Device ms a launch
# (utils/stage_plans.py --restrict --kernels K23, median of 20; one NVIDIA
# H100 80GB HBM3 at 700 W), first form against the stage on its plan: 9^3
# 0.0028 / 0.0068, 17^3 0.0031 / 0.0068, 33^3 0.0034 / 0.0073, 65^3 0.0036 /
# 0.0097, 129^3 0.0120 / 0.0207, 257^3 0.1035 / 0.0644, 513^3 0.8146 /
# 0.4348.
MSPLIT_RESTRICT_STAGE_MIN_N = 257


class RestrictPlan(NamedTuple):
    """How one launch of the streaming restriction stage (restrict.cuh:
    K3's on a plain n^3 level, K9's where ``split`` (and K23's, on the
    electrospray's pair: K9's tile), K18's on the fold layout where
    ``fold``) cuts the level's
    interior coarse points: blocks own boxes of ``bci`` coarse planes x
    ``bcj`` coarse rows x ``bck`` coarse k, tiles numbered k fastest, then
    j, then i, from coarse point 1 (a block at the field's edge also
    zeroes the coarse boundary next to its box); a warp a fine row of the
    box's cone, ``threads`` = 32 (2 bcj + 1), its lanes ``chunks`` x 32
    groups of 4 points of the row; ``smem`` the bytes of shared memory a
    block takes (``_restrict_smem``). ``rows`` and ``cols``: a segment
    launch's (K30, K39) interior coarse rows and columns, which its boxes
    tile (``_restrict_plan``'s seg_rows and seg_cols), else None: the
    level's."""
    n: int
    split: bool
    bci: int
    bcj: int
    bck: int
    chunks: int
    threads: int
    smem: int
    fold: bool = False
    rows: int = None
    cols: int = None

    @property
    def tiles(self):
        """(planes, rows, k): the number of boxes along each axis."""
        m = _interior(self.n)
        return (-(-(self.rows or m) // self.bci), -(-(self.cols or m) // self.bcj),
                -(-m // self.bck))

    @property
    def blocks(self) -> int:
        ni, nj, nk = self.tiles
        return ni * nj * nk

    @property
    def args(self):
        """The launchers' plan arguments: (bci, bcj, bck, chunks, threads,
        smem)."""
        return (self.bci, self.bcj, self.bck, self.chunks, self.threads, self.smem)


def _interior(n: int) -> int:
    """Interior coarse points along an axis of an n-point level."""
    return (n + 1) // 2 - 2


def _restrict_points(bck: int, split: bool) -> int:
    """Residual points of a fine row of a box of bck coarse k: bck + 1
    slots on a split level, 2 bck + 1 fine k on a plain one."""
    return bck + 1 if split else 2 * bck + 1


def _restrict_widths(bck: int, split: bool):
    """(e, r, A) floats of a tile row of a box of bck coarse k, each a
    multiple of 4: e the row's points, ``RESTRICT_PAD`` before them and as
    many after (its k halo and the last group's reads), r and A the points
    (restrict.cuh, widths)."""
    pts = _restrict_points(bck, split)
    r4 = -(-pts // 4) * 4
    return -(-(pts + 2 * RESTRICT_PAD) // 4) * 4, r4, r4


def _restrict_smem(bcj: int, bck: int, split: bool) -> int:
    """Shared-memory bytes of a block: a ring of 3 e planes of 2 bcj + 3
    rows and 2 r planes of 2 bcj + 1 rows (both colours of each on a split
    level), and A, 2 bcj + 1 rows (restrict.cuh, smem_bytes, which the
    launchers check a plan against)."""
    we, wr, wa = _restrict_widths(bck, split)
    colours = 2 if split else 1
    return 4 * (colours * (3 * (2 * bcj + 3) * we + 2 * (2 * bcj + 1) * wr)
                + (2 * bcj + 1) * wa)


def _restrict_chunks(bck: int, split: bool):
    """The chunks of 32 groups of 4 points a lane's warp takes for a fine
    row of a box of bck coarse k: 1, ``RESTRICT_MAX_CHUNKS``, or None
    where the row does not fit."""
    points = _restrict_points(bck, split)
    for chunks in (1, RESTRICT_MAX_CHUNKS):
        if 128 * chunks >= points:
            return chunks
    return None


def _evened(m: int):
    """The box sizes that cut an axis of m points into tiles of one size
    (the last shorter by less than a tile)."""
    return [b for b in range(1, m + 1) if -(-m // -(-m // b)) == b]


def _restrict_cost(plan: RestrictPlan, sms: int) -> float:
    """The estimated time of a launch on ``plan`` (us): the blocks run in
    waves of what the SMs hold at once (shared memory, threads,
    ``RESTRICT_REGISTERS``; K9's two-chunk kernel one block an SM), each
    SM's resident blocks copying ``RESTRICT_SM_BYTES_PER_US`` between
    them. A block takes 2 bci + 1 steps and a prologue of about 1.5, each
    ``RESTRICT_STEP_US`` plus its resident blocks' planes of e and r
    (halos included) at that rate."""
    split, bci, bcj, bck = plan.split, plan.bci, plan.bcj, plan.bck
    we, wr, _ = _restrict_widths(bck, split)
    colours = 2 if split else 1
    e_plane = 4 * colours * (2 * bcj + 3) * we
    r_plane = 4 * colours * (2 * bcj + 1) * wr
    per_sm = min(SM_SMEM // (plan.smem + 1024), 2048 // plan.threads,
                 65536 // (plan.threads * RESTRICT_REGISTERS),
                 1 if split and plan.chunks > 1 else 32)
    blocks = plan.blocks
    resident = min(per_sm, -(-blocks // sms))
    waves = -(-blocks // (per_sm * sms))
    step = RESTRICT_STEP_US + resident * (e_plane + r_plane) / RESTRICT_SM_BYTES_PER_US
    return waves * (2 * bci + 2.5) * step


@functools.lru_cache(maxsize=None)
def _restrict_plan(n: int, sms: int, split: bool = False, fold: bool = False,
                   seg_rows: int = None, seg_cols: int = None) -> RestrictPlan:
    """The plan of one launch of the streaming restriction stage on an n^3
    level (K3; K9 and K23 on a split one; K18 on a fold one, whose tile rows and
    interior coarse counts are K3's, so it takes K3's plan) for a card of
    ``sms`` SMs, within
    ``SMEM_MAX`` bytes of shared memory a block: k in whole rows where a
    fine row fits ``RESTRICT_MAX_CHUNKS`` chunks, else in the fewest tiles
    that do (a multiple of 4 slots on a split level whose rows hold a
    multiple of 4); over the plane and row counts that cut their axes
    evenly (at most ``RESTRICT_MAX_ROWS`` coarse rows), the plan of least
    ``_restrict_cost``; a plan of at least one block an SM first where the
    level has one. ``seg_rows``: the plan of a segment launch (K30, K39:
    K3's tile) whose boxes tile that many interior coarse rows (a rank's,
    ``pallas_sharded.seg_restrict_extents``) instead of the level's;
    ``seg_cols`` (K39, with ``seg_rows``): that many columns too. Raises
    for a level without interior coarse points (n < 5) or an even n."""
    m = _interior(n)
    if n % 2 == 0 or m < 1:
        raise ValueError(f"the restriction stage takes an odd n >= 5, got n = {n}")
    if split and fold:
        raise ValueError("a restriction level is split or fold, not both")
    if seg_rows is not None and (split or fold or seg_rows < 1):
        raise ValueError(f"seg_rows = {seg_rows}: a plain level's plan of one row or more")
    if seg_cols is not None and (seg_rows is None or seg_cols < 1):
        raise ValueError(f"seg_cols = {seg_cols}: a segment plan of one column or more")
    if fold:
        return _restrict_plan(n, sms)._replace(fold=True)
    s = split_shape(n)[2]
    evened = _evened(m)
    bck = next(b for b in reversed(evened) if _restrict_chunks(b, split) is not None
               and not (split and s % 4 == 0 and b < m and b % 4))
    chunks = _restrict_chunks(bck, split)
    best = None
    for bcj in (b for b in _evened(seg_cols or m) if b <= RESTRICT_MAX_ROWS):
        smem = _restrict_smem(bcj, bck, split)
        if smem > SMEM_MAX:
            break
        for bci in _evened(seg_rows or m):
            plan = RestrictPlan(n, split, bci, bcj, bck, chunks, 32 * (2 * bcj + 1), smem,
                                rows=seg_rows, cols=seg_cols)
            key = (plan.blocks < sms, _restrict_cost(plan, sms), -plan.blocks)
            if best is None or key < best[0]:
                best = (key, plan)
    return best[1]


@functools.lru_cache(maxsize=None)
def _restrict_args_on(n: int, index: int, split: bool, fold: bool, seg_rows: int = None,
                      seg_cols: int = None):
    return _restrict_plan(n, _sms(index), split, fold, seg_rows, seg_cols).args


def _restrict_args(n: int, device, split: bool = False, fold: bool = False,
                   seg_rows: int = None, seg_cols: int = None):
    """The restriction launchers' plan arguments on ``device``
    (``RestrictPlan.args``; ``seg_rows``, ``seg_cols``: _restrict_plan's)."""
    index = device.index if device.index is not None else torch.cuda.current_device()
    return _restrict_args_on(n, index, split, fold, seg_rows, seg_cols)


# ---------- the streaming double-float residual-and-norm stage (K32, K41), and
# ---------- the one-field residual stage on its geometry (K33)

DF_MAX_ROWS = 8     # rows a block owns at most, a warp each (residual_df_norm_seg.cu, kMaxRows)
DF_MAX_PLANES = 32  # planes a block streams at most in a plan (longer measured slower at 513^3)
DF_MAX_CHUNKS = 8   # 32-point chunks of a lane's row tile at most (kMaxChunks)
DF_RING = 3         # planes of each streamed field in a block's ring (kRing)
DF_ZERO_PER_THREAD = 32  # zeros a thread of a launch without interior points writes
# registers a thread takes by chunks (ptxas, the Seg and Seg2 kernels' most,
# rounded up to the allocation's 8): the cost model's occupancy
DF_REGISTERS = {1: 64, 2: 64, 4: 72, 8: 128}
# The cost model's constants: a step's latency, and the bytes an SM's
# blocks move a microsecond (3.35 TB/s over 132 SMs); with them, and
# DF_MAX_PLANES, the planner's plan is the fastest or within 3% of the
# candidates timed at 129^3-513^3 (utils/stage_plans.py --seg-df; one
# NVIDIA H100 80GB HBM3 at 700 W).
DF_STEP_US = 1.0
DF_SM_BYTES_PER_US = 25.4e3
# K32 and K41 take the stage on levels of at least this size and their
# first form, one thread a point, below: on a small level a launch is
# latency, and the stage's prologue and steps cost more than the loads they
# save. Device ms a call, stage and first form (utils/stage_plans.py
# --seg-df, median of 20; one NVIDIA H100 80GB HBM3 at 700 W): K32 65^3 L =
# 80 0.0087 / 0.0081, L = 24 0.0063 / 0.0058, 129^3 L = 160 0.0296 /
# 0.0406, L = 48 0.0138 / 0.0170; K41 65^3 68^2 0.0097 / 0.0098, 36^2
# 0.0072 / 0.0055, 129^3 136^2 0.0331 / 0.0435, 72^2 0.0146 / 0.0162.
DF_STAGE_MIN_N = 129
# registers a thread of K33's stage takes by chunks (ptxas, resid_stage_kernel):
# its cost model's occupancy; with it the planner's plan is the fastest or
# within 2% of the candidates timed at 65^3-513^3, but for 513^3's one-rank
# block (6%; utils/stage_plans.py --offpath --kernels K33)
RESID_REGISTERS = {1: 40, 2: 40, 4: 48, 8: 64}
# The stages on this geometry by name: the fields each streams through a
# ring of its own, and the registers a thread of it takes by chunks.
DF_STAGES = {"df": (2, DF_REGISTERS), "resid": (1, RESID_REGISTERS)}


class DfPlan(NamedTuple):
    """How one launch of the streaming stage on a rank's block cuts its
    interior points (``rows`` planes x ``cols`` rows x n - 2 k): blocks own
    boxes of ``bi`` planes x ``bj`` rows x ``bk`` k, tiles numbered k
    fastest, then j, then i; a warp a row, ``threads`` = 32 bj, a lane the
    points 32 c apart of ``chunks`` chunks; ``smem`` the bytes of a block's
    rings (``_df_smem``), one a streamed field; ``stage`` the kernel it
    plans (``DF_STAGES``): "df" the double-float residual-and-norm stage
    (K32, K41), "resid" the residual stage (K33)."""
    n: int
    bi: int
    bj: int
    bk: int
    chunks: int
    threads: int
    smem: int
    rows: int
    cols: int
    stage: str = "df"

    @property
    def fields(self):
        return DF_STAGES[self.stage][0]

    @property
    def tiles(self):
        """(planes, rows, k): the number of boxes along each axis."""
        return (-(-self.rows // self.bi), -(-self.cols // self.bj), -(-(self.n - 2) // self.bk))

    @property
    def blocks(self) -> int:
        ni, nj, nk = self.tiles
        return ni * nj * nk

    @property
    def args(self):
        """The launchers' plan arguments: (bi, bj, bk, chunks, threads,
        smem)."""
        return (self.bi, self.bj, self.bk, self.chunks, self.threads, self.smem)


def _df_smem(bj: int, bk: int, fields: int = 2) -> int:
    """Shared-memory bytes of a block: DF_RING planes of each of ``fields``
    streamed fields (u_hi and u_lo; K33's u), bj + 2 rows of bk + 2 floats
    rounded up to 4 (seg_stream.cuh, smem_bytes, which the launchers check a
    plan against)."""
    return 4 * fields * DF_RING * (bj + 2) * (-(-(bk + 2) // 4) * 4)


def _df_chunks(bk: int):
    """The least power of 2 of 32-point chunks that covers bk k, or None
    past DF_MAX_CHUNKS."""
    chunks = 1
    while 32 * chunks < bk:
        chunks *= 2
    return chunks if chunks <= DF_MAX_CHUNKS else None


def _df_make(n: int, bi: int, bj: int, bk: int, rows: int, cols: int,
             stage: str = "df") -> DfPlan:
    smem = _df_smem(bj, bk, DF_STAGES[stage][0])
    return DfPlan(n, bi, bj, bk, _df_chunks(bk), 32 * bj, smem, rows, cols, stage)


def _df_cost(plan: DfPlan, sms: int) -> float:
    """The estimated time of a launch on ``plan`` (us): the blocks run in
    waves of what the SMs hold at once (shared memory, threads, the
    registers of the plan's stage in ``DF_STAGES``), each SM's resident
    blocks moving ``DF_SM_BYTES_PER_US`` between them. A block takes bi
    steps and a prologue of about 2, each ``DF_STEP_US`` plus its resident
    blocks' planes of the streamed fields (halo rows and k included), of f
    (one or two) and of r at that rate."""
    bj, bk, fields = plan.bj, plan.bk, plan.fields
    step_bytes = 4 * (fields * (bj + 2) * (bk + 2) + (fields + 1) * bj * bk)
    registers = DF_STAGES[plan.stage][1][plan.chunks]
    per_sm = min(SM_SMEM // (plan.smem + 1024), 2048 // plan.threads,
                 65536 // (plan.threads * registers), 32)
    resident = min(per_sm, -(-plan.blocks // sms))
    waves = -(-plan.blocks // (per_sm * sms))
    return waves * (plan.bi + 2) * (DF_STEP_US + resident * step_bytes / DF_SM_BYTES_PER_US)


def _df_candidates(n: int, rows: int, cols: int, stage: str = "df"):
    """The plans the stage takes on ``rows`` interior planes x ``cols``
    interior rows of an n-point level: k in whole rows where they fit
    DF_MAX_CHUNKS chunks, else in the fewest tiles that do, and in two
    tiles more; over the row and plane counts that cut their axes evenly,
    at most DF_MAX_ROWS rows and DF_MAX_PLANES planes."""
    m = n - 2
    whole = -(-m // -(-m // (32 * DF_MAX_CHUNKS)))
    half = -(-m // (2 * -(-m // whole)))
    out = []
    for bk in sorted({whole, half}):
        for bj in (b for b in _evened(cols) if b <= DF_MAX_ROWS):
            for bi in (b for b in _evened(rows) if b <= DF_MAX_PLANES):
                out.append(_df_make(n, bi, bj, bk, rows, cols, stage))
    return out


@functools.lru_cache(maxsize=None)
def _df_plan(n: int, sms: int, rows: int, cols: int, stage: str = "df") -> DfPlan:
    """The plan of one launch of the double-float residual-and-norm stage
    (K32, K41; ``stage`` "df") or of the residual stage (K33; "resid")
    on a rank's ``rows`` interior planes and ``cols`` interior rows
    (``pallas_sharded.seg_df_extents``; n - 2 on an i-sharded block) of an
    n-point level, for a card of ``sms`` SMs: of ``_df_candidates``,
    the one of least ``_df_cost``, one of at least one block an SM first
    where the rank has one. Raises for n < 3 or an empty interior."""
    if n < 3 or rows < 1 or cols < 1:
        raise ValueError(f"the df stage plans n >= 3 and an interior, got n = {n}, rows = "
                         f"{rows}, cols = {cols}")
    best = None
    for plan in _df_candidates(n, rows, cols, stage):
        key = (plan.blocks < sms, _df_cost(plan, sms), -plan.blocks, plan.bk)
        if best is None or key < best[0]:
            best = (key, plan)
    return best[1]


def _df_zero_blocks(points: int, threads: int) -> int:
    """The blocks of a launch on a block without interior points, which
    write its ``points`` zeros, DF_ZERO_PER_THREAD a thread
    (residual_df_norm_seg.cu, df_blocks)."""
    return -(-points // (DF_ZERO_PER_THREAD * threads))


# ------------------------------------------- K9: residual + restriction


def _residual_split_plain(er, eb, fr, fb, h: float):
    """(sr, sb, red_odd): each colour's residual f - (1/h^2)(nbr_sum - 6e)
    on its live interior slots, 0 elsewhere."""
    red_odd, live_r, live_b = _masks(er.shape[0], er.device)
    inv_h2 = 1.0 / (h * h)
    sr = fr - inv_h2 * (_nbr_sum(eb, red_odd) - 6.0 * er)
    sb = fb - inv_h2 * (_nbr_sum(er, ~red_odd) - 6.0 * eb)
    return (torch.where(live_r, sr, torch.zeros_like(sr)),
            torch.where(live_b, sb, torch.zeros_like(sb)), red_odd)


def residual_restrict_split_plain(er, eb, rr, rb, h: float):
    """Plain version of K9: the split residual; the k taps to the coarse
    interior k's, 0.5 E[ck - 1] + 0.25 (O[ck - 1] + O[ck]) with E / O the
    colour holding the row's even / odd k's; then the 3-tap weights along
    i, then j; the coarse boundary is zero."""
    sr, sb, red_odd = _residual_split_plain(er, eb, rr, rb, h)

    def k_taps(even, odd):
        return 0.5 * even[:, :, :-1] + 0.25 * (odd[:, :, :-1] + odd[:, :, 1:])

    t = torch.where(red_odd, k_taps(sb, sr), k_taps(sr, sb))
    t = pk._restrict_axis(pk._restrict_axis(t, 0), 1)
    nc = (er.shape[0] + 1) // 2
    out = torch.zeros((nc, nc, nc), dtype=er.dtype, device=er.device)
    out[1:-1, 1:-1, 1:-1] = t
    return out


def residual_restrict_split(er, eb, rr, rb, h: float):
    """Split correction pair (er, eb) and its RHS pair -> the rect
    (nc, nc, nc) coarse RHS, nc = (n + 1) / 2: full weighting of the
    interior residual, zero coarse boundary, without storing the fine
    residual; the inputs are left as they are. The CUDA form is one launch
    of the streaming restriction stage (restrict.cuh) on
    ``_restrict_plan(n, sms, split=True)``."""
    if not _on_cuda(er, eb, rr, rb):
        return residual_restrict_split_plain(er, eb, rr, rb, h)
    n = er.shape[0]
    nc = (n + 1) // 2
    out = torch.empty((nc, nc, nc), dtype=er.dtype, device=er.device)
    _check(_lib().mg_split_residual_restrict(out.data_ptr(), er.data_ptr(), eb.data_ptr(),
                                             rr.data_ptr(), rb.data_ptr(), n, 1.0 / (h * h),
                                             *_restrict_args(n, er.device, split=True),
                                             _stream()),
           "residual_restrict_split")
    LAUNCHES["residual_restrict_split"] += 1
    return out


# ------------------------------ K10: prolongation + correction + smooth


def _prolong_split(ec, n: int):
    """(corr_r, corr_b): the trilinear interpolation of the rect coarse
    ec at each colour's slots, in the Pallas kernel's order: j (even rows
    copy, odd ones 0.5 a + 0.5 b), then i (odd planes 0.5 (a + b)), then
    k (slot kk of parity p = 0 takes 0.5 (y[kk] + y[kk + 1]), p = 1 takes
    y[kk + 1])."""
    y = pk._interp_axis(ec, 1)
    yi = y.new_empty((n,) + tuple(y.shape[1:]))
    yi[0::2] = y
    yi[1::2] = 0.5 * (y[:-1] + y[1:])
    s = split_shape(n)[2]
    lo, hi = yi[:, :, :s], yi[:, :, 1:s + 1]
    avg = 0.5 * (lo + hi)
    red_odd = _masks(n, ec.device)[0]
    return torch.where(red_odd, avg, hi), torch.where(red_odd, hi, avg)


def prolong_smooth_split_plain(ec, er, eb, rr, rb, h: float, n_iter: int):
    """Plain version of K10: (er, eb) + P ec at the live interior slots,
    then the black-first RB stage."""
    _, live_r, live_b = _masks(er.shape[0], er.device)
    corr_r, corr_b = _prolong_split(ec, er.shape[0])
    er = er + torch.where(live_r, corr_r, torch.zeros_like(corr_r))
    eb = eb + torch.where(live_b, corr_b, torch.zeros_like(corr_b))
    return rb_smooth_split_plain(er, eb, rr, rb, h, n_iter, red_first=False)


def prolong_smooth_split(ec, er, eb, rr, rb, h: float, n_iter: int):
    """rb_smooth_split(e + P ec, r, h, n_iter, black first) as a fresh
    pair (er, eb are left as they are): the post-smoothing stage of the
    finest level, with the rect coarse correction ec interpolated and
    added. The CUDA form is one one-pass launch for n_iter <= 2 (the
    correction made as each plane reaches shared memory); a larger n_iter
    goes on with K7 stage launches, black first, counted as K10's."""
    if n_iter < 1:
        raise ValueError(f"n_iter must be >= 1, got {n_iter}")
    if not _on_cuda(er, eb, rr, rb, coarse=ec):
        return prolong_smooth_split_plain(ec, er, eb, rr, rb, h, n_iter)
    lib, stream, n, h2 = _lib(), _stream(), er.shape[0], h * h
    first, *rest = _stage_chunks(n_iter)
    out_r, out_b = torch.empty_like(er), torch.empty_like(eb)
    _check(lib.mg_split_prolong_stage(out_r.data_ptr(), out_b.data_ptr(), ec.data_ptr(),
                                      er.data_ptr(), eb.data_ptr(), rr.data_ptr(),
                                      rb.data_ptr(), n, h2,
                                      *_plan_args(n, first, er.device, prolong=True),
                                      stream),
           "prolong_smooth_split")
    LAUNCHES["prolong_smooth_split"] += 1
    for chunk in rest:
        out_r, out_b = _stage_launch(lib, out_r, out_b, rr, rb, h2, chunk, False, stream,
                                     "prolong_smooth_split")
    return out_r, out_b


# --------------------------- K12 / K11: double-float residual (+ step)


def residual_df_norm_split_plain(u_hr, u_hb, u_lr, u_lb, f_hr, f_hb, f_lr, f_lb, h: float):
    """Plain version of K12: the EFT residual pair of (u_hi + u_lo) against
    (f_hi + f_lo), 0 off the live interior, and ||r||^2 summed in f64 and
    returned in r's dtype, as the kernel does."""
    red_odd, live_r, live_b = _masks(u_hr.shape[0], u_hr.device)
    inv_h2 = 1.0 / (h * h)
    r_r = pk._eft_residual(f_hr, f_lr, u_hr, _nbrs(u_hb, red_odd), u_lr,
                           _nbrs(u_lb, red_odd), inv_h2)
    r_b = pk._eft_residual(f_hb, f_lb, u_hb, _nbrs(u_hr, ~red_odd), u_lb,
                           _nbrs(u_lr, ~red_odd), inv_h2)
    r_r = torch.where(live_r, r_r, torch.zeros_like(r_r))
    r_b = torch.where(live_b, r_b, torch.zeros_like(r_b))
    sr, sb = r_r.to(torch.float64), r_b.to(torch.float64)
    return r_r, r_b, torch.sum(sr * sr + sb * sb).to(r_r.dtype)


def residual_df_norm_split(u_hr, u_hb, u_lr, u_lb, f_hr, f_hb, f_lr, f_lb, h: float):
    """(r_r, r_b, ||r||^2): the compensated residual pair of the
    double-float solution pair and its squared norm (a 0-d tensor on the
    fields' device)."""
    fields = (u_hr, u_hb, u_lr, u_lb, f_hr, f_hb, f_lr, f_lb)
    if not _on_cuda(*fields):
        return residual_df_norm_split_plain(*fields, h)
    lib, n = _lib(), u_hr.shape[0]
    r_r, r_b = torch.empty_like(u_hr), torch.empty_like(u_hb)
    nrm2 = torch.empty((), dtype=torch.float32, device=u_hr.device)
    partials = torch.empty(lib.mg_split_df_partials(n), dtype=torch.float64,
                           device=u_hr.device)
    _check(lib.mg_split_residual_df_norm(
        r_r.data_ptr(), r_b.data_ptr(), nrm2.data_ptr(), partials.data_ptr(),
        *(x.data_ptr() for x in fields), n, 1.0 / (h * h), _stream()),
        "residual_df_norm_split")
    LAUNCHES["residual_df_norm_split"] += 1
    return r_r, r_b, nrm2


def df_step_split_plain(u_hr, u_hb, u_lr, u_lb, e_r, e_b, f_hr, f_hb, f_lr, f_lb, h: float):
    """Plain version of K11: df_add on each colour, then K12's plain
    version."""
    hr, lr = pk.df_add(u_hr, u_lr, e_r)
    hb, lb = pk.df_add(u_hb, u_lb, e_b)
    return (hr, hb, lr, lb) + residual_df_norm_split_plain(hr, hb, lr, lb, f_hr, f_hb,
                                                           f_lr, f_lb, h)


def df_step_split(u_hr, u_hb, u_lr, u_lb, e_r, e_b, f_hr, f_hb, f_lr, f_lb, h: float):
    """(u_hr', u_hb', u_lr', u_lb', r_r, r_b, ||r||^2): the tail of a
    defect-correction step on split pairs, the double-float pair + e and
    the compensated residual of the result with its squared norm. All
    outputs are fresh tensors; the norm is a 0-d tensor on the fields'
    device."""
    fields = (u_hr, u_hb, u_lr, u_lb, e_r, e_b, f_hr, f_hb, f_lr, f_lb)
    if not _on_cuda(*fields):
        return df_step_split_plain(*fields, h)
    lib, n = _lib(), u_hr.shape[0]
    outs = [torch.empty_like(u_hr) for _ in range(6)]
    nrm2 = torch.empty((), dtype=torch.float32, device=u_hr.device)
    partials = torch.empty(lib.mg_split_df_partials(n), dtype=torch.float64,
                           device=u_hr.device)
    _check(lib.mg_split_df_step(
        *(x.data_ptr() for x in outs), nrm2.data_ptr(), partials.data_ptr(),
        *(x.data_ptr() for x in fields), n, 1.0 / (h * h), _stream()),
        "df_step_split")
    LAUNCHES["df_step_split"] += 1
    return (*outs, nrm2)
