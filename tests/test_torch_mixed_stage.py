"""The one-pass full-layout mixed smoothing stages (K13
``mixed_rb_smooth_fused``, K14 ``mixed_rb_smooth_from_zero_fused`` and K15
``mixed_prolong_smooth_fused``, multigrid_parallel_tpu_torch.ops.pallas_mixed)
on the CPU: an emulation of
the CUDA kernels' schedule held against the plain versions, and the
wrappers' CPU contract.

The CUDA stage (ops/csrc/rect.cuh with the kMixed layout, ``stage_body``
and ``box_body``) cannot run here, so its schedule is emulated in torch
(tests/torch_stage_emulation.py), block by block, as the kernel runs it, on
rect.cuh's tile: a field row
(i, j) of the (n, n, n) field held as two colour rows of slots, slot kk of
a colour holding k = 2 kk + 1 + p, the k-face slots (k = 0 and n - 1)
holding the loaded face values (K14: zeros; K13: e's); the plan's boxes with halos of
2 n_iter planes and rows (and k_halo slots where k is tiled); tile planes
filled with NaN outside the loaded box, K14's tile all zeros instead; a
ring of tile planes for each colour as deep as the kernel's (a plane gone
from a ring raises); K15's e + P ec on every point of each plane as it
arrives (K4's step, the coarse boundary live); the skewed wavefront
(half-sweep s at plane p - 2 s once plane p has arrived; a step's
half-sweeps and store all read before any writes, as the kernel runs them
at once), each half-sweep on its region updating its colour in place, the
neighbours summed in the plain version's order, those across a face (i, j
or k at 1 or n - 2) selected as the slot's own value, 0 at a pinned x-face
node; and the store with the BC pass: a step after its last half-sweep,
each interior plane's owned rows written with the boundary nodes they are
the copy source of (k = 0 from k = 1, row 0 from row 1, plane 0 from plane
1, ..., 0 at a pinned x-face node, the pin read at the node's own (j, k)).
The emulation must equal the plain versions bit for bit, and three faults
of the schedule must not: a halo one plane short, a k-face neighbour read
from the tile's loaded k-face slot, and an x-face or a z-face node stored
before its source's last half-sweep. K13, the same stage on a loaded
(BC-consistent) e, is held the same way, and a zero tile in place of e, a
k-face neighbour read from the tile's loaded slot and a halo one plane
short must make it differ. The card tests hold the kernels themselves
against the plain versions (tests/test_torch_cuda.py).
"""

import numpy as np
import pytest
import torch

from multigrid_parallel_tpu_torch.ops import pallas_mixed as tpm
from multigrid_parallel_tpu_torch.ops import pallas_split as tps
from torch_stage_emulation import emulate_k14 as _emulate_k14
from torch_stage_emulation import emulate_k15 as _emulate_k15
from torch_stage_emulation import field as _field
from torch_stage_emulation import pins as _pins

torch.set_num_threads(1)

H100_SMS = 132


def _plans(kind, n):
    """The plan of each launch size (n_iter 1, 2): the planner's for the
    H100's 132 SMs (a box up to 129^3), its wavefront's for 4 SMs, a box of
    5 planes by 4 rows, 7 planes by 8 whole rows on the wavefront, 4-slot k
    tiles with the 4-slot k halo by 12 rows and 11 planes (wavefront), or
    boxes of 1 plane by 1 row with 4-slot k tiles. The H100's plans at 9^3
    and 17^3 are boxes of one plane (and one row): every x- and y-face node
    is written by the block of its source, not its own."""
    s = n // 2

    def plan(n_iter):
        halo = 2 * n_iter
        if kind == "h100":
            return tps._stage_plan(n, n_iter, H100_SMS, rect=True)
        if kind == "wave":
            return tps._wave_plan(n, n_iter, 4, False, True)
        if kind == "box":
            return tps.StagePlan(n, n_iter, halo, 0, 5, 4, s, 256, 0, True, True)
        if kind == "rows":
            return tps.StagePlan(n, n_iter, halo, 0, 7, 8, s, 256, 0, True)
        if kind == "one_k_tiles":
            return tps.StagePlan(n, n_iter, halo, tps.STAGE_K_HALO, 1, 1, 4, 256, 0, True, True)
        return tps.StagePlan(n, n_iter, halo, tps.STAGE_K_HALO, 11, 12, 4, 256, 0, True)

    return plan


CASES = [(9, "h100"), (9, "wave"), (17, "h100"), (17, "rows"), (33, "box"), (33, "k_tiles")]


@pytest.mark.parametrize("pins", ["electrospray", "random"])
@pytest.mark.parametrize("n_iter", [1, 2])
@pytest.mark.parametrize("n,kind", CASES)
def test_emulated_mixed_stages_match_plain(n, kind, n_iter, pins):
    """K14 (both orders) and K15 on the level sizes 9^3, 17^3 and 33^3, on
    box and wavefront plans with several blocks in i and j (and k where
    tiled, down to 1 x 1 blocks), the electrospray's pins and random ones
    (k-face columns too), fields and the coarse correction random at every
    point (the coarse boundary live): bit for bit against the plain
    versions."""
    h = 3e-4 / (n - 1)
    rng = np.random.default_rng(10 * n + n_iter)
    pin = _pins(pins, n, rng)
    e, r, ec = _field(rng, n), _field(rng, n), _field(rng, (n + 1) // 2)
    plan_of = _plans(kind, n)
    assert plan_of(n_iter).blocks > 1
    for red_first in (True, False):
        got = _emulate_k14(r, pin, h, n_iter, red_first, plan_of)
        want = tpm.mixed_rb_smooth_from_zero_plain(r, pin, h, n_iter, red_first)
        assert torch.equal(got, want), red_first
    got = _emulate_k15(ec, e, r, pin, h, n_iter, plan_of)
    assert torch.equal(got, tpm.mixed_prolong_smooth_plain(ec, e, r, pin, h, n_iter))


def test_emulated_mixed_stages_on_one_row_k_tiles():
    """Boxes of 1 plane by 1 row by 4 slots (13^3: two k tiles a row), so
    that every face node, the z faces too, is written by a block of its
    source's and no block holds a whole row: bit for bit."""
    n, h = 13, 3e-4 / 12
    rng = np.random.default_rng(13)
    pin = _pins("random", n, rng)
    e, r, ec = _field(rng, n), _field(rng, n), _field(rng, 7)
    plan_of = _plans("one_k_tiles", n)
    assert plan_of(2).tiles == (n, n, 2)
    got = _emulate_k14(r, pin, h, 2, True, plan_of)
    assert torch.equal(got, tpm.mixed_rb_smooth_from_zero_plain(r, pin, h, 2, True))
    got = _emulate_k15(ec, e, r, pin, h, 2, plan_of)
    assert torch.equal(got, tpm.mixed_prolong_smooth_plain(ec, e, r, pin, h, 2))


def test_emulated_mixed_stages_chain_past_two_iterations():
    """n_iter 3: a two-iteration launch (K14 from zero, K15 with its
    correction), then the stage on the field so far."""
    n, h = 17, 3e-4 / 16
    rng = np.random.default_rng(3)
    pin = _pins("random", n, rng)
    e, r, ec = _field(rng, n), _field(rng, n), _field(rng, 9)
    plan_of = _plans("rows", n)
    for red_first in (True, False):
        got = _emulate_k14(r, pin, h, 3, red_first, plan_of)
        assert torch.equal(got, tpm.mixed_rb_smooth_from_zero_plain(r, pin, h, 3, red_first))
    got = _emulate_k15(ec, e, r, pin, h, 3, plan_of)
    assert torch.equal(got, tpm.mixed_prolong_smooth_plain(ec, e, r, pin, h, 3))


@pytest.mark.parametrize("fault", ["short_halo", "k_face_slot", "early_x", "early_z"])
@pytest.mark.parametrize("kind", ["rows", "box"])
def test_emulation_finds_a_faulty_schedule(kind, fault):
    """The emulation is a check: a halo one plane short, the k-face
    neighbours read from the tile's k-face slots (K14's zeros, K15's loaded
    e + P ec), or the x-face planes or the z faces stored before their
    sources' last half-sweep, each leaves a wrong value in the output of
    K14 and of K15, on the wavefront and on the box; the same plans
    without the fault equal the plain versions."""
    n, n_iter = 17, 2
    h = 3e-4 / (n - 1)
    rng = np.random.default_rng(5)
    pin = _pins("electrospray", n, rng)
    e, r, ec = _field(rng, n), _field(rng, n), _field(rng, 9)
    plan = _plans(kind, n)(n_iter)
    want14 = tpm.mixed_rb_smooth_from_zero_plain(r, pin, h, n_iter, True)
    want15 = tpm.mixed_prolong_smooth_plain(ec, e, r, pin, h, n_iter)
    assert torch.equal(_emulate_k14(r, pin, h, n_iter, True, lambda _: plan), want14)
    assert torch.equal(_emulate_k15(ec, e, r, pin, h, n_iter, lambda _: plan), want15)
    bad, broken = plan, None
    if fault == "short_halo":
        bad = plan._replace(halo=plan.halo - 1)
    else:
        broken = fault
    # the faulty schedules still write every point once: a wrong value, not a count
    got14 = _emulate_k14(r, pin, h, n_iter, True, lambda _: bad, broken)
    got15 = _emulate_k15(ec, e, r, pin, h, n_iter, lambda _: bad, broken)
    assert not torch.equal(got14, want14)
    assert not torch.equal(got15, want15)


def _k13_inputs(n, seed):
    """(pin, e, r, h): random pins and fields, e made BC-consistent, as the
    cycle hands it over."""
    rng = np.random.default_rng(seed)
    pin = _pins("random", n, rng)
    e, r = _field(rng, n), _field(rng, n)
    return pin, tpm.apply_bcs_padded(e, pin), r, 3e-4 / (n - 1)


@pytest.mark.parametrize("n,kind", CASES)
def test_emulated_k13_matches_plain(n, kind):
    """K13, the stage on the loaded e, on the level sizes 9^3, 17^3 and
    33^3 and the plans of K14's test: n_iter 1 red first and n_iter 2 black
    first, bit for bit against the plain version."""
    pin, e, r, h = _k13_inputs(n, 40 + n)
    for n_iter, red_first in ((1, True), (2, False)):
        got = _emulate_k14(r, pin, h, n_iter, red_first, _plans(kind, n), e=e)
        assert torch.equal(got, tpm.mixed_rb_smooth_plain(e, r, pin, h, n_iter, red_first)), \
            n_iter


def test_emulated_k13_chains_past_two_iterations():
    """n_iter 3: K13's two-iteration launch on e, then the stage on the
    field so far, both orders."""
    pin, e, r, h = _k13_inputs(17, 4)
    for red_first in (True, False):
        got = _emulate_k14(r, pin, h, 3, red_first, _plans("rows", 17), e=e)
        assert torch.equal(got, tpm.mixed_rb_smooth_plain(e, r, pin, h, 3, red_first))


@pytest.mark.parametrize("fault", ["zero_tile", "k_face_slot", "short_halo"])
def test_emulation_finds_a_faulty_k13(fault):
    """The emulation is a check of K13 too (17^3, n_iter 2, the wavefront
    plan of whole rows): a zero tile in place of the loaded e, the k-face
    neighbours read from the tile's loaded k-face slots, or a halo one
    plane short leaves a wrong value; without the fault it equals the plain
    version."""
    n, n_iter = 17, 2
    pin, e, r, h = _k13_inputs(n, 6)
    plan = _plans("rows", n)(n_iter)
    want = tpm.mixed_rb_smooth_plain(e, r, pin, h, n_iter, True)
    assert torch.equal(_emulate_k14(r, pin, h, n_iter, True, lambda _: plan, e=e), want)
    bad, broken = (plan._replace(halo=plan.halo - 1), None) if fault == "short_halo" else (
        plan, fault)
    got = _emulate_k14(r, pin, h, n_iter, True, lambda _: bad, broken, e=e)
    assert not torch.equal(got, want)


# ------------------------------------------------- the wrappers on the CPU


def test_k14_k15_return_fresh_fields_and_leave_their_inputs():
    """On the CPU the wrappers are the plain versions: fresh outputs, the
    inputs as they were, no launch counted; n_iter < 1 is refused."""
    n, h = 17, 3e-4 / 16
    rng = np.random.default_rng(7)
    pin = _pins("random", n, rng)
    e, r, ec = _field(rng, n), _field(rng, n), _field(rng, 9)
    before = [x.clone() for x in (e, r, ec, pin)]
    tpm.reset_launches()
    got15 = tpm.mixed_prolong_smooth_fused(ec, e, r, pin, h, 2)
    got14 = tpm.mixed_rb_smooth_from_zero_fused(r, pin, h, 2)
    assert all(torch.equal(a, b) for a, b in zip((e, r, ec, pin), before))
    assert got15 is not e and got14 is not r
    assert torch.equal(got15, tpm.mixed_prolong_smooth_plain(ec, e, r, pin, h, 2))
    assert torch.equal(got14, tpm.mixed_rb_smooth_from_zero_plain(r, pin, h, 2))
    assert not any(tpm.LAUNCHES.values())
    for call in (lambda: tpm.mixed_rb_smooth_from_zero_fused(r, pin, h, 0),
                 lambda: tpm.mixed_prolong_smooth_fused(ec, e, r, pin, h, 0)):
        with pytest.raises(ValueError, match="n_iter"):
            call()


def test_k13_returns_a_fresh_field_and_leaves_its_inputs():
    """On the CPU K13's wrapper is the plain version: a fresh field at
    n_iter 1-3, e and r as they were, no launch counted; n_iter < 1 is
    refused."""
    pin, e, r, h = _k13_inputs(17, 8)
    before = [x.clone() for x in (e, r, pin)]
    tpm.reset_launches()
    for n_iter in (1, 2, 3):
        got = tpm.mixed_rb_smooth_fused(e, r, pin, h, n_iter)
        assert got is not e and torch.equal(got, tpm.mixed_rb_smooth_plain(e, r, pin, h, n_iter))
    assert all(torch.equal(a, b) for a, b in zip((e, r, pin), before))
    assert not any(tpm.LAUNCHES.values())
    with pytest.raises(ValueError, match="n_iter"):
        tpm.mixed_rb_smooth_fused(e, r, pin, h, 0)
