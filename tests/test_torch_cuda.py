"""The port's CUDA kernels against their plain PyTorch versions, the
double-float solve on the card against the same solve on the CPU, the
split-colour solve (K7-K12 on the finest level) against the fused rect
one, and the electrospray tiers (full: K13-K15 with K3 and K5; k-fold:
K16-K20; split-colour: K21-K25 over the fold cycle) on the card against
the CPU, K26 (smoothing stage + residual) and K27 (double-float
residual) against their plain versions, the f64 reference solve on the
card against the CPU, the smoother study on K1, and the i-sharded
kernels K28-K33 on four simulated ranks against their plain versions
and the single-device kernels, with the sharded solve on one NCCL rank
against the fused single-device solve, the i-sharded electrospray
kernels K34-K36 likewise against their plain versions and K13-K15, with
the sharded electrospray solve on one NCCL rank against the full tier,
and the (i, j)-sharded kernels K37-K41 on four simulated 2x2 blocks
against their plain versions and K1-K5, with the 2D solver on one NCCL
rank against the fused single-device solve, the packed split-colour
stage K42 against its plain version, the one-pass split stages K7, K8
and K10 against theirs at 9^3-513^3 (one launch a call), and the
one-pass rect stages K1, K2 and K4 against theirs at 9^3-513^3 (K1 also
at the smoother study's 50^3) and on hand plans (one launch a call),
the one-pass Dirichlet segment stages K31 and K40 against theirs on the
257^3 production segments and blocks (one launch a call at n_iter <= 2),
the segment restriction stages K30 and K39 against theirs on the
production segments and blocks at 9^3-513^3 and on hand plans, stitched
against K3, NaN-poisoned (one launch a call), K32 and K41 (the streaming
df residual-and-norm stage, its first form below 129^3) likewise, the
stage on every plan its planner weighs, K33's streaming residual stage
likewise at 9^3-513^3 on every rank of four and on one rank's block,
stitched against R, with its launcher's refusals,
the streaming restriction stages K3 and K9 against theirs at
9^3-513^3 on NaN-poisoned outputs and on hand plans (one launch a call),
and the one-pass fold stages K16, K17 and K19 against theirs at
9^3-513^3 and on hand plans, with the electrospray's pins and random
ones, on NaN-poisoned outputs (one launch a call; K16 on fields whose x
and y faces hold NaN), K18 on both of its forms at 9^3-513^3 and on hand
plans likewise, the one-pass full-layout
mixed stages K13, K14 and K15 likewise (K13 at 9^3-513^3, n_iter 1-3), the
one-pass segment stages K34 and K35 on every segment geometry at
9^3-257^3, and the one-pass msplit stages K22 and K24 on the split pair
likewise.

These need an NVIDIA GPU (a CUDA kernel has no CPU mode) and skip
themselves where there is none. The file imports no jax, so on a machine
with a card and without jax it runs on its own:

    python -m pytest --noconftest tests/test_torch_cuda.py -q
"""

import numpy as np
import pytest
import torch

import multigrid_parallel_tpu_torch as tmg
from multigrid_parallel_tpu_torch import cycles_padded as tcp
from multigrid_parallel_tpu_torch import cycles_split as tcs
from multigrid_parallel_tpu_torch import mixed_padded as tmp
from multigrid_parallel_tpu_torch.mixed_bc import MixedBCSolver
from multigrid_parallel_tpu_torch.ops import pallas3d as tpk
from multigrid_parallel_tpu_torch.ops import pallas_mixed as tpm
from multigrid_parallel_tpu_torch.ops import pallas_mixed_fold as tpmf
from multigrid_parallel_tpu_torch.ops import pallas_mixed_split as tpms
from multigrid_parallel_tpu_torch.ops import pallas_split as tps
from multigrid_parallel_tpu_torch.ops import pallas_splitcolor as tpsc

torch.set_num_threads(1)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels have no CPU mode)")
    return torch.device("cuda")


def _fields32(seed, n, dev):
    rng = np.random.default_rng(seed)
    return tuple(torch.from_numpy(rng.standard_normal((n, n, n)).astype(np.float32)).to(dev)
                 for _ in range(2))


def _df_state(seed, n, dev):
    h = 1.0 / (n - 1)
    c = np.arange(n) * h
    x, y, z = np.meshgrid(c, c, c, indexing="ij")
    rng = np.random.default_rng(seed)
    u64 = x * x - 2 * y * y + z * z + 1e-9 * rng.standard_normal((n, n, n))
    f64 = np.sin(x + y + z)
    return [t.to(dev) for x64 in (u64, f64)
            for t in tpk.df_split(torch.from_numpy(x64))]


@pytest.mark.cuda
@pytest.mark.parametrize("n", [17, 65])
def test_kernels_match_plain_on_card(cuda, n):
    h = 1.0 / (n - 1)
    u, f = _fields32(6, n, cuda)
    tpk.reset_launches()
    for n_iter in (1, 2, 3):
        for red_first in (True, False):
            want = tpk.rb_smooth_plain(u, f, h, n_iter, red_first)
            got = tpk.rb_smooth_fused(u.clone(), f, h, n_iter, red_first)
            assert torch.equal(got, want)
            assert torch.equal(tpk.rb_smooth_from_zero_fused(f, h, n_iter, red_first),
                               tpk.rb_smooth_from_zero_plain(f, h, n_iter, red_first))
    assert torch.equal(tpk.residual_fused(u, f, h), tpk.residual_plain(u, f, h))
    state = _df_state(7, n, cuda)
    r, nrm2 = tpk.residual_df_norm_fused(*state, h)
    r_ref, nrm2_ref = tpk.residual_df_norm_plain(*state, h)
    assert torch.equal(r, r_ref)
    assert float(nrm2) == pytest.approx(float(nrm2_ref), rel=1e-5)
    # K1 and K2: one one-pass launch per 2 iterations, (1 + 1 + 2) x 2 orders
    assert tpk.LAUNCHES == {**dict.fromkeys(tpk.KERNELS, 0),
                            "rb_smooth_fused": 8, "rb_smooth_from_zero_fused": 8,
                            "residual_fused": 1, "residual_df_norm_fused": 1}


@pytest.mark.cuda
@pytest.mark.parametrize("n", [17, 65])
def test_fused_kernels_match_plain_on_card(cuda, n):
    h = 1.0 / (n - 1)
    nc = (n + 1) // 2
    e, r = _fields32(8, n, cuda)
    ec = _fields32(9, nc, cuda)[0]
    tpk.reset_launches()
    # K3: the same operations in the same order (the plain version's
    # strided 3-taps), bit for bit
    got = tpk.residual_restrict_fused(e, r, h)
    assert got.shape == (nc, nc, nc)
    assert torch.equal(got, tpk.residual_restrict_plain(e, r, h))
    for n_iter in (1, 2):
        e0 = e.clone()
        got = tpk.prolong_smooth_fused(ec, e, r, h, n_iter)
        assert torch.equal(e, e0)  # fresh output, e untouched
        assert torch.equal(got, tpk.prolong_smooth_plain(ec, e, r, h, n_iter))
    u_hi, u_lo, f_hi, f_lo = _df_state(10, n, cuda)
    d = 1e-6 * e
    got = tpk.df_step_residual_norm_fused(u_hi, u_lo, d, f_hi, f_lo, h)
    want = tpk.df_step_residual_norm_plain(u_hi, u_lo, d, f_hi, f_lo, h)
    for g, w in zip(got[:3], want[:3]):
        assert torch.equal(g, w)
    assert float(got[3]) == pytest.approx(float(want[3]), rel=1e-5)
    # K5 on the updated pair gives K6's residual and norm bit for bit
    r5, nrm5 = tpk.residual_df_norm_fused(got[0], got[1], f_hi, f_lo, h)
    assert torch.equal(r5, got[2]) and float(nrm5) == float(got[3])
    # K4: one one-pass launch a call at n_iter = 1, 2
    assert tpk.LAUNCHES == {**dict.fromkeys(tpk.KERNELS, 0),
                            "residual_restrict_fused": 1, "prolong_smooth_fused": 1 + 1,
                            "df_step_residual_norm_fused": 1, "residual_df_norm_fused": 1}


def _rect_fields(seed, n, dev, count):
    """``count`` fields random at every point, the boundary too: what a
    stage keeps there must come from its input."""
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.standard_normal((n, n, n)).astype(np.float32)).to(dev)
            for _ in range(count)]


@pytest.mark.cuda
@pytest.mark.parametrize("n", [9, 16, 17, 33, 65, 129, 257, 513])
def test_rect_stages_match_plain_on_card(cuda, n):
    """The one-pass stages K2 and K4 bit for bit against their plain
    versions (9-129: the box schedule; 257, 513: the wavefront, 257 the main
    path's plan; 513: k tiles at n_iter 2; 16: an even size, K2 only),
    n_iter 1-3, both orders of K2, on fields random everywhere; one launch
    a call at n_iter <= 2, two at 3; fresh outputs, e, r and ec
    untouched."""
    h = 1.0 / (n - 1)
    e, r = _rect_fields(60 + n, n, cuda, 2)
    plan = tps._stage_plan(n, 2, tps._sms(torch.cuda.current_device()), rect=True)
    assert plan.box == (n <= tps.RECT_BOX_MAX_N) and (plan.k_halo > 0) == (n == 513)
    for n_iter in (1, 2, 3):
        calls = 1 if n_iter <= 2 else 2
        for red_first in (True, False):
            want = tpk.rb_smooth_from_zero_plain(r, h, n_iter, red_first)
            tpk.reset_launches()
            got = tpk.rb_smooth_from_zero_fused(r, h, n_iter, red_first)
            assert tpk.LAUNCHES == {**dict.fromkeys(tpk.KERNELS, 0),
                                    "rb_smooth_from_zero_fused": calls}
            assert torch.equal(got, want), (n_iter, red_first)
        if n % 2 == 0:
            continue
        ec = _rect_fields(61 + n, (n + 1) // 2, cuda, 1)[0]
        before = [x.clone() for x in (e, r, ec)]
        want = tpk.prolong_smooth_plain(ec, e, r, h, n_iter)
        tpk.reset_launches()
        got = tpk.prolong_smooth_fused(ec, e, r, h, n_iter)
        assert tpk.LAUNCHES == {**dict.fromkeys(tpk.KERNELS, 0), "prolong_smooth_fused": calls}
        torch.cuda.synchronize()
        assert all(torch.equal(a, b) for a, b in zip((e, r, ec), before))
        assert got.data_ptr() not in {x.data_ptr() for x in (e, r, ec)}
        assert torch.equal(got, want), n_iter


@pytest.mark.cuda
@pytest.mark.parametrize("n", [9, 17, 33, 50, 65, 129, 257, 513])
def test_k1_stage_matches_plain_on_card(cuda, n):
    """The one-pass stage K1 bit for bit against its plain version (9-129:
    the box schedule, 50 the smoother study's even size; 257, 513: the
    wavefront, 513 with k tiles at n_iter 2), n_iter 1-3, both orders, on u
    random at every point, its boundary included, which comes through
    unchanged; u left as it is, a fresh output; one launch a call at n_iter
    <= 2, two at 3; and K1's per-sweep form likewise, 2 n_iter launches
    counted apart."""
    h = 1.0 / (n - 1)
    u, f = _rect_fields(80 + n, n, cuda, 2)
    u0 = u.clone()
    for n_iter in (1, 2, 3):
        calls = 1 if n_iter <= 2 else 2
        for red_first in (True, False):
            want = tpk.rb_smooth_plain(u, f, h, n_iter, red_first)
            tpk.reset_launches()
            got = tpk.rb_smooth_fused(u, f, h, n_iter, red_first)
            assert tpk.LAUNCHES == {**dict.fromkeys(tpk.KERNELS, 0), "rb_smooth_fused": calls}
            torch.cuda.synchronize()
            assert torch.equal(u, u0) and got.data_ptr() not in (u.data_ptr(), f.data_ptr())
            assert torch.equal(got, want), (n_iter, red_first)
            mine = u.clone()
            assert tpk.rb_smooth_fused_per_sweep(mine, f, h, n_iter, red_first) is mine
            assert tpk.PER_SWEEP_LAUNCHES == {"rb_smooth_fused_per_sweep": 2 * n_iter}
            assert tpk.LAUNCHES["rb_smooth_fused"] == calls
            assert torch.equal(mine, want), (n_iter, red_first)


def _rect_stage_on_plan(plan, f, h, red_first=True, u=None, ec=None):
    """One launch of the K2 stage (on u, or from zero) or, given ec, of the
    K4 one (u is e) on a plan of the caller's, into a fresh field."""
    out = torch.empty_like(f)
    args = (plan.n_iter, plan.bi, plan.bj, plan.bk, plan.k_halo, plan.threads, plan.smem,
            int(plan.box), tpk._stream())
    lib = tpk._lib()
    if ec is None:
        err = lib.mg_rect_stage(out.data_ptr(), None if u is None else u.data_ptr(),
                                f.data_ptr(), plan.n, h * h, int(red_first), *args)
    else:
        err = lib.mg_rect_prolong_stage(out.data_ptr(), ec.data_ptr(), u.data_ptr(),
                                        f.data_ptr(), plan.n, h * h, *args)
    assert err == 0
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("box", [False, True], ids=["wave", "box"])
@pytest.mark.parametrize("bk", [0, 4, 12])
@pytest.mark.parametrize("n", [11, 33, 35])
def test_rect_stages_on_hand_plans_on_card(cuda, n, bk, box):
    """K2's stage (from zero and on an initial guess) and K4's on plans of
    8 rows by 9 planes a block, on the wavefront and on the box: whole rows
    (bk = 0; n = 11 and 35: a row's n // 2 slots not a multiple of 4) and k
    tiles of 4 or 12 slots with the 4-slot k halo (12 leaves a short last
    tile), on fields random everywhere: bit for bit against the plain
    versions; a plan whose shared memory is not the kernel's is refused."""
    h = 1.0 / (n - 1)
    s = n // 2
    if bk >= s:
        pytest.skip("a k tile as wide as the row is the whole-row plan")
    e, r = _rect_fields(70 + n + bk, n, cuda, 2)
    ec = _rect_fields(71 + n, (n + 1) // 2, cuda, 1)[0]
    for n_iter in (1, 2):
        halo, k_halo = 2 * n_iter, tps.STAGE_K_HALO if bk else 0
        width = tps._stage_width(n, bk or s, k_halo, rect=True)
        box_bi = 9 if box else 0
        plan = tps.StagePlan(n, n_iter, halo, k_halo, 9, 8, bk or s, 32 * (8 + 2 * halo),
                             tps._stage_smem(n_iter, 8, width, rect=True, box_bi=box_bi), True,
                             box)
        assert plan.tiles[2] == (-(-s // bk) if bk else 1)
        for red_first in (True, False):
            got = _rect_stage_on_plan(plan, r, h, red_first)
            assert torch.equal(got, tpk.rb_smooth_from_zero_plain(r, h, n_iter, red_first))
            got = _rect_stage_on_plan(plan, r, h, red_first, u=e)
            assert torch.equal(got, tpk.rb_smooth_plain(e, r, h, n_iter, red_first))
        k4 = plan._replace(smem=tps._stage_smem(n_iter, 8, width, prolong=True, rect=True,
                                                box_bi=box_bi))
        got = _rect_stage_on_plan(k4, r, h, u=e, ec=ec)
        assert torch.equal(got, tpk.prolong_smooth_plain(ec, e, r, h, n_iter)), n_iter
        bad = plan._replace(smem=plan.smem + 16)
        with pytest.raises(AssertionError):
            _rect_stage_on_plan(bad, r, h)


@pytest.mark.cuda
def test_wrappers_reject_what_the_kernels_do_not_take(cuda):
    f = torch.zeros((9, 9, 9), device=cuda)
    with pytest.raises(TypeError):
        tpk.residual_fused(f.double(), f.double(), 0.125)
    with pytest.raises(ValueError):
        tpk.residual_fused(f[:, :, :8], f[:, :, :8], 0.125)
    with pytest.raises(ValueError):
        tpk.residual_fused(f.transpose(0, 2), f, 0.125)


@pytest.mark.cuda
@pytest.mark.parametrize("fused", [True, False], ids=["fused", "unfused"])
def test_df_solve_on_card_matches_cpu(cuda, fused):
    hier = tmg.Hierarchy(ndim=3, coarse_n=5, num_levels=4)  # 33^3
    prob = tmg.poisson_3d_quadratic()
    init = tcp.ref_init_norm(prob, hier)
    out = {}
    for dev in ("cpu", cuda):
        run = tcp.make_on_device_df_solver(hier, tmg.CycleConfig(), inner_cycles=4,
                                           init_norm=init, device=dev, fused=fused)
        u_hi, u_lo, nrm, it = run(*tcp.setup_df_problem(prob, hier, dev))
        assert float(nrm) <= 1e-8 * init
        out[str(dev)] = (tpk.df_to_f64(u_hi, u_lo).cpu(), it)
    assert out["cpu"][1] == out["cuda"][1]
    assert float((out["cpu"][0] - out["cuda"][0]).abs().max()) <= 1e-8


@pytest.mark.cuda
def test_fused_df_solve_65_on_card(cuda):
    hier = tmg.Hierarchy(ndim=3, coarse_n=5, num_levels=5)  # 65^3
    prob = tmg.poisson_3d_quadratic()
    init = tcp.ref_init_norm(prob, hier)
    out = {}
    for fused in (True, False):
        run = tcp.make_on_device_df_solver(hier, tmg.CycleConfig(), inner_cycles=4,
                                           init_norm=init, device=cuda, fused=fused)
        tpk.reset_launches()
        u_hi, u_lo, nrm, it = run(*tcp.setup_df_problem(prob, hier, cuda))
        assert float(nrm) <= 1e-8 * init and 1 <= it <= 10
        out[fused] = (tpk.df_to_f64(u_hi, u_lo), it, dict(tpk.LAUNCHES))
    launches = out[True][2]
    assert launches["residual_fused"] == 0 and launches["rb_smooth_fused"] > 0
    assert min(launches[k] for k in ("residual_restrict_fused", "prolong_smooth_fused",
                                     "df_step_residual_norm_fused")) > 0
    assert out[False][2]["residual_restrict_fused"] == 0
    assert out[True][1] == out[False][1]
    assert float((out[True][0] - out[False][0]).abs().max()) <= 1e-8


def _split_pairs(seed, n, dev, count):
    """``count`` random split pairs packed from zero-boundary cubes, so
    their dead slots and boundary rows are 0 (the pair invariant)."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(count):
        x = np.zeros((n, n, n), np.float32)
        x[1:-1, 1:-1, 1:-1] = rng.standard_normal((n - 2,) * 3)
        out.append(tuple(t.to(dev) for t in tps.pack_split(torch.from_numpy(x))))
    return out


@pytest.mark.cuda
def test_split_kernels_match_plain_on_card(cuda):
    n = 65
    h = 1.0 / (n - 1)
    e, r = _split_pairs(11, n, cuda, 2)
    ec = _fields32(12, (n + 1) // 2, cuda)[0]
    tps.reset_launches()
    for n_iter in (1, 2):
        for red_first in (True, False):
            want = tps.rb_smooth_split_plain(*e, *r, h, n_iter, red_first)
            got = tps.rb_smooth_split(e[0].clone(), e[1].clone(), *r, h, n_iter, red_first)
            assert all(torch.equal(g, w) for g, w in zip(got, want))
            want = tps.rb_smooth_split_from_zero_plain(*r, h, n_iter, red_first)
            got = tps.rb_smooth_split_from_zero(*r, h, n_iter, red_first)
            assert all(torch.equal(g, w) for g, w in zip(got, want))
        e0 = tuple(x.clone() for x in e)
        got = tps.prolong_smooth_split(ec, *e, *r, h, n_iter)
        assert all(torch.equal(a, b) for a, b in zip(e, e0))  # fresh pair, e untouched
        want = tps.prolong_smooth_split_plain(ec, *e, *r, h, n_iter)
        assert all(torch.equal(g, w) for g, w in zip(got, want))
    got = tps.residual_restrict_split(*e, *r, h)
    assert got.shape == ((n + 1) // 2,) * 3
    assert torch.equal(got, tps.residual_restrict_split_plain(*e, *r, h))
    # a double-float state near a solution, packed, and a small correction
    u_hi, u_lo, f_hi, f_lo = (tps.pack_split(x) for x in _df_state(13, n, cuda))
    d = tuple(1e-6 * x for x in e)
    got = tps.residual_df_norm_split(*u_hi, *u_lo, *f_hi, *f_lo, h)
    want = tps.residual_df_norm_split_plain(*u_hi, *u_lo, *f_hi, *f_lo, h)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert float(got[2]) == pytest.approx(float(want[2]), rel=1e-5)
    got = tps.df_step_split(*u_hi, *u_lo, *d, *f_hi, *f_lo, h)
    want = tps.df_step_split_plain(*u_hi, *u_lo, *d, *f_hi, *f_lo, h)
    assert all(torch.equal(g, w) for g, w in zip(got[:6], want[:6]))
    assert float(got[6]) == pytest.approx(float(want[6]), rel=1e-5)
    # K12 on the updated pair gives K11's residual and norm bit for bit
    r12 = tps.residual_df_norm_split(*got[:4], *f_hi, *f_lo, h)
    assert torch.equal(r12[0], got[4]) and torch.equal(r12[1], got[5])
    assert float(r12[2]) == float(got[6])
    # K7, K8 and K10 one launch a call at n_iter <= 2 (orders x n_iter = 1,
    # 2 and n_iter = 1, 2)
    assert tps.LAUNCHES == {"rb_smooth_split": 4, "rb_smooth_split_from_zero": 4,
                            "residual_restrict_split": 1, "prolong_smooth_split": 2,
                            "df_step_split": 1, "residual_df_norm_split": 2}


def _random_pairs(seed, n, dev, count):
    """``count`` split pairs random at every slot, boundary rows and dead
    slots too: what a stage keeps there must come from its input."""
    rng = np.random.default_rng(seed)
    shape = tps.split_shape(n)
    return [tuple(torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(dev)
                  for _ in range(2)) for _ in range(count)]


@pytest.mark.cuda
@pytest.mark.parametrize("data", ["invariant", "random"])
@pytest.mark.parametrize("n", [9, 11, 17, 33, 65, 257, 513])
def test_split_stages_match_plain_on_card(cuda, n, data):
    """The one-pass stages K7 and K10 bit for bit against their plain
    versions (n = 11: 5 slots a row, the 4-byte copy path; 257: the main
    path's plan; 513: k tiles at n_iter 2), n_iter 1-3, both orders of K7,
    on pairs that keep the pair invariant and on pairs random everywhere;
    one launch a call at n_iter <= 2, two at 3; and K7's per-sweep form
    likewise, 2 n_iter launches counted apart."""
    h = 1.0 / (n - 1)
    e, r = (_split_pairs if data == "invariant" else _random_pairs)(20 + n, n, cuda, 2)
    ec = _fields32(21 + n, (n + 1) // 2, cuda)[0]
    if n == 513:
        assert tps._stage_plan(n, 2, tps._sms(torch.cuda.current_device())).k_halo > 0
    for n_iter in (1, 2, 3):
        calls = 1 if n_iter <= 2 else 2
        for red_first in (True, False):
            want = tps.rb_smooth_split_plain(*e, *r, h, n_iter, red_first)
            tps.reset_launches()
            got = tps.rb_smooth_split(*e, *r, h, n_iter, red_first)
            assert tps.LAUNCHES["rb_smooth_split"] == calls
            assert _bitwise_pair(got, want), (n_iter, red_first)
            mine = tuple(x.clone() for x in e)
            tps.rb_smooth_split_per_sweep(*mine, *r, h, n_iter, red_first)
            assert tps.PER_SWEEP_LAUNCHES["rb_smooth_split_per_sweep"] == 2 * n_iter
            assert tps.LAUNCHES["rb_smooth_split"] == calls
            assert _bitwise_pair(mine, want), (n_iter, red_first)
        want = tps.prolong_smooth_split_plain(ec, *e, *r, h, n_iter)
        tps.reset_launches()
        got = tps.prolong_smooth_split(ec, *e, *r, h, n_iter)
        assert tps.LAUNCHES["prolong_smooth_split"] == calls
        assert tps.LAUNCHES["rb_smooth_split"] == 0
        assert _bitwise_pair(got, want), n_iter


@pytest.mark.cuda
@pytest.mark.parametrize("n", [9, 11, 17, 33, 65, 129, 257, 513])
def test_k8_stage_matches_plain_on_card(cuda, n):
    """The one-pass stage K8 bit for bit against its plain version at every
    slot, dead slots and boundary rows included (n = 11: 5 slots a row, the
    4-byte zero fill; 257: the main path's plan; 513: k tiles at n_iter
    2), n_iter 1-3, both orders, on f random at every slot, the allocator
    poisoned with NaN first, so that a slot left unwritten shows; one launch
    a call at n_iter <= 2, two at 3, and no K7 launch counted."""
    h = 1.0 / (n - 1)
    (f,) = _random_pairs(30 + n, n, cuda, 1)
    for n_iter in (1, 2, 3):
        calls = 1 if n_iter <= 2 else 2
        for red_first in (True, False):
            want = tps.rb_smooth_split_from_zero_plain(*f, h, n_iter, red_first)
            poison = [torch.full(tps.split_shape(n), float("nan"), device=cuda)
                      for _ in range(8)]
            del poison  # back to the caching allocator, NaN inside
            tps.reset_launches()
            got = tps.rb_smooth_split_from_zero(*f, h, n_iter, red_first)
            assert tps.LAUNCHES == {**dict.fromkeys(tps.KERNELS, 0),
                                    "rb_smooth_split_from_zero": calls}
            assert _bitwise_pair(got, want), (n_iter, red_first)


def _poison_allocator(shape, dev, count=8):
    """Fill the caching allocator's free blocks of ``shape`` with NaN, so
    that an output point left unwritten shows."""
    poison = [torch.full(shape, float("nan"), device=dev) for _ in range(count)]
    del poison


def _same_with_nan(got, want):
    """Bit for bit where finite, and NaN at the same points."""
    return (torch.equal(got.isnan(), want.isnan())
            and torch.equal(got.nan_to_num(), want.nan_to_num()))


RESTRICT_SIZES = [9, 17, 33, 65, 129, 257, 513]


@pytest.mark.cuda
@pytest.mark.parametrize("n", RESTRICT_SIZES)
def test_k3_restrict_matches_plain_on_card(cuda, n):
    """The streaming restriction stage K3 bit for bit against
    ``residual_restrict_plain`` at every coarse point (257: the fused
    path's finest level), on e and r random at every point, faces
    included, at h = 1 / (n - 1) and at the electrospray's h = 3e-4 / (n -
    1), the allocator poisoned with NaN first; exactly one launch a call;
    the inputs unchanged."""
    nc = (n + 1) // 2
    e, r = _rect_fields(90 + n, n, cuda, 2)
    before = [x.clone() for x in (e, r)]
    for h in (1.0 / (n - 1), 3e-4 / (n - 1)):
        want = tpk.residual_restrict_plain(e, r, h)
        _poison_allocator((nc, nc, nc), cuda)
        tpk.reset_launches()
        got = tpk.residual_restrict_fused(e, r, h)
        assert tpk.LAUNCHES == {**dict.fromkeys(tpk.KERNELS, 0), "residual_restrict_fused": 1}
        assert torch.equal(got, want), h
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip((e, r), before))


@pytest.mark.cuda
@pytest.mark.parametrize("n", RESTRICT_SIZES)
def test_k9_restrict_matches_plain_on_card(cuda, n):
    """The streaming restriction stage K9 bit for bit against
    ``residual_restrict_split_plain`` at every coarse point (257: the split
    path's finest level), on pairs random at every slot, boundary rows
    included, with NaN in r's dead slots (no residual reads them), the
    allocator poisoned with NaN first; then with NaN in e's dead slots too
    (the k = n - 1 face its last odd slot reads): NaN at the same coarse
    points and every other bit for bit; exactly one launch a call; the
    inputs unchanged."""
    h = 1.0 / (n - 1)
    nc = (n + 1) // 2
    e, r = _random_pairs(95 + n, n, cuda, 2)
    _, live_r, live_b = tps._masks(n, cuda)
    idx = torch.arange(n, device=cuda)
    inner = (idx >= 1) & (idx <= n - 2)
    dead = [(inner[:, None, None] & inner[None, :, None]) & ~live for live in (live_r, live_b)]
    for x, d in zip(r, dead):
        x[d] = float("nan")
    for nan_e in (False, True):
        if nan_e:
            for x, d in zip(e, dead):
                x[d] = float("nan")
        before = [x.clone() for x in (*e, *r)]
        want = tps.residual_restrict_split_plain(*e, *r, h)
        assert bool(want.isnan().any()) == nan_e
        _poison_allocator((nc, nc, nc), cuda)
        tps.reset_launches()
        got = tps.residual_restrict_split(*e, *r, h)
        assert tps.LAUNCHES == {**dict.fromkeys(tps.KERNELS, 0), "residual_restrict_split": 1}
        if nan_e:
            assert _same_with_nan(got, want)
        else:
            assert torch.equal(got, want)
        torch.cuda.synchronize()
        assert all(_same_with_nan(a, b) for a, b in zip((*e, *r), before))


@pytest.mark.cuda
@pytest.mark.parametrize("split", [False, True], ids=["k3", "k9"])
@pytest.mark.parametrize("n", [17, 33, 35])
def test_restrict_on_hand_plans_on_card(cuda, n, split):
    """K3 and K9 on plans of the caller's: several
    blocks in i and j, whole k rows and k tiles (35: K9's rows of 17
    slots, 4-byte copies; 33: tiles of 4 slots, the 16-byte windows, and
    of 2, the exact ones); bit for bit against the plain versions."""
    h = 1.0 / (n - 1)
    nc = (n + 1) // 2
    m = nc - 2
    if split:
        e, r = _random_pairs(110 + n, n, cuda, 2)
        want = tps.residual_restrict_split_plain(*e, *r, h)
    else:
        e, r = ((x,) for x in _rect_fields(111 + n, n, cuda, 2))
        want = tpk.residual_restrict_plain(*e, *r, h)
    lib = tps._lib()
    fn = lib.mg_split_residual_restrict if split else lib.mg_residual_restrict
    for bci, bcj, bck in ((2, 3, m), (3, 2, 2), (5, min(m, 8), 4), (m, 1, 3)):
        plan = tps.RestrictPlan(n, split, bci, bcj, bck, tps._restrict_chunks(bck, split),
                                32 * (2 * bcj + 1), tps._restrict_smem(bcj, bck, split))
        _poison_allocator((nc, nc, nc), cuda)
        out = torch.empty((nc, nc, nc), device=cuda)
        ptrs = [x.data_ptr() for x in (out, *e, *r)]
        assert fn(*ptrs, n, 1.0 / (h * h), *plan.args, tps._stream()) == 0
        assert torch.equal(out, want), plan
    # a plan the kernels do not take is refused, not run
    bad = (1, 9, 1, 1, 32 * 19, tps._restrict_smem(9, 1, split))
    assert fn(*ptrs, n, 1.0 / (h * h), *bad, tps._stream()) != 0


def _stage_on_plan(plan, e, r, h, red_first=False, ec=None):
    """One launch of the K7 stage (K8's where e is None; given ec, the K10
    one) on a plan of the caller's, into a fresh pair."""
    out = [torch.empty_like(x) for x in r]
    ptrs = [x.data_ptr() for x in (*out, *(() if ec is None else (ec,)), *(e or ()), *r)]
    args = (plan.n_iter, plan.bi, plan.bj, plan.bk, plan.k_halo, plan.threads, plan.smem,
            tps._stream())
    lib = tps._lib()
    if e is None:
        err = lib.mg_split_stage_from_zero(*ptrs, plan.n, h * h, int(red_first), *args)
    elif ec is None:
        err = lib.mg_split_stage(*ptrs, plan.n, h * h, int(red_first), *args)
    else:
        err = lib.mg_split_prolong_stage(*ptrs, plan.n, h * h, *args)
    assert err == 0
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("bk", [4, 12])
@pytest.mark.parametrize("n", [33, 35])
def test_split_stages_on_k_tiles_on_card(cuda, n, bk):
    """K7, K8 and K10 on plans that tile k (4-slot k halo; n = 33: 16 slots
    a row, 16-byte copies, region edges inside a 4-slot group; 35: 17
    slots, 4-byte copies; bk = 12 leaves a short last tile), 8 rows by 9
    planes a block, on pairs random everywhere: bit for bit against the
    plain versions."""
    h = 1.0 / (n - 1)
    s = tps.split_shape(n)[2]
    e, r = _random_pairs(40 + n + bk, n, cuda, 2)
    ec = _fields32(41 + n, (n + 1) // 2, cuda)[0]
    for n_iter in (1, 2):
        halo = 2 * n_iter
        width = bk + 2 * tps.STAGE_K_HALO
        plan = tps.StagePlan(n, n_iter, halo, tps.STAGE_K_HALO, 9, 8, bk, 32 * (8 + 2 * halo),
                             tps._stage_smem(n_iter, 8, width))
        assert plan.tiles[2] == -(-s // bk) > 1
        for red_first in (True, False):
            got = _stage_on_plan(plan, e, r, h, red_first)
            want = tps.rb_smooth_split_plain(*e, *r, h, n_iter, red_first)
            assert _bitwise_pair(got, want), (n_iter, red_first)
            got = _stage_on_plan(plan, None, r, h, red_first)
            want = tps.rb_smooth_split_from_zero_plain(*r, h, n_iter, red_first)
            assert _bitwise_pair(got, want), (n_iter, red_first)
        plan = plan._replace(smem=tps._stage_smem(n_iter, 8, width, prolong=True))
        got = _stage_on_plan(plan, e, r, h, ec=ec)
        assert _bitwise_pair(got, tps.prolong_smooth_split_plain(ec, *e, *r, h, n_iter)), n_iter


@pytest.mark.cuda
def test_split_stage_leaves_its_inputs_untouched(cuda):
    """K7 returns a fresh pair: its inputs (and K10's) are as they were."""
    n = 33
    h = 1.0 / (n - 1)
    e, r = _split_pairs(22, n, cuda, 2)
    ec = _fields32(23, (n + 1) // 2, cuda)[0]
    before = [x.clone() for x in (*e, *r, ec)]
    got = tps.rb_smooth_split(*e, *r, h, 2, True)
    got10 = tps.prolong_smooth_split(ec, *e, *r, h, 2)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip((*e, *r, ec), before))
    assert all(g.data_ptr() not in {x.data_ptr() for x in (*e, *r)} for g in (*got, *got10))
    assert not _bitwise_pair(got, e)


def _bitwise_pair(got, want):
    return all(torch.equal(g, w) for g, w in zip(got, want))


@pytest.mark.cuda
def test_split_wrappers_reject_what_the_kernels_do_not_take(cuda):
    e, r = _split_pairs(14, 9, cuda, 1)[0]
    with pytest.raises(TypeError):
        tps.rb_smooth_split_from_zero(e.double(), r.double(), 0.125, 1)
    with pytest.raises(ValueError):
        tps.rb_smooth_split_from_zero(e.transpose(0, 1), r, 0.125, 1)


@pytest.mark.cuda
def test_splitcolor_kernel_matches_plain_on_card(cuda):
    """K42 on packed arrays (pairs of zero-boundary cubes joined along j),
    into a fresh array, u2 left as it is, bitwise equal to its plain
    version; one launch a call at n_iter <= 2."""
    n = 65
    h = 1.0 / (n - 1)
    u2, f2 = (torch.cat(pair, dim=1) for pair in _split_pairs(16, n, cuda, 2))
    u0 = u2.clone()
    tpsc.reset_launches()
    for n_iter in (1, 2):
        for red_first in (True, False):
            want = tpsc.rb_smooth_split_fused_plain(u2, f2, h, n_iter, red_first)
            before = tpsc.LAUNCHES["rb_smooth_split_fused"]
            got = tpsc.rb_smooth_split_fused(u2, f2, h, n_iter, n, red_first)
            assert got is not u2
            assert tpsc.LAUNCHES["rb_smooth_split_fused"] - before == 1
            torch.cuda.synchronize()
            assert torch.equal(u2, u0) and torch.equal(got, want), (n_iter, red_first)
    assert tpsc.LAUNCHES == {"rb_smooth_split_fused": 4}


def _packed_random(seed, n, dev):
    """Packed (n, 2 n, S) arrays of u and f random at every slot, dead
    slots and boundary rows too: what the stage keeps there must come from
    its input."""
    rng = np.random.default_rng(seed)
    shape = tpsc.split_shape(n)
    return [torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(dev)
            for _ in range(2)]


@pytest.mark.cuda
@pytest.mark.parametrize("n", [9, 17, 33, 65, 129, 257, 513])
def test_k42_stage_matches_plain_on_card(cuda, n):
    """K42's one-pass stage (K7's on the packed array, K7's plan: whole rows,
    k tiles at 513^3) bit for bit against its plain version, n_iter 1-3,
    both orders, on arrays random at every slot, the allocator poisoned with
    NaN first; u2 and f2 left as they are; one launch a call at n_iter <= 2,
    two at 3; its per-sweep form likewise, 2 n_iter launches counted
    apart."""
    h = 1.0 / (n - 1)
    u2, f2 = _packed_random(90 + n, n, cuda)
    before = (u2.clone(), f2.clone())
    for n_iter in (1, 2, 3):
        for red_first in (True, False):
            want = tpsc.rb_smooth_split_fused_plain(u2, f2, h, n_iter, red_first)
            _poison_allocator(u2.shape, cuda)
            tpsc.reset_launches()
            got = tpsc.rb_smooth_split_fused(u2, f2, h, n_iter, n, red_first)
            assert tpsc.LAUNCHES == {"rb_smooth_split_fused": 1 if n_iter <= 2 else 2}
            torch.cuda.synchronize()
            assert torch.equal(u2, before[0]) and torch.equal(f2, before[1])
            assert torch.equal(got, want), (n_iter, red_first)
            mine = u2.clone()
            assert tpsc.rb_smooth_split_fused_per_sweep(mine, f2, h, n_iter, n, red_first) is mine
            assert tpsc.PER_SWEEP_LAUNCHES == {"rb_smooth_split_fused_per_sweep": 2 * n_iter}
            assert torch.equal(mine, want), (n_iter, red_first)


@pytest.mark.cuda
def test_k42_launcher_rejects_what_the_stage_does_not_run(cuda):
    """mg_splitcolor_stage refuses a plan of 3 iterations, shared memory
    other than the plan's, and an output that meets u2 or f2; the planner's
    own plan runs."""
    n = 33
    h2 = (1.0 / (n - 1)) ** 2
    u2, f2 = _packed_random(7, n, cuda)
    out = torch.empty_like(u2)
    lib = tpk._lib()
    plan = list(tps._plan_args(n, 2, u2.device))

    def run(dst, args):
        return lib.mg_splitcolor_stage(dst.data_ptr(), u2.data_ptr(), f2.data_ptr(), n, h2, 1,
                                       *args, tpk._stream())

    assert run(out, plan) == 0
    assert run(out, [3] + plan[1:]) != 0
    assert run(out, plan[:-1] + [plan[-1] + 16]) != 0
    assert run(u2, plan) != 0 and run(f2, plan) != 0
    torch.cuda.synchronize()
    assert torch.equal(out, tpsc.rb_smooth_split_fused_plain(u2, f2, 1.0 / (n - 1), 2, True))


@pytest.mark.cuda
def test_splitcolor_wrapper_rejects_what_the_kernel_does_not_take(cuda):
    n = 9
    u2, f2 = (torch.cat(pair, dim=1) for pair in _split_pairs(17, n, cuda, 2))
    with pytest.raises(TypeError, match="float32"):
        tpsc.rb_smooth_split_fused(u2.double(), f2.double(), 0.125, 1, n)
    strided = u2.permute(2, 1, 0).contiguous().permute(2, 1, 0)  # the shape, not the strides
    with pytest.raises(ValueError, match="contiguous"):
        tpsc.rb_smooth_split_fused(strided, f2, 0.125, 1, n)


@pytest.mark.cuda
def test_split_solve_65_on_card_matches_fused(cuda):
    hier = tmg.Hierarchy(ndim=3, coarse_n=5, num_levels=5)  # 65^3
    prob = tmg.poisson_3d_quadratic()
    init = tcp.ref_init_norm(prob, hier)
    tpk.reset_launches()
    tps.reset_launches()
    run = tcs.make_split_df_solver(hier, tmg.CycleConfig(), inner_cycles=4, init_norm=init,
                                   device=cuda)
    hr, hb, lr, lb, nrm, it = run(*tcs.setup_split_df_problem(prob, hier, cuda))
    assert float(nrm) <= 1e-8 * init and 1 <= it <= 10
    assert min(tps.LAUNCHES.values()) > 0
    assert tpk.LAUNCHES["residual_fused"] == tpk.LAUNCHES["residual_df_norm_fused"] == 0
    assert tpk.LAUNCHES["df_step_residual_norm_fused"] == 0
    # the rect levels are entered from a zero correction: K2, K3, K4, no K1
    # launch
    assert tpk.LAUNCHES["rb_smooth_fused"] == 0
    assert min(tpk.LAUNCHES[k] for k in ("rb_smooth_from_zero_fused",
                                         "residual_restrict_fused",
                                         "prolong_smooth_fused")) > 0
    u = tcs.unsplit_solution(hr, hb, lr, lb, prob, hier)
    run = tcp.make_on_device_df_solver(hier, tmg.CycleConfig(), inner_cycles=4,
                                       init_norm=init, device=cuda)
    u_hi, u_lo, _, it_rect = run(*tcp.setup_df_problem(prob, hier, cuda))
    assert it == it_rect
    assert float((u - tpk.df_to_f64(u_hi, u_lo)).abs().max()) <= 1e-8


def _electrospray_pins(n, dev):
    return tpm.dirichlet_pin_planes(tmg.electrospray_problem(), n, dev)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [17, 65])
def test_mixed_kernels_match_plain_on_card(cuda, n):
    """K13-K15 at the electrospray's non-dyadic h, with its pin planes and
    a random x-face mask, on BC-consistent corrections (where the
    kernels' folded reads equal the plain copy form bit for bit)."""
    h = 3e-4 / (n - 1)
    e, r = _fields32(15, n, cuda)
    ec = _fields32(16, (n + 1) // 2, cuda)[0]  # live coarse boundary
    r = torch.where(_interior(n, cuda), r, torch.zeros_like(r))
    rng = np.random.default_rng(17)
    random_pin = torch.from_numpy((rng.random((2, n, n)) < 0.3).astype(np.float32)).to(cuda)
    tpm.reset_launches()
    for pin in (_electrospray_pins(n, cuda), random_pin):
        e_bc = tpm.apply_bcs_padded(e, pin)
        for n_iter in (1, 2):
            for red_first in (True, False):
                want = tpm.mixed_rb_smooth_plain(e_bc, r, pin, h, n_iter, red_first)
                e0 = e_bc.clone()
                got = tpm.mixed_rb_smooth_fused(e_bc, r, pin, h, n_iter, red_first)
                assert torch.equal(got, want) and torch.equal(e_bc, e0)  # fresh, e untouched
            assert torch.equal(tpm.mixed_rb_smooth_from_zero_fused(r, pin, h, n_iter),
                               tpm.mixed_rb_smooth_from_zero_plain(r, pin, h, n_iter))
            e0 = e.clone()
            got = tpm.mixed_prolong_smooth_fused(ec, e, r, pin, h, n_iter)
            assert torch.equal(e, e0)  # fresh output, e untouched
            assert torch.equal(got, tpm.mixed_prolong_smooth_plain(ec, e, r, pin, h, n_iter))
    # per pin, n_iter 1 and 2: K13 2 orders, K14 and K15 one call; one launch
    # a call (one-pass stages)
    assert tpm.LAUNCHES == {**dict.fromkeys(tpm.KERNELS, 0),
                            "mixed_rb_smooth_fused": 2 * 2 * 2,
                            "mixed_rb_smooth_from_zero_fused": 2 * 2,
                            "mixed_prolong_smooth_fused": 2 * 2}


def _mixed_pins(kind, n, dev, rng):
    """(2, n, n) pin planes: the electrospray's, or a random patch mask
    whose k = 0 and n - 1 columns pin nodes too."""
    if kind == "electrospray":
        return _electrospray_pins(n, dev)
    pin = torch.from_numpy((rng.random((2, n, n)) < 0.3).astype(np.float32)).to(dev)
    assert bool(pin[:, :, 0].any()) and bool(pin[:, :, n - 1].any())
    return pin


def _cubes(rng, n, dev, count):
    """``count`` fields random at every point, the boundary too: the
    stages must neither read nor keep it."""
    return [torch.from_numpy(rng.standard_normal((n, n, n)).astype(np.float32)).to(dev)
            for _ in range(count)]


@pytest.mark.cuda
@pytest.mark.parametrize("n", [9, 17, 33, 65, 129, 257, 513])
def test_k14_k15_stages_match_plain_on_card(cuda, n):
    """The one-pass full-layout mixed stages K14 and K15 bit for bit
    against their plain versions (9-129: the box schedule; 257, 513: the
    wavefront, 257 the main path's plan, 513 with k tiles at n_iter 2),
    n_iter 1-3, both orders of K14, with the electrospray's pins and random
    ones (k-face columns too), on fields and a coarse correction random at
    every point (K15's coarse boundary live) and the allocator poisoned
    with NaN first, so that a point left unwritten shows; one launch a call
    at n_iter <= 2, two at 3, and no other kernel counted; fresh outputs,
    the inputs left as they were."""
    h = 3e-4 / (n - 1)
    rng = np.random.default_rng(190 + n)
    e, r = _cubes(rng, n, cuda, 2)
    ec = _cubes(rng, (n + 1) // 2, cuda, 1)[0]
    plan = tps._stage_plan(n, 2, tps._sms(torch.cuda.current_device()), rect=True)
    assert plan.box == (n <= tps.RECT_BOX_MAX_N) and (plan.k_halo > 0) == (n == 513)
    for kind in ("electrospray", "random"):
        pin = _mixed_pins(kind, n, cuda, rng)
        before = [x.clone() for x in (e, r, ec, pin)]
        for n_iter in (1, 2, 3):
            calls = 1 if n_iter <= 2 else 2
            for red_first in (True, False):
                want = tpm.mixed_rb_smooth_from_zero_plain(r, pin, h, n_iter, red_first)
                _poison_allocator((n, n, n), cuda)
                tpm.reset_launches()
                got = tpm.mixed_rb_smooth_from_zero_fused(r, pin, h, n_iter, red_first)
                assert tpm.LAUNCHES == {**dict.fromkeys(tpm.KERNELS, 0),
                                        "mixed_rb_smooth_from_zero_fused": calls}
                assert torch.equal(got, want), (kind, n_iter, red_first)
            want = tpm.mixed_prolong_smooth_plain(ec, e, r, pin, h, n_iter)
            _poison_allocator((n, n, n), cuda)
            tpm.reset_launches()
            got = tpm.mixed_prolong_smooth_fused(ec, e, r, pin, h, n_iter)
            assert tpm.LAUNCHES == {**dict.fromkeys(tpm.KERNELS, 0),
                                    "mixed_prolong_smooth_fused": calls}
            torch.cuda.synchronize()
            assert got.data_ptr() not in {x.data_ptr() for x in (e, r, ec, pin)}
            assert torch.equal(got, want), (kind, n_iter)
        assert all(torch.equal(a, b) for a, b in zip((e, r, ec, pin), before))


def _mixed_stage_on_plan(plan, r, pin, h, red_first=True, u=None, ec=None):
    """One launch of the full-layout mixed stage (K14's from zero, or on u)
    or, given ec, of K15's (u is e) on a plan of the caller's, into a fresh
    field; the launcher's error code and the field."""
    out = torch.empty_like(r)
    args = (plan.n_iter, plan.bi, plan.bj, plan.bk, plan.k_halo, plan.threads, plan.smem,
            int(plan.box), tpk._stream())
    lib = tpk._lib()
    if ec is None:
        err = lib.mg_mixed_stage(out.data_ptr(), None if u is None else u.data_ptr(),
                                 r.data_ptr(), pin.data_ptr(), plan.n, h * h, int(red_first),
                                 *args)
    else:
        err = lib.mg_mixed_prolong_stage(out.data_ptr(), ec.data_ptr(), u.data_ptr(),
                                         r.data_ptr(), pin.data_ptr(), plan.n, h * h, *args)
    return err, out


@pytest.mark.cuda
@pytest.mark.parametrize("box", [False, True], ids=["wave", "box"])
@pytest.mark.parametrize("bk", [0, 4, 12])
@pytest.mark.parametrize("n", [9, 17, 33, 35])
def test_mixed_stages_on_hand_plans_on_card(cuda, n, bk, box):
    """K14's stage (from zero and on a BC-consistent initial guess) and
    K15's on plans of several blocks in i, j and k: 8 rows by 9 planes, and
    1 row by 1 plane (whose x-, y- and z-face nodes its source's block
    writes), on the wavefront and on the box, whole rows (bk = 0; n = 35: a
    row's 17 slots not a multiple of 4) and k tiles of 4 or 12 slots with
    the 4-slot k halo; random pins (k-face columns too), fields random
    everywhere, the allocator poisoned with NaN: bit for bit against the
    plain versions; a plan whose shared memory is not the kernel's is
    refused."""
    h = 3e-4 / (n - 1)
    s, nc = n // 2, (n + 1) // 2
    if bk >= s:
        pytest.skip("a k tile as wide as the row is the whole-row plan")
    rng = np.random.default_rng(230 + n + bk)
    e, r = _cubes(rng, n, cuda, 2)
    ec = _cubes(rng, nc, cuda, 1)[0]
    pin = _mixed_pins("random", n, cuda, rng)
    e_bc = tpm.apply_bcs_padded(e, pin)  # K13's contract: a BC-consistent guess
    for bi, bj in ((9, 8), (1, 1)):
        for n_iter in (1, 2):
            halo, k_halo = 2 * n_iter, tps.STAGE_K_HALO if bk else 0
            width = tps._stage_width(n, bk or s, k_halo, rect=True)
            box_bi = bi if box else 0
            plan = tps.StagePlan(n, n_iter, halo, k_halo, bi, bj, bk or s,
                                 32 * min(18, bj + 2 * halo),
                                 tps._stage_smem(n_iter, bj, width, rect=True, box_bi=box_bi),
                                 True, box)
            assert plan.blocks > 1 and plan.tiles[2] == (-(-s // bk) if bk else 1)
            for red_first in (True, False):
                _poison_allocator((n, n, n), cuda)
                err, got = _mixed_stage_on_plan(plan, r, pin, h, red_first)
                assert err == 0 and torch.equal(
                    got, tpm.mixed_rb_smooth_from_zero_plain(r, pin, h, n_iter, red_first))
                err, got = _mixed_stage_on_plan(plan, r, pin, h, red_first, u=e_bc)
                assert err == 0 and torch.equal(
                    got, tpm.mixed_rb_smooth_plain(e_bc, r, pin, h, n_iter, red_first))
            k15 = plan._replace(smem=tps._stage_smem(n_iter, bj, width, prolong=True, rect=True,
                                                     box_bi=box_bi))
            _poison_allocator((n, n, n), cuda)
            err, got = _mixed_stage_on_plan(k15, r, pin, h, u=e, ec=ec)
            want = tpm.mixed_prolong_smooth_plain(ec, e, r, pin, h, n_iter)
            assert err == 0 and torch.equal(got, want), (bi, n_iter)
            assert _mixed_stage_on_plan(plan._replace(smem=plan.smem + 16), r, pin, h)[0] != 0
            assert _mixed_stage_on_plan(k15._replace(smem=k15.smem + 16), r, pin, h, u=e,
                                        ec=ec)[0] != 0


@pytest.mark.cuda
@pytest.mark.parametrize("n", [9, 17, 33, 65, 129, 257, 513])
def test_k13_stage_matches_plain_on_card(cuda, n):
    """K13, the full-layout mixed stage on a loaded BC-consistent e, with
    the electrospray's pins and random ones (k-face columns too), both
    orders, n_iter 1-3, r random everywhere, the allocator poisoned with
    NaN: bit for bit against the plain version, a fresh field, e and r
    untouched, ceil(n_iter / 2) launches a call and no other kernel; its
    launcher refuses an output that meets e or r."""
    h = 3e-4 / (n - 1)
    rng = np.random.default_rng(300 + n)
    e, r = _cubes(rng, n, cuda, 2)
    for kind in ("electrospray", "random"):
        pin = _mixed_pins(kind, n, cuda, rng)
        e_bc = tpm.apply_bcs_padded(e, pin)
        before = [e_bc.clone(), r.clone()]
        for n_iter in (1, 2, 3):
            for red_first in (True, False):
                want = tpm.mixed_rb_smooth_plain(e_bc, r, pin, h, n_iter, red_first)
                _poison_allocator((n, n, n), cuda, count=2 if n == 513 else 8)
                tpm.reset_launches()
                got = tpm.mixed_rb_smooth_fused(e_bc, r, pin, h, n_iter, red_first)
                assert tpm.LAUNCHES == {**dict.fromkeys(tpm.KERNELS, 0),
                                        "mixed_rb_smooth_fused": -(-n_iter // 2)}
                assert torch.equal(got, want), (kind, n_iter, red_first)
                del want, got
        assert torch.equal(e_bc, before[0]) and torch.equal(r, before[1])
    plan = tps._plan_args(n, 2, cuda, rect=True)
    lib, stream, h2 = tpk._lib(), tpk._stream(), h * h
    for out, u in ((e_bc, e_bc), (r, e_bc), (r, None)):  # out meets e, or r
        assert lib.mg_mixed_stage(out.data_ptr(), None if u is None else u.data_ptr(),
                                  r.data_ptr(), pin.data_ptr(), n, h2, 1, *plan, stream) != 0
    fresh = torch.empty_like(r)
    assert lib.mg_mixed_stage(fresh.data_ptr(), e_bc.data_ptr(), r.data_ptr(), pin.data_ptr(), n,
                              h2, 1, *plan, stream) == 0
    torch.cuda.synchronize()


def _interior(n, dev):
    inner = torch.zeros((n, n, n), dtype=torch.bool, device=dev)
    inner[1:-1, 1:-1, 1:-1] = True
    return inner


@pytest.mark.cuda
def test_reused_kernels_non_dyadic_h_on_card(cuda):
    """K3 and K5 at h = 3e-4 / (n - 1), on fields with a live boundary."""
    n = 65
    h = 3e-4 / (n - 1)
    e, r = _fields32(18, n, cuda)
    got = tpk.residual_restrict_fused(e, r, h)
    assert torch.equal(got, tpk.residual_restrict_plain(e, r, h))
    rng = np.random.default_rng(19)
    x = np.linspace(0.0, 1.0, n)[:, None, None]
    state = [t.to(cuda) for a in (-1350.0 * x * x + 1e-3 * rng.standard_normal((n, n, n)),
                                  1e3 * rng.standard_normal((n, n, n)))
             for t in tpk.df_split(torch.from_numpy(a))]
    r5, nrm5 = tpk.residual_df_norm_fused(*state, h)
    r_ref, nrm_ref = tpk.residual_df_norm_plain(*state, h)
    assert torch.equal(r5, r_ref)
    assert float(nrm5) == pytest.approx(float(nrm_ref), rel=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("gamma", [1, 2], ids=["V", "W"])
def test_mixed_tier_on_card_matches_cpu(cuda, gamma):
    """The electrospray tier at 33^3 on the card (K13-K15, K3, K5) against
    the same tier on the CPU (plain versions): same outer steps, within
    1e-7 V; the card launches only the tier's kernels."""
    prob = tmg.electrospray_problem()
    hier = tmg.Hierarchy(ndim=3, coarse_n=5, num_levels=4, length=prob.length)
    out = {}
    for dev in ("cpu", cuda):
        s = MixedBCSolver(prob, hier, n_smooth=2, gamma=gamma, device=dev)
        tpk.reset_launches()
        tpm.reset_launches()
        hi, lo, nrm, it = tmp.make_mixed_padded_df_solver(s, inner_cycles=1)(
            *tmp.setup_mixed_df_problem(s))
        out[str(dev)] = (tmp.unpack_mixed_solution(hi, lo, hier).cpu(), it)
    assert out["cpu"][1] == out["cuda"][1]
    assert float((out["cpu"][0] - out["cuda"][0]).abs().max()) <= 1e-7
    # K13 runs only where a correction is revisited: W-cycles (inner_cycles 1)
    assert (tpm.LAUNCHES["mixed_rb_smooth_fused"] > 0) == (gamma > 1)
    assert tpm.LAUNCHES["mixed_rb_smooth_from_zero_fused"] > 0
    assert tpm.LAUNCHES["mixed_prolong_smooth_fused"] > 0
    assert tpk.LAUNCHES["residual_restrict_fused"] > 0 and tpk.LAUNCHES["residual_df_norm_fused"] > 0
    assert all(tpk.LAUNCHES[k] == 0 for k in ("rb_smooth_fused", "rb_smooth_from_zero_fused",
                                               "residual_fused", "prolong_smooth_fused",
                                               "df_step_residual_norm_fused"))


@pytest.mark.cuda
@pytest.mark.parametrize("n", [17, 65])
def test_fold_kernels_match_plain_on_card(cuda, n):
    """K16-K20 at the electrospray's h, with its pin planes and a random
    x-face mask, on fold fields packed from BC-consistent cubes; K19 with
    the coarse level's sign planes (the pin-edge delta live at 17^3,
    whose coarse level is 9^3). The fold plain versions read only what
    the kernels read, so fields are expected bitwise equal."""
    h = 3e-4 / (n - 1)
    nc = (n + 1) // 2
    prob = tmg.electrospray_problem()
    e, r = _fields32(20, n, cuda)
    r = tpmf.pack_fold(torch.where(_interior(n, cuda), r, torch.zeros_like(r)))
    ec = tpmf.pack_fold(tpm.apply_bcs_padded(_fields32(21, nc, cuda)[0],
                                             _electrospray_pins(nc, cuda)))
    sgn_c = tpmf.fold_edge_sign_planes(prob, nc, cuda)
    assert bool(sgn_c.any()) == (n == 17)
    rng = np.random.default_rng(22)
    random_pin = torch.from_numpy((rng.random((2, n, n)) < 0.3).astype(np.float32)).to(cuda)
    tpmf.reset_launches()
    for pin_full in (_electrospray_pins(n, cuda), random_pin):
        pin = tpmf.pack_fold(pin_full)
        fe = tpmf.pack_fold(tpm.apply_bcs_padded(e, pin_full))
        for n_iter in (1, 2):
            for red_first in (True, False):
                want = tpmf.mixed_rb_smooth_fold_plain(fe, r, pin, h, n_iter, red_first)
                got = tpmf.mixed_rb_smooth_fold(fe.clone(), r, pin, h, n_iter, red_first)
                assert torch.equal(got, want)
            assert torch.equal(tpmf.mixed_rb_smooth_from_zero_fold(r, pin, h, n_iter),
                               tpmf.mixed_rb_smooth_from_zero_fold_plain(r, pin, h, n_iter))
            e0 = fe.clone()
            got = tpmf.mixed_prolong_smooth_fold(ec, fe, r, pin, sgn_c, h, n_iter)
            assert torch.equal(fe, e0)  # fresh output, e untouched
            assert torch.equal(got, tpmf.mixed_prolong_smooth_fold_plain(ec, fe, r, pin, sgn_c,
                                                                         h, n_iter))
        got = tpmf.residual_restrict_fold(fe, r, h)
        assert got.shape == (nc, nc, nc - 2)
        assert torch.equal(got, tpmf.residual_restrict_fold_plain(fe, r, h))
    x = np.linspace(0.0, 1.0, n)[:, None, None]
    state = [tpmf.pack_fold(t.to(cuda))
             for a in (-1350.0 * x * x + 1e-3 * rng.standard_normal((n, n, n)),
                       1e3 * rng.standard_normal((n, n, n)))
             for t in tpk.df_split(torch.from_numpy(a))]
    r20, nrm20 = tpmf.residual_df_norm_fold(*state, h)
    r_ref, nrm_ref = tpmf.residual_df_norm_fold_plain(*state, h)
    assert torch.equal(r20, r_ref)
    assert float(nrm20) == pytest.approx(float(nrm_ref), rel=1e-5)
    # per pin, n_iter 1 and 2: K16 (2 orders), K17 and K19 one launch a call
    assert tpmf.LAUNCHES == {"mixed_rb_smooth_fold": 2 * 2 * 2,
                             "mixed_rb_smooth_from_zero_fold": 2 * 2,
                             "residual_restrict_fold": 2,
                             "mixed_prolong_smooth_fold": 2 * 2,
                             "residual_df_norm_fold": 1}


def _fold_pins(kind, n, dev, rng):
    """(fine pin planes (2, n, n - 2), coarse sign planes (2, nc, nc - 2)):
    the electrospray's, or a random patch mask and random signs in {-1, 0,
    1} (nonzero at the k-edge columns K19 reads)."""
    nc = (n + 1) // 2
    if kind == "electrospray":
        prob = tmg.electrospray_problem()
        return (tpmf.fold_pin_planes(prob, n, dev),
                tpmf.fold_edge_sign_planes(prob, nc, dev))
    pin = torch.from_numpy((rng.random((2, n, n - 2)) < 0.3).astype(np.float32)).to(dev)
    sgn = torch.from_numpy(rng.integers(-1, 2, (2, nc, nc - 2)).astype(np.float32)).to(dev)
    return pin, sgn


def _fold_fields(rng, n, dev, count):
    """``count`` fold fields random at every stored point, the x and y
    faces too: the stages must neither read nor keep them."""
    return [torch.from_numpy(rng.standard_normal((n, n, n - 2)).astype(np.float32)).to(dev)
            for _ in range(count)]


@pytest.mark.cuda
@pytest.mark.parametrize("n", [9, 17, 33, 65, 129, 257, 513])
def test_k17_k19_stages_match_plain_on_card(cuda, n):
    """The one-pass fold stages K17 and K19 bit for bit against their
    plain versions (9-129: the box schedule; 257, 513: the wavefront, 257
    the main path's plan, 513 with k tiles at n_iter 2), n_iter 1-3, both
    orders of K17, with the electrospray's pins and random ones and
    nonzero coarse signs, on fields random at every stored point and the
    allocator poisoned with NaN first, so that a point left unwritten
    shows; one launch a call at n_iter <= 2, two at 3, and no other kernel
    counted; fresh outputs, the inputs left as they were."""
    h = 3e-4 / (n - 1)
    nc = (n + 1) // 2
    rng = np.random.default_rng(90 + n)
    e, r = _fold_fields(rng, n, cuda, 2)
    ec = _fold_fields(rng, nc, cuda, 1)[0]
    plan = tps._stage_plan(n, 2, tps._sms(torch.cuda.current_device()), rect=True)
    assert plan.box == (n <= tps.RECT_BOX_MAX_N) and (plan.k_halo > 0) == (n == 513)
    for kind in ("electrospray", "random"):
        pin, sgn_c = _fold_pins(kind, n, cuda, rng)
        assert bool(sgn_c.any()) == (kind == "random" or nc <= 17)
        before = [x.clone() for x in (e, r, ec, pin, sgn_c)]
        for n_iter in (1, 2, 3):
            calls = 1 if n_iter <= 2 else 2
            for red_first in (True, False):
                want = tpmf.mixed_rb_smooth_from_zero_fold_plain(r, pin, h, n_iter, red_first)
                _poison_allocator((n, n, n - 2), cuda)
                tpmf.reset_launches()
                got = tpmf.mixed_rb_smooth_from_zero_fold(r, pin, h, n_iter, red_first)
                assert tpmf.LAUNCHES == {**dict.fromkeys(tpmf.KERNELS, 0),
                                         "mixed_rb_smooth_from_zero_fold": calls}
                assert torch.equal(got, want), (kind, n_iter, red_first)
            want = tpmf.mixed_prolong_smooth_fold_plain(ec, e, r, pin, sgn_c, h, n_iter)
            _poison_allocator((n, n, n - 2), cuda)
            tpmf.reset_launches()
            got = tpmf.mixed_prolong_smooth_fold(ec, e, r, pin, sgn_c, h, n_iter)
            assert tpmf.LAUNCHES == {**dict.fromkeys(tpmf.KERNELS, 0),
                                     "mixed_prolong_smooth_fold": calls}
            torch.cuda.synchronize()
            assert got.data_ptr() not in {x.data_ptr() for x in (e, r, ec, pin, sgn_c)}
            assert torch.equal(got, want), (kind, n_iter)
        assert all(torch.equal(a, b) for a, b in zip((e, r, ec, pin, sgn_c), before))


def _fold_stage_on_plan(plan, r, pin, h, red_first=True, u=None, ec=None, sgn=None):
    """One launch of the fold stage (K17's from zero, or on u) or, given
    ec, of K19's (u is e) on a plan of the caller's, into a fresh field;
    the launcher's error code and the field."""
    out = torch.empty_like(r)
    args = (plan.n_iter, plan.bi, plan.bj, plan.bk, plan.k_halo, plan.threads, plan.smem,
            int(plan.box), tpk._stream())
    lib = tpk._lib()
    if ec is None:
        err = lib.mg_fold_stage(out.data_ptr(), None if u is None else u.data_ptr(),
                                r.data_ptr(), pin.data_ptr(), plan.n, h * h, int(red_first),
                                *args)
    else:
        err = lib.mg_fold_prolong_stage(out.data_ptr(), ec.data_ptr(), u.data_ptr(),
                                        r.data_ptr(), pin.data_ptr(), sgn.data_ptr(), plan.n,
                                        h * h, *args)
    return err, out


@pytest.mark.cuda
@pytest.mark.parametrize("box", [False, True], ids=["wave", "box"])
@pytest.mark.parametrize("bk", [0, 4, 12])
@pytest.mark.parametrize("n", [9, 17, 33, 35])
def test_fold_stages_on_hand_plans_on_card(cuda, n, bk, box):
    """K17's stage (from zero and on an initial guess) and K19's on plans
    of several blocks in i, j and k: 8 rows by 9 planes, and 1 row by 1
    plane (whose x- and y-face nodes its source's block writes), on the
    wavefront and on the box, whole rows (bk = 0; n = 35: a row's 17 slots
    not a multiple of 4) and k tiles of 4 or 12 slots with the 4-slot k
    halo; random pins and signs, fields random everywhere, the allocator
    poisoned with NaN: bit for bit against the plain versions; a plan
    whose shared memory is not the kernel's is refused."""
    h = 3e-4 / (n - 1)
    s, nc = n // 2, (n + 1) // 2
    if bk >= s:
        pytest.skip("a k tile as wide as the row is the whole-row plan")
    rng = np.random.default_rng(130 + n + bk)
    e, r = _fold_fields(rng, n, cuda, 2)
    ec = _fold_fields(rng, nc, cuda, 1)[0]
    pin, sgn = _fold_pins("random", n, cuda, rng)
    for bi, bj in ((9, 8), (1, 1)):
        for n_iter in (1, 2):
            halo, k_halo = 2 * n_iter, tps.STAGE_K_HALO if bk else 0
            width = tps._stage_width(n, bk or s, k_halo, rect=True)
            box_bi = bi if box else 0
            plan = tps.StagePlan(n, n_iter, halo, k_halo, bi, bj, bk or s,
                                 32 * min(18, bj + 2 * halo),
                                 tps._stage_smem(n_iter, bj, width, rect=True, box_bi=box_bi),
                                 True, box)
            assert plan.blocks > 1 and plan.tiles[2] == (-(-s // bk) if bk else 1)
            for red_first in (True, False):
                _poison_allocator((n, n, n - 2), cuda)
                err, got = _fold_stage_on_plan(plan, r, pin, h, red_first)
                assert err == 0 and torch.equal(
                    got, tpmf.mixed_rb_smooth_from_zero_fold_plain(r, pin, h, n_iter, red_first))
                err, got = _fold_stage_on_plan(plan, r, pin, h, red_first, u=e)
                assert err == 0 and torch.equal(
                    got, tpmf.mixed_rb_smooth_fold_plain(e, r, pin, h, n_iter, red_first))
            k19 = plan._replace(smem=tps._stage_smem(n_iter, bj, width, prolong=True, rect=True,
                                                     box_bi=box_bi))
            _poison_allocator((n, n, n - 2), cuda)
            err, got = _fold_stage_on_plan(k19, r, pin, h, u=e, ec=ec, sgn=sgn)
            want = tpmf.mixed_prolong_smooth_fold_plain(ec, e, r, pin, sgn, h, n_iter)
            assert err == 0 and torch.equal(got, want), (bi, n_iter)
            assert _fold_stage_on_plan(plan._replace(smem=plan.smem + 16), r, pin, h)[0] != 0
            assert _fold_stage_on_plan(k19._replace(smem=k19.smem + 16), r, pin, h, u=e, ec=ec,
                                       sgn=sgn)[0] != 0


@pytest.mark.cuda
@pytest.mark.parametrize("n", [9, 17, 33, 65, 129, 257, 513])
def test_k16_stage_matches_plain_on_card(cuda, n):
    """K16, the fold stage on a loaded field, bit for bit against its plain
    version (9-129: the box schedule; 257, 513: the wavefront), n_iter 1-3,
    both orders, with the electrospray's pins and random ones, on e whose
    x and y faces hold NaN (only its interior may be read), the allocator
    poisoned with NaN first; one launch a call at n_iter <= 2, two at 3,
    and no other kernel counted; a fresh field, e and r left as they
    were."""
    h = 3e-4 / (n - 1)
    rng = np.random.default_rng(150 + n)
    e, r = _fold_fields(rng, n, cuda, 2)
    e[0] = e[-1] = float("nan")
    e[:, 0] = e[:, -1] = float("nan")
    for kind in ("electrospray", "random"):
        pin, _ = _fold_pins(kind, n, cuda, rng)
        before = [x.clone() for x in (e, r, pin)]
        for n_iter in (1, 2, 3):
            for red_first in (True, False):
                want = tpmf.mixed_rb_smooth_fold_plain(e, r, pin, h, n_iter, red_first)
                assert bool(torch.isfinite(want).all())
                _poison_allocator((n, n, n - 2), cuda)
                tpmf.reset_launches()
                got = tpmf.mixed_rb_smooth_fold(e, r, pin, h, n_iter, red_first)
                assert tpmf.LAUNCHES == {**dict.fromkeys(tpmf.KERNELS, 0),
                                         "mixed_rb_smooth_fold": 1 if n_iter <= 2 else 2}
                torch.cuda.synchronize()
                assert got.data_ptr() not in {x.data_ptr() for x in (e, r, pin)}
                assert torch.equal(got, want), (kind, n_iter, red_first)
        assert all(_same_with_nan(a, b) for a, b in zip((e, r, pin), before))


def _fold_restrict_on(plan, e, r, h):
    """One launch of K18's streaming stage on ``plan``, or of its first
    form where ``plan`` is None, into a fresh coarse fold field; the
    launcher's error code and the field."""
    n = e.shape[0]
    nc = (n + 1) // 2
    out = torch.empty((nc, nc, nc - 2), device=e.device)
    lib, ptrs = tpmf._lib(), (out.data_ptr(), e.data_ptr(), r.data_ptr())
    if plan is None:
        return lib.mg_residual_restrict_fold(*ptrs, n, 1.0 / (h * h), tpk._stream()), out
    return lib.mg_fold_residual_restrict(*ptrs, n, 1.0 / (h * h), *plan.args,
                                         tpk._stream()), out


@pytest.mark.cuda
@pytest.mark.parametrize("n", RESTRICT_SIZES)
def test_k18_restrict_matches_plain_on_card(cuda, n):
    """K18 bit for bit against ``residual_restrict_fold_plain`` at every
    stored coarse point (9-129: the first form below the crossover,
    pallas_split.FOLD_RESTRICT_STAGE_MIN_N; 257: the fold tier's finest
    level), on fold fields random at every stored point, at the
    electrospray's h = 3e-4 / (n - 1), the allocator poisoned with NaN
    first: the wrapper, exactly one launch a call, and each of its forms
    at this size (the stage on the planner's plan); the inputs
    unchanged."""
    h = 3e-4 / (n - 1)
    nc = (n + 1) // 2
    rng = np.random.default_rng(170 + n)
    e, r = _fold_fields(rng, n, cuda, 2)
    before = [x.clone() for x in (e, r)]
    want = tpmf.residual_restrict_fold_plain(e, r, h)
    _poison_allocator((nc, nc, nc - 2), cuda)
    tpmf.reset_launches()
    got = tpmf.residual_restrict_fold(e, r, h)
    assert tpmf.LAUNCHES == {**dict.fromkeys(tpmf.KERNELS, 0), "residual_restrict_fold": 1}
    assert got.shape == (nc, nc, nc - 2) and torch.equal(got, want)
    for plan in (None, tps._restrict_plan(n, tps._sms(torch.cuda.current_device()), fold=True)):
        _poison_allocator((nc, nc, nc - 2), cuda)
        err, out = _fold_restrict_on(plan, e, r, h)
        assert err == 0 and torch.equal(out, want), plan
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip((e, r), before))


@pytest.mark.cuda
@pytest.mark.parametrize("n", [17, 33, 35])
def test_k18_restrict_on_hand_plans_on_card(cuda, n):
    """K18's streaming stage on plans of the caller's: several blocks in i
    and j, whole k rows and k tiles of 2, 3 and 4 coarse k (the first and
    last tiles' windows clipped at the stored slots; 35: rows of 33
    slots); bit for bit against the plain version on NaN-poisoned
    outputs; a plan whose shared memory is not the kernel's, or one that
    the kernel does not take, is refused."""
    h = 3e-4 / (n - 1)
    nc = (n + 1) // 2
    m = nc - 2
    rng = np.random.default_rng(190 + n)
    e, r = _fold_fields(rng, n, cuda, 2)
    want = tpmf.residual_restrict_fold_plain(e, r, h)
    for bci, bcj, bck in ((2, 3, m), (3, 2, 2), (5, min(m, 8), 4), (m, 1, 3)):
        plan = tps.RestrictPlan(n, False, bci, bcj, bck, tps._restrict_chunks(bck, False),
                                32 * (2 * bcj + 1), tps._restrict_smem(bcj, bck, False), True)
        _poison_allocator((nc, nc, nc - 2), cuda)
        err, out = _fold_restrict_on(plan, e, r, h)
        assert err == 0 and torch.equal(out, want), plan
        assert _fold_restrict_on(plan._replace(smem=plan.smem + 16), e, r, h)[0] != 0
    bad = plan._replace(bcj=9, threads=32 * 19, smem=tps._restrict_smem(9, plan.bck, False))
    assert _fold_restrict_on(bad, e, r, h)[0] != 0


@pytest.mark.cuda
def test_fold_wrappers_reject_what_the_kernels_do_not_take(cuda):
    e = torch.zeros((9, 9, 7), device=cuda)
    pin = torch.zeros((2, 9, 7), device=cuda)
    with pytest.raises(TypeError):
        tpmf.mixed_rb_smooth_from_zero_fold(e.double(), pin.double(), 0.125, 1)
    with pytest.raises(ValueError):
        tpmf.residual_restrict_fold(e.transpose(0, 1), e, 0.125)
    with pytest.raises(ValueError):
        tpmf.mixed_rb_smooth_fold(e, e, pin.cpu(), 0.125, 1)


@pytest.mark.cuda
@pytest.mark.parametrize("gamma", [1, 2], ids=["V", "W"])
def test_fold_tier_on_card_matches_cpu(cuda, gamma):
    """The electrospray fold tier at 33^3 on the card (K16-K20) against the
    same tier on the CPU (plain versions): same outer steps, within 1e-7 V;
    the card launches only the fold kernels."""
    prob = tmg.electrospray_problem()
    hier = tmg.Hierarchy(ndim=3, coarse_n=5, num_levels=4, length=prob.length)
    out = {}
    for dev in ("cpu", cuda):
        s = MixedBCSolver(prob, hier, n_smooth=2, gamma=gamma, device=dev)
        for mod in (tpk, tpm, tpmf):
            mod.reset_launches()
        hi, lo, nrm, it = tmp.make_mixed_fold_df_solver(s, inner_cycles=1)(
            *tmp.setup_mixed_fold_df_problem(s))
        out[str(dev)] = (tmp.unpack_mixed_fold_solution(hi, lo, s).cpu(), it)
    assert out["cpu"][1] == out["cuda"][1]
    assert float((out["cpu"][0] - out["cuda"][0]).abs().max()) <= 1e-7
    # K16 runs only where a correction is revisited: W-cycles (inner_cycles 1)
    assert (tpmf.LAUNCHES["mixed_rb_smooth_fold"] > 0) == (gamma > 1)
    assert all(tpmf.LAUNCHES[k] > 0 for k in tpmf.KERNELS if k != "mixed_rb_smooth_fold")
    assert not any(tpk.LAUNCHES.values()) and not any(tpm.LAUNCHES.values())


@pytest.mark.cuda
@pytest.mark.parametrize("n", [17, 65])
def test_msplit_kernels_match_plain_on_card(cuda, n):
    """K21-K25 at the electrospray's h, with its pin packs and a random
    x-face mask, on pairs packed from BC-consistent cubes; K24 with the
    coarse level's sign planes (the pin-edge delta live at 17^3). Every
    kernel takes the same steps as its plain version: fields bit for bit
    (K25's norm within rel 1e-5)."""
    h = 3e-4 / (n - 1)
    nc = (n + 1) // 2
    prob = tmg.electrospray_problem()
    e, r = _fields32(23, n, cuda)
    r2 = tps.pack_split(torch.where(_interior(n, cuda), r, torch.zeros_like(r)))
    ec = tpmf.pack_fold(tpm.apply_bcs_padded(_fields32(24, nc, cuda)[0],
                                             _electrospray_pins(nc, cuda)))
    sgn_c = tpmf.fold_edge_sign_planes(prob, nc, cuda)
    assert bool(sgn_c.any()) == (n == 17)
    rng = np.random.default_rng(25)
    random_pin = torch.from_numpy((rng.random((2, n, n)) < 0.3).astype(np.float32)).to(cuda)
    tpms.reset_launches()
    for pin_full in (_electrospray_pins(n, cuda), random_pin):
        packs = tpms.msplit_plane_packs(pin_full)
        e2 = tps.pack_split(tpm.apply_bcs_padded(e, pin_full))
        for n_iter in (1, 2):
            for red_first in (True, False):
                want = tpms.mixed_rb_smooth_msplit_plain(*e2, *r2, packs, h, n_iter, red_first)
                got = tpms.mixed_rb_smooth_msplit(*(x.clone() for x in e2), *r2, packs, h,
                                                  n_iter, red_first)
                assert all(torch.equal(g, w) for g, w in zip(got, want))
            got = tpms.mixed_rb_smooth_from_zero_msplit(*r2, packs, h, n_iter)
            want = tpms.mixed_rb_smooth_from_zero_msplit_plain(*r2, packs, h, n_iter)
            assert all(torch.equal(g, w) for g, w in zip(got, want))
            e0 = tuple(x.clone() for x in e2)
            got = tpms.mixed_prolong_smooth_msplit(ec, *e2, *r2, packs, sgn_c, h, n_iter)
            assert all(torch.equal(a, b) for a, b in zip(e2, e0))  # fresh pair, e untouched
            want = tpms.mixed_prolong_smooth_msplit_plain(ec, *e2, *r2, packs, sgn_c, h, n_iter)
            assert all(torch.equal(g, w) for g, w in zip(got, want))
        got = tpms.residual_restrict_msplit(*e2, *r2, h)
        assert got.shape == (nc, nc, nc - 2)
        assert torch.equal(got, tpms.residual_restrict_msplit_plain(*e2, *r2, h))
    x = np.linspace(0.0, 1.0, n)[:, None, None]
    state = [t for a in (-1350.0 * x * x + 1e-3 * rng.standard_normal((n, n, n)),
                         1e3 * rng.standard_normal((n, n, n)))
             for half in tpk.df_split(torch.from_numpy(a).to(cuda)) for t in tps.pack_split(half)]
    got = tpms.residual_df_norm_msplit(*state, h)
    want = tpms.residual_df_norm_msplit_plain(*state, h)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert float(got[2]) == pytest.approx(float(want[2]), rel=1e-5)
    # per pin, n_iter 1 and 2: K21 2 orders, K22 and K24 one launch a call
    assert tpms.LAUNCHES == {"mixed_rb_smooth_msplit": 2 * 2 * (1 + 1),
                             "mixed_rb_smooth_from_zero_msplit": 2 * (1 + 1),
                             "residual_restrict_msplit": 2,
                             "mixed_prolong_smooth_msplit": 2 * (1 + 1),
                             "residual_df_norm_msplit": 1}


def _msplit_pins(kind, n, dev, rng):
    """(parity pin packs (2, 2, n, S), coarse sign planes (2, nc, nc - 2)):
    the electrospray's, or a random patch mask and random signs in {-1, 0,
    1} (nonzero at the k-edge columns K24 reads)."""
    nc = (n + 1) // 2
    if kind == "electrospray":
        prob = tmg.electrospray_problem()
        return tpms.msplit_pin_packs(prob, n, dev), tpmf.fold_edge_sign_planes(prob, nc, dev)
    mask = torch.from_numpy((rng.random((2, n, n)) < 0.3).astype(np.float32)).to(dev)
    sgn = torch.from_numpy(rng.integers(-1, 2, (2, nc, nc - 2)).astype(np.float32)).to(dev)
    return tpms.msplit_plane_packs(mask), sgn


@pytest.mark.cuda
@pytest.mark.parametrize("n", [9, 17, 33, 65, 129, 257, 513])
def test_k22_k24_stages_match_plain_on_card(cuda, n):
    """The one-pass msplit stages K22 and K24 bit for bit against their
    plain versions (257: the main path's plans; 513: k tiles at n_iter
    2), n_iter 1-3, both orders of K22, with the electrospray's pins and
    random ones and nonzero coarse signs, on pairs random at every slot
    (dead slots and boundary rows too) and the allocator poisoned with NaN
    first, so that a slot left unwritten shows; one launch a call at
    n_iter <= 2, two at 3, and no other kernel counted; fresh pairs, the
    inputs left as they were."""
    h = 3e-4 / (n - 1)
    nc = (n + 1) // 2
    rng = np.random.default_rng(150 + n)
    e, r = _random_pairs(150 + n, n, cuda, 2)
    ec = torch.from_numpy(rng.standard_normal((nc, nc, nc - 2)).astype(np.float32)).to(cuda)
    if n == 513:
        assert tps._stage_plan(n, 2, tps._sms(torch.cuda.current_device())).k_halo > 0
    shape = tps.split_shape(n)
    for kind in ("electrospray", "random"):
        packs, sgn_c = _msplit_pins(kind, n, cuda, rng)
        assert bool(sgn_c.any()) == (kind == "random" or nc <= 17)
        inputs = (*e, *r, ec, packs, sgn_c)
        before = [x.clone() for x in inputs]
        for n_iter in (1, 2, 3):
            calls = 1 if n_iter <= 2 else 2
            for red_first in (True, False):
                want = tpms.mixed_rb_smooth_from_zero_msplit_plain(*r, packs, h, n_iter,
                                                                   red_first)
                _poison_allocator(shape, cuda)
                tpms.reset_launches()
                got = tpms.mixed_rb_smooth_from_zero_msplit(*r, packs, h, n_iter, red_first)
                assert tpms.LAUNCHES == {**dict.fromkeys(tpms.KERNELS, 0),
                                         "mixed_rb_smooth_from_zero_msplit": calls}
                assert _bitwise_pair(got, want), (kind, n_iter, red_first)
            want = tpms.mixed_prolong_smooth_msplit_plain(ec, *e, *r, packs, sgn_c, h, n_iter)
            _poison_allocator(shape, cuda)
            tpms.reset_launches()
            got = tpms.mixed_prolong_smooth_msplit(ec, *e, *r, packs, sgn_c, h, n_iter)
            assert tpms.LAUNCHES == {**dict.fromkeys(tpms.KERNELS, 0),
                                     "mixed_prolong_smooth_msplit": calls}
            torch.cuda.synchronize()
            assert not {g.data_ptr() for g in got} & {x.data_ptr() for x in inputs}
            assert _bitwise_pair(got, want), (kind, n_iter)
        assert all(torch.equal(a, b) for a, b in zip(inputs, before))


def _nan_off_interior(pair, n):
    """The pair with NaN in its boundary rows and dead slots: what K21
    must not read."""
    _, live_r, live_b = tps._masks(n, pair[0].device)
    return tuple(torch.where(live, x, torch.full_like(x, float("nan")))
                 for x, live in zip(pair, (live_r, live_b)))


@pytest.mark.cuda
@pytest.mark.parametrize("n", [9, 17, 33, 65, 129, 257, 513])
def test_k21_stage_matches_plain_on_card(cuda, n):
    """K21, the stage on the loaded pair, bit for bit against its plain
    version (257: the main path's plan, 513: k tiles), n_iter 1-3, both
    orders, with the electrospray's pins and random ones, on a pair random
    at its live interior slots and NaN at its boundary rows and dead slots
    (which no sweep reads and the BC pass rewrites), the allocator
    poisoned with NaN first; ceil(n_iter / 2) launches a call and no other
    kernel counted; a fresh pair, the inputs left as they were."""
    h = 3e-4 / (n - 1)
    rng = np.random.default_rng(200 + n)
    e, r = _random_pairs(200 + n, n, cuda, 2)
    e = _nan_off_interior(e, n)
    shape = tps.split_shape(n)
    for kind in ("electrospray", "random"):
        packs, _ = _msplit_pins(kind, n, cuda, rng)
        inputs = (*e, *r, packs)
        before = [x.clone() for x in inputs]
        for n_iter in (1, 2, 3):
            for red_first in (True, False):
                want = tpms.mixed_rb_smooth_msplit_plain(*e, *r, packs, h, n_iter, red_first)
                assert all(bool(torch.isfinite(w).all()) for w in want)
                _poison_allocator(shape, cuda)
                tpms.reset_launches()
                got = tpms.mixed_rb_smooth_msplit(*e, *r, packs, h, n_iter, red_first)
                assert tpms.LAUNCHES == {**dict.fromkeys(tpms.KERNELS, 0),
                                         "mixed_rb_smooth_msplit": -(-n_iter // 2)}
                torch.cuda.synchronize()
                assert not {g.data_ptr() for g in got} & {x.data_ptr() for x in inputs}
                assert _bitwise_pair(got, want), (kind, n_iter, red_first)
        assert all(_same_with_nan(a, b) for a, b in zip(inputs, before))


def _msplit_restrict_fields(seed, n, dev):
    """(e, r) pairs random at every slot, boundary rows too, NaN at their
    dead slots (no residual of K23's reads one)."""
    e, r = _random_pairs(seed, n, dev, 2)
    for pair in (e, r):
        for x, k in zip(pair, tps._slot_k(n, dev)):
            x[k > n - 2] = float("nan")
    return e, r


def _msplit_restrict_on(plan, e, r, h, out=None):
    """One launch of K23's streaming stage on ``plan``, or of its first
    form where ``plan`` is None, into ``out`` (a fresh coarse fold field
    where None); the launcher's error code and the field."""
    n = e[0].shape[0]
    nc = (n + 1) // 2
    out = torch.empty((nc, nc, nc - 2), device=e[0].device) if out is None else out
    lib, ptrs = tpms._lib(), [x.data_ptr() for x in (out, *e, *r)]
    if plan is None:
        return lib.mg_msplit_residual_restrict(*ptrs, n, 1.0 / (h * h), tpk._stream()), out
    return lib.mg_msplit_restrict_stage(*ptrs, n, 1.0 / (h * h), *plan.args,
                                        tpk._stream()), out


@pytest.mark.cuda
@pytest.mark.parametrize("n", RESTRICT_SIZES)
def test_k23_restrict_matches_plain_on_card(cuda, n):
    """K23 bit for bit against ``residual_restrict_msplit_plain`` at every
    stored coarse point (257: the msplit tier's finest level), on pairs
    random at every slot, boundary rows included, NaN at their dead slots,
    at the electrospray's h = 3e-4 / (n - 1), the allocator poisoned with
    NaN first: the wrapper, exactly one launch a call, and each of its
    forms at this size (the stage on K9's plan, and the first form below
    pallas_split.MSPLIT_RESTRICT_STAGE_MIN_N); the inputs unchanged."""
    h = 3e-4 / (n - 1)
    nc = (n + 1) // 2
    e, r = _msplit_restrict_fields(210 + n, n, cuda)
    before = [x.clone() for x in (*e, *r)]
    want = tpms.residual_restrict_msplit_plain(*e, *r, h)
    assert bool(torch.isfinite(want).all())
    _poison_allocator((nc, nc, nc - 2), cuda)
    tpms.reset_launches()
    got = tpms.residual_restrict_msplit(*e, *r, h)
    assert tpms.LAUNCHES == {**dict.fromkeys(tpms.KERNELS, 0), "residual_restrict_msplit": 1}
    assert got.shape == (nc, nc, nc - 2) and torch.equal(got, want)
    forms = [tps._restrict_plan(n, tps._sms(torch.cuda.current_device()), split=True)]
    if n < tps.MSPLIT_RESTRICT_STAGE_MIN_N:
        forms.append(None)
    for plan in forms:
        _poison_allocator((nc, nc, nc - 2), cuda)
        err, out = _msplit_restrict_on(plan, e, r, h)
        assert err == 0 and torch.equal(out, want), plan
    torch.cuda.synchronize()
    assert all(_same_with_nan(a, b) for a, b in zip((*e, *r), before))


@pytest.mark.cuda
@pytest.mark.parametrize("n", [17, 33, 35])
def test_k23_restrict_on_hand_plans_on_card(cuda, n):
    """K23's stage on plans of the caller's: several blocks in i and j,
    whole k rows and k tiles (35: rows of 17 slots, 4-byte copies; 33:
    tiles of 4 slots, the 16-byte windows, and of 2, the exact ones), bit
    for bit against the plain version; a plan the kernel does not take, a
    shared-memory size not the plan's, and an output that meets an input
    are refused, not run."""
    h = 3e-4 / (n - 1)
    nc = (n + 1) // 2
    m = nc - 2
    e, r = _msplit_restrict_fields(220 + n, n, cuda)
    want = tpms.residual_restrict_msplit_plain(*e, *r, h)
    for bci, bcj, bck in ((2, 3, m), (3, 2, 2), (5, min(m, 8), 4), (m, 1, 3)):
        plan = tps.RestrictPlan(n, True, bci, bcj, bck, tps._restrict_chunks(bck, True),
                                32 * (2 * bcj + 1), tps._restrict_smem(bcj, bck, True))
        _poison_allocator((nc, nc, nc - 2), cuda)
        err, out = _msplit_restrict_on(plan, e, r, h)
        assert err == 0 and torch.equal(out, want), plan
    bad = tps.RestrictPlan(n, True, 1, 9, 1, 1, 32 * 19, tps._restrict_smem(9, 1, True))
    assert _msplit_restrict_on(bad, e, r, h)[0] != 0
    assert _msplit_restrict_on(plan._replace(smem=plan.smem + 16), e, r, h)[0] != 0
    for x in (*e, *r):
        alias = x.view(-1)[:nc * nc * (nc - 2)].view(nc, nc, nc - 2)
        assert _msplit_restrict_on(plan, e, r, h, out=alias)[0] != 0
    torch.cuda.synchronize()
    assert torch.equal(tpms.residual_restrict_msplit_plain(*e, *r, h), want)  # inputs untouched


@pytest.mark.cuda
def test_msplit_stage_launcher_refuses_an_output_that_meets_an_input(cuda):
    """K21's launcher (the msplit stage, K22's and K24's later launches
    too) refuses an output pair that meets e, f, the pin packs or the
    other output, and runs on one that does not."""
    n = 17
    h = 3e-4 / (n - 1)
    rng = np.random.default_rng(230)
    e, r = _random_pairs(230, n, cuda, 2)
    packs, _ = _msplit_pins("random", n, cuda, rng)
    plan = tps._stage_plan(n, 2, tps._sms(torch.cuda.current_device()), msplit=True)
    args = (plan.n_iter, plan.bi, plan.bj, plan.bk, plan.k_halo, plan.threads, plan.smem,
            tpk._stream())
    lib = tpk._lib()
    # the packs at the head of a buffer that an output can overlap
    buf = torch.zeros(2 * r[0].numel(), device=cuda)
    packs = buf[:packs.numel()].view_as(packs).copy_(packs)

    def launch(out_r, out_b):
        return lib.mg_msplit_stage(out_r.data_ptr(), out_b.data_ptr(),
                                   *(x.data_ptr() for x in (*e, *r, packs)), n, h * h, 1, *args)

    fresh = [torch.empty_like(x) for x in r]
    assert launch(*fresh) == 0
    torch.cuda.synchronize()
    assert _bitwise_pair(fresh, tpms.mixed_rb_smooth_msplit_plain(*e, *r, packs, h, 2))
    for x in (*e, *r):
        assert launch(x, fresh[1]) != 0 and launch(fresh[0], x) != 0
    assert launch(fresh[0], fresh[0]) != 0
    assert launch(buf[-r[0].numel():].view_as(r[0]), fresh[1]) == 0
    assert launch(buf[packs.numel() - 1:][:r[0].numel()].view_as(r[0]), fresh[1]) != 0


def _msplit_stage_on_plan(plan, r, packs, h, red_first=True, e=None, ec=None, sgn=None):
    """One launch of the msplit stage (K22's from zero, or on the pair e)
    or, given ec, of K24's (on e) on a plan of the caller's, into a fresh
    pair; the launcher's error code and the pair."""
    out = tuple(torch.empty_like(x) for x in r)
    args = (plan.n_iter, plan.bi, plan.bj, plan.bk, plan.k_halo, plan.threads, plan.smem,
            tpk._stream())
    lib = tpk._lib()
    ptrs = [x.data_ptr() for x in out]
    if ec is None:
        loaded = (None, None) if e is None else tuple(x.data_ptr() for x in e)
        err = lib.mg_msplit_stage(*ptrs, *loaded, *(x.data_ptr() for x in r), packs.data_ptr(),
                                  plan.n, h * h, int(red_first), *args)
    else:
        err = lib.mg_msplit_prolong_stage(*ptrs, ec.data_ptr(), sgn.data_ptr(),
                                          *(x.data_ptr() for x in (*e, *r)), packs.data_ptr(),
                                          plan.n, h * h, *args)
    return err, out


@pytest.mark.cuda
@pytest.mark.parametrize("bk", [0, 4, 12])
@pytest.mark.parametrize("n", [9, 17, 33, 35])
def test_msplit_stages_on_hand_plans_on_card(cuda, n, bk):
    """K22's stage (from zero and on a loaded pair) and K24's on plans of
    several blocks in i, j and k: 8 rows by 9 planes, and 1 row by 1 plane
    (whose x- and y-face rows its source's block writes), whole rows (bk =
    0; n = 35: a row's 17 slots not a multiple of 4, the 4-byte path) and
    k tiles of 4 or 12 slots with the 4-slot k halo; random pins and
    signs, pairs random everywhere, the allocator poisoned with NaN: bit
    for bit against the plain versions; a plan whose shared memory is not
    the kernel's is refused."""
    h = 3e-4 / (n - 1)
    s, nc = tps.split_shape(n)[2], (n + 1) // 2
    if bk >= s:
        pytest.skip("a k tile as wide as the row is the whole-row plan")
    rng = np.random.default_rng(170 + n + bk)
    e, r = _random_pairs(170 + n + bk, n, cuda, 2)
    ec = torch.from_numpy(rng.standard_normal((nc, nc, nc - 2)).astype(np.float32)).to(cuda)
    packs, sgn = _msplit_pins("random", n, cuda, rng)
    shape = tps.split_shape(n)
    for bi, bj in ((9, 8), (1, 1)):
        for n_iter in (1, 2):
            halo, k_halo = 2 * n_iter, tps.STAGE_K_HALO if bk else 0
            width = bk + 2 * k_halo if bk else s
            plan = tps.StagePlan(n, n_iter, halo, k_halo, bi, bj, bk or s,
                                 32 * min(20, bj + 2 * halo), tps._stage_smem(n_iter, bj, width))
            assert plan.blocks > 1 and plan.tiles[2] == (-(-s // bk) if bk else 1)
            for red_first in (True, False):
                _poison_allocator(shape, cuda)
                err, got = _msplit_stage_on_plan(plan, r, packs, h, red_first)
                assert err == 0 and _bitwise_pair(got, tpms.mixed_rb_smooth_from_zero_msplit_plain(
                    *r, packs, h, n_iter, red_first)), (bi, n_iter, red_first)
                err, got = _msplit_stage_on_plan(plan, r, packs, h, red_first, e=e)
                assert err == 0 and _bitwise_pair(got, tpms.mixed_rb_smooth_msplit_plain(
                    *e, *r, packs, h, n_iter, red_first)), (bi, n_iter, red_first)
            k24 = plan._replace(smem=tps._stage_smem(n_iter, bj, width, prolong=True))
            _poison_allocator(shape, cuda)
            err, got = _msplit_stage_on_plan(k24, r, packs, h, e=e, ec=ec, sgn=sgn)
            want = tpms.mixed_prolong_smooth_msplit_plain(ec, *e, *r, packs, sgn, h, n_iter)
            assert err == 0 and _bitwise_pair(got, want), (bi, n_iter)
            assert _msplit_stage_on_plan(plan._replace(smem=plan.smem + 16), r, packs, h)[0] != 0
            assert _msplit_stage_on_plan(k24._replace(smem=k24.smem + 16), r, packs, h, e=e,
                                         ec=ec, sgn=sgn)[0] != 0


@pytest.mark.cuda
def test_msplit_wrappers_reject_what_the_kernels_do_not_take(cuda):
    e = torch.zeros(tps.split_shape(9), device=cuda)
    packs = torch.zeros((2, 2, 9, 4), device=cuda)
    with pytest.raises(TypeError):
        tpms.mixed_rb_smooth_from_zero_msplit(e.double(), e.double(), packs.double(), 0.125, 1)
    with pytest.raises(ValueError):
        tpms.residual_restrict_msplit(e.transpose(0, 1), e, e, e, 0.125)
    with pytest.raises(ValueError):
        tpms.mixed_rb_smooth_msplit(e, e, e, e, packs.cpu(), 0.125, 1)


@pytest.mark.cuda
@pytest.mark.parametrize("gamma, inner_cycles", [(1, 1), (2, 1), (1, 2)],
                         ids=["V", "W", "V_inner2"])
def test_msplit_tier_on_card_matches_cpu(cuda, gamma, inner_cycles):
    """The electrospray split tier at 33^3 on the card (K21-K25 at 33, the
    fold kernels below) against the same tier on the CPU: same outer
    steps, within 1e-7 V; K21 runs only where a finest-level cycle starts
    from a correction (inner_cycles 2)."""
    prob = tmg.electrospray_problem()
    hier = tmg.Hierarchy(ndim=3, coarse_n=5, num_levels=4, length=prob.length)
    out = {}
    for dev in ("cpu", cuda):
        s = MixedBCSolver(prob, hier, n_smooth=2, gamma=gamma, device=dev)
        for mod in (tpk, tpm, tpmf, tpms):
            mod.reset_launches()
        hr, hb, lr, lb, nrm, it = tmp.make_mixed_split_df_solver(s, inner_cycles=inner_cycles)(
            *tmp.setup_mixed_split_df_problem(s))
        out[str(dev)] = (tmp.unpack_mixed_split_solution(hr, hb, lr, lb, s).cpu(), it)
    assert out["cpu"][1] == out["cuda"][1]
    assert float((out["cpu"][0] - out["cuda"][0]).abs().max()) <= 1e-7
    assert (tpms.LAUNCHES["mixed_rb_smooth_msplit"] > 0) == (inner_cycles > 1)
    assert all(tpms.LAUNCHES[k] > 0 for k in tpms.KERNELS if k != "mixed_rb_smooth_msplit")
    assert tpmf.LAUNCHES["residual_df_norm_fold"] == 0
    assert not any(tpk.LAUNCHES.values()) and not any(tpm.LAUNCHES.values())


@pytest.mark.cuda
@pytest.mark.parametrize("n", [17, 65])
def test_k26_k27_match_plain_on_card(cuda, n):
    h = 1.0 / (n - 1)
    u, f = _fields32(20, n, cuda)
    tpk.reset_launches()
    u0 = u.clone()
    for n_iter in (1, 2, 3):
        for red_first in (True, False):
            want_u, want_r = tpk.rb_smooth_residual_plain(u, f, h, n_iter, red_first)
            got_u, got_r = tpk.rb_smooth_residual_fused(u, f, h, n_iter, red_first)
            torch.cuda.synchronize()
            assert torch.equal(u, u0)  # fresh (u', r), u left as it is
            assert torch.equal(got_u, want_u) and torch.equal(got_r, want_r)
    state = _df_state(21, n, cuda)
    r = tpk.residual_df_fused(*state, h)
    assert torch.equal(r, tpk.residual_df_plain(*state, h))
    assert torch.equal(r, tpk.residual_df_norm_fused(*state, h)[0])
    nrm = tpk.residual_norm_fused(u, f, h)
    assert float(nrm) == pytest.approx(float(tpk.residual_norm_plain(u, f, h)), rel=1e-6)
    # K26: ceil(n_iter / 2) launches a call, n_iter = 1, 2, 3, both orders
    assert tpk.LAUNCHES == {**dict.fromkeys(tpk.KERNELS, 0),
                            "rb_smooth_residual_fused": 8, "residual_df_fused": 1,
                            "residual_df_norm_fused": 1, "residual_fused": 1}


@pytest.mark.cuda
@pytest.mark.parametrize("n", [9, 17, 33, 50, 65, 129, 257, 513])
def test_k26_stage_matches_plain_on_card(cuda, n):
    """K26's one-pass stage (K1's with halos one deeper that also writes the
    residual: the box up to 129^3, the wavefront at 257^3 and 513^3, k tiles
    at n_iter 2 there) bit for bit against its plain version, u' and r,
    n_iter 1-3, both orders, on u and f random at every point, the allocator
    poisoned with NaN first; u and f left as they are; one launch a call at
    n_iter <= 2, two at 3 (K1's stage, then K26's)."""
    h = 1.0 / (n - 1)
    u, f = _rect_fields(110 + n, n, cuda, 2)
    before = (u.clone(), f.clone())
    for n_iter in (1, 2, 3):
        for red_first in (True, False):
            want = tpk.rb_smooth_residual_plain(u, f, h, n_iter, red_first)
            _poison_allocator(u.shape, cuda)
            tpk.reset_launches()
            got = tpk.rb_smooth_residual_fused(u, f, h, n_iter, red_first)
            assert tpk.LAUNCHES == {**dict.fromkeys(tpk.KERNELS, 0),
                                    "rb_smooth_residual_fused": 1 if n_iter <= 2 else 2}
            torch.cuda.synchronize()
            assert torch.equal(u, before[0]) and torch.equal(f, before[1])
            assert torch.equal(got[0], want[0]), ("u", n_iter, red_first)
            assert torch.equal(got[1], want[1]), ("r", n_iter, red_first)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [33, 257])
def test_k26_launcher_rejects_what_the_stage_does_not_run(cuda, n):
    """mg_rect_resid_stage refuses a plan of 3 iterations, K1's plan (its
    halo and shared memory one short), shared memory other than the plan's,
    a k halo wider than its tile, and outputs that meet each other, u or f;
    the planner's own plan runs."""
    h = 1.0 / (n - 1)
    u, f = _rect_fields(8 + n, n, cuda, 2)
    out, r = torch.empty_like(u), torch.empty_like(u)
    lib = tpk._lib()
    plan = list(tps._plan_args(n, 2, u.device, rect=True, resid=True))

    def run(dst, res, args):
        return lib.mg_rect_resid_stage(dst.data_ptr(), res.data_ptr(), u.data_ptr(),
                                       f.data_ptr(), n, h * h, 1.0 / (h * h), 1, *args,
                                       tpk._stream())

    assert run(out, r, plan) == 0
    assert run(out, r, [3] + plan[1:]) != 0
    assert run(out, r, list(tps._plan_args(n, 2, u.device, rect=True))) != 0
    assert run(out, r, plan[:6] + [plan[6] + 16] + plan[7:]) != 0
    s = n // 2  # 4-slot k tiles under an 8-slot halo, the smem they would take
    tiles = tps.StagePlan(n, 2, 5, 8, 9, 8, 4, 32 * 18,
                          tps._stage_smem(2, 8, 20, rect=True, resid=True), True)
    assert s > 4 and run(out, r, [2, tiles.bi, tiles.bj, tiles.bk, tiles.k_halo, tiles.threads,
                                  tiles.smem, 0]) != 0
    assert run(out, out, plan) != 0 and run(u, r, plan) != 0 and run(out, f, plan) != 0
    torch.cuda.synchronize()
    want = tpk.rb_smooth_residual_plain(u, f, h, 2, True)
    assert torch.equal(out, want[0]) and torch.equal(r, want[1])


@pytest.mark.cuda
def test_reference_solve_on_card_matches_cpu(cuda):
    # the f64 reference solve is plain torch on either device
    hier = tmg.Hierarchy(ndim=3, coarse_n=5, num_levels=4)
    runs = [tmg.solve(tmg.poisson_3d_quadratic(), hier, device=d) for d in (cuda, "cpu")]
    assert runs[0].n_cycles == runs[1].n_cycles == 14
    assert runs[0].u.is_cuda
    assert float((runs[0].u.cpu() - runs[1].u).abs().max()) <= 1e-12
    assert runs[0].error_norm == pytest.approx(runs[1].error_norm, rel=1e-6)


@pytest.mark.cuda
def test_smoother_study_on_k1(cuda):
    from multigrid_parallel_tpu_torch.studies import smoother_study

    # both set up in f32, so K1's trajectory equals the plain one bit for bit
    tpk.reset_launches()
    got = smoother_study(num_levels=2, rel_tol=0.0, max_iters=6, use_pallas=True,
                         dtype=torch.float32, device=cuda)
    assert tpk.LAUNCHES["rb_smooth_fused"] == 2 * 6  # one one-pass launch a stage
    plain = smoother_study(num_levels=2, rel_tol=0.0, max_iters=6, dtype=torch.float32,
                           device=cuda)
    assert got.residual_norms == plain.residual_norms


# ------------------------------------------- the i-sharded kernels K28-K33


def _sharded_fields(dev, n, L, n_dev=4):
    import torch_sharded_ranks as rk

    rng = np.random.default_rng(40)
    glob = lambda m, rows: torch.from_numpy(rk.global_field(rng, m, rows)).to(dev)  # noqa: E731
    return glob(n, n_dev * L), glob(n, n_dev * L), glob((n + 1) // 2, n_dev * L // 2)


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["K28", "K29", "K30", "K31", "K32", "K33"])
def test_sharded_kernels_match_plain_and_single_device_on_card(cuda, kernel):
    """Four simulated ranks' segments of a 65^3 field (L = 18: the last
    rank owns pad planes only): each rank's kernel output bitwise equal to
    its plain version, and the stitched owned rows to the single-device
    kernel on the whole field."""
    import torch_sharded_ranks as rk
    from multigrid_parallel_tpu_torch.ops import pallas_sharded as tpx

    n, L, D = 65, 18, 4
    h, nc, Lc = 1.0 / (n - 1), (n + 1) // 2, L // 2
    u, f, ec = _sharded_fields(cuda, n, L)
    parts = lambda x, r, kl, kr, Lr=L: rk.rank_parts(x, r, Lr, kl, kr)  # noqa: E731
    tpx.reset_launches()
    if kernel == "K32":
        df = [t for x in (u, f) for t in tpk.df_split(x.double() + 1e-9 * x.double() ** 2)]
        want_r, want_n2 = tpk.residual_df_norm_fused(*(x[:n] for x in df), h)
        outs, n2 = [], 0.0
        for r in range(D):
            segs = [parts(x, r, 1, 1) for x in df]
            got, part = tpx.residual_df_norm_halo(*segs, r * L - 1, h, n, L)
            ref, ref_part = tpx.residual_df_norm_halo_plain(*segs, r * L - 1, h, n, L)
            assert torch.equal(got, ref), r
            assert float(part) == pytest.approx(float(ref_part), rel=1e-6, abs=0.0)
            outs.append(got)
            n2 += float(part)
        assert torch.equal(torch.cat(outs)[:n], want_r)
        assert n2 == pytest.approx(float(want_n2), rel=1e-6)
        assert tpx.LAUNCHES["residual_df_norm_seg"] == D
        return
    hh = 4
    calls = {
        "K28": ("rb_smooth_seg", 1,  # one-pass: one launch a call
                lambda r: tpx.rb_smooth_halo(parts(u, r, hh, hh), parts(f, r, hh, hh),
                                             r * L - hh, h, 2, n, L, False),
                lambda r: tpx.rb_smooth_halo_plain(parts(u, r, hh, hh), parts(f, r, hh, hh),
                                                   r * L - hh, h, 2, n, L, False),
                tpk.rb_smooth_fused(u[:n].clone(), f[:n], h, 2, red_first=False)),
        "K29": ("rb_smooth_from_zero_seg", 1,  # one-pass: one launch a call
                lambda r: tpx.rb_smooth_from_zero_halo(parts(f, r, hh, hh), r * L - hh, h, 2,
                                                       n, L),
                lambda r: tpx.rb_smooth_from_zero_halo_plain(parts(f, r, hh, hh), r * L - hh, h,
                                                             2, n, L),
                tpk.rb_smooth_from_zero_fused(f[:n], h, 2)),
        "K30": ("residual_restrict_seg", 1,
                lambda r: tpx.residual_restrict_halo(parts(u, r, 2, 1), parts(f, r, 2, 1),
                                                     r * L - 2, h, n, Lc),
                lambda r: tpx.residual_restrict_halo_plain(parts(u, r, 2, 1), parts(f, r, 2, 1),
                                                           r * L - 2, h, n, Lc),
                tpk.residual_restrict_fused(u[:n], f[:n], h)),
        "K31": ("prolong_smooth_seg", 1,
                lambda r: tpx.prolong_smooth_halo(parts(ec, r, 2, 3, Lc), parts(u, r, hh, hh),
                                                  parts(f, r, hh, hh), r * L - hh, h, 2, n, L),
                lambda r: tpx.prolong_smooth_halo_plain(parts(ec, r, 2, 3, Lc),
                                                        parts(u, r, hh, hh), parts(f, r, hh, hh),
                                                        r * L - hh, h, 2, n, L),
                tpk.prolong_smooth_fused(ec[:nc], u[:n], f[:n], h, 2)),
        "K33": ("residual_seg", 1,
                lambda r: tpx.residual_ext(rk.rank_ext(u, r, L, 1), rk.rank_ext(f, r, L, 1),
                                           r * L - 1, h, n, L),
                lambda r: tpx.residual_ext_plain(rk.rank_ext(u, r, L, 1), rk.rank_ext(f, r, L, 1),
                                                 r * L - 1, h, n, L),
                tpk.residual_fused(u[:n], f[:n], h)),
    }
    name, per_call, kern, plain, want = calls[kernel]
    tpx.reset_launches()
    outs = []
    for r in range(D):
        got = kern(r)
        assert torch.equal(got, plain(r)), r
        outs.append(got)
    assert torch.equal(torch.cat(outs)[:want.shape[0]], want)
    assert tpx.LAUNCHES == {**dict.fromkeys(tpx.KERNELS, 0), name: per_call * D}


# (n, L, ranks) of K33: four ranks' L = 96 (n - 1) / 256 (at 257^3 rank 3 pad only) and one
# rank's L = 320 (n - 1) / 256 (at 257^3 63 pad planes), at every odd n 9^3-513^3
K33_CASES = [(n, L, ranks) for n in (9, 17, 33, 65, 129, 257, 513)
             for L, ranks in ((96 * (n - 1) // 256, 4), (320 * (n - 1) // 256, 1))]


def _k33_rank(x, r, L, n):
    """Rank r's ext copy (L + 2 planes, halo 1) of the global field x, its
    planes past the field NaN (no residual reads them)."""
    import torch_sharded_ranks as rk

    return _nan_past(rk.rank_ext(x, r, L, 1), (r * L - 1,), n, (0,))


@pytest.mark.cuda
@pytest.mark.parametrize("n,L,ranks", K33_CASES)
def test_k33_resid_stage_matches_plain_on_card(cuda, n, L, ranks):
    """K33 on every rank of the geometry: the streaming stage launched on
    its plan, and the wrapper (that stage at every size: the library holds
    no other K33 kernel), each bit for bit its plain version on fields
    random at every plane, u's and f's planes past the
    field NaN, the output NaN before the stage and the allocator poisoned
    with NaN before the wrapper (a point left unwritten shows); one launch a
    call; the inputs left as they were; the stitched r equal to R's on the
    whole field, the pad planes 0."""
    from multigrid_parallel_tpu_torch.ops import pallas_sharded as tpx

    h, inv_h2 = 1.0 / (n - 1), float((n - 1) ** 2)
    lib, stream = tpk._lib(), tpk._stream()
    assert not hasattr(lib, "mg_seg_residual")  # the first form, one thread a point, is gone
    rng = np.random.default_rng(1400 + n + L)
    u, f = (torch.from_numpy(rng.standard_normal((ranks * L, n, n)).astype(np.float32)).to(cuda)
            for _ in range(2))
    outs = []
    for r in range(ranks):
        u_ext, f_ext = _k33_rank(u, r, L, n), _k33_rank(f, r, L, n)
        before = (u_ext.clone(), f_ext.clone())
        want = tpx.residual_ext_plain(u_ext, f_ext, r * L - 1, h, n, L)
        rows = tpx.seg_df_extents(n, r * L, L)[0]
        stage = torch.full((L, n, n), float("nan"), device=cuda)
        us = tpx._seg(tpx._ext_parts(u_ext, 1, L), 1, 1, L)
        assert lib.mg_seg_resid_stage(stage.data_ptr(), *tpx._ptrs(us), f_ext[1:-1].data_ptr(),
                                      1, L, 1, n, r * L, inv_h2,
                                      *tpx.seg_resid_args(n, cuda, rows), stream) == 0
        assert torch.equal(stage, want), r
        _poison_allocator((L, n, n), cuda)
        tpx.reset_launches()
        got = tpx.residual_ext(u_ext, f_ext, r * L - 1, h, n, L)
        assert tpx.LAUNCHES == {**dict.fromkeys(tpx.KERNELS, 0), "residual_seg": 1}
        assert bool(torch.isfinite(got).all()) and torch.equal(got, want), r
        assert _same_with_nan(u_ext, before[0]) and _same_with_nan(f_ext, before[1])
        outs.append(got)
    whole = torch.cat(outs)
    assert torch.equal(whole[:n], tpk.residual_fused(u[:n], f[:n], h)) and not whole[n:].any()


@pytest.mark.cuda
@pytest.mark.parametrize("n", [17, 65, 257])
def test_k33_stage_on_every_candidate_plan_on_card(cuda, n):
    """K33's stage launched directly on every plan that its planner weighs
    (pallas_split._df_candidates of the "resid" stage) of the one-rank block and
    rank 1's of four (the production sizes scaled to the level): r bit for
    bit the plain version's on NaN-filled outputs."""
    from multigrid_parallel_tpu_torch.ops import pallas_sharded as tpx

    h, lib, stream = 1.0 / (n - 1), tpk._lib(), tpk._stream()
    rng = np.random.default_rng(1500 + n)
    for L, r in ((320 * (n - 1) // 256, 0), (96 * (n - 1) // 256, 1)):
        u, f = (torch.from_numpy(rng.standard_normal(((r + 2) * L, n, n)).astype(np.float32))
                .to(cuda) for _ in range(2))
        u_ext, f_ext = _k33_rank(u, r, L, n), _k33_rank(f, r, L, n)
        us = tpx._seg(tpx._ext_parts(u_ext, 1, L), 1, 1, L)
        want = tpx.residual_ext_plain(u_ext, f_ext, r * L - 1, h, n, L)
        rows = tpx.seg_df_extents(n, r * L, L)[0]
        for plan in tps._df_candidates(n, rows, n - 2, stage="resid"):
            out = torch.full((L, n, n), float("nan"), device=cuda)
            assert lib.mg_seg_resid_stage(out.data_ptr(), *tpx._ptrs(us), f_ext[1:-1].data_ptr(),
                                          1, L, 1, n, r * L, 1.0 / (h * h), *plan.args,
                                          stream) == 0, plan
            assert torch.equal(out, want), (L, r, plan)


@pytest.mark.cuda
def test_k33_launcher_refuses_what_the_stage_does_not_take(cuda):
    """The K33 stage launcher refuses a plan it cannot run (a box past the
    interior, chunks that do not cover its k tile, threads other than a
    warp a row), shared memory other than its one ring's (K32's two rings
    among them), a missing halo plane on either side and an r that meets
    u's segment or f; the wrapper's own arguments succeed."""
    from multigrid_parallel_tpu_torch.ops import pallas_sharded as tpx

    n, L, r = 33, 12, 1
    inv_h2 = float((n - 1) ** 2)
    lib, stream = tpk._lib(), tpk._stream()
    rng = np.random.default_rng(1600)
    u, f = (torch.from_numpy(rng.standard_normal((4 * L, n, n)).astype(np.float32)).to(cuda)
            for _ in range(2))
    u_ext, f_ext = _k33_rank(u, r, L, n), _k33_rank(f, r, L, n)
    us, fb = tpx._seg(tpx._ext_parts(u_ext, 1, L), 1, 1, L), f_ext[1:-1]
    rows = tpx.seg_df_extents(n, r * L, L)[0]
    plan = tps._df_plan(n, torch.cuda.get_device_properties(0).multi_processor_count, rows,
                        n - 2, stage="resid")
    out = torch.empty((L, n, n), device=cuda)

    def k33(args, kl=1, kr=1, r_out=out):
        return lib.mg_seg_resid_stage(r_out.data_ptr(), *tpx._ptrs(us), fb.data_ptr(), kl, L, kr,
                                      n, r * L, inv_h2, *args, stream)

    bi, bj, bk, chunks, threads, smem = plan.args
    assert k33(plan.args) == 0
    assert torch.equal(out, tpx.residual_ext_plain(u_ext, f_ext, r * L - 1, h=1.0 / (n - 1),
                                                   n=n, L=L))
    assert k33((rows + 1, bj, bk, chunks, threads, smem)) != 0          # past the interior
    assert k33((bi, bj, bk, 2 * chunks, threads, smem)) != 0            # chunks
    assert k33((bi, bj, bk, chunks, threads + 32, smem)) != 0           # threads
    assert k33((bi, bj, bk, chunks, threads, smem + 16)) != 0           # other smem
    assert k33((bi, bj, bk, chunks, threads, tps._df_smem(bj, bk))) != 0  # K32's two rings
    assert k33(plan.args, kl=0) != 0 and k33(plan.args, kr=0) != 0
    assert k33(plan.args, r_out=us.body) != 0 and k33(plan.args, r_out=fb) != 0
    assert k33(plan.args, r_out=u_ext[:L]) != 0
    torch.cuda.synchronize()


@pytest.mark.cuda
def test_sharded_df_solver_one_nccl_rank_matches_fused(cuda):
    """make_sharded_df_solver at 65^3 on one NCCL rank (a spawned process)
    against the single-device fused solve: the same outer steps, the
    solution within 1e-9, only K28-K32 launched."""
    import torch_sharded_ranks as rk
    from multigrid_parallel_tpu_torch.parallel.launch import launch

    hier = tmg.Hierarchy(ndim=3, coarse_n=5, num_levels=5)
    prob = tmg.poisson_3d_quadratic()
    init = tcp.ref_init_norm(prob, hier, cuda)
    steps, nrm, _, err, u, plan, launches = launch(rk.df_solver, 1, 65, 4, False, 0, init,
                                                   backend="nccl", device="cuda")[0]
    run = tcp.make_on_device_df_solver(hier, tmg.CycleConfig(n_smooth=2), rel_tol=1e-8,
                                       inner_cycles=4, init_norm=init, device=cuda)
    out = run(*tcp.setup_df_problem(prob, hier, cuda))
    assert (plan.n_sharded, plan.fine_local) == (4, 80)
    assert steps == out[3] and nrm <= 1e-8 * init
    assert float((u - tpk.df_to_f64(*out[:2]).cpu()).abs().max()) <= 1e-9
    seg = {"rb_smooth_seg", "rb_smooth_from_zero_seg", "residual_restrict_seg",
           "prolong_smooth_seg", "residual_df_norm_seg"}
    assert {k for k, v in launches.items() if v} == seg, launches


def _nan_past_field(parts, g0, gj0, L, Lj, hl, hr, n):
    """Five (i, j) parts (body, jl, jr, lh, rhc; lh hl rows, rhc hr) of a
    block whose body point (0, 0) is global (g0, gj0), with every HALO
    point past the field's edge (a global row or column < 0 or > n - 1)
    NaN; the body's pad points keep their values."""
    body, jl, jr, lh, rh = (t.clone() for t in parts)
    hj = jl.shape[1]

    def poison(t, rows0, cols0):
        g = torch.arange(t.shape[0], device=t.device) + rows0
        gj = torch.arange(t.shape[1], device=t.device) + cols0
        out = (g[:, None] < 0) | (g[:, None] > n - 1) | (gj[None, :] < 0) | (gj[None, :] > n - 1)
        t[out] = float("nan")

    poison(jl, g0, gj0 - hj)
    poison(jr, g0, gj0 + Lj)
    poison(lh, g0 - hl, gj0 - hj)
    poison(rh, g0 + L + hr - rh.shape[0], gj0 - hj)
    return body, jl, jr, lh, rh


# (n, L, ranks) of K31: the production segments at 257^3, four ranks' L = 96 (rank 3 pad
# only) and one rank's L = 320 (63 pad rows), and 65^3 with L = 24
K31_CASES = [(257, 96, 4), (257, 320, 1), (65, 24, 4)]
# (n, (nx, ny), Li, Lj) of K40: the 1x1 block at 257^3 (15 pad rows and columns) and every
# block of the 2x2 mesh (block (1, 1) 31 pad rows and columns), and 65^3's 1x4 narrow blocks
K40_CASES = [(257, (1, 1), 272, 272), (257, (2, 2), 144, 144), (65, (1, 4), 80, 18)]


@pytest.mark.cuda
@pytest.mark.parametrize("n,L,ranks", K31_CASES)
def test_k31_seg_stage_matches_plain_on_card(cuda, n, L, ranks):
    """The one-pass K31 stage on every rank of the geometry, n_iter 1-3:
    each body bit for bit its plain version, on fields random at every
    plane (pad rows and the coarse block's pad rows too, so the pad rows'
    e + P ec shows), e's and r's halo rows past the field NaN, the
    allocator poisoned with NaN before each call (a point left unwritten
    shows); exactly one launch a call at n_iter <= 2 (6 at 3, the first
    form); at n_iter 2 the stitched bodies equal K4's on the whole field;
    the inputs left as they were."""
    import torch_sharded_ranks as rk
    from multigrid_parallel_tpu_torch.ops import pallas_sharded as tpx

    h, nc, lc = 1.0 / (n - 1), (n + 1) // 2, L // 2
    rng = np.random.default_rng(500 + n + L)
    e, f = (torch.from_numpy(rng.standard_normal((ranks * L, n, n)).astype(np.float32)).to(cuda)
            for _ in range(2))
    ec = torch.from_numpy(rng.standard_normal((ranks * lc, nc, nc)).astype(np.float32)).to(cuda)
    for n_iter in (1, 2, 3):
        hh, calls = 2 * n_iter, 1 if n_iter <= 2 else 2 * n_iter
        outs = []
        for r in range(ranks):
            gi0 = r * L - hh
            e3 = _seg_triples(e, r, L, hh, hh, n, tail=2)
            f3 = _seg_triples(f, r, L, hh, hh, n)
            ec3 = rk.rank_parts(ec, r, lc, n_iter, n_iter + 1, tail=1)
            before = [t.clone() for t in (*e3, *f3, *ec3)]
            want = tpx.prolong_smooth_halo_plain(ec3, e3, f3, gi0, h, n_iter, n, L)
            _poison_allocator((L, n, n), cuda)
            tpx.reset_launches()
            got = tpx.prolong_smooth_halo(ec3, e3, f3, gi0, h, n_iter, n, L)
            assert tpx.LAUNCHES == {**dict.fromkeys(tpx.KERNELS, 0), "prolong_smooth_seg": calls}
            assert bool(torch.isfinite(got).all()) and torch.equal(got, want), (n_iter, r)
            assert all(_same_with_nan(a, b) for a, b in zip((*e3, *f3, *ec3), before))
            outs.append(got)
        if n_iter == 2:
            whole = torch.cat(outs)[:n]
            assert torch.equal(whole, tpk.prolong_smooth_fused(ec[:nc], e[:n], f[:n], h, 2))


@pytest.mark.cuda
@pytest.mark.parametrize("n,mesh,li,lj", K40_CASES)
def test_k40_seg2d_stage_matches_plain_on_card(cuda, n, mesh, li, lj):
    """The one-pass K40 stage on every block of the mesh, n_iter 1-3: each
    block bit for bit its plain version, on fields random at every point
    (the pad rows and columns too), e's and r's halo points past the field
    NaN (corner blocks included), the allocator poisoned with NaN before
    each call; exactly one launch a call at n_iter <= 2 (6 at 3, the first
    form); at n_iter 2 the stitched blocks equal K4's on the whole field;
    the inputs left as they were."""
    import torch_sharded_ranks as rk
    from multigrid_parallel_tpu_torch.ops import pallas_sharded2d as tpx2

    (nx, ny), h, nc = mesh, 1.0 / (n - 1), (n + 1) // 2
    rng = np.random.default_rng(600 + n + li + lj)

    def rnd(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(cuda)

    e, f, ec = rnd(nx * li, ny * lj, n), rnd(nx * li, ny * lj, n), rnd(nx * li // 2, ny * lj // 2,
                                                                         nc)
    for n_iter in (1, 2, 3):
        hh, calls = 2 * n_iter, 1 if n_iter <= 2 else 2 * n_iter
        outs = {}
        for ix in range(nx):
            for iy in range(ny):
                g0, gj0 = ix * li, iy * lj
                e5 = _nan_past_field(rk.rank_parts2d(e, ix, iy, li, lj, hh, hh, tail=2), g0, gj0,
                                     li, lj, hh, hh, n)
                f5 = _nan_past_field(rk.rank_parts2d(f, ix, iy, li, lj, hh, hh), g0, gj0, li, lj,
                                     hh, hh, n)
                c5 = rk.rank_parts2d(ec, ix, iy, li // 2, lj // 2, n_iter, n_iter + 1)
                before = [t.clone() for t in (*e5, *f5, *c5)]
                gij0 = (g0 - hh, gj0 - hh)
                want = tpx2.prolong_smooth_halo2d_plain(c5, e5, f5, gij0, h, n_iter, n, li, lj)
                _poison_allocator((li, lj, n), cuda)
                tpx2.reset_launches()
                got = tpx2.prolong_smooth_halo2d(c5, e5, f5, gij0, h, n_iter, n, li, lj)
                assert tpx2.LAUNCHES == {**dict.fromkeys(tpx2.KERNELS, 0),
                                         "prolong_smooth_seg2d": calls}
                assert bool(torch.isfinite(got).all()) and torch.equal(got, want), (n_iter, ix, iy)
                assert all(_same_with_nan(a, b) for a, b in zip((*e5, *f5, *c5), before))
                outs[ix, iy] = got
        if n_iter == 2:
            whole = _stitch2d(lambda ix, iy: outs[ix, iy], nx, ny)[:n, :n].contiguous()
            assert torch.equal(whole, tpk.prolong_smooth_fused(ec[:nc, :nc].contiguous(),
                                                               e[:n, :n].contiguous(),
                                                               f[:n, :n].contiguous(), h, 2))


@pytest.mark.cuda
def test_seg_rect_launchers_refuse_what_they_do_not_take(cuda):
    """The K31 and K40 launchers refuse a plan whose shared memory is not
    the kernel's, and a halo shorter than 2 n_iter (K31: the left or the
    right rows; K40: also the j columns); the wrappers' own arguments
    succeed."""
    import torch_sharded_ranks as rk
    from multigrid_parallel_tpu_torch.ops import pallas_sharded as tpx
    from multigrid_parallel_tpu_torch.ops import pallas_sharded2d as tpx2

    n, L, r, n_iter, hh = 33, 16, 1, 2, 4
    h2 = (1.0 / (n - 1)) ** 2
    e, f, ec = _sharded_fields(cuda, n, L)
    lib, stream, ptrs = tpk._lib(), tpk._stream(), tpx._ptrs
    es, fs = (tpx._seg(rk.rank_parts(x, r, L, hh, hh), hh, hh, L) for x in (e, f))
    cs = tpx._seg(rk.rank_parts(ec, r, L // 2, n_iter, n_iter + 1), n_iter, n_iter + 1, L // 2)
    plan = tps._plan_args(n, n_iter, cuda, prolong=True, rect=True,
                          seg_planes=tpx.seg_rect_planes(r * L, L, n))
    bad = plan[:6] + (plan[6] + 16,) + plan[7:]
    out = torch.empty((L, n, n), device=cuda)

    def k31(kl, kr, p):
        return lib.mg_seg_prolong_stage(out.data_ptr(), *ptrs(cs), cs.kl, n_iter + 1, *ptrs(es),
                                        *ptrs(fs), kl, L, kr, n, r * L, h2, *p, stream)

    assert k31(hh, hh, plan) == 0
    assert k31(hh, hh, bad) != 0 and k31(hh - 1, hh, plan) != 0 and k31(hh, hh - 1, plan) != 0
    li = lj = 18
    u2, f2, ec2 = _blocks2d(cuda, n, li, lj)
    e5, r5 = (tpx2._seg2(rk.rank_parts2d(x, 1, 1, li, lj, hh, hh), li, lj, hh, hh, hh, hh)
              for x in (u2, f2))
    c5 = tpx2._seg2(rk.rank_parts2d(ec2, 1, 1, li // 2, lj // 2, n_iter, n_iter + 1), li // 2,
                    lj // 2, n_iter, n_iter + 1, n_iter, n_iter + 1)
    plan2 = tps._plan_args(n, n_iter, cuda, prolong=True, rect=True,
                           seg_planes=tpx.seg_rect_planes(li, li, n),
                           seg_cols=tpx.seg_rect_planes(lj, lj, n))
    bad2 = plan2[:6] + (plan2[6] + 16,) + plan2[7:]
    out2 = torch.empty((li, lj, n), device=cuda)

    def k40(kr, hjr, p, e=e5):
        return lib.mg_seg2d_prolong_stage(out2.data_ptr(), c5.desc(), e.desc(), r5.desc(), kr,
                                          hjr, n_iter + 1, n_iter + 1, li, lj, n, li, lj, h2, *p,
                                          stream)

    assert k40(hh, hh, plan2) == 0
    assert k40(hh, hh, bad2) != 0 and k40(hh - 1, hh, plan2) != 0 and k40(hh, hh - 1, plan2) != 0
    short = tpx2._Seg2(e5.body, e5.jl[:, 1:], e5.jr, e5.lh, e5.rh, e5.r_off)  # a j halo of 3
    assert k40(hh, hh, plan2, short) != 0
    torch.cuda.synchronize()


# (n, L, ranks) of K30: the production segments at 257^3 (four ranks' L = 96, rank 3 pad
# only; one rank's L = 320, 63 pad planes) and 513^3 (one rank, L = 640), and each level
# below 257^3 of both plans
K30_CASES = ([(257, 96, 4), (257, 320, 1), (513, 640, 1)]
             + [(257 >> d | 1, 320 >> d, 1) for d in range(1, 6)]
             + [(257 >> d | 1, 96 >> d, 4) for d in range(1, 5)])
# (n, (nx, ny), Li, Lj) of K39: the 1x1 block at 257^3 (15 pad rows and columns) and every
# block of the 2x2 mesh, each level of both plans below it, 17^3 and 9^3 blocks, and 65^3's
# 1x4 narrow blocks (the last of pad columns only)
K39_CASES = ([(257, (1, 1), 272, 272), (257, (2, 2), 144, 144)]
             + [(257 >> d | 1, (1, 1), 272 >> d, 272 >> d) for d in range(1, 4)]
             + [(257 >> d | 1, (2, 2), 144 >> d, 144 >> d) for d in range(1, 4)]
             + [(17, (1, 1), 18, 18), (9, (1, 1), 10, 10), (65, (1, 4), 80, 18)])


def _nan_past(x, first, n, dims):
    """x (a rank's part) with every point whose GLOBAL index along one of
    ``dims`` (its first index ``first`` there) lies past the field (< 0 or
    > n - 1) NaN: points no restriction reads."""
    x = x.clone()
    for d, g in zip(dims, first):
        idx = torch.arange(x.shape[d], device=x.device) + g
        out = (idx < 0) | (idx > n - 1)
        x[(slice(None),) * d + (out,)] = float("nan")
    return x


@pytest.mark.cuda
@pytest.mark.parametrize("n,L,ranks", K30_CASES)
def test_k30_seg_restrict_matches_plain_on_card(cuda, n, L, ranks):
    """K30 on every rank of the geometry, through the wrapper's choice of
    form: each coarse block bit for bit its plain version, on fields random
    at every plane, e's and r's planes past the field NaN (halo and pad
    planes, which no restriction reads), the allocator poisoned with NaN
    before each call (a point left unwritten shows); one launch a call;
    the inputs left as they were; the stitched blocks equal K3's on the
    whole field, the pad planes 0."""
    import torch_sharded_ranks as rk
    from multigrid_parallel_tpu_torch.ops import pallas_sharded as tpx

    h, nc, lc = 1.0 / (n - 1), (n + 1) // 2, L // 2
    rng = np.random.default_rng(700 + n + L)
    e, f = (torch.from_numpy(rng.standard_normal((ranks * L, n, n)).astype(np.float32)).to(cuda)
            for _ in range(2))
    outs = []
    for r in range(ranks):
        g0 = r * L
        e3, f3 = ([_nan_past(t, (g,), n, (0,)) for t, g in zip(rk.rank_parts(x, r, L, 2, 1),
                                                                 (g0, g0 - 2, g0 + L))]
                  for x in (e, f))
        before = [t.clone() for t in (*e3, *f3)]
        want = tpx.residual_restrict_halo_plain(e3, f3, g0 - 2, h, n, lc)
        _poison_allocator((lc, nc, nc), cuda)
        tpx.reset_launches()
        got = tpx.residual_restrict_halo(e3, f3, g0 - 2, h, n, lc)
        assert tpx.LAUNCHES == {**dict.fromkeys(tpx.KERNELS, 0), "residual_restrict_seg": 1}
        assert bool(torch.isfinite(got).all()) and torch.equal(got, want), r
        assert all(_same_with_nan(a, b) for a, b in zip((*e3, *f3), before))
        outs.append(got)
    whole = torch.cat(outs)
    assert torch.equal(whole[:nc], tpk.residual_restrict_fused(e[:n], f[:n], h))
    assert not whole[nc:].any()


@pytest.mark.cuda
@pytest.mark.parametrize("n,mesh,li,lj", K39_CASES)
def test_k39_seg2d_restrict_matches_plain_on_card(cuda, n, mesh, li, lj):
    """K39 on every block of the mesh, through the wrapper's choice of
    form: each coarse block bit for bit its plain version, on fields random
    at every point, e's and r's points past the field NaN (halo and pad
    rows and columns, corner blocks included), the allocator poisoned with
    NaN before each call; one launch a call; the inputs left as they were;
    the stitched blocks equal K3's on the whole field, the pad points 0."""
    import torch_sharded_ranks as rk
    from multigrid_parallel_tpu_torch.ops import pallas_sharded2d as tpx2

    (nx, ny), h, nc = mesh, 1.0 / (n - 1), (n + 1) // 2
    lic, ljc = li // 2, lj // 2
    rng = np.random.default_rng(800 + n + li + lj)
    e, f = (torch.from_numpy(rng.standard_normal((nx * li, ny * lj, n)).astype(np.float32))
            .to(cuda) for _ in range(2))
    outs = {}
    for ix in range(nx):
        for iy in range(ny):
            g0, gj0 = ix * li, iy * lj
            firsts = ((g0, gj0), (g0, gj0 - 2), (g0, gj0 + lj), (g0 - 2, gj0 - 2),
                      (g0 + li, gj0 - 2))
            e5, f5 = ([_nan_past(t, g, n, (0, 1)) for t, g in
                       zip(rk.rank_parts2d(x, ix, iy, li, lj, 2, 1), firsts)] for x in (e, f))
            before = [t.clone() for t in (*e5, *f5)]
            gij0 = (g0 - 2, gj0 - 2)
            want = tpx2.residual_restrict_halo2d_plain(e5, f5, gij0, h, n, lic, ljc)
            _poison_allocator((lic, ljc, nc), cuda)
            tpx2.reset_launches()
            got = tpx2.residual_restrict_halo2d(e5, f5, gij0, h, n, lic, ljc)
            assert tpx2.LAUNCHES == {**dict.fromkeys(tpx2.KERNELS, 0),
                                     "residual_restrict_seg2d": 1}
            assert bool(torch.isfinite(got).all()) and torch.equal(got, want), (ix, iy)
            assert all(_same_with_nan(a, b) for a, b in zip((*e5, *f5), before))
            outs[ix, iy] = got
    whole = _stitch2d(lambda ix, iy: outs[ix, iy], nx, ny)
    want = tpk.residual_restrict_fused(e[:n, :n].contiguous(), f[:n, :n].contiguous(), h)
    assert torch.equal(whole[:nc, :nc], want)
    assert not whole[nc:].any() and not whole[:, nc:].any()


@pytest.mark.cuda
@pytest.mark.parametrize("n", [17, 65, 257])
def test_seg_restrict_on_hand_plans_on_card(cuda, n):
    """K30's and K39's stages on hand plans (several blocks along i and j,
    k tiles of 2 and 3 coarse points, one row a block) launched directly:
    bit for bit their plain versions on NaN-poisoned outputs; K30 on an
    interior rank and the last of four (a pad tail; at 17^3 pad only), K39 on the (1, 1)
    block of a 2x2 mesh, its halos and corner block from the other three."""
    import torch_sharded_ranks as rk
    from multigrid_parallel_tpu_torch.ops import pallas_sharded as tpx
    from multigrid_parallel_tpu_torch.ops import pallas_sharded2d as tpx2

    h, nc, m = 1.0 / (n - 1), (n + 1) // 2, (n + 1) // 2 - 2
    L = 2 * ((n + 3) // 8 + 1)
    lib, stream = tpk._lib(), tpk._stream()
    rng = np.random.default_rng(900 + n)
    e, f = (torch.from_numpy(rng.standard_normal((4 * L, n, n)).astype(np.float32)).to(cuda)
            for _ in range(2))
    for r in (1, 3):
        g0 = r * L
        e3, f3 = (rk.rank_parts(x, r, L, 2, 1) for x in (e, f))
        es, fs = (tpx._seg(x, 2, 1, L, composite=False) for x in (e3, f3))
        want = tpx.residual_restrict_halo_plain(e3, f3, g0 - 2, h, n, L // 2)
        rows, _ = tpx.seg_restrict_extents(n, g0, L)
        for bci, bcj, bck in ((2, 3, m), (3, 2, 2), (1, 8, 3), (rows, 1, 1)):
            plan = tps._restrict_plan(n, 132, seg_rows=rows)._replace(
                bci=min(bci, rows), bcj=min(bcj, m), bck=min(bck, m))
            plan = plan._replace(chunks=tps._restrict_chunks(plan.bck, False),
                                 threads=32 * (2 * plan.bcj + 1),
                                 smem=tps._restrict_smem(plan.bcj, plan.bck, False))
            out = torch.full((L // 2, nc, nc), float("nan"), device=cuda)
            assert lib.mg_seg_restrict_stage(out.data_ptr(), *tpx._ptrs(es), *tpx._ptrs(fs), 2,
                                             L, 1, n, g0, 1.0 / (h * h), *plan.args,
                                             stream) == 0
            assert torch.equal(out, want), (r, plan)
    li = lj = 2 * ((n + 3) // 4)
    e2, f2 = (torch.from_numpy(rng.standard_normal((2 * li, 2 * lj, n)).astype(np.float32))
              .to(cuda) for _ in range(2))
    e5, f5 = (rk.rank_parts2d(x, 1, 1, li, lj, 2, 1) for x in (e2, f2))
    es, fs = (tpx2._seg2(x, li, lj, 2, 1, 2, 1, composite=False) for x in (e5, f5))
    want = tpx2.residual_restrict_halo2d_plain(e5, f5, (li - 2, lj - 2), h, n, li // 2, lj // 2)
    rows, cols = tpx.seg_restrict_extents(n, li, li, lj, lj)
    for bci, bcj, bck in ((2, 3, m), (3, 2, 2), (1, 8, 3)):
        plan = tps._restrict_plan(n, 132, seg_rows=rows, seg_cols=cols)._replace(
            bci=min(bci, rows), bcj=min(bcj, cols), bck=min(bck, m))
        plan = plan._replace(chunks=tps._restrict_chunks(plan.bck, False),
                             threads=32 * (2 * plan.bcj + 1),
                             smem=tps._restrict_smem(plan.bcj, plan.bck, False))
        out = torch.full((li // 2, lj // 2, nc), float("nan"), device=cuda)
        assert lib.mg_seg2d_restrict_stage(out.data_ptr(), es.desc(), fs.desc(), 1, 1, li, lj, n,
                                           li, lj, 1.0 / (h * h), *plan.args, stream) == 0
        assert torch.equal(out, want), plan


@pytest.mark.cuda
def test_seg_restrict_launchers_refuse_what_they_do_not_take(cuda):
    """The K30 and K39 stage launchers refuse a plan whose shared memory is
    not the kernel's, a halo shorter than the stencil's (e 2 rows before
    the block and 1 after; K39 also 2 columns before and 1 after), and an
    odd rank offset; the wrappers' own arguments succeed."""
    import torch_sharded_ranks as rk
    from multigrid_parallel_tpu_torch.ops import pallas_sharded as tpx
    from multigrid_parallel_tpu_torch.ops import pallas_sharded2d as tpx2

    n, L, r = 33, 16, 1
    inv_h2 = float((n - 1) ** 2)
    e, f, _ = _sharded_fields(cuda, n, L)
    lib, stream, ptrs = tpk._lib(), tpk._stream(), tpx._ptrs
    es, fs = (tpx._seg(rk.rank_parts(x, r, L, 2, 1), 2, 1, L, composite=False) for x in (e, f))
    plan = tps._restrict_args(n, cuda, seg_rows=tpx.seg_restrict_extents(n, r * L, L)[0])
    bad = plan[:5] + (plan[5] + 16,)
    out = torch.empty((L // 2, (n + 1) // 2, (n + 1) // 2), device=cuda)

    def k30(kl, kr, g0, p):
        return lib.mg_seg_restrict_stage(out.data_ptr(), *ptrs(es), *ptrs(fs), kl, L, kr, n, g0,
                                         inv_h2, *p, stream)

    assert k30(2, 1, r * L, plan) == 0
    assert k30(2, 1, r * L, bad) != 0
    assert k30(1, 1, r * L, plan) != 0 and k30(2, 0, r * L, plan) != 0
    assert k30(2, 1, r * L + 1, plan) != 0
    li = lj = 18
    u2, f2, _ = _blocks2d(cuda, n, li, lj)
    e5, r5 = (tpx2._seg2(rk.rank_parts2d(x, 1, 1, li, lj, 2, 1), li, lj, 2, 1, 2, 1,
                         composite=False) for x in (u2, f2))
    plan2 = tps._restrict_args(n, cuda, seg_rows=tpx.seg_restrict_extents(n, li, li, lj, lj)[0],
                               seg_cols=tpx.seg_restrict_extents(n, li, li, lj, lj)[1])
    bad2 = plan2[:5] + (plan2[5] + 16,)
    out2 = torch.empty((li // 2, lj // 2, (n + 1) // 2), device=cuda)

    def k39(kr, hjr, g0, gj0, p, e=e5):
        return lib.mg_seg2d_restrict_stage(out2.data_ptr(), e.desc(), r5.desc(), kr, hjr, li, lj,
                                           n, g0, gj0, inv_h2, *p, stream)

    assert k39(1, 1, li, lj, plan2) == 0
    assert k39(1, 1, li, lj, bad2) != 0
    assert k39(0, 1, li, lj, plan2) != 0 and k39(1, 0, li, lj, plan2) != 0
    assert k39(1, 1, li + 1, lj, plan2) != 0 and k39(1, 1, li, lj + 1, plan2) != 0
    short_j = tpx2._Seg2(e5.body, e5.jl[:, 1:], e5.jr, e5.lh[:, 1:], e5.rh[:, 1:], e5.r_off)
    short_i = tpx2._Seg2(e5.body, e5.jl, e5.jr, e5.lh[1:], e5.rh, e5.r_off)
    assert k39(1, 1, li, lj, plan2, short_j) != 0 and k39(1, 1, li, lj, plan2, short_i) != 0
    torch.cuda.synchronize()


# (n, L, ranks) of K32, K30's: the production segments at 257^3 (four ranks' L = 96, rank
# 3 pad only; one rank's L = 320, 63 pad planes) and 513^3, each level below 257^3 of both
# plans
K32_CASES = K30_CASES
# (n, (nx, ny), Li, Lj) of K41: K39's blocks, and the 4x1 and 1x4 meshes' blocks at 257^3
K41_CASES = K39_CASES + [(257, (4, 1), 72, 272), (257, (1, 4), 272, 72)]


def _df_global(rng, rows, cols, n, dev):
    """u_hi, u_lo, f_hi, f_lo: double-float splits of two random f64 fields of
    (rows, cols, n), random at every point."""
    return [t.to(dev) for _ in range(2)
            for t in tpk.df_split(torch.from_numpy(rng.standard_normal((rows, cols, n))))]


def _norm_within(got, want):
    """A partial norm within rel 1e-6 of the plain version's (the f64 sum in
    another order), exactly 0 where that is."""
    return abs(float(got) - float(want)) <= 1e-6 * abs(float(want))


@pytest.mark.cuda
@pytest.mark.parametrize("n,L,ranks", K32_CASES)
def test_k32_df_stage_matches_plain_on_card(cuda, n, L, ranks):
    """K32 on every rank of the geometry, through the wrapper's choice of
    form (the streaming stage from DF_STAGE_MIN_N up, the first form
    below): r bit for bit its plain version and the partial norm within
    rel 1e-6 of its, on
    double-float fields random at every plane, u's and f's planes past the
    field NaN (halo and pad planes, which no residual reads), the allocator
    poisoned with NaN before each call (a point left unwritten shows); one
    launch a call; the inputs left as they were; the stitched r equal to
    K5's on the whole field, the pad planes 0, the norms summed within rel
    1e-6 of K5's."""
    import torch_sharded_ranks as rk
    from multigrid_parallel_tpu_torch.ops import pallas_sharded as tpx

    h = 1.0 / (n - 1)
    df = _df_global(np.random.default_rng(1000 + n + L), ranks * L, n, n, cuda)
    outs, n2 = [], 0.0
    for r in range(ranks):
        g0 = r * L
        parts = [[_nan_past(t, (g,), n, (0,)) for t, g in zip(rk.rank_parts(x, r, L, 1, 1),
                                                               (g0, g0 - 1, g0 + L))]
                 for x in df]
        before = [t.clone() for p in parts for t in p]
        want, want_n2 = tpx.residual_df_norm_halo_plain(*parts, g0 - 1, h, n, L)
        _poison_allocator((L, n, n), cuda)
        tpx.reset_launches()
        got, got_n2 = tpx.residual_df_norm_halo(*parts, g0 - 1, h, n, L)
        assert tpx.LAUNCHES == {**dict.fromkeys(tpx.KERNELS, 0), "residual_df_norm_seg": 1}
        assert bool(torch.isfinite(got).all()) and torch.equal(got, want), r
        assert _norm_within(got_n2, want_n2), (r, float(got_n2), float(want_n2))
        assert all(_same_with_nan(a, b) for a, b in zip((t for p in parts for t in p), before))
        outs.append(got)
        n2 += float(got_n2)
    whole = torch.cat(outs)
    want_r, want_n2 = tpk.residual_df_norm_fused(*(x[:n] for x in df), h)
    assert torch.equal(whole[:n], want_r) and not whole[n:].any()
    assert _norm_within(n2, want_n2)


@pytest.mark.cuda
@pytest.mark.parametrize("n,mesh,li,lj", K41_CASES)
def test_k41_df_stage_matches_plain_on_card(cuda, n, mesh, li, lj):
    """K41 on every block of the mesh, through the wrapper's choice of form,
    as K32's test:
    r bit for bit its plain version, the norm within rel 1e-6, on fields
    random at every point, u's and f's points past the field NaN (halo and
    pad rows and columns), NaN-poisoned outputs, one launch a call, the
    inputs as they were; the stitched r equal to K5's on the whole field,
    the pad points 0, the norms summed within rel 1e-6 of K5's."""
    import torch_sharded_ranks as rk
    from multigrid_parallel_tpu_torch.ops import pallas_sharded2d as tpx2

    (nx, ny), h = mesh, 1.0 / (n - 1)
    df = _df_global(np.random.default_rng(1100 + n + li + lj), nx * li, ny * lj, n, cuda)
    outs, n2 = {}, 0.0
    for ix in range(nx):
        for iy in range(ny):
            g0, gj0 = ix * li, iy * lj
            firsts = ((g0, gj0), (g0, gj0 - 1), (g0, gj0 + lj), (g0 - 1, gj0 - 1),
                      (g0 + li, gj0 - 1))
            parts = [[_nan_past(t, g, n, (0, 1)) for t, g in
                      zip(rk.rank_parts2d(x, ix, iy, li, lj, 1, 1), firsts)] for x in df]
            before = [t.clone() for p in parts for t in p]
            gij0 = (g0 - 1, gj0 - 1)
            want, want_n2 = tpx2.residual_df_norm_halo2d_plain(*parts, gij0, h, n, li, lj)
            _poison_allocator((li, lj, n), cuda)
            tpx2.reset_launches()
            got, got_n2 = tpx2.residual_df_norm_halo2d(*parts, gij0, h, n, li, lj)
            assert tpx2.LAUNCHES == {**dict.fromkeys(tpx2.KERNELS, 0),
                                     "residual_df_norm_seg2d": 1}
            assert bool(torch.isfinite(got).all()) and torch.equal(got, want), (ix, iy)
            assert _norm_within(got_n2, want_n2), (ix, iy)
            assert all(_same_with_nan(a, b)
                       for a, b in zip((t for p in parts for t in p), before))
            outs[ix, iy] = got
            n2 += float(got_n2)
    whole = _stitch2d(lambda ix, iy: outs[ix, iy], nx, ny)
    want_r, want_n2 = tpk.residual_df_norm_fused(*(x[:n, :n].contiguous() for x in df), h)
    assert torch.equal(whole[:n, :n], want_r)
    assert not whole[n:].any() and not whole[:, n:].any()
    assert _norm_within(n2, want_n2)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [17, 65, 257])
def test_df_stage_on_every_candidate_plan_on_card(cuda, n):
    """K32's and K41's stages launched directly on every plan that the
    planner weighs (pallas_split._df_candidates) of the one-rank segment,
    rank 1's of four ranks and the 1x1 block (the production sizes scaled
    to the level): r bit for bit the plain version's on NaN-poisoned
    outputs, the norm within rel 1e-6."""
    import torch_sharded_ranks as rk
    from multigrid_parallel_tpu_torch.ops import pallas_sharded as tpx
    from multigrid_parallel_tpu_torch.ops import pallas_sharded2d as tpx2

    h, lib, stream = 1.0 / (n - 1), tpk._lib(), tpk._stream()
    rng = np.random.default_rng(1200 + n)
    for L, r in ((max(320 * (n - 1) // 256, n + 1), 0), (max(96 * (n - 1) // 256, -(-n // 4)), 1)):
        df = _df_global(rng, (r + 2) * L, n, n, cuda)
        parts = [rk.rank_parts(x, r, L, 1, 1) for x in df]
        segs = [tpx._seg(x, 1, 1, L) for x in parts[:2]]
        want, want_n2 = tpx.residual_df_norm_halo_plain(*parts, r * L - 1, h, n, L)
        rows, cols = tpx.seg_df_extents(n, r * L, L)
        for plan in tps._df_candidates(n, rows, cols):
            out = torch.full((L, n, n), float("nan"), device=cuda)
            nrm2 = torch.full((), float("nan"), device=cuda)
            partials = torch.empty(plan.blocks, dtype=torch.float64, device=cuda)
            assert lib.mg_seg_df_stage(out.data_ptr(), nrm2.data_ptr(), partials.data_ptr(),
                                       plan.blocks, *tpx._ptrs(segs[0]), *tpx._ptrs(segs[1]),
                                       parts[2][0].data_ptr(), parts[3][0].data_ptr(), 1, L, 1,
                                       n, r * L, 1.0 / (h * h), *plan.args, stream) == 0, plan
            assert torch.equal(out, want) and _norm_within(nrm2, want_n2), (L, r, plan)
    w = max(272 * (n - 1) // 256, n + 1)
    df = _df_global(rng, w, w, n, cuda)
    parts = [rk.rank_parts2d(x, 0, 0, w, w, 1, 1) for x in df]
    segs = tpx2._norm_segs(parts, w, w)
    want, want_n2 = tpx2.residual_df_norm_halo2d_plain(*parts, (-1, -1), h, n, w, w)
    rows, cols = tpx.seg_df_extents(n, 0, w, 0, w)
    for plan in tps._df_candidates(n, rows, cols):
        out = torch.full((w, w, n), float("nan"), device=cuda)
        nrm2 = torch.full((), float("nan"), device=cuda)
        partials = torch.empty(plan.blocks, dtype=torch.float64, device=cuda)
        assert lib.mg_seg2d_df_stage(out.data_ptr(), nrm2.data_ptr(), partials.data_ptr(),
                                     plan.blocks, *(s.desc() for s in segs), 1, 1, w, w, n, 0, 0,
                                     1.0 / (h * h), *plan.args, stream) == 0, plan
        assert torch.equal(out, want) and _norm_within(nrm2, want_n2), plan


@pytest.mark.cuda
def test_df_stage_launchers_refuse_what_they_do_not_take(cuda):
    """The K32 and K41 stage launchers refuse a plan whose shared memory is
    not the kernel's, a partials count that is not the launch's blocks, a
    missing halo (u without its row or column of halo on a side) and an r
    that meets an input; the wrappers' own arguments succeed."""
    import torch_sharded_ranks as rk
    from multigrid_parallel_tpu_torch.ops import pallas_sharded as tpx
    from multigrid_parallel_tpu_torch.ops import pallas_sharded2d as tpx2

    n, L, r = 33, 16, 1
    inv_h2 = float((n - 1) ** 2)
    lib, stream = tpk._lib(), tpk._stream()
    df = _df_global(np.random.default_rng(1300), 4 * L, n, n, cuda)
    parts = [rk.rank_parts(x, r, L, 1, 1) for x in df]
    uh, ul = (tpx._seg(x, 1, 1, L) for x in parts[:2])
    fh, fl = parts[2][0], parts[3][0]
    rows, cols = tpx.seg_df_extents(n, r * L, L)
    nparts, plan = tpx.seg_df_parts(n, cuda, rows, cols, L * n * n)
    bad = plan[:5] + (plan[5] + 16,)
    out = torch.empty((L, n, n), device=cuda)
    nrm2 = torch.empty((), device=cuda)
    partials = torch.empty(nparts + 1, dtype=torch.float64, device=cuda)

    def k32(kl, kr, p, m=nparts, r_out=out):
        return lib.mg_seg_df_stage(r_out.data_ptr(), nrm2.data_ptr(), partials.data_ptr(), m,
                                   *tpx._ptrs(uh), *tpx._ptrs(ul), fh.data_ptr(), fl.data_ptr(),
                                   kl, L, kr, n, r * L, inv_h2, *p, stream)

    assert k32(1, 1, plan) == 0
    assert k32(1, 1, bad) != 0 and k32(1, 1, plan, nparts + 1) != 0
    assert k32(0, 1, plan) != 0 and k32(1, 0, plan) != 0
    assert k32(1, 1, plan, r_out=uh.body) != 0 and k32(1, 1, plan, r_out=fl) != 0
    li = lj = 18
    df2 = _df_global(np.random.default_rng(1301), 2 * li, 2 * lj, n, cuda)
    segs = tpx2._norm_segs([rk.rank_parts2d(x, 1, 1, li, lj, 1, 1) for x in df2], li, lj)
    rows2, cols2 = tpx.seg_df_extents(n, li, li, lj, lj)
    nparts2, plan2 = tpx.seg_df_parts(n, cuda, rows2, cols2, li * lj * n)
    bad2 = plan2[:5] + (plan2[5] + 16,)
    out2 = torch.empty((li, lj, n), device=cuda)

    def k41(kr, hjr, p, s=segs, m=nparts2, r_out=out2):
        return lib.mg_seg2d_df_stage(r_out.data_ptr(), nrm2.data_ptr(), partials.data_ptr(), m,
                                     *(x.desc() for x in s), kr, hjr, li, lj, n, li, lj, inv_h2,
                                     *p, stream)

    assert k41(1, 1, plan2) == 0
    assert k41(1, 1, bad2) != 0 and k41(1, 1, plan2, m=nparts2 + 1) != 0
    assert k41(0, 1, plan2) != 0 and k41(1, 0, plan2) != 0
    u = segs[0]
    no_jl = tpx2._Seg2(u.body, u.jl[:, :0], u.jr, u.lh, u.rh, u.r_off)
    no_lh = tpx2._Seg2(u.body, u.jl, u.jr, u.lh[:0], u.rh, u.r_off)
    assert k41(1, 1, plan2, (no_jl,) + tuple(segs[1:])) != 0
    assert k41(1, 1, plan2, (no_lh,) + tuple(segs[1:])) != 0
    assert k41(1, 1, plan2, r_out=segs[3].body) != 0 and k41(1, 1, plan2, r_out=u.body) != 0
    torch.cuda.synchronize()


# (n, L, ranks) of K28, K30's: the production segments at 257^3 (four ranks' L = 96, rank
# 3 pad only; one rank's L = 320, 63 pad planes) and 513^3, each level below 257^3 of both
# plans (the 1x4 j-replicated tier's 9^3 level among them: one rank of L = 10)
K28_CASES = K30_CASES
# (n, (nx, ny), Li, Lj) of K37, K39's: the 1x1 and 2x2 blocks at 257^3 and below, 17^3 and
# 9^3 blocks, and 65^3's 1x4 narrow blocks (the last of pad columns only)
K37_CASES = K39_CASES


@pytest.mark.cuda
@pytest.mark.parametrize("n,L,ranks", K28_CASES)
def test_k28_seg_stage_matches_plain_on_card(cuda, n, L, ranks):
    """The one-pass K28 stage on every rank of the geometry, n_iter 1 and 2
    in both orders and n_iter 3 (the first form) red first: each body bit
    for bit its plain version, on fields random at every plane (the pad
    rows too, which the body keeps), u's and f's halo rows past the field
    NaN, the allocator poisoned with NaN before each call; exactly one
    launch a call at n_iter <= 2 (6 at 3); the inputs left as they were;
    at n_iter 2 the stitched bodies equal K1's on the whole field."""
    from multigrid_parallel_tpu_torch.ops import pallas_sharded as tpx

    h = 1.0 / (n - 1)
    rng = np.random.default_rng(1000 + n + L)
    u, f = (torch.from_numpy(rng.standard_normal((ranks * L, n, n)).astype(np.float32)).to(cuda)
            for _ in range(2))
    for n_iter, red in ((1, True), (1, False), (2, True), (2, False), (3, True)):
        hh, calls = 2 * n_iter, 1 if n_iter <= 2 else 2 * n_iter
        outs = []
        for r in range(ranks):
            gi0 = r * L - hh
            u3, f3 = _seg_triples(u, r, L, hh, hh, n, tail=2), _seg_triples(f, r, L, hh, hh, n)
            before = [t.clone() for t in (*u3, *f3)]
            want = tpx.rb_smooth_halo_plain(u3, f3, gi0, h, n_iter, n, L, red)
            _poison_allocator((L, n, n), cuda)
            tpx.reset_launches()
            got = tpx.rb_smooth_halo(u3, f3, gi0, h, n_iter, n, L, red)
            assert tpx.LAUNCHES == {**dict.fromkeys(tpx.KERNELS, 0), "rb_smooth_seg": calls}
            assert bool(torch.isfinite(got).all()) and torch.equal(got, want), (n_iter, red, r)
            assert all(_same_with_nan(a, b) for a, b in zip((*u3, *f3), before))
            outs.append(got)
        if n_iter == 2:
            whole = torch.cat(outs)[:n]
            assert torch.equal(whole, tpk.rb_smooth_fused(u[:n], f[:n], h, 2, red)), red


@pytest.mark.cuda
@pytest.mark.parametrize("n,mesh,li,lj", K37_CASES)
def test_k37_seg2d_stage_matches_plain_on_card(cuda, n, mesh, li, lj):
    """The one-pass K37 stage on every block of the mesh, n_iter 1 and 2 in
    both orders and n_iter 3 (the first form) red first: each block bit
    for bit its plain version, on fields random at every point (the pad
    rows and columns too, which the block keeps), u's and f's halo points
    past the field NaN (corner blocks included), the allocator poisoned
    with NaN before each call; exactly one launch a call at n_iter <= 2 (6
    at 3); the inputs left as they were; at n_iter 2 the stitched blocks
    equal K1's on the whole field."""
    import torch_sharded_ranks as rk
    from multigrid_parallel_tpu_torch.ops import pallas_sharded2d as tpx2

    (nx, ny), h = mesh, 1.0 / (n - 1)
    rng = np.random.default_rng(1100 + n + li + lj)
    u, f = (torch.from_numpy(rng.standard_normal((nx * li, ny * lj, n)).astype(np.float32))
            .to(cuda) for _ in range(2))
    for n_iter, red in ((1, True), (1, False), (2, True), (2, False), (3, True)):
        hh, calls = 2 * n_iter, 1 if n_iter <= 2 else 2 * n_iter
        outs = {}
        for ix in range(nx):
            for iy in range(ny):
                g0, gj0 = ix * li, iy * lj
                u5 = _nan_past_field(rk.rank_parts2d(u, ix, iy, li, lj, hh, hh, tail=2), g0, gj0,
                                     li, lj, hh, hh, n)
                f5 = _nan_past_field(rk.rank_parts2d(f, ix, iy, li, lj, hh, hh), g0, gj0, li, lj,
                                     hh, hh, n)
                before = [t.clone() for t in (*u5, *f5)]
                gij0 = (g0 - hh, gj0 - hh)
                want = tpx2.rb_smooth_halo2d_plain(u5, f5, gij0, h, n_iter, n, li, lj, red)
                _poison_allocator((li, lj, n), cuda)
                tpx2.reset_launches()
                got = tpx2.rb_smooth_halo2d(u5, f5, gij0, h, n_iter, n, li, lj, red)
                assert tpx2.LAUNCHES == {**dict.fromkeys(tpx2.KERNELS, 0),
                                         "rb_smooth_seg2d": calls}
                assert bool(torch.isfinite(got).all()) and torch.equal(got, want), (
                    n_iter, red, ix, iy)
                assert all(_same_with_nan(a, b) for a, b in zip((*u5, *f5), before))
                outs[ix, iy] = got
        if n_iter == 2:
            whole = _stitch2d(lambda ix, iy: outs[ix, iy], nx, ny)[:n, :n].contiguous()
            assert torch.equal(whole, tpk.rb_smooth_fused(u[:n, :n].contiguous(),
                                                          f[:n, :n].contiguous(), h, 2, red)), red


@pytest.mark.cuda
@pytest.mark.parametrize("n", [17, 65, 129])
def test_seg_smooth_on_candidate_plans_on_card(cuda, n):
    """K28's and K37's stages on every candidate plan of the stage bench
    (utils.stage_plans.candidates: boxes and wavefronts of several block
    sizes) launched directly, red first: bit for bit their plain versions
    on NaN-poisoned outputs; K28 on the last of four ranks (a pad tail; at
    17^3 pad only), K37 on the (1, 1) block of a 2x2 mesh, its halos and
    corner block from the other three."""
    import torch_sharded_ranks as rk
    from multigrid_parallel_tpu_torch.ops import pallas_sharded as tpx
    from multigrid_parallel_tpu_torch.ops import pallas_sharded2d as tpx2
    from multigrid_parallel_tpu_torch.utils.stage_plans import candidates

    h, hh = 1.0 / (n - 1), 4
    lib, stream = tpk._lib(), tpk._stream()
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    rng = np.random.default_rng(1200 + n)

    def args(plan):
        return (plan.n_iter, plan.bi, plan.bj, plan.bk, plan.k_halo, plan.threads, plan.smem,
                int(plan.box), stream)

    L = 2 * ((n + 3) // 8 + 1)
    u, f = (torch.from_numpy(rng.standard_normal((4 * L, n, n)).astype(np.float32)).to(cuda)
            for _ in range(2))
    u3, f3 = (rk.rank_parts(x, 3, L, hh, hh) for x in (u, f))
    us, fs = (tpx._seg(x, hh, hh, L) for x in (u3, f3))
    want = tpx.rb_smooth_halo_plain(u3, f3, 3 * L - hh, h, 2, n, L, True)
    for label, plan in candidates(n, False, sms, tpx.seg_rect_planes(3 * L, L, n)).items():
        out = torch.full((L, n, n), float("nan"), device=cuda)
        assert lib.mg_seg_smooth_stage(out.data_ptr(), *tpx._ptrs(us), *tpx._ptrs(fs), hh, L,
                                       hh, n, 3 * L, h * h, 1, *args(plan)) == 0, label
        assert torch.equal(out, want), label
    li = lj = 2 * ((n + 3) // 4)
    u2, f2 = (torch.from_numpy(rng.standard_normal((2 * li, 2 * lj, n)).astype(np.float32))
              .to(cuda) for _ in range(2))
    u5, f5 = (rk.rank_parts2d(x, 1, 1, li, lj, hh, hh) for x in (u2, f2))
    us2, fs2 = (tpx2._seg2(x, li, lj, hh, hh, hh, hh) for x in (u5, f5))
    want = tpx2.rb_smooth_halo2d_plain(u5, f5, (li - hh, lj - hh), h, 2, n, li, lj, True)
    extent = (tpx.seg_rect_planes(li, li, n), tpx.seg_rect_planes(lj, lj, n))
    for label, plan in candidates(n, False, sms, *extent).items():
        out = torch.full((li, lj, n), float("nan"), device=cuda)
        assert lib.mg_seg2d_smooth_stage(out.data_ptr(), us2.desc(), fs2.desc(), hh, hh, li, lj,
                                         n, li, lj, h * h, 1, *args(plan)) == 0, label
        assert torch.equal(out, want), label


@pytest.mark.cuda
def test_seg_smooth_launchers_refuse_what_they_do_not_take(cuda):
    """The K28 and K37 launchers refuse a plan whose shared memory is not
    the kernel's, a halo shorter than 2 n_iter (K28: the left or the right
    rows; K37: also the j columns), and an output that meets u or f (its
    body, a halo buffer); the wrappers' own arguments succeed."""
    import torch_sharded_ranks as rk
    from multigrid_parallel_tpu_torch.ops import pallas_sharded as tpx
    from multigrid_parallel_tpu_torch.ops import pallas_sharded2d as tpx2

    n, L, r, n_iter, hh = 33, 16, 1, 2, 4
    h2 = (1.0 / (n - 1)) ** 2
    u, f, _ = _sharded_fields(cuda, n, L)
    lib, stream, ptrs = tpk._lib(), tpk._stream(), tpx._ptrs
    us, fs = (tpx._seg(rk.rank_parts(x, r, L, hh, hh), hh, hh, L) for x in (u, f))
    plan = tps._plan_args(n, n_iter, cuda, rect=True, seg_planes=tpx.seg_rect_planes(r * L, L, n))
    bad = plan[:6] + (plan[6] + 16,) + plan[7:]
    out = torch.empty((L, n, n), device=cuda)

    def k28(kl, kr, p, o=out):
        return lib.mg_seg_smooth_stage(o.data_ptr(), *ptrs(us), *ptrs(fs), kl, L, kr, n, r * L,
                                       h2, 1, *p, stream)

    assert k28(hh, hh, plan) == 0
    assert k28(hh, hh, bad) != 0 and k28(hh - 1, hh, plan) != 0 and k28(hh, hh - 1, plan) != 0
    assert k28(hh, hh, plan, us.body) != 0 and k28(hh, hh, plan, us.lh) != 0
    assert k28(hh, hh, plan, fs.rh) != 0 and k28(hh, hh, plan, fs.body[1:]) != 0
    li = lj = 18
    u2, f2, _ = _blocks2d(cuda, n, li, lj)
    u5, f5 = (tpx2._seg2(rk.rank_parts2d(x, 1, 1, li, lj, hh, hh), li, lj, hh, hh, hh, hh)
              for x in (u2, f2))
    plan2 = tps._plan_args(n, n_iter, cuda, rect=True, seg_planes=tpx.seg_rect_planes(li, li, n),
                           seg_cols=tpx.seg_rect_planes(lj, lj, n))
    bad2 = plan2[:6] + (plan2[6] + 16,) + plan2[7:]
    out2 = torch.empty((li, lj, n), device=cuda)

    def k37(kr, hjr, p, u=u5, o=out2):
        return lib.mg_seg2d_smooth_stage(o.data_ptr(), u.desc(), f5.desc(), kr, hjr, li, lj, n,
                                         li, lj, h2, 1, *p, stream)

    assert k37(hh, hh, plan2) == 0
    assert k37(hh, hh, bad2) != 0 and k37(hh - 1, hh, plan2) != 0 and k37(hh, hh - 1, plan2) != 0
    short = tpx2._Seg2(u5.body, u5.jl[:, 1:], u5.jr, u5.lh, u5.rh, u5.r_off)  # a j halo of 3
    assert k37(hh, hh, plan2, short) != 0
    for part in (*u5.parts(), f5.body, f5.jr, f5.rh):
        assert k37(hh, hh, plan2, o=part) != 0
    torch.cuda.synchronize()


# (n, L, ranks) of K29, K28's: the production segments at 257^3 and 513^3, each level below
# 257^3 of both plans, the 1x4 j-replicated tier's 9^3 level among them
K29_CASES = K28_CASES
# (n, (nx, ny), Li, Lj) of K38, K37's: the 1x1 and 2x2 blocks at 257^3 and below, 17^3 and
# 9^3 blocks, and 65^3's 1x4 narrow blocks (the last of pad columns only)
K38_CASES = K37_CASES


@pytest.mark.cuda
@pytest.mark.parametrize("n,L,ranks", K29_CASES)
def test_k29_seg_stage_matches_plain_on_card(cuda, n, L, ranks):
    """The one-pass K29 stage (K2's from a zero tile) on every rank of the
    geometry, n_iter 1 and 2 in both orders and n_iter 3 (the first form)
    red first: each body bit for bit its plain version, on an f random at
    every plane (the pad rows too, which the body holds as 0), its halo
    rows past the field NaN, the right buffer composite, the allocator
    poisoned with NaN before each call; the pad rows 0; exactly one launch
    a call at n_iter <= 2 (6 at 3); f left as it was; at n_iter 2 the
    stitched bodies equal K2's on the whole field."""
    from multigrid_parallel_tpu_torch.ops import pallas_sharded as tpx

    h = 1.0 / (n - 1)
    rng = np.random.default_rng(1300 + n + L)
    f = torch.from_numpy(rng.standard_normal((ranks * L, n, n)).astype(np.float32)).to(cuda)
    for n_iter, red in ((1, True), (1, False), (2, True), (2, False), (3, True)):
        hh, calls = 2 * n_iter, 1 if n_iter <= 2 else 2 * n_iter
        outs = []
        for r in range(ranks):
            gi0 = r * L - hh
            f3 = _seg_triples(f, r, L, hh, hh, n, tail=2)
            before = [t.clone() for t in f3]
            want = tpx.rb_smooth_from_zero_halo_plain(f3, gi0, h, n_iter, n, L, red)
            _poison_allocator((L, n, n), cuda)
            tpx.reset_launches()
            got = tpx.rb_smooth_from_zero_halo(f3, gi0, h, n_iter, n, L, red)
            assert tpx.LAUNCHES == {**dict.fromkeys(tpx.KERNELS, 0),
                                    "rb_smooth_from_zero_seg": calls}
            assert bool(torch.isfinite(got).all()) and torch.equal(got, want), (n_iter, red, r)
            assert not got[max(0, n - r * L):].any(), (n_iter, red, r)
            assert all(_same_with_nan(a, b) for a, b in zip(f3, before))
            outs.append(got)
        if n_iter == 2:
            whole = torch.cat(outs)[:n]
            assert torch.equal(whole, tpk.rb_smooth_from_zero_fused(f[:n], h, 2, red)), red


@pytest.mark.cuda
@pytest.mark.parametrize("n,mesh,li,lj", K38_CASES)
def test_k38_seg2d_stage_matches_plain_on_card(cuda, n, mesh, li, lj):
    """The one-pass K38 stage (K2's from a zero tile) on every block of the
    mesh, n_iter 1 and 2 in both orders and n_iter 3 (the first form) red
    first: each block bit for bit its plain version, on an f random at
    every point (the pad rows and columns too, which the block holds as 0),
    its halo points past the field NaN (corner blocks included), the
    allocator poisoned with NaN before each call; the pad rows and columns
    0; exactly one launch a call at n_iter <= 2 (6 at 3); f left as it was;
    at n_iter 2 the stitched blocks equal K2's on the whole field."""
    import torch_sharded_ranks as rk
    from multigrid_parallel_tpu_torch.ops import pallas_sharded2d as tpx2

    (nx, ny), h = mesh, 1.0 / (n - 1)
    rng = np.random.default_rng(1400 + n + li + lj)
    f = torch.from_numpy(rng.standard_normal((nx * li, ny * lj, n)).astype(np.float32)).to(cuda)
    for n_iter, red in ((1, True), (1, False), (2, True), (2, False), (3, True)):
        hh, calls = 2 * n_iter, 1 if n_iter <= 2 else 2 * n_iter
        outs = {}
        for ix in range(nx):
            for iy in range(ny):
                g0, gj0 = ix * li, iy * lj
                f5 = _nan_past_field(rk.rank_parts2d(f, ix, iy, li, lj, hh, hh, tail=2), g0, gj0,
                                     li, lj, hh, hh, n)
                before = [t.clone() for t in f5]
                gij0 = (g0 - hh, gj0 - hh)
                want = tpx2.rb_smooth_from_zero_halo2d_plain(f5, gij0, h, n_iter, n, li, lj, red)
                _poison_allocator((li, lj, n), cuda)
                tpx2.reset_launches()
                got = tpx2.rb_smooth_from_zero_halo2d(f5, gij0, h, n_iter, n, li, lj, red)
                assert tpx2.LAUNCHES == {**dict.fromkeys(tpx2.KERNELS, 0),
                                         "rb_smooth_from_zero_seg2d": calls}
                assert bool(torch.isfinite(got).all()) and torch.equal(got, want), (
                    n_iter, red, ix, iy)
                assert not got[max(0, n - g0):].any() and not got[:, max(0, n - gj0):].any()
                assert all(_same_with_nan(a, b) for a, b in zip(f5, before))
                outs[ix, iy] = got
        if n_iter == 2:
            whole = _stitch2d(lambda ix, iy: outs[ix, iy], nx, ny)[:n, :n].contiguous()
            assert torch.equal(whole, tpk.rb_smooth_from_zero_fused(f[:n, :n].contiguous(), h, 2,
                                                                    red)), red


@pytest.mark.cuda
@pytest.mark.parametrize("n", [17, 65, 129])
def test_seg_from_zero_on_candidate_plans_on_card(cuda, n):
    """K29's and K38's stages on every candidate plan of the stage bench
    (utils.stage_plans.candidates) launched directly, black first: bit for
    bit their plain versions on NaN-poisoned outputs; K29 on the last of
    four ranks (a pad tail; at 17^3 pad only), K38 on the (1, 1) block of a
    2x2 mesh, its halos and corner block from the other three."""
    import torch_sharded_ranks as rk
    from multigrid_parallel_tpu_torch.ops import pallas_sharded as tpx
    from multigrid_parallel_tpu_torch.ops import pallas_sharded2d as tpx2
    from multigrid_parallel_tpu_torch.utils.stage_plans import candidates

    h, hh = 1.0 / (n - 1), 4
    lib, stream = tpk._lib(), tpk._stream()
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    rng = np.random.default_rng(1500 + n)

    def args(plan):
        return (plan.n_iter, plan.bi, plan.bj, plan.bk, plan.k_halo, plan.threads, plan.smem,
                int(plan.box), stream)

    L = 2 * ((n + 3) // 8 + 1)
    f = torch.from_numpy(rng.standard_normal((4 * L, n, n)).astype(np.float32)).to(cuda)
    f3 = rk.rank_parts(f, 3, L, hh, hh)
    fs = tpx._seg(f3, hh, hh, L)
    want = tpx.rb_smooth_from_zero_halo_plain(f3, 3 * L - hh, h, 2, n, L, False)
    for label, plan in candidates(n, False, sms, tpx.seg_rect_planes(3 * L, L, n)).items():
        out = torch.full((L, n, n), float("nan"), device=cuda)
        assert lib.mg_seg_smooth_from_zero_stage(out.data_ptr(), *tpx._ptrs(fs), hh, L, hh, n,
                                                 3 * L, h * h, 0, *args(plan)) == 0, label
        assert torch.equal(out, want), label
    li = lj = 2 * ((n + 3) // 4)
    f2 = torch.from_numpy(rng.standard_normal((2 * li, 2 * lj, n)).astype(np.float32)).to(cuda)
    f5 = rk.rank_parts2d(f2, 1, 1, li, lj, hh, hh)
    fs2 = tpx2._seg2(f5, li, lj, hh, hh, hh, hh)
    want = tpx2.rb_smooth_from_zero_halo2d_plain(f5, (li - hh, lj - hh), h, 2, n, li, lj, False)
    extent = (tpx.seg_rect_planes(li, li, n), tpx.seg_rect_planes(lj, lj, n))
    for label, plan in candidates(n, False, sms, *extent).items():
        out = torch.full((li, lj, n), float("nan"), device=cuda)
        assert lib.mg_seg2d_smooth_from_zero_stage(out.data_ptr(), fs2.desc(), hh, hh, li, lj,
                                                   n, li, lj, h * h, 0, *args(plan)) == 0, label
        assert torch.equal(out, want), label


@pytest.mark.cuda
def test_seg_from_zero_launchers_refuse_what_they_do_not_take(cuda):
    """The K29 and K38 launchers refuse a plan whose shared memory is not
    the kernel's, an f halo shorter than 2 n_iter (K29: the left or the
    right rows; K38: also the j columns), and an output that meets f (its
    body, a halo buffer); the wrappers' own arguments succeed."""
    import torch_sharded_ranks as rk
    from multigrid_parallel_tpu_torch.ops import pallas_sharded as tpx
    from multigrid_parallel_tpu_torch.ops import pallas_sharded2d as tpx2

    n, L, r, n_iter, hh = 33, 16, 1, 2, 4
    h2 = (1.0 / (n - 1)) ** 2
    _, f, _ = _sharded_fields(cuda, n, L)
    lib, stream, ptrs = tpk._lib(), tpk._stream(), tpx._ptrs
    fs = tpx._seg(rk.rank_parts(f, r, L, hh, hh), hh, hh, L)
    plan = tps._plan_args(n, n_iter, cuda, rect=True, seg_planes=tpx.seg_rect_planes(r * L, L, n))
    bad = plan[:6] + (plan[6] + 16,) + plan[7:]
    out = torch.empty((L, n, n), device=cuda)

    def k29(kl, kr, p, o=out):
        return lib.mg_seg_smooth_from_zero_stage(o.data_ptr(), *ptrs(fs), kl, L, kr, n, r * L,
                                                 h2, 1, *p, stream)

    assert k29(hh, hh, plan) == 0
    assert k29(hh, hh, bad) != 0 and k29(hh - 1, hh, plan) != 0 and k29(hh, hh - 1, plan) != 0
    assert k29(hh, hh, plan, fs.body) != 0 and k29(hh, hh, plan, fs.lh) != 0
    assert k29(hh, hh, plan, fs.rh) != 0 and k29(hh, hh, plan, fs.body[1:]) != 0
    li = lj = 18
    _, f2, _ = _blocks2d(cuda, n, li, lj)
    f5 = tpx2._seg2(rk.rank_parts2d(f2, 1, 1, li, lj, hh, hh), li, lj, hh, hh, hh, hh)
    plan2 = tps._plan_args(n, n_iter, cuda, rect=True, seg_planes=tpx.seg_rect_planes(li, li, n),
                           seg_cols=tpx.seg_rect_planes(lj, lj, n))
    bad2 = plan2[:6] + (plan2[6] + 16,) + plan2[7:]
    out2 = torch.empty((li, lj, n), device=cuda)

    def k38(kr, hjr, p, f=f5, o=out2):
        return lib.mg_seg2d_smooth_from_zero_stage(o.data_ptr(), f.desc(), kr, hjr, li, lj, n,
                                                   li, lj, h2, 1, *p, stream)

    assert k38(hh, hh, plan2) == 0
    assert k38(hh, hh, bad2) != 0 and k38(hh - 1, hh, plan2) != 0 and k38(hh, hh - 1, plan2) != 0
    short = tpx2._Seg2(f5.body, f5.jl[:, 1:], f5.jr, f5.lh, f5.rh, f5.r_off)  # a j halo of 3
    assert k38(hh, hh, plan2, short) != 0
    for part in f5.parts():
        assert k38(hh, hh, plan2, o=part) != 0
    torch.cuda.synchronize()


# --------------------------------- the i-sharded electrospray kernels K34-K36


@pytest.mark.cuda
@pytest.mark.parametrize("n,L", [(65, 18), (65, 32)])
@pytest.mark.parametrize("kernel", ["K34", "K35", "K36"])
def test_sharded_mixed_kernels_match_plain_and_single_device_on_card(cuda, kernel, n, L):
    """Four simulated ranks' segments of a 65^3 electrospray field (the
    last rank owns pad planes only; L = 32 puts plane 64 at rank 2's row 0,
    whose left halo is one plane deeper): each rank's kernel output bitwise
    equal to its plain version, the stitched owned rows to K13-K15 on the
    whole field, the pad planes zero."""
    import torch_sharded_ranks as rk

    D, hh = 4, 4
    es = tmg.electrospray_problem()
    h, nc, Lc = es.length / (n - 1), (n + 1) // 2, L // 2
    pin = tpm.dirichlet_pin_planes(es, n, cuda)
    u, f, ec = _sharded_fields(cuda, n, L)
    u[:n] = tpm.apply_bcs_padded(u[:n], pin)  # BC-consistent, as the cycle hands it over

    def parts(x, r):
        return rk.rank_parts(x, r, L, hh + (r * L == n - 1), hh)

    calls = {
        "K34": ("mixed_rb_smooth_seg",
                lambda r: tpm.mixed_rb_smooth_halo(parts(u, r), parts(f, r), pin, r * L - hh, h,
                                                   2, n, L),
                lambda r: tpm.mixed_rb_smooth_halo_plain(parts(u, r), parts(f, r), pin,
                                                         r * L - hh, h, 2, n, L),
                tpm.mixed_rb_smooth_fused(u[:n].clone(), f[:n], pin, h, 2)),
        "K35": ("mixed_rb_smooth_from_zero_seg",
                lambda r: tpm.mixed_rb_smooth_from_zero_halo(parts(f, r), pin, r * L - hh, h, 2,
                                                             n, L),
                lambda r: tpm.mixed_rb_smooth_from_zero_halo_plain(parts(f, r), pin, r * L - hh,
                                                                   h, 2, n, L),
                tpm.mixed_rb_smooth_from_zero_fused(f[:n], pin, h, 2)),
        "K36": ("mixed_prolong_smooth_seg",
                lambda r: tpm.mixed_prolong_smooth_halo(
                    rk.rank_parts(ec, r, Lc, 2 + (r * L == n - 1), 3), parts(u, r), parts(f, r),
                    pin, r * L - hh, h, 2, n, L),
                lambda r: tpm.mixed_prolong_smooth_halo_plain(
                    rk.rank_parts(ec, r, Lc, 2 + (r * L == n - 1), 3), parts(u, r), parts(f, r),
                    pin, r * L - hh, h, 2, n, L),
                tpm.mixed_prolong_smooth_fused(ec[:nc], u[:n], f[:n], pin, h, 2)),
    }
    name, kern, plain, want = calls[kernel]
    tpm.reset_launches()
    outs = []
    for r in range(D):
        got = kern(r)
        assert torch.equal(got, plain(r)), r
        outs.append(got)
    got = torch.cat(outs)
    assert torch.equal(got[:n], want) and not got[n:].any()
    # K34, K35 and K36: one-pass stages, one launch a call
    assert tpm.LAUNCHES == {**dict.fromkeys(tpm.KERNELS, 0), name: D}


def _seg_triples(x, rank, L, kl, kr, n, tail=0):
    """Rank ``rank``'s (local, lh, rhc) triple of the global field x (n
    valid planes, ``tail`` local tail planes in rhc), its halo rows past the
    field's edge (negative planes, planes past n - 1) NaN."""
    import torch_sharded_ranks as rk

    body, lh, rh = rk.rank_parts(x, rank, L, kl, kr, tail)
    g0 = rank * L
    lh[:max(0, min(kl, kl - g0))] = float("nan")  # planes g0 - kl .. -1
    rh[tail + max(0, n - g0 - L):] = float("nan")  # planes g0 + L + (n - g0 - L) .. on
    return body, lh, rh


# (n, L, ranks): every geometry of the stage's emulation (tests/test_torch_seg_stage.py) at
# 9^3-257^3: rank 0, interior ranks, plane n - 1 at a rank's row 0 (9 / 8, 33 / 16, 257 / 64),
# pad tails, ranks of pad rows only, the four-rank (L = 96 at 257^3) and the one-rank (320)
# production segments
SEG_STAGE_CASES = [(9, 8, 2), (17, 6, 4), (33, 16, 3), (65, 24, 4), (129, 48, 4), (257, 96, 4),
                   (257, 320, 1), (257, 64, 5)]


@pytest.mark.cuda
@pytest.mark.parametrize("n,L,ranks", SEG_STAGE_CASES)
def test_k35_k36_seg_stages_match_plain_on_card(cuda, n, L, ranks):
    """The one-pass segment stages K35 (both orders) and K36 on every
    rank of the geometry, n_iter 1-3, with the electrospray's pins and
    random ones: each body bit for bit its plain version, on fields random
    at every plane (pad planes too), the halo rows past the field's edge
    NaN, the allocator poisoned with NaN before each call (a point left
    unwritten shows); exactly one launch a call at n_iter <= 2 (7 at 3, the
    first form) and no other kernel; at n_iter 2 the stitched bodies equal
    K14's and K15's on the whole field, their pad rows 0 (K35) and e's
    (K36); the inputs left as they were."""
    es = tmg.electrospray_problem()
    h, nc, lc = es.length / (n - 1), (n + 1) // 2, L // 2
    rng = np.random.default_rng(260 + n + L)
    f, e = (torch.from_numpy(rng.standard_normal((ranks * L, n, n)).astype(np.float32)).to(cuda)
            for _ in range(2))
    ec = torch.from_numpy(rng.standard_normal((ranks * lc, nc, nc)).astype(np.float32)).to(cuda)
    for kind in ("electrospray", "random"):
        pin = _mixed_pins(kind, n, cuda, rng)
        e[:n] = tpm.apply_bcs_padded(e[:n], pin)  # BC-consistent, as the cycle hands it over
        for n_iter in (1, 2, 3):
            hh, calls = 2 * n_iter, 1 if n_iter <= 2 else 7
            k35, k36 = [], []
            for r in range(ranks):
                gi0 = r * L - hh
                kl = tpm._stage_kl(gi0, n_iter, n)
                f3 = _seg_triples(f, r, L, kl, hh, n, tail=2)
                e3 = _seg_triples(e, r, L, kl, hh, n)
                ec3 = _seg_triples(ec, r, lc, kl - n_iter, n_iter + 1, nc, tail=1)
                before = [t.clone() for t in (*f3, *e3, *ec3)]
                for red_first in (True, False):
                    want = tpm.mixed_rb_smooth_from_zero_halo_plain(f3, pin, gi0, h, n_iter, n,
                                                                    L, red_first)
                    _poison_allocator((L, n, n), cuda)
                    tpm.reset_launches()
                    got = tpm.mixed_rb_smooth_from_zero_halo(f3, pin, gi0, h, n_iter, n, L,
                                                             red_first)
                    assert tpm.LAUNCHES == {**dict.fromkeys(tpm.KERNELS, 0),
                                            "mixed_rb_smooth_from_zero_seg": calls}
                    assert torch.equal(got, want), (kind, n_iter, r, red_first)
                    if red_first:
                        k35.append(got)
                want = tpm.mixed_prolong_smooth_halo_plain(ec3, e3, f3, pin, gi0, h, n_iter, n,
                                                           L)
                _poison_allocator((L, n, n), cuda)
                tpm.reset_launches()
                got = tpm.mixed_prolong_smooth_halo(ec3, e3, f3, pin, gi0, h, n_iter, n, L)
                assert tpm.LAUNCHES == {**dict.fromkeys(tpm.KERNELS, 0),
                                        "mixed_prolong_smooth_seg": calls}
                assert torch.equal(got, want), (kind, n_iter, r)
                k36.append(got)
                assert all(_same_with_nan(a, b) for a, b in zip((*f3, *e3, *ec3), before))
            if n_iter == 2:
                k35, k36 = torch.cat(k35), torch.cat(k36)
                assert torch.equal(k35[:n], tpm.mixed_rb_smooth_from_zero_fused(f[:n], pin, h, 2))
                assert torch.equal(k36[:n], tpm.mixed_prolong_smooth_fused(ec[:nc], e[:n], f[:n],
                                                                           pin, h, 2))
                assert not k35[n:].any() and torch.equal(k36[n:], e[n:])


@pytest.mark.cuda
@pytest.mark.parametrize("n,L,ranks", SEG_STAGE_CASES)
def test_k34_seg_stage_matches_plain_on_card(cuda, n, L, ranks):
    """The one-pass segment stage K34 on a loaded u, both orders, on every
    rank of the geometry, n_iter 1-3, with the electrospray's pins and
    random ones: each body bit for bit its plain version, on fields random
    at every plane (pad planes too; u BC-consistent on the field), the halo
    rows past the field's edge NaN, the allocator poisoned with NaN before
    each call; exactly one launch a call at n_iter <= 2 (7 at 3, the first
    form on a copy of u's segments) and no other kernel; at n_iter 2 the
    stitched bodies equal K13's on the whole field in both orders, their pad
    rows u's; the inputs left as they were."""
    es = tmg.electrospray_problem()
    h = es.length / (n - 1)
    rng = np.random.default_rng(270 + n + L)
    f, u = (torch.from_numpy(rng.standard_normal((ranks * L, n, n)).astype(np.float32)).to(cuda)
            for _ in range(2))
    for kind in ("electrospray", "random"):
        pin = _mixed_pins(kind, n, cuda, rng)
        u[:n] = tpm.apply_bcs_padded(u[:n], pin)  # BC-consistent, as the cycle hands it over
        for n_iter in (1, 2, 3):
            hh, calls = 2 * n_iter, 1 if n_iter <= 2 else 2 * n_iter + 1
            bodies = {True: [], False: []}
            for r in range(ranks):
                gi0 = r * L - hh
                kl = tpm._stage_kl(gi0, n_iter, n)
                f3 = _seg_triples(f, r, L, kl, hh, n, tail=2)
                u3 = _seg_triples(u, r, L, kl, hh, n, tail=1)
                before = [t.clone() for t in (*f3, *u3)]
                for red_first in (True, False):
                    want = tpm.mixed_rb_smooth_halo_plain(u3, f3, pin, gi0, h, n_iter, n, L,
                                                          red_first)
                    _poison_allocator((L, n, n), cuda)
                    tpm.reset_launches()
                    got = tpm.mixed_rb_smooth_halo(u3, f3, pin, gi0, h, n_iter, n, L, red_first)
                    assert tpm.LAUNCHES == {**dict.fromkeys(tpm.KERNELS, 0),
                                            "mixed_rb_smooth_seg": calls}
                    assert torch.equal(got, want), (kind, n_iter, r, red_first)
                    bodies[red_first].append(got)
                assert all(_same_with_nan(a, b) for a, b in zip((*f3, *u3), before))
            if n_iter == 2:
                for red_first, parts in bodies.items():
                    got = torch.cat(parts)
                    assert torch.equal(got[:n], tpm.mixed_rb_smooth_fused(u[:n], f[:n], pin, h,
                                                                          2, red_first))
                    assert torch.equal(got[n:], u[n:])


@pytest.mark.cuda
def test_seg_stage_launchers_refuse_what_they_do_not_take(cuda):
    """The K34, K35 and K36 launchers refuse a plan whose shared memory is
    not the kernel's, and a left halo of 2 n_iter where plane n - 1 is row 0
    (33^3, L = 16, rank 2); K34's and K35's an output that meets u's or f's
    segment; the wrappers' own calls succeed."""
    n, L, r, n_iter, hh = 33, 16, 2, 2, 4
    nc = (n + 1) // 2
    h2 = (3e-4 / (n - 1)) ** 2
    pin = _mixed_pins("random", n, cuda, np.random.default_rng(5))
    f, e, ec = _sharded_fields(cuda, n, L)
    lib, stream = tpk._lib(), tpk._stream()
    from multigrid_parallel_tpu_torch.ops import pallas_sharded as tpx

    ptrs = tpx._ptrs

    def k35(kl, plan, out, f3=None):
        f3 = f3 or tpx._seg(_seg_triples(f, r, L, kl, hh, n), kl, hh, L)
        return lib.mg_seg_mixed_stage(out.data_ptr(), None, None, None, 0, *ptrs(f3),
                                      pin.data_ptr(), kl, L, hh, n, r * L, h2, 1, *plan, stream)

    def k34(kl, plan, out, u3=None, f3=None):
        f3 = f3 or tpx._seg(_seg_triples(f, r, L, kl, hh, n), kl, hh, L)
        u3 = u3 or tpx._seg(_seg_triples(e, r, L, kl, hh, n), kl, hh, L)
        return lib.mg_seg_mixed_stage(out.data_ptr(), *ptrs(u3), *ptrs(f3), pin.data_ptr(), kl,
                                      L, hh, n, r * L, h2, 1, *plan, stream)

    def k36(kl, plan, out):
        f3 = tpx._seg(_seg_triples(f, r, L, kl, hh, n), kl, hh, L)
        e3 = tpx._seg(_seg_triples(e, r, L, kl, hh, n), kl, hh, L)
        c3 = tpx._seg(_seg_triples(ec, r, L // 2, kl - n_iter, n_iter + 1, nc),
                      kl - n_iter, n_iter + 1, L // 2)
        return lib.mg_seg_mixed_prolong_stage(out.data_ptr(), *ptrs(c3), c3.kl, n_iter + 1,
                                              *ptrs(e3), *ptrs(f3), pin.data_ptr(), kl, L, hh,
                                              n, r * L, h2, *plan, stream)

    planes = tpm._seg_planes(r * L - hh, n_iter, n, L)
    for launch, prolong in ((k34, False), (k35, False), (k36, True)):
        plan = tps._plan_args(n, n_iter, cuda, prolong=prolong, rect=True, seg_planes=planes)
        out = torch.empty((L, n, n), device=cuda)
        assert launch(hh + 1, plan, out) == 0
        bad = plan[:6] + (plan[6] + 16,) + plan[7:]
        assert launch(hh + 1, bad, out) != 0
        assert launch(hh, plan, out) != 0
    plan = tps._plan_args(n, n_iter, cuda, rect=True, seg_planes=planes)
    f3 = tpx._seg(_seg_triples(f, r, L, hh + 1, hh, n), hh + 1, hh, L)
    u3 = tpx._seg(_seg_triples(e, r, L, hh + 1, hh, n), hh + 1, hh, L)
    for part in (0, 1, 2):  # the body, the left halo, the right one
        assert k34(hh + 1, plan, u3[part], u3, f3) != 0
        assert k34(hh + 1, plan, f3[part], u3, f3) != 0
        assert k35(hh + 1, plan, f3[part], f3) != 0
    torch.cuda.synchronize()


@pytest.mark.cuda
def test_sharded_mixed_wrappers_reject_what_the_kernels_do_not_take(cuda):
    import torch_sharded_ranks as rk

    n, L, hh = 33, 10, 4
    pin = tpm.dirichlet_pin_planes(tmg.electrospray_problem(), n, cuda)
    u, f, _ = _sharded_fields(cuda, n, L)
    u3, f3 = rk.rank_parts(u, 1, L, hh, hh), rk.rank_parts(f, 1, L, hh, hh)
    with pytest.raises(TypeError):
        tpm.mixed_rb_smooth_halo(tuple(t.double() for t in u3), f3, pin, L - hh, 1e-5, 2, n, L)
    with pytest.raises(TypeError):
        tpm.mixed_rb_smooth_halo(u3, f3, pin.double(), L - hh, 1e-5, 2, n, L)
    with pytest.raises(ValueError, match="pin planes on"):
        tpm.mixed_rb_smooth_from_zero_halo(f3, pin.cpu(), L - hh, 1e-5, 2, n, L)
    with pytest.raises(ValueError, match="different devices"):
        tpm.mixed_rb_smooth_halo((u3[0].cpu(),) + u3[1:], f3, pin, L - hh, 1e-5, 2, n, L)
    with pytest.raises(ValueError, match="planes"):
        tpm.mixed_rb_smooth_halo(tuple(t[:, :-1] for t in u3), f3, pin, L - hh, 1e-5, 2, n, L)
    with pytest.raises(ValueError, match="contiguous"):
        tpm.mixed_rb_smooth_halo((u3[0].transpose(1, 2),) + u3[1:], f3, pin, L - hh, 1e-5, 2,
                                 n, L)


@pytest.mark.cuda
def test_sharded_mixed_df_solver_one_nccl_rank_matches_full_tier(cuda):
    """make_sharded_mixed_padded_df_solver at 33^3 on one NCCL rank (a
    spawned process; K34-K36, K30, K32 at every level above 5^3) against
    the single-device full tier: the same outer steps and solution."""
    import torch_sharded_ranks as rk
    from multigrid_parallel_tpu_torch.parallel.launch import launch

    u, nrm, steps, plan, calls = launch(rk.mixed_df_solver, 1, 0, 0, 0, backend="nccl",
                                        device="cuda")[0]
    es = tmg.electrospray_problem()
    hier = tmg.Hierarchy(ndim=3, coarse_n=5, num_levels=4, length=es.length)
    s = MixedBCSolver(es, hier, n_smooth=2, gamma=2, device=cuda)
    out = tmp.make_mixed_padded_df_solver(s, rel_tol=1e-6, inner_cycles=2)(
        *tmp.setup_mixed_df_problem(s))
    want = tmp.unpack_mixed_solution(out[0], out[1], hier).cpu()
    assert (plan.n_sharded, plan.fine_local) == (3, 40)
    assert steps == out[3]
    assert float((u - want).abs().max()) <= 1e-7 * float(want.abs().max())
    assert calls["mixed_prolong_smooth_halo"] > 0 and calls["residual_df_norm_halo"] == steps + 1


# ------------------------------------ the (i, j)-sharded kernels K37-K41


def _blocks2d(dev, n, li, lj, nx=2, ny=2):
    """u, f (nx li, ny lj, n) and the coarse ec (nx li / 2, ny lj / 2, nc):
    a standard normal cube in [:m, :m], zero pads."""
    rng = np.random.default_rng(41)

    def glob(m, a, b):
        x = np.zeros((nx * a, ny * b, m), np.float32)
        x[:m, :m] = rng.standard_normal((m, m, m))
        return torch.from_numpy(x).to(dev)

    return glob(n, li, lj), glob(n, li, lj), glob((n + 1) // 2, li // 2, lj // 2)


def _stitch2d(per_rank, nx=2, ny=2):
    return torch.cat([torch.cat([per_rank(ix, iy) for iy in range(ny)], dim=1)
                      for ix in range(nx)])


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["K37", "K38", "K39", "K40", "K41"])
def test_sharded2d_kernels_match_plain_and_single_device_on_card(cuda, kernel):
    """Four simulated ranks' 2x2 blocks of a 65^3 field (Li = Lj = 34:
    the blocks meet at an interior point, so the stages read the corner
    blocks), five-part halos: each rank's kernel output bitwise equal to
    its plain version, and the stitched owned points to the single-device
    kernel on the whole field; the ext form and the j-extended triple
    launch the same kernel."""
    import torch_sharded_ranks as rk
    from multigrid_parallel_tpu_torch.ops import pallas_sharded2d as tpx2

    n, li, lj = 65, 34, 34
    h, nc, lic, ljc = 1.0 / (n - 1), (n + 1) // 2, li // 2, lj // 2
    u, f, ec = _blocks2d(cuda, n, li, lj)

    def p5(x, ix, iy, kl, kr, a=li, b=lj):
        return rk.rank_parts2d(x, ix, iy, a, b, kl, kr)

    g = lambda ix, iy, halo: (ix * li - halo, iy * lj - halo)  # noqa: E731
    cube = lambda x, m=n: x[:m, :m].contiguous()  # noqa: E731  (the whole field)
    tpx2.reset_launches()
    if kernel == "K41":
        df = [t for x in (u, f) for t in tpk.df_split(x.double() + 1e-9 * x.double() ** 2)]
        want_r, want_n2 = tpk.residual_df_norm_fused(*(cube(x) for x in df), h)
        parts, n2 = {}, 0.0
        for ix in range(2):
            for iy in range(2):
                segs = [p5(x, ix, iy, 1, 1) for x in df]
                got, part = tpx2.residual_df_norm_halo2d(*segs, g(ix, iy, 1), h, n, li, lj)
                ref, ref_part = tpx2.residual_df_norm_halo2d_plain(*segs, g(ix, iy, 1), h, n,
                                                                   li, lj)
                assert torch.equal(got, ref), (ix, iy)
                assert float(part) == pytest.approx(float(ref_part), rel=1e-6, abs=0.0)
                parts[ix, iy] = got
                n2 += float(part)
        assert torch.equal(_stitch2d(lambda ix, iy: parts[ix, iy])[:n, :n], want_r)
        assert n2 == pytest.approx(float(want_n2), rel=1e-6)
        assert tpx2.LAUNCHES["residual_df_norm_seg2d"] == 4
        return
    hh = 4
    calls = {
        "K37": ("rb_smooth_seg2d", 1,  # one-pass: one launch a call
                lambda ix, iy: tpx2.rb_smooth_halo2d(p5(u, ix, iy, hh, hh), p5(f, ix, iy, hh, hh),
                                                     g(ix, iy, hh), h, 2, n, li, lj, True),
                lambda ix, iy: tpx2.rb_smooth_halo2d_plain(p5(u, ix, iy, hh, hh),
                                                           p5(f, ix, iy, hh, hh), g(ix, iy, hh),
                                                           h, 2, n, li, lj, True),
                tpk.rb_smooth_fused(cube(u), cube(f), h, 2, red_first=True)),
        "K38": ("rb_smooth_from_zero_seg2d", 1,  # one-pass: one launch a call
                lambda ix, iy: tpx2.rb_smooth_from_zero_halo2d(p5(f, ix, iy, hh, hh),
                                                               g(ix, iy, hh), h, 2, n, li, lj),
                lambda ix, iy: tpx2.rb_smooth_from_zero_halo2d_plain(
                    p5(f, ix, iy, hh, hh), g(ix, iy, hh), h, 2, n, li, lj),
                tpk.rb_smooth_from_zero_fused(cube(f), h, 2)),
        "K39": ("residual_restrict_seg2d", 1,
                lambda ix, iy: tpx2.residual_restrict_halo2d(p5(u, ix, iy, 2, 1),
                                                             p5(f, ix, iy, 2, 1), g(ix, iy, 2), h,
                                                             n, lic, ljc),
                lambda ix, iy: tpx2.residual_restrict_halo2d_plain(
                    p5(u, ix, iy, 2, 1), p5(f, ix, iy, 2, 1), g(ix, iy, 2), h, n, lic, ljc),
                tpk.residual_restrict_fused(cube(u), cube(f), h)),
        "K40": ("prolong_smooth_seg2d", 1,
                lambda ix, iy: tpx2.prolong_smooth_halo2d(p5(ec, ix, iy, 2, 3, lic, ljc),
                                                          p5(u, ix, iy, hh, hh),
                                                          p5(f, ix, iy, hh, hh), g(ix, iy, hh),
                                                          h, 2, n, li, lj),
                lambda ix, iy: tpx2.prolong_smooth_halo2d_plain(
                    p5(ec, ix, iy, 2, 3, lic, ljc), p5(u, ix, iy, hh, hh),
                    p5(f, ix, iy, hh, hh), g(ix, iy, hh), h, 2, n, li, lj),
                tpk.prolong_smooth_fused(cube(ec, nc), cube(u), cube(f), h, 2)),
    }
    name, per_call, kern, plain, want = calls[kernel]
    outs = {}
    for ix in range(2):
        for iy in range(2):
            got = kern(ix, iy)
            assert torch.equal(got, plain(ix, iy)), (ix, iy)
            outs[ix, iy] = got
    m = want.shape[0]
    assert torch.equal(_stitch2d(lambda ix, iy: outs[ix, iy])[:m, :m], want)
    assert tpx2.LAUNCHES == {**dict.fromkeys(tpx2.KERNELS, 0), name: per_call * 4}
    if kernel == "K37":  # the ext form and the triple: views of one buffer each
        ext = _stitch2d(lambda ix, iy: tpx2.rb_smooth_ext2d(
            rk.rank_ext2d(u, ix, iy, li, lj, hh, hh, hh, hh),
            rk.rank_ext2d(f, ix, iy, li, lj, hh, hh, hh, hh), g(ix, iy, hh), h, 2, n, li, lj))
        tri = _stitch2d(lambda ix, iy: tpx2.rb_smooth_halo2d(
            rk.rank_triple2d(u, ix, iy, li, lj, hh, hh, 8, 2),
            rk.rank_triple2d(f, ix, iy, li, lj, hh, hh, 8), g(ix, iy, hh), h, 2, n, li, lj))
        assert torch.equal(ext[:n, :n], want) and torch.equal(tri[:n, :n], want)


@pytest.mark.cuda
def test_sharded2d_wrappers_reject_what_the_kernels_do_not_take(cuda):
    import torch_sharded_ranks as rk
    from multigrid_parallel_tpu_torch.ops import pallas_sharded2d as tpx2

    u, f, _ = _blocks2d(cuda, 17, 12, 16)
    p5 = lambda x: rk.rank_parts2d(x, 1, 1, 12, 16, 4, 4)  # noqa: E731
    with pytest.raises(TypeError, match="float32"):
        tpx2.rb_smooth_halo2d(tuple(t.double() for t in p5(u)), p5(f), (8, 12), 1 / 16, 2, 17,
                              12, 16)
    with pytest.raises(ValueError, match="different devices"):
        tpx2.rb_smooth_halo2d(tuple(t.cpu() for t in p5(u)), p5(f), (8, 12), 1 / 16, 2, 17, 12,
                              16)
    bad = p5(u)
    bad = (bad[0].transpose(1, 2).contiguous().transpose(1, 2),) + bad[1:]
    with pytest.raises(ValueError, match="unit k stride"):
        tpx2.rb_smooth_halo2d(bad, p5(f), (8, 12), 1 / 16, 2, 17, 12, 16)


@pytest.mark.cuda
def test_sharded2d_df_solver_one_nccl_rank_matches_fused(cuda):
    """make_sharded2d_padded_df_solver at 33^3 on one NCCL rank (a 1x1
    mesh, a spawned process) against the single-device fused solve: the
    same outer steps, the solution bit for bit, only K37-K41 launched (the
    plan shards down to 9^3 and gathers the bare 5^3 LU)."""
    import torch_sharded_ranks as rk
    from multigrid_parallel_tpu_torch.parallel.launch import launch

    hier = tmg.Hierarchy(ndim=3, coarse_n=5, num_levels=4)
    prob = tmg.poisson_3d_quadratic()
    init = tcp.ref_init_norm(prob, hier, cuda)
    u, steps, nrm, plan, tiers, _, launches = launch(rk.padded_solver2d_on, 1, (1, 1), None, 0, 4,
                                                     33, init, backend="nccl", device="cuda")[0]
    run = tcp.make_on_device_df_solver(hier, tmg.CycleConfig(n_smooth=2), rel_tol=1e-8,
                                       inner_cycles=4, init_norm=init, device=cuda)
    out = run(*tcp.setup_df_problem(prob, hier, cuda))
    assert tiers == {33: "2d", 17: "2d", 9: "2d", 5: "replicated"}, tiers
    assert steps == out[3] and nrm <= 1e-8 * init
    assert torch.equal(u, tpk.df_to_f64(*out[:2]).cpu())
    seg2d = {"rb_smooth_seg2d", "rb_smooth_from_zero_seg2d", "residual_restrict_seg2d",
             "prolong_smooth_seg2d", "residual_df_norm_seg2d"}
    assert {k for k, v in launches.items() if v} == seg2d, launches
    assert launches["residual_df_norm_seg2d"] == steps + 1
