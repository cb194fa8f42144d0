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
at the smoother study's 50^3) and on hand plans (one launch a call).

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


def _ulps(got, want, ulps=4):
    err = float((got.double() - want.double()).abs().max())
    return err <= ulps * float(np.spacing(np.float32(want.abs().max().item())))


@pytest.mark.cuda
@pytest.mark.parametrize("n", [17, 65])
def test_fused_kernels_match_plain_on_card(cuda, n):
    h = 1.0 / (n - 1)
    nc = (n + 1) // 2
    e, r = _fields32(8, n, cuda)
    ec = _fields32(9, nc, cuda)[0]
    tpk.reset_launches()
    # K3: the same operations in the same order (the plain version's
    # strided 3-taps), expected bitwise; held to 4 ulp of the max
    got = tpk.residual_restrict_fused(e, r, h)
    assert got.shape == (nc, nc, nc)
    assert _ulps(got, tpk.residual_restrict_plain(e, r, h))
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
    assert _ulps(got, tps.residual_restrict_split_plain(*e, *r, h))
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
    in place, bitwise equal to its plain version; 2 n_iter launches a
    call."""
    n = 65
    h = 1.0 / (n - 1)
    u2, f2 = (torch.cat(pair, dim=1) for pair in _split_pairs(16, n, cuda, 2))
    tpsc.reset_launches()
    for n_iter in (1, 2):
        for red_first in (True, False):
            want = tpsc.rb_smooth_split_fused_plain(u2, f2, h, n_iter, red_first)
            got = u2.clone()
            before = tpsc.LAUNCHES["rb_smooth_split_fused"]
            assert tpsc.rb_smooth_split_fused(got, f2, h, n_iter, n, red_first) is got
            assert tpsc.LAUNCHES["rb_smooth_split_fused"] - before == 2 * n_iter
            assert torch.equal(got, want), (n_iter, red_first)
    assert tpsc.LAUNCHES == {"rb_smooth_split_fused": 2 * (2 + 4)}


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
                got = tpm.mixed_rb_smooth_fused(e_bc.clone(), r, pin, h, n_iter, red_first)
                assert torch.equal(got, want)
            assert torch.equal(tpm.mixed_rb_smooth_from_zero_fused(r, pin, h, n_iter),
                               tpm.mixed_rb_smooth_from_zero_plain(r, pin, h, n_iter))
            e0 = e.clone()
            got = tpm.mixed_prolong_smooth_fused(ec, e, r, pin, h, n_iter)
            assert torch.equal(e, e0)  # fresh output, e untouched
            assert torch.equal(got, tpm.mixed_prolong_smooth_plain(ec, e, r, pin, h, n_iter))
    # per pin, n_iter 1 and 2: K13 2 orders x (2 n_iter + 1); K14 and K15 2 n_iter + 1
    assert tpm.LAUNCHES == {**dict.fromkeys(tpm.KERNELS, 0),
                            "mixed_rb_smooth_fused": 2 * 2 * (3 + 5),
                            "mixed_rb_smooth_from_zero_fused": 2 * (3 + 5),
                            "mixed_prolong_smooth_fused": 2 * (3 + 5)}


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
    assert _ulps(got, tpk.residual_restrict_plain(e, r, h))
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
        assert _ulps(got, tpmf.residual_restrict_fold_plain(fe, r, h))
    x = np.linspace(0.0, 1.0, n)[:, None, None]
    state = [tpmf.pack_fold(t.to(cuda))
             for a in (-1350.0 * x * x + 1e-3 * rng.standard_normal((n, n, n)),
                       1e3 * rng.standard_normal((n, n, n)))
             for t in tpk.df_split(torch.from_numpy(a))]
    r20, nrm20 = tpmf.residual_df_norm_fold(*state, h)
    r_ref, nrm_ref = tpmf.residual_df_norm_fold_plain(*state, h)
    assert torch.equal(r20, r_ref)
    assert float(nrm20) == pytest.approx(float(nrm_ref), rel=1e-5)
    # per pin, n_iter 1 and 2: K16 2 orders x (2 n_iter + 1); K17 and K19 2 n_iter + 1
    assert tpmf.LAUNCHES == {"mixed_rb_smooth_fold": 2 * 2 * (3 + 5),
                             "mixed_rb_smooth_from_zero_fold": 2 * (3 + 5),
                             "residual_restrict_fold": 2,
                             "mixed_prolong_smooth_fold": 2 * (3 + 5),
                             "residual_df_norm_fold": 1}


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
    coarse level's sign planes (the pin-edge delta live at 17^3). K21,
    K22, K24 and K25 take the same steps as their plain versions (fields
    bitwise); K23 too, held to 4 ulp of the max as K18 is."""
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
        assert _ulps(got, tpms.residual_restrict_msplit_plain(*e2, *r2, h))
    x = np.linspace(0.0, 1.0, n)[:, None, None]
    state = [t for a in (-1350.0 * x * x + 1e-3 * rng.standard_normal((n, n, n)),
                         1e3 * rng.standard_normal((n, n, n)))
             for half in tpk.df_split(torch.from_numpy(a).to(cuda)) for t in tps.pack_split(half)]
    got = tpms.residual_df_norm_msplit(*state, h)
    want = tpms.residual_df_norm_msplit_plain(*state, h)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert float(got[2]) == pytest.approx(float(want[2]), rel=1e-5)
    # per pin, n_iter 1 and 2: K21 2 orders x (2 n_iter + 1); K22 2 n_iter + 1; K24 2 n_iter + 2
    assert tpms.LAUNCHES == {"mixed_rb_smooth_msplit": 2 * 2 * (3 + 5),
                             "mixed_rb_smooth_from_zero_msplit": 2 * (3 + 5),
                             "residual_restrict_msplit": 2,
                             "mixed_prolong_smooth_msplit": 2 * (4 + 6),
                             "residual_df_norm_msplit": 1}


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
    for n_iter in (1, 2, 3):
        for red_first in (True, False):
            want_u, want_r = tpk.rb_smooth_residual_plain(u, f, h, n_iter, red_first)
            u1 = u.clone()
            got_u, got_r = tpk.rb_smooth_residual_fused(u1, f, h, n_iter, red_first)
            assert got_u is u1
            assert torch.equal(got_u, want_u) and torch.equal(got_r, want_r)
    state = _df_state(21, n, cuda)
    r = tpk.residual_df_fused(*state, h)
    assert torch.equal(r, tpk.residual_df_plain(*state, h))
    assert torch.equal(r, tpk.residual_df_norm_fused(*state, h)[0])
    nrm = tpk.residual_norm_fused(u, f, h)
    assert float(nrm) == pytest.approx(float(tpk.residual_norm_plain(u, f, h)), rel=1e-6)
    # K26: 2 n_iter launches a call, n_iter = 1, 2, 3, both orders
    assert tpk.LAUNCHES == {**dict.fromkeys(tpk.KERNELS, 0),
                            "rb_smooth_residual_fused": 24, "residual_df_fused": 1,
                            "residual_df_norm_fused": 1, "residual_fused": 1}


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
        "K28": ("rb_smooth_seg", 4,
                lambda r: tpx.rb_smooth_halo(parts(u, r, hh, hh), parts(f, r, hh, hh),
                                             r * L - hh, h, 2, n, L, False),
                lambda r: tpx.rb_smooth_halo_plain(parts(u, r, hh, hh), parts(f, r, hh, hh),
                                                   r * L - hh, h, 2, n, L, False),
                tpk.rb_smooth_fused(u[:n].clone(), f[:n], h, 2, red_first=False)),
        "K29": ("rb_smooth_from_zero_seg", 4,
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
        "K31": ("prolong_smooth_seg", 4,
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
    assert tpm.LAUNCHES == {**dict.fromkeys(tpm.KERNELS, 0), name: 5 * D}


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
        "K37": ("rb_smooth_seg2d", 4,
                lambda ix, iy: tpx2.rb_smooth_halo2d(p5(u, ix, iy, hh, hh), p5(f, ix, iy, hh, hh),
                                                     g(ix, iy, hh), h, 2, n, li, lj, True),
                lambda ix, iy: tpx2.rb_smooth_halo2d_plain(p5(u, ix, iy, hh, hh),
                                                           p5(f, ix, iy, hh, hh), g(ix, iy, hh),
                                                           h, 2, n, li, lj, True),
                tpk.rb_smooth_fused(cube(u), cube(f), h, 2, red_first=True)),
        "K38": ("rb_smooth_from_zero_seg2d", 4,
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
        "K40": ("prolong_smooth_seg2d", 4,
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
