"""The packed split-colour smoothing stage of the port
(multigrid_parallel_tpu_torch.ops.pallas_splitcolor, K42) against the
JAX package: the packed layout and its conversions, the plain version
against the Pallas kernel in interpret mode at 17³ and 33³, against the
port's pair (K7) and rect (K1) plain versions, the wrapper's checks, and
the stage bench (utils.timing.profile_splitcolor_stage) on the CPU.

On CPU tensors the wrapper takes the plain PyTorch version; the CUDA
kernel is held against it on the card (tests/test_torch_cuda.py,
chip_smoke.py phase 13).

Tolerances. The JAX kernel takes float32 only (it runs with x64 off and
refuses f64 inputs), so both sides run in f32. Against the Pallas kernel:
bitwise, as the plain version follows the kernel's addition order. Layout
and conversions: bitwise (gathers and copies). Against K7 and K1: 4 ulp
of max|u|, because their neighbour sums add the two k terms one at a
time, not as one pair (1-3 ulp measured at 17³-129³).
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multigrid_parallel_tpu.ops import pallas3d as jpk
from multigrid_parallel_tpu.ops import pallas_splitcolor as jsc
from multigrid_parallel_tpu_torch.ops import pallas3d as tpk
from multigrid_parallel_tpu_torch.ops import pallas_split as tps
from multigrid_parallel_tpu_torch.ops import pallas_splitcolor as tsc
from multigrid_parallel_tpu_torch.utils import convert
from multigrid_parallel_tpu_torch.utils.timing import HBM_BYTES_PER_S, profile_splitcolor_stage

torch.set_num_threads(1)


def _cube(n, seed, boundary=False):
    """Random f32 (n, n, n) field with zero k faces: interior only (a
    correction), or with the i / j boundary rows too."""
    rng = np.random.default_rng(seed)
    x = np.zeros((n, n, n), np.float32)
    if boundary:
        x[:, :, 1:-1] = rng.standard_normal((n, n, n - 2))
    else:
        x[1:-1, 1:-1, 1:-1] = rng.standard_normal((n - 2,) * 3)
    return x


def _jax_pack(x):
    return jsc.pack_split(jpk.pad3(jnp.asarray(x)), x.shape[0])


# --------------------------------------------------------------- layout


@pytest.mark.parametrize("n", [3, 17, 257])
def test_split_shape(n):
    s = -(-(n - 2) // 2)  # ceil((n - 2) / 2): the interior k's of one colour
    assert tsc.split_shape(n) == (n, 2 * n, s) == (n, 2 * n, (n - 1) // 2)
    assert tsc.split_shape(n)[1:] == (2 * tps.split_shape(n)[1], tps.split_shape(n)[2])
    assert convert.jax_splitcolor_shape(n) == jsc.split_shape(n)


def test_pack_unpack_round_trip():
    n = 17
    x = torch.from_numpy(_cube(n, 0, boundary=True))
    u2 = tsc.pack_split(x)
    assert u2.shape == tsc.split_shape(n) and u2.is_contiguous()
    assert torch.equal(u2, torch.cat(tps.pack_split(x), dim=1))
    assert torch.equal(tsc.unpack_split(u2), x)


def test_dead_slots_are_zero():
    """The last slot of the colour holding a row's even k's (black where
    i + j is even, red elsewhere) is exactly 0; every other slot of a
    random field is not."""
    n = 17
    u2 = tsc.pack_split(torch.from_numpy(_cube(n, 1, boundary=True)))
    q = torch.from_numpy((np.arange(n)[:, None] + np.arange(n)[None, :]) % 2 == 1)
    red, black = u2[:, :n], u2[:, n:]
    assert not red[..., -1][q].any() and not black[..., -1][~q].any()
    assert red[..., -1][~q].all() and black[..., -1][q].all()
    assert red[..., :-1].all() and black[..., :-1].all()


@pytest.mark.parametrize("n", [17, 33])
def test_pack_matches_jax(n):
    x = _cube(n, 2, boundary=True)
    want = convert.from_jax_splitcolor(_jax_pack(x), n, device="cpu")
    assert torch.equal(tsc.pack_split(torch.from_numpy(x)), want)


def test_convert_splitcolor_round_trip_and_shape_errors():
    n = 17
    u2 = tsc.pack_split(torch.from_numpy(_cube(n, 3, boundary=True)))
    a = convert.to_jax_splitcolor(u2, n)
    assert a.shape == convert.jax_splitcolor_shape(n) == (n, 48, 128)
    assert not a[:, n:24].any() and not a[:, 24 + n:].any() and not a[:, :, 8:].any()
    assert torch.equal(convert.from_jax_splitcolor(a, n, device="cpu"), u2)
    with pytest.raises(ValueError, match="expected shape"):
        convert.from_jax_splitcolor(a[:, :24], n, device="cpu")
    with pytest.raises(ValueError, match="packed array"):
        convert.to_jax_splitcolor(u2[:, :n], n)


# --------------------------------------------------------------- K42


@functools.lru_cache(maxsize=None)
def _jax_stage(n, block_i, n_iter, red_first):
    """(u, f, JAX packed result): the Pallas kernel in interpret mode on
    f32 inputs packed from zero-boundary cubes."""
    u, f = _cube(n, 10 + n), _cube(n, 20 + n)
    out = jsc.rb_smooth_split_fused(_jax_pack(u), _jax_pack(f), 1.0 / (n - 1), n_iter, n,
                                    red_first=red_first, block_i=block_i)
    return u, f, np.asarray(out)


# the slab is block_i + 4 n_iter planes and must fit in n: block_i <= 9 at 17^3
@pytest.mark.parametrize("n,block_i", [(17, 4), (17, 8), (33, 16)])
@pytest.mark.parametrize("n_iter", [1, 2])
@pytest.mark.parametrize("red_first", [True, False], ids=["red_first", "black_first"])
def test_plain_matches_pallas_bitwise(n, block_i, n_iter, red_first):
    u, f, want = _jax_stage(n, block_i, n_iter, red_first)
    u2, f2 = tsc.pack_split(torch.from_numpy(u)), tsc.pack_split(torch.from_numpy(f))
    got = tsc.rb_smooth_split_fused_plain(u2, f2, 1.0 / (n - 1), n_iter, red_first)
    assert torch.equal(got, convert.from_jax_splitcolor(want, n, device="cpu"))
    np.testing.assert_array_equal(convert.to_jax_splitcolor(got, n), want)  # pads stay 0


@pytest.mark.parametrize("n", [17, 33])
@pytest.mark.parametrize("n_iter", [1, 2])
@pytest.mark.parametrize("red_first", [True, False], ids=["red_first", "black_first"])
def test_plain_matches_pair_and_rect(n, n_iter, red_first):
    u, f = (torch.from_numpy(_cube(n, s)) for s in (30, 31))
    h = 1.0 / (n - 1)
    got = tsc.rb_smooth_split_fused_plain(tsc.pack_split(u), tsc.pack_split(f), h, n_iter,
                                          red_first)
    k7 = torch.cat(tps.rb_smooth_split_plain(*tps.pack_split(u), *tps.pack_split(f), h, n_iter,
                                             red_first), dim=1)
    k1 = tpk.rb_smooth_plain(u, f, h, n_iter, red_first)
    tol = 4 * float(np.spacing(np.float32(got.abs().max())))
    assert float((got - k7).abs().max()) <= tol
    assert float((tsc.unpack_split(got) - k1).abs().max()) <= tol
    assert torch.equal(tsc.pack_split(k1) == 0, got == 0)  # same live slots, dead slots 0


def test_wrapper_updates_in_place_on_cpu():
    """K42's first form (one launch a half-sweep) updates u2 in place; the
    stage returns a fresh array and leaves u2 as it is; on the CPU both
    run the plain version and launch nothing."""
    n = 17
    u2, f2 = (tsc.pack_split(torch.from_numpy(_cube(n, s))) for s in (40, 41))
    u0 = u2.clone()
    want = tsc.rb_smooth_split_fused_plain(u2, f2, 1.0 / (n - 1), 2, False)
    before = (dict(tsc.LAUNCHES), dict(tsc.PER_SWEEP_LAUNCHES))
    got = tsc.rb_smooth_split_fused(u2, f2, 1.0 / (n - 1), 2, n, red_first=False)
    assert got is not u2 and torch.equal(u2, u0) and torch.equal(got, want)
    got = tsc.rb_smooth_split_fused_per_sweep(u2, f2, 1.0 / (n - 1), 2, n, red_first=False)
    assert got is u2 and torch.equal(u2, want)
    assert (tsc.LAUNCHES, tsc.PER_SWEEP_LAUNCHES) == before  # the plain path launches nothing


@pytest.mark.parametrize("case", ["shape", "n", "even_n", "devices", "dtype"])
def test_wrapper_rejects_what_the_kernel_does_not_take(case):
    n = 17
    u2, f2 = (tsc.pack_split(torch.from_numpy(_cube(n, s))) for s in (50, 51))
    args, error = {
        "shape": ((u2[:, :n], f2[:, :n], n), ValueError),
        "n": ((u2, f2, 15), ValueError),
        "even_n": ((torch.zeros(16, 32, 7), torch.zeros(16, 32, 7), 16), ValueError),
        "devices": ((u2, f2.to("meta"), n), ValueError),
        "dtype": ((u2.int(), f2.int(), n), TypeError),
    }[case]
    u, f, m = args
    with pytest.raises(error):
        tsc.rb_smooth_split_fused(u, f, 1.0 / (m - 1), 1, m)


# ------------------------------------------------------- the stage bench


def test_profile_splitcolor_stage_on_cpu():
    n = 17
    rows = profile_splitcolor_stage(n=n, reps=2, device="cpu")
    assert [label.split()[0] for label, *_ in rows] == ["rect", "rect", "packed", "packed",
                                                        "pair", "pair", "same-bytes"]
    assert all("one launch a half-sweep" in rows[i][0] for i in (1, 3, 5))
    cube, packed = n ** 3 * 4, n * 2 * n * ((n - 1) // 2) * 4
    assert [b for _, _, b, _ in rows] == [3 * cube] * 2 + [3 * packed] * 5
    for _, seconds, nbytes, bound_s in rows:
        assert seconds > 0 and bound_s == nbytes / HBM_BYTES_PER_S
