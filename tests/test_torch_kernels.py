"""The kernel functions of the port's first slice (K1, K2, R, K5 in
multigrid_parallel_tpu_torch.ops.pallas3d), the rest of that module
(K26 smooth + residual, K27 double-float residual, residual_norm_fused)
against the JAX package's Pallas kernels, run in interpret mode at 17^3
f32 on the same numpy-seeded inputs, and the double-float helpers.

On CPU tensors the wrappers take their plain PyTorch versions; the CUDA
kernels themselves are held against those plain versions on the card
(tests/test_torch_cuda.py and chip_smoke.py).

Tolerance for fields: max |port - jax| <= 4 f32 ulp of the field's max
(the two sides run the same IEEE operations in the same order; the JAX
side goes through XLA's CPU compiler, which may contract or reorder a
few of them)."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from multigrid_parallel_tpu.ops import pallas3d as jpk
from multigrid_parallel_tpu.ops import stencils_3d as jops
from multigrid_parallel_tpu_torch.ops import _build
from multigrid_parallel_tpu_torch.ops import pallas3d as tpk
from multigrid_parallel_tpu_torch.utils import convert

torch.set_num_threads(1)

N = 17
H = 1.0 / (N - 1)


def _fields32(seed, n=N):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((n, n, n)).astype(np.float32),
            rng.standard_normal((n, n, n)).astype(np.float32))


def _assert_ulps(got, want, ulps=4):
    got = np.asarray(got, dtype=np.float32)
    want = np.asarray(want, dtype=np.float32)
    assert got.shape == want.shape, (got.shape, want.shape)
    tol = ulps * np.spacing(np.abs(want).max())
    err = np.abs(got.astype(np.float64) - want.astype(np.float64)).max()
    assert err <= tol, (err, tol)


def _pad(x):
    return jnp.asarray(convert.to_jax_layout(torch.from_numpy(x), x.shape[0]))


def _unpad(x, n=N):
    return np.asarray(x)[:, :n, :n]


@pytest.mark.parametrize("red_first", [True, False])
def test_rb_smooth_fused_matches_pallas(red_first):
    u, f = _fields32(0)
    want = jpk.rb_smooth_fused_pipelined(_pad(u), _pad(f), H, 2, N,
                                         red_first=red_first, block_i=4)
    ut = torch.from_numpy(u.copy())
    got = tpk.rb_smooth_fused(ut, torch.from_numpy(f), H, 2, red_first=red_first)
    # a fresh field, ut left as it is, as the CUDA form does
    assert got is not ut and torch.equal(ut, torch.from_numpy(u))
    _assert_ulps(got, _unpad(want))


@pytest.mark.parametrize("red_first", [True, False])
def test_rb_smooth_from_zero_fused_matches_pallas(red_first):
    _, f = _fields32(1)
    want = jpk.rb_smooth_from_zero_fused(_pad(f), H, 2, N,
                                         red_first=red_first, block_i=4)
    got = tpk.rb_smooth_from_zero_fused(torch.from_numpy(f), H, 2,
                                        red_first=red_first)
    _assert_ulps(got, _unpad(want))


def test_residual_fused_matches_pallas():
    u, f = _fields32(2)
    want = jpk.residual_fused_pipelined(_pad(u), _pad(f), H, N, block_i=4)
    got = tpk.residual_fused(torch.from_numpy(u), torch.from_numpy(f), H)
    _assert_ulps(got, _unpad(want))


def _df_state(seed, n=N):
    """A smooth double-float state near a solution (the K5 regime)."""
    h = 1.0 / (n - 1)
    c = np.arange(n) * h
    x, y, z = np.meshgrid(c, c, c, indexing="ij")
    rng = np.random.default_rng(seed)
    u64 = (x * x - 2 * y * y + z * z
           + 1e-4 * np.sin(9 * x) * np.cos(7 * y) * np.sin(5 * z)
           + 1e-9 * rng.standard_normal((n, n, n)))
    f64 = np.sin(x + y + z)
    return u64, f64


def test_residual_df_norm_fused_matches_pallas():
    u64, f64 = _df_state(3)
    u_hi, u_lo = jpk.df_split(jnp.asarray(u64), pad=True)
    f_hi, f_lo = jpk.df_split(jnp.asarray(f64), pad=True)
    r_want, n_want = jpk.residual_df_norm_fused_padded(u_hi, u_lo, f_hi, f_lo,
                                                       H, N, block_i=4)
    port = convert.from_jax_state(u_hi, u_lo, f_hi, f_lo, N, device="cpu")
    r_got, n_got = tpk.residual_df_norm_fused(*port, H)
    _assert_ulps(r_got, _unpad(r_want))
    # the norms differ only in the order (and, on the JAX side, the f32
    # precision) of the sum of squares
    assert float(n_got) == pytest.approx(float(n_want), rel=1e-5)
    assert n_got.dtype == torch.float32 and n_got.shape == ()


def test_residual_df_matches_f64_oracle():
    # as test_df_solver.test_df_residual_matches_f64: r_hi is one f32, so
    # its error is ~ulp-RELATIVE to |r|
    u64, f64 = _df_state(4)
    want = np.asarray(jops.residual(jnp.asarray(u64), jnp.asarray(f64), H))
    u_hi, u_lo = tpk.df_split(torch.from_numpy(u64))
    f_hi, f_lo = tpk.df_split(torch.from_numpy(f64))
    r, nrm2 = tpk.residual_df_norm_fused(u_hi, u_lo, f_hi, f_lo, H)
    err = np.abs(r.numpy().astype(np.float64) - want).max()
    assert err < 2e-7 * np.abs(want).max() + 1e-10, err
    assert float(nrm2) == pytest.approx(float((want * want).sum()), rel=1e-5)


@pytest.mark.parametrize("red_first", [True, False])
@pytest.mark.parametrize("n_iter", [1, 2])
def test_rb_smooth_residual_fused_matches_pallas(red_first, n_iter):
    u, f = _fields32(11)
    want_u, want_r = jpk.rb_smooth_residual_fused_padded(
        _pad(u), _pad(f), H, n_iter, N, red_first=red_first, block_i=4)
    ut = torch.from_numpy(u.copy())
    got_u, got_r = tpk.rb_smooth_residual_fused(ut, torch.from_numpy(f), H, n_iter,
                                                red_first=red_first)
    assert got_u is ut  # updated in place, as the CUDA form does
    _assert_ulps(got_u, _unpad(want_u))
    _assert_ulps(got_r, _unpad(want_r))
    # the plain version is K1's plain version, then R's
    pu, pr = tpk.rb_smooth_residual_plain(torch.from_numpy(u), torch.from_numpy(f), H,
                                          n_iter, red_first)
    assert torch.equal(pu, got_u) and torch.equal(pr, got_r)


def test_rb_smooth_residual_fused_needs_an_iteration():
    u, f = _fields32(12, 9)
    with pytest.raises(ValueError, match="n_iter"):
        tpk.rb_smooth_residual_fused(torch.from_numpy(u), torch.from_numpy(f), 0.125, 0)


def test_residual_df_fused_matches_pallas():
    u64, f64 = _df_state(13)
    u_hi, u_lo = jpk.df_split(jnp.asarray(u64), pad=True)
    f_hi, f_lo = jpk.df_split(jnp.asarray(f64), pad=True)
    want = jpk.residual_df_fused_padded(u_hi, u_lo, f_hi, f_lo, H, N, block_i=4)
    port = convert.from_jax_state(u_hi, u_lo, f_hi, f_lo, N, device="cpu")
    got = tpk.residual_df_fused(*port, H)
    _assert_ulps(got, _unpad(want))
    # K27's r is K5's r
    assert torch.equal(got, tpk.residual_df_norm_fused(*port, H)[0])


def test_residual_norm_fused_matches_jax():
    u, f = _fields32(14)
    want = jpk.residual_norm_fused(jnp.asarray(u), jnp.asarray(f), H, block_i=4)
    got = tpk.residual_norm_fused(torch.from_numpy(u), torch.from_numpy(f), H)
    assert got.shape == () and got.dtype == torch.float32
    # the residuals agree to 4 ulp; the f32 sums of squares run in
    # another order
    assert float(got) == pytest.approx(float(want), rel=1e-5)
    assert torch.equal(got, tpk.residual_norm_plain(torch.from_numpy(u),
                                                    torch.from_numpy(f), H))


def test_df_split_add_match_jax():
    rng = np.random.default_rng(1)
    x = rng.standard_normal(1000) * 100
    d = (rng.standard_normal(1000) * 1e-5).astype(np.float32)
    hi, lo = tpk.df_split(torch.from_numpy(x))
    jhi, jlo = jpk.df_split(jnp.asarray(x))
    np.testing.assert_array_equal(hi.numpy(), np.asarray(jhi))
    np.testing.assert_array_equal(lo.numpy(), np.asarray(jlo))
    # a double-float pair resolves ~2^-48 relative
    np.testing.assert_allclose(tpk.df_to_f64(hi, lo).numpy(), x, rtol=5e-15)
    hi2, lo2 = tpk.df_add(hi, lo, torch.from_numpy(d))
    jhi2, jlo2 = jpk.df_add(jhi, jlo, jnp.asarray(d))
    np.testing.assert_array_equal(hi2.numpy(), np.asarray(jhi2))
    np.testing.assert_array_equal(lo2.numpy(), np.asarray(jlo2))
    np.testing.assert_allclose(tpk.df_to_f64(hi2, lo2).numpy(),
                               x + d.astype(np.float64), rtol=1e-13, atol=1e-12)


def test_wrappers_raise_off_cpu_and_cuda():
    # no fallback: a tensor that is neither on the CPU nor on a CUDA
    # device gets an error, never the plain version
    f = torch.zeros((5, 5, 5), device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        tpk.rb_smooth_from_zero_fused(f, 0.25, 1)
    with pytest.raises(ValueError, match="different devices"):
        tpk.residual_fused(torch.zeros((5, 5, 5)), f, 0.25)


def test_cpu_path_counts_no_launches():
    tpk.reset_launches()
    u, f = _fields32(5, 9)
    tpk.residual_fused(torch.from_numpy(u), torch.from_numpy(f), 0.125)
    assert set(tpk.LAUNCHES) == set(tpk.KERNELS)
    assert all(v == 0 for v in tpk.LAUNCHES.values())


def test_build_flags_and_library_name():
    flags = _build.NVCC_FLAGS
    assert "--fmad=false" in flags and "arch=compute_90a,code=sm_90a" in flags
    assert "arch=compute_90a,code=sm_90a" in _build.LINK_FLAGS
    assert not any("fast_math" in f for f in flags + _build.LINK_FLAGS)
    path = _build.library_path()
    assert path == _build.library_path()  # stable hash of the sources
    assert path.parent.name == "_build" and path.suffix == ".so"
    names = {p.name for p in _build._sources()}
    assert {"rb_smooth.cu", "residual.cu", "residual_df_norm.cu", "residual_restrict.cu",
            "prolong_smooth.cu", "df_step.cu", "rb_smooth_residual.cu", "eft.cuh",
            "stencil.cuh", "rect.cuh"} <= names
    assert {"mg_residual_restrict", "mg_rect_stage", "mg_rect_prolong_stage", "mg_df_step",
            "mg_df_step_partials", "mg_rb_last_sweep_residual",
            "mg_residual_df"} <= set(_build._SIGNATURES)
    # no kernel source leans on a library for the work its TPU kernel does
    for src in _build._sources():
        text = src.read_text()
        assert "cublas" not in text.lower() and "torch/" not in text, src.name
