"""yondx_torch modules against their JAX counterparts in yondx (CPU, fp32).

Inputs are made with numpy from a seed and handed to both sides; each
test states its tolerance. The JAX side runs as the package's own tests
run it on the CPU.
"""
import importlib

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from yondx.core import tiling as j_tiling
from yondx.isp import bayer as j_bayer
from yondx.nle import fit as j_fit
from yondx.nle import robust as j_robust
from yondx.nle import threshold as j_threshold
from yondx.pipeline import denoiser as j_denoiser
from yondx.pipeline import fused as j_fused
from yondx.pipeline import policy as j_policy
from yondx.pipeline import refine as j_refine
from yondx.vst import lut as j_lut

from yondx_torch.core import tiling as t_tiling
from yondx_torch.isp import bayer as t_bayer
from yondx_torch.nle import fit as t_fit
from yondx_torch.nle import robust as t_robust
from yondx_torch.nle import threshold as t_threshold
from yondx_torch.pipeline import denoiser as t_denoiser
from yondx_torch.pipeline import fused as t_fused
from yondx_torch.pipeline import policy as t_policy
from yondx_torch.pipeline import refine as t_refine
from yondx_torch.vst import lut as t_lut
from yondx_torch.vst import vst as t_vst
from torch_test_util import _one_torch_thread  # noqa: F401

# yondx.vst re-exports the function `vst` under the module's own name
j_vst = importlib.import_module("yondx.vst.vst")


def _t(a):
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _np(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def _pg_rggb(seed, h=96, w=128, K=8.74, sig=12.81, scale=959.0, lo=0.05,
             hi=0.75):
    """Piecewise-flat Poisson-Gaussian RGGB stack [1, h, w, 4] in [0, 1]."""
    rng = np.random.default_rng(seed)
    levels = rng.random((4, 4, 4)) * (hi - lo) + lo
    clean = np.kron(levels, np.ones((h // 4, w // 4, 1)))
    # levels below 0 stay below 0 (black-clipped after the final clip)
    noisy = (K * rng.poisson(np.maximum(clean, 0) * scale / K)
             + rng.normal(0, sig, clean.shape)) / scale + np.minimum(clean, 0)
    return np.clip(noisy, 0, 1).astype(np.float32)[None]


# --- isp / core / vst --------------------------------------------------------

def test_bayer_matches_jax_and_round_trips():
    x = np.random.default_rng(0).random((2, 8, 12)).astype(np.float32)
    r = t_bayer.bayer2rggb(_t(x))
    np.testing.assert_array_equal(_np(r), np.asarray(j_bayer.bayer2rggb(
        jnp.asarray(x))))
    np.testing.assert_array_equal(_np(t_bayer.rggb2bayer(r)), x)


@pytest.mark.parametrize("shape,channels_last", [((1, 37, 45, 4), True),
                                                 ((2, 33, 63), False),
                                                 ((1, 64, 32, 4), True)])
def test_pad_unpad_matches_jax(shape, channels_last):
    x = np.random.default_rng(1).random(shape).astype(np.float32)
    tp, tp2d = t_tiling.pad_to_multiple(_t(x), 32, channels_last)
    jp, jp2d = j_tiling.pad_to_multiple(jnp.asarray(x), 32, channels_last)
    assert tp2d == tuple(jp2d)
    np.testing.assert_array_equal(_np(tp), np.asarray(jp))   # exact copy
    np.testing.assert_array_equal(
        _np(t_tiling.unpad(tp, tp2d, channels_last)), x)


@pytest.mark.parametrize("exact", [True, False])
def test_vst_and_inverse_match_jax(exact):
    rng = np.random.default_rng(2)
    x = (rng.random(4096) * 900).astype(np.float32)
    K, sig = np.float32(8.74), np.float32(12.81)
    z_t = t_vst.vst(_t(x), _t(sig), gain=_t(K))
    z_j = j_vst.vst(jnp.asarray(x), sig, gain=K)
    np.testing.assert_allclose(_np(z_t), np.asarray(z_j), rtol=1e-6)
    # fp32 elementwise: a few ulps
    i_t = t_vst.inverse_vst(z_t, _t(sig), gain=_t(K), exact=exact)
    i_j = j_vst.inverse_vst(z_j, sig, gain=K, exact=exact)
    np.testing.assert_allclose(_np(i_t), np.asarray(i_j), rtol=2e-6,
                               atol=1e-4)


def test_lut_grids_and_tables_match_jax():
    for name in ("X_LUT", "SG_LUT", "X_EXT", "FULL_X_GRID", "SG_EXT"):
        np.testing.assert_array_equal(getattr(t_lut, name),
                                      getattr(j_lut, name))
    np.testing.assert_array_equal(t_lut.BiasLUT().lut, j_lut.BiasLUT().lut)
    np.testing.assert_array_equal(t_lut.load_sgext_lut(),
                                  j_lut.load_sgext_lut())
    np.testing.assert_array_equal(t_lut._CHEB_DCT, j_lut._CHEB_DCT)


@pytest.mark.parametrize("K,sigma", [(8.74, 12.81), (2.0, 1.0), (1.0, 20.0),
                                     (1.0, 150.0), (0.5, 120.0)])
def test_bias_curve_and_cheb_lookup_match_jax(K, sigma):
    lut = t_lut.BiasLUT().lut
    sgext = t_lut.load_sgext_lut()
    c_t = t_fused.device_bias_curve(_t(lut), _t(K), _t(sigma), _t(sgext))
    c_j = j_fused.device_bias_curve(jnp.asarray(lut), jnp.float32(K),
                                    jnp.float32(sigma), jnp.asarray(sgext))
    # fp32 blends of the same table entries
    np.testing.assert_allclose(_np(c_t), np.asarray(c_j), rtol=1e-5,
                               atol=1e-6)
    co_t = t_lut.cheb_fit_curve(c_t)
    co_j = j_lut.cheb_fit_curve(c_j)
    np.testing.assert_allclose(_np(co_t), np.asarray(co_j), atol=1e-5)
    x = np.concatenate([np.linspace(0, 2, 257), np.geomspace(2, 6e4, 511)])
    x = (x * K).astype(np.float32)
    b_t = t_lut.lookup_bias_curve_cheb(_t(x), co_t, _t(K))
    b_j = j_lut.lookup_bias_curve_cheb(jnp.asarray(x), co_j, jnp.float32(K))
    # 64-term fp32 Clenshaw recurrences in the same order
    np.testing.assert_allclose(_np(b_t), np.asarray(b_j), atol=2e-5)
    np.testing.assert_allclose(_np(t_lut.frac_index_x(_t(x) / K)),
                               np.asarray(j_lut.frac_index_x(
                                   jnp.asarray(x) / K)), rtol=1e-5,
                               atol=1e-4)


# --- NLE threshold / fit / robust ---------------------------------------------

@pytest.mark.parametrize("subsample", [1, 4])
def test_score3_threshold_matches_jax(subsample):
    rng = np.random.default_rng(4)
    tex = (rng.random((1, 64, 96, 4)) ** 3 * 0.05).astype(np.float32)
    mean = rng.random((1, 64, 96, 4)).astype(np.float32)
    th_t, p25_t = t_threshold.score3_threshold_with_p25(
        _t(tex), _t(mean), step=5, subsample=subsample)
    th_j, p25_j = j_threshold.score3_threshold_with_p25(
        jnp.asarray(tex), jnp.asarray(mean), step=5, subsample=subsample)
    # percentiles interpolate between the same sorted samples
    np.testing.assert_allclose(float(th_t), float(th_j), rtol=1e-6)
    np.testing.assert_allclose(float(p25_t), float(p25_j), rtol=1e-6)
    # step 7: the 25th percentile is off the candidate grid
    _, p25b_t = t_threshold.score3_threshold_with_p25(_t(tex), _t(mean),
                                                      step=7)
    _, p25b_j = j_threshold.score3_threshold_with_p25(
        jnp.asarray(tex), jnp.asarray(mean), step=7)
    np.testing.assert_allclose(float(p25b_t), float(p25b_j), rtol=1e-6)


def test_linefit_and_nonsat_match_jax():
    rng = np.random.default_rng(5)
    x = rng.random(5000).astype(np.float32)
    y = (3e-3 * x + 2e-4 + rng.normal(0, 1e-4, 5000)).astype(np.float32)
    w = (rng.random(5000) > 0.3).astype(np.float32)
    wt = t_fit.nonsat_weights(_t(x), _t(w))
    wj = j_fit.nonsat_weights(jnp.asarray(x), jnp.asarray(w))
    np.testing.assert_array_equal(_np(wt), np.asarray(wj))
    bt = t_fit.masked_linefit(_t(x), _t(y), wt)
    bj = j_fit.masked_linefit(jnp.asarray(x), jnp.asarray(y), wj)
    # fp32 weighted sums of 5000 terms
    np.testing.assert_allclose([float(v) for v in bt],
                               [float(v) for v in bj], rtol=1e-4)
    zero = t_fit.masked_linefit(_t(x), _t(y), torch.zeros(5000))
    assert [float(v) for v in zero] == [0.0, 0.0]


@pytest.mark.parametrize("h", [96, 1408])   # 1408 rows: band subsampling
def test_robust_estimates_match_jax(h):
    lr = _pg_rggb(6, h=h)
    dn = _pg_rggb(6, h=h, K=1.0, sig=1.0)     # a much cleaner proxy
    # histogram statistics of identical fp32 inputs: rtol 1e-4 covers a
    # log() ulp at a bin edge moving one sample
    for tf, jf in ((t_robust.mad_self_estimate, j_robust.mad_self_estimate),
                   (t_robust.flat_floor_stats, j_robust.flat_floor_stats),
                   (t_robust.mad_noise_floor, j_robust.mad_noise_floor)):
        got = tf(_t(lr))
        ref = jf(jnp.asarray(lr))
        np.testing.assert_allclose(np.asarray(_np(torch.stack(got)) if
                                              isinstance(got, tuple)
                                              else _np(got)),
                                   np.asarray(ref), rtol=1e-4)
    got = t_robust.mad_collab_estimate(_t(lr), _t(dn))
    ref = j_robust.mad_collab_estimate(jnp.asarray(lr), jnp.asarray(dn))
    np.testing.assert_allclose([float(v) for v in got],
                               [float(v) for v in ref], rtol=1e-4)


@pytest.mark.parametrize("fit,mad,band", [
    ((3e-3, 2e-4), (1e-3, 1e-4), None),      # fit inflated -> MAD
    ((3e-3, 2e-4), (2.9e-3, 1.9e-4), None),  # agree -> fit
    ((1e-3, 1e-5), (3e-3, 1e-4), 1.8),       # collab band low side -> MAD
    ((3e-3, 9e-4), (2.5e-3, 1e-4), 1.8),     # band keeps fit; b2 repair
    ((3e-3, 2e-4), (np.inf, np.inf), 1.8),   # invalid MAD -> fit
])
def test_combine_and_shape_consistency_match_jax(fit, mad, band):
    ref_mean = 0.4
    ft, mt = tuple(_t(v) for v in fit), tuple(_t(v) for v in mad)
    fj = tuple(jnp.float32(v) for v in fit)
    mj = tuple(jnp.float32(v) for v in mad)
    ct = t_robust.combine_estimates(ft, mt, _t(ref_mean), band=band)
    cj = j_robust.combine_estimates(fj, mj, jnp.float32(ref_mean), band=band)
    np.testing.assert_array_equal([float(v) for v in ct],
                                  [float(v) for v in cj])
    self_reg = (_t(2.8e-3), _t(1e-4))
    st = t_robust.shape_consistent_collab(ct, ft, mt, _t(ref_mean), self_reg)
    sj = j_robust.shape_consistent_collab(
        cj, fj, mj, jnp.float32(ref_mean),
        (jnp.float32(2.8e-3), jnp.float32(1e-4)))
    np.testing.assert_allclose([float(v) for v in st],
                               [float(v) for v in sj], rtol=1e-6)


# --- guidance, refine, policy -------------------------------------------------

@pytest.mark.parametrize("K,sigma,lo,hi", [
    (8.74, 12.81, 0.05, 0.75),     # mid noise
    (0.5, 0.8, 0.05, 0.75),        # low noise
    (40.0, 60.0, 0.05, 0.75),      # high noise
    (8.74, 12.81, -0.3, 1.3),      # heavily clipped
])
def test_adaptive_sigma_corr_matches_jax(K, sigma, lo, hi):
    x = _pg_rggb(7, K=K, sig=sigma, lo=lo, hi=hi)
    Kd, sd = 0.98 * K, 1.02 * sigma
    got = t_denoiser.adaptive_sigma_corr(_t(x), _t(Kd), _t(sd), _t(959.0))
    ref = j_denoiser.adaptive_sigma_corr(jnp.asarray(x), jnp.float32(Kd),
                                         jnp.float32(sd), jnp.float32(959.0))
    assert float(got) == float(ref)


def test_wiener_refine_matches_jax():
    rng = np.random.default_rng(8)
    clean = np.kron(rng.random((1, 4, 6, 1)) * 0.6 + 0.2,
                    np.ones((1, 16, 16, 4))).astype(np.float32)
    nsr = 0.03
    z_noisy = (clean + rng.normal(0, nsr, clean.shape)).astype(np.float32)
    z_dn = (clean + rng.normal(0, nsr * 0.2, clean.shape)).astype(np.float32)
    got = t_refine.wiener_refine(_t(z_dn), _t(z_noisy), noise_var=nsr ** 2,
                                 x01=_t(z_dn))
    ref = j_refine.wiener_refine(jnp.asarray(z_dn), jnp.asarray(z_noisy),
                                 noise_var=nsr ** 2, x01=jnp.asarray(z_dn),
                                 noise_floor="bucket", residual_shrink=True,
                                 shrink_full_alpha=1.0,
                                 shrink_mode="oriented")
    # fp32 box filters and a-trous sums; outputs are O(1)
    np.testing.assert_allclose(_np(got), np.asarray(ref), atol=2e-5)
    np.testing.assert_allclose(
        _np(t_refine._bucket_noise_floor(_t(z_noisy), _t(z_dn), nsr ** 2)),
        np.asarray(j_refine._bucket_noise_floor(
            jnp.asarray(z_noisy), jnp.asarray(z_dn), nsr ** 2)), rtol=1e-4)
    assert t_refine._dir_mean_noise_vars(3, 9) == \
        j_refine._dir_mean_noise_vars(3, 9)
    assert t_refine._starlet_noise_vars(3) == j_refine._starlet_noise_vars(3)


def test_combine_rounds_cases():
    """The combine_rounds cases of tests/test_product_50mp.py, on the port."""
    dn0 = torch.zeros((4, 4))
    dn1 = torch.ones((4, 4))
    cr = t_policy.combine_rounds
    assert float(torch.mean(cr(dn0, dn1, 0.0, policy="replace"))) == 1.0
    assert float(torch.mean(cr(dn0, dn1, 0.0, policy="avg"))) == 0.5
    assert float(torch.mean(cr(dn0, dn1, 0.01, policy="guard",
                               tol=0.1))) == 0.0
    assert float(torch.mean(cr(dn0, dn1, -0.5, policy="guard",
                               tol=0.1))) == 1.0
    assert float(torch.mean(cr(dn0, dn1, 0.01, policy="avg_guard",
                               tol=0.1))) == 0.0
    assert float(torch.mean(cr(dn0, dn1, 0.5, policy="avg_guard",
                               tol=0.1))) == 0.5
    assert float(torch.mean(cr(dn0, dn1, -5.0, policy="rescue",
                               tol=0.15))) == 0.0
    assert float(torch.mean(cr(dn0, dn1, 0.10, policy="rescue",
                               tol=0.15))) == 0.0
    mid = float(torch.mean(cr(dn0, dn1, 0.30, policy="rescue", tol=0.15)))
    assert 0.4 < mid < 0.6
    assert float(torch.mean(cr(dn0, dn1, 0.50, policy="rescue",
                               tol=0.15))) == 1.0
    assert float(torch.mean(cr(dn0, dn1, 0.50, policy="rescue", tol=0.15,
                               floor_frac=0.9, floor_frac_tol=1.5))) == 0.0
    assert float(torch.mean(cr(dn0, dn1, 0.50, policy="rescue", tol=0.15,
                               floor_frac=2.0, floor_frac_tol=1.5))) == 1.0
    with pytest.raises(ValueError):
        cr(dn0, dn1, 0.0, policy="nope")


@pytest.mark.parametrize("policy", ["avg_guard", "rescue"])
def test_policy_matches_jax(policy):
    rng = np.random.default_rng(9)
    dn0 = rng.random((8, 8)).astype(np.float32)
    dn1 = rng.random((8, 8)).astype(np.float32)
    for self_reg, col_reg in (((1e-3, 1e-4), (1.5e-3, 1e-4)),
                              ((1e-3, 1e-4), (0.5e-3, 2e-5))):
        a_t = t_policy.reg_agreement(tuple(_t(v) for v in self_reg),
                                     tuple(_t(v) for v in col_reg), _t(0.4))
        a_j = j_policy.reg_agreement(tuple(jnp.float32(v) for v in self_reg),
                                     tuple(jnp.float32(v) for v in col_reg),
                                     jnp.float32(0.4))
        np.testing.assert_allclose(float(a_t), float(a_j), rtol=1e-6)
        got = t_policy.combine_rounds(_t(dn0), _t(dn1), a_t, policy=policy,
                                      floor_frac=_t(2.0))
        ref = j_policy.combine_rounds(jnp.asarray(dn0), jnp.asarray(dn1),
                                      a_j, policy=policy,
                                      floor_frac=jnp.float32(2.0))
        np.testing.assert_allclose(_np(got), np.asarray(ref), atol=1e-6)
    assert (t_policy.DEFAULT_POLICY, t_policy.DEFAULT_TOL,
            t_policy.DEFAULT_FLOOR_FRAC) == (j_policy.DEFAULT_POLICY,
                                             j_policy.DEFAULT_TOL,
                                             j_policy.DEFAULT_FLOOR_FRAC)
