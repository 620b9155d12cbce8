"""Every option of the port's fused entry (yondx_torch.pipeline.fused)
against the JAX `make_fused_blind_denoiser`, one case per option value,
with a 7-px box blur standing in for the net on both sides (as
tests/test_fused.py does) on a small piecewise-flat Poisson-Gaussian
frame, fp32, CPU.

Tolerances (those of tests/test_torch_fused.py): the output to atol
2e-4, the regs of every round to rtol 1e-3. The histogram percentiles of
th_impl='hist' are held bit for bit.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from yondx.isp import bayer2rggb as j_bayer2rggb
from yondx.nle import box_mean as j_box_mean
from yondx.nle import threshold as j_threshold
from yondx.pipeline.fused import make_fused_blind_denoiser as j_make
from yondx.vst.lut import BiasLUT as JBiasLUT

from yondx_torch.nle import threshold as t_threshold
from yondx_torch.nle.boxfilter import box_mean as t_box_mean
from yondx_torch.pipeline.fused import make_fused_blind_denoiser as t_make
from yondx_torch.vst.lut import BiasLUT
from torch_test_util import _one_torch_thread  # noqa: F401

SCALE = 959.0


class _JBlur:
    def apply(self, params, x, t=None):
        return j_box_mean(x, 7)


class _TBlur(torch.nn.Module):
    def forward(self, x, t=None):
        return t_box_mean(x, 7)


def _frames(n=1, H=192, W=256, seed=3):
    """n Bayer frames of 4x4 flat levels with Poisson-Gaussian noise
    (K 6, sigma 8 DN at scale 959) -> RGGB [n, H/2, W/2, 4]."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        clean = np.kron(rng.random((4, 4)) * 0.6 + 0.1,
                        np.ones((H // 4, W // 4)))
        noisy = (6.0 * rng.poisson(clean * SCALE / 6.0)
                 + rng.normal(0, 8.0, clean.shape)) / SCALE
        out.append(np.asarray(j_bayer2rggb(jnp.asarray(
            np.clip(noisy, 0, 1).astype(np.float32)))))
    return np.stack(out)


@pytest.fixture(scope="module")
def lut():
    return JBiasLUT().lut


def _run_both(lut, rggb, **kw):
    kw = {"guided": False, "max_iter": 1, **kw}
    fj = j_make(_JBlur(), None, lut, **kw)
    dn_j, regs_j = fj(jnp.asarray(rggb), jnp.float32(SCALE))
    ft = t_make(_TBlur(), BiasLUT().lut, device="cpu", **kw)
    dn_t, regs_t = ft(torch.from_numpy(rggb.copy()), SCALE)
    return (np.asarray(dn_j), np.asarray(regs_j), dn_t.numpy(),
            regs_t.numpy(), ft)


CASES = {
    "bias_corr=None": dict(bias_corr=None),
    "bias_corr=post": dict(bias_corr="post"),
    "iter_policy=replace": dict(iter_policy="replace"),
    "iter_policy=avg": dict(iter_policy="avg"),
    "iter_policy=guard": dict(iter_policy="guard", iter_policy_tol=0.02),
    "iter_policy=avg_guard": dict(iter_policy="avg_guard",
                                  iter_policy_tol=0.02),
    "iter_policy=rescue": dict(iter_policy="rescue", iter_policy_tol=0.0),
    "max_iter=2": dict(max_iter=2, iter_policy="replace"),
    # robust_nle=False: the flat-mask fit itself gives the regs, which the
    # MAD cross-check overrides on this frame
    "k=19": dict(k=19, robust_nle=False),
    "k=41": dict(k=41, robust_nle=False),
    "step=10": dict(step=10, robust_nle=False),
    "pad_base=8": dict(pad_base=8),
    "th_impl=hist": dict(th_impl="hist", robust_nle=False),
    "th_impl=hist,pallas,subsample=4": dict(th_impl="hist",
                                            use_pallas_nle=True,
                                            th_subsample=4,
                                            robust_nle=False),
    "refine_knobs": dict(refine=True, refine_k=9, refine_floor="q10",
                         refine_shrink_mode="iso", refine_shrink_lam=0.5),
}


@pytest.mark.parametrize("name", list(CASES))
def test_option_matches_jax(lut, name):
    kw = CASES[name]
    rggb = _frames()
    dn_j, regs_j, dn_t, regs_t, ft = _run_both(lut, rggb, **kw)
    rounds = kw.get("max_iter", 1) + 1
    assert dn_t.shape == rggb.shape and regs_t.shape == (rounds, 2)
    np.testing.assert_allclose(regs_t, regs_j, rtol=1e-3)
    np.testing.assert_allclose(dn_t, dn_j, atol=2e-4)
    policy = kw.get("iter_policy", "rescue")
    if policy != "rescue":
        assert ft.stats["second_passes"] == rounds - 1


@pytest.mark.parametrize("frames_sequential", [True, False])
def test_frames_batch_mode_matches_jax(lut, frames_sequential):
    """batch_mode='frames': two frames with their own (K, sigma); the
    port runs them one by one under both settings."""
    rggb = np.concatenate([_frames(seed=3), _frames(seed=4)])
    dn_j, regs_j, dn_t, regs_t, _ = _run_both(
        lut, rggb, batch_mode="frames", frames_sequential=frames_sequential)
    assert regs_t.shape == (2, 2, 2)
    np.testing.assert_allclose(regs_t, regs_j, rtol=1e-3)
    np.testing.assert_allclose(dn_t, dn_j, atol=2e-4)


@pytest.mark.parametrize("n", [1000, 300_000])
def test_hist_percentiles_bit_equal(n):
    rng = np.random.default_rng(n)
    tex = (rng.random(n) ** 3 * 0.05).astype(np.float32)
    q = jnp.linspace(5, 100, 20)
    want = np.asarray(jax.jit(j_threshold._hist_percentiles)(
        jnp.asarray(tex), q))
    got = t_threshold._hist_percentiles(torch.from_numpy(tex),
                                        torch.linspace(5, 100, 20))
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("impl", ["sort", "hist"])
@pytest.mark.parametrize("subsample", [1, 4])
def test_score3_threshold_matches_jax(impl, subsample):
    rng = np.random.default_rng(7)
    tex = (rng.random(200_000) ** 3 * 0.05).astype(np.float32)
    mean = rng.random(200_000).astype(np.float32)
    want = jax.jit(lambda t, m: j_threshold.adaptive_threshold_score3(
        t, m, 5, impl, subsample))(jnp.asarray(tex), jnp.asarray(mean))
    got = t_threshold.adaptive_threshold_score3(
        torch.from_numpy(tex), torch.from_numpy(mean), 5, impl, subsample)
    np.testing.assert_array_equal([float(g) for g in got],
                                  [float(w) for w in want])


@pytest.mark.parametrize("k", [19, 41])
def test_k1_plan_at_other_windows_matches_jax(k):
    """K1's staging, run lengths and per-tile shifts (emulated on the CPU
    by tests/test_torch_k1_plan.py) at the fused entry's other windows,
    with their texture pre-blur k // 3 * 2 + 1, against the JAX moments,
    at that file's tolerances (mean 2e-6, var 1e-6, tex 1e-5)."""
    from yondx.nle import boxfilter as j_box
    from test_torch_k1_plan import k1_plan
    inner = k // 3 * 2 + 1
    x = np.random.default_rng(k).random((1, 150, 200, 4)).astype(np.float32)
    xj = jnp.asarray(x)
    refs = {"self": j_box.nle_moments(xj, k, inner),
            "collab_dn": (*j_box.mean_varfilt(xj, k), None),
            "collab_lr": (None, np.maximum(np.asarray(j_box.varfilt(xj, k)),
                                           0.0), None)}
    for flavour, (texture, mean) in (("self", (True, True)),
                                     ("collab_dn", (False, True)),
                                     ("collab_lr", (False, False))):
        got = k1_plan(torch.from_numpy(x), k, inner, texture, mean)
        for key, g, r, tol in zip(("mean", "var", "tex"), got,
                                  refs[flavour], (2e-6, 1e-6, 1e-5)):
            assert (g is None) == (r is None), (flavour, key)
            if g is not None:
                np.testing.assert_allclose(g.numpy(), np.asarray(r),
                                           atol=tol, err_msg=(flavour, key))
