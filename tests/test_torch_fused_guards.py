"""The port's product path against the JAX `make_fused_blind_denoiser` on
its guard paths (CPU, fp32): the beta1<=0 abort guard, the rescue gate's
second pass, and batch_mode='frames'.

Tolerances as in test_torch_fused.py: output atol 2e-4 (1e-3 behind the
chaotic stub below, with its reason); regs of both rounds rtol 1e-3.
"""
import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
import torch.nn.functional as F
from flax import serialization

import yondx.nle.boxfilter as j_boxfilter
from yondx.isp import bayer2rggb as j_bayer2rggb
from yondx.models import build_model
from yondx.pipeline.fused import make_fused_blind_denoiser as j_make
from yondx.vst.lut import BiasLUT as JBiasLUT

import yondx_torch.pipeline.fused as t_fused
from yondx_torch.models.unets import S2DT16_ARCH, load_guided_s2d
from yondx_torch.vst.lut import BiasLUT
from torch_test_util import _two_torch_threads  # noqa: F401

S2DT = os.path.join(os.path.dirname(__file__), "..", "checkpoints",
                    "Gaussian",
                    "Gaussian_GRUS2DT_mix_1to50c_norm_best_model.ckpt")


def assert_regs_close(got, ref):
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref), rtol=1e-3)


def _rggb(bayer):
    return np.array(j_bayer2rggb(jnp.asarray(bayer)))


def _scene(rng, K_true=6.0, sig_true=8.0, scale=959.0):
    """tests/test_fused.py's two-crop scene: Bayer [2, 512, 512]."""
    clean = np.kron(rng.random((2, 2, 2)) * 0.6 + 0.1,
                    np.ones((1, 256, 256)))
    noisy = (K_true * rng.poisson(clean * scale / K_true)
             + rng.normal(0, sig_true, clean.shape)) / scale
    return np.clip(noisy, 0, 1).astype(np.float32)


class _JBrightNoise:
    """Output noise amplitude grows with brightness -> collab beta1 < 0."""

    def apply(self, params, x, t=None):
        return jnp.clip(x + 0.4 * x * jnp.sin(x * 397.0), 0.0, 1.0)


class _TBrightNoise(torch.nn.Module):
    def forward(self, x):
        return torch.clamp(x + 0.4 * x * torch.sin(x * 397.0), 0.0, 1.0)


class _JIdentity:
    def apply(self, params, x, t=None):
        return x


@pytest.mark.parametrize("stub,out_atol", [
    # tests/test_fused.py's stub: its slope 1 + 0.4*397*x*cos(397x) (up
    # to ~160) amplifies the 5e-7 difference of the VST chain (measured
    # with the identity stub) to 3.1e-4 at the output, hence 1e-3 there
    ((_JBrightNoise(), _TBrightNoise()), 1e-3),
    # identity "denoiser": var_lr == var_dn, collab beta1 = 0, guard trips
    ((_JIdentity(), torch.nn.Identity()), 2e-4),
], ids=["bright_noise", "identity"])
def test_abort_guard_keeps_round0_and_repeats_reg(stub, out_atol):
    """(c) beta1 <= 0 in the collab round: output stays round 0 and regs
    repeat round 0, on both sides."""
    j_net, t_net = stub
    rggb = _rggb(_scene(np.random.default_rng(17)))
    lut = JBiasLUT().lut
    kw = dict(guided=False, robust_nle=False)
    dn1_j, regs1_j = j_make(j_net, None, lut, max_iter=1, **kw)(
        jnp.asarray(rggb), jnp.float32(959.0))
    tf0 = t_fused.make_fused_blind_denoiser(t_net, BiasLUT().lut,
                                            max_iter=0, device="cpu", **kw)
    tf1 = t_fused.make_fused_blind_denoiser(t_net, BiasLUT().lut,
                                            max_iter=1, device="cpu", **kw)
    dn0_t, regs0_t = tf0(torch.from_numpy(rggb), 959.0)
    dn1_t, regs1_t = tf1(torch.from_numpy(rggb), 959.0)
    regs1_t = regs1_t.numpy()
    # the guard tripped on the port: round 1 repeats round 0 exactly
    np.testing.assert_array_equal(regs1_t[1], regs1_t[0])
    np.testing.assert_array_equal(regs0_t.numpy()[0], regs1_t[0])
    np.testing.assert_array_equal(dn1_t.numpy(), dn0_t.numpy())
    # and agrees with the JAX graph, which tripped too
    np.testing.assert_array_equal(np.asarray(regs1_j)[1],
                                  np.asarray(regs1_j)[0])
    np.testing.assert_allclose(regs1_t, np.asarray(regs1_j), rtol=1e-3)
    np.testing.assert_allclose(dn1_t.numpy(), np.asarray(dn1_j),
                               atol=out_atol)


class _JGuidedBlur:
    """tests/test_product_50mp.py's noise-adaptive toy SNR-net."""

    def apply(self, params, x, t):
        xp = jnp.pad(x, ((0, 0), (3, 3), (3, 3), (0, 0)), mode="reflect")
        k = jnp.tile(jnp.ones((7, 7, 1, 1), jnp.float32) / 49.0,
                     (1, 1, 1, x.shape[-1]))
        blur = jax.lax.conv_general_dilated(
            xp, k, (1, 1), "VALID",
            dimension_numbers=("NHWC", "HWIO", "NHWC"),
            feature_group_count=x.shape[-1])
        w = jnp.clip(0.55 + t * 4.0, 0.0, 1.0)[:, None, None, None]
        return x * (1.0 - w) + blur * w


class _TGuidedBlur(torch.nn.Module):
    def forward(self, x, t):
        xc = x.permute(0, 3, 1, 2)
        xp = F.pad(xc, (3, 3, 3, 3), mode="reflect")
        k = torch.full((xc.shape[1], 1, 7, 7), 1.0 / 49.0)
        blur = F.conv2d(xp, k, groups=xc.shape[1]).permute(0, 2, 3, 1)
        w = torch.clamp(0.55 + t * 4.0, 0.0, 1.0)[:, None, None, None]
        return x * (1.0 - w) + blur * w


def test_rescue_gate_second_pass_runs_on_both_sides(monkeypatch):
    """The rescue gate's `need` holds: the self fit's variance map is
    scaled by 0.04^2 on both sides (a ~25x std under-estimate, the regime
    of tests/test_product_50mp.py), so collab comes back far higher and
    the input floor certifies the self model low. The port runs its
    second pass (a Python `if`), JAX its lax.cond branch."""
    rng = np.random.default_rng(11)
    H = W = 384
    clean = np.kron(rng.random((4, 4)) * 0.6 + 0.2, np.ones((H // 4, W // 4)))
    K, sigma, scale = 24.0, 6.0, 959.0
    bayer = np.clip((K * rng.poisson(clean * scale / K)
                     + rng.normal(0, sigma, clean.shape)) / scale,
                    0, 1).astype(np.float32)
    rggb = _rggb(bayer)[None]
    low = 0.04 ** 2
    j_orig = j_boxfilter.nle_moments
    monkeypatch.setattr(j_boxfilter, "nle_moments",
                        lambda x, k, inner: (lambda m, v, t: (m, v * low, t))(
                            *j_orig(x, k, inner)))
    t_orig = t_fused.nle_moments

    def t_low(x, k, inner, texture=True, mean=True):
        m, v, t = t_orig(x, k, inner, texture=texture, mean=mean)
        return m, (v * low if texture else v), t   # self fit only

    monkeypatch.setattr(t_fused, "nle_moments", t_low)
    kw = dict(guided=True, robust_nle=False, refine=True, max_iter=1)
    lut = JBiasLUT().lut
    dn0_j, _ = j_make(_JGuidedBlur(), None, lut, **dict(kw, max_iter=0))(
        jnp.asarray(rggb), jnp.float32(scale))
    dn_j, regs_j = j_make(_JGuidedBlur(), None, lut, **kw)(
        jnp.asarray(rggb), jnp.float32(scale))
    ft = t_fused.make_fused_blind_denoiser(_TGuidedBlur(), BiasLUT().lut,
                                           device="cpu", **kw)
    dn_t, regs_t = ft(torch.from_numpy(rggb), scale)
    assert ft.stats["second_passes"] == 1
    # JAX took its second pass too: the output left round 0
    assert float(np.abs(np.asarray(dn_j) - np.asarray(dn0_j)).max()) > 1e-2
    assert_regs_close(regs_t.numpy(), np.asarray(regs_j))
    np.testing.assert_allclose(dn_t.numpy(), np.asarray(dn_j), atol=2e-4)


def test_frames_mode_matches_jax():
    """(d) batch_mode='frames', B=2 independent frames, the shipped net."""
    with open(S2DT, "rb") as f:
        variables = serialization.msgpack_restore(f.read())["params"]
    model = build_model(dict(S2DT16_ARCH))
    net = load_guided_s2d(S2DT, device="cpu")
    rng = np.random.default_rng(21)
    frames = []
    for K, sig in ((8.74, 12.81), (3.0, 4.0)):
        clean = np.kron(rng.random((4, 6)) * 0.7 + 0.05, np.ones((64, 64)))
        noisy = (K * rng.poisson(clean * 959.0 / K)
                 + rng.normal(0, sig, clean.shape)) / 959.0
        frames.append(_rggb(np.clip(noisy, 0, 1).astype(np.float32)))
    rggb = np.stack(frames)                       # [2, 128, 192, 4]
    kw = dict(guided=True, max_iter=1, refine=True,
              sigma_corr="adaptive", batch_mode="frames")
    dn_j, regs_j = j_make(model, variables, JBiasLUT().lut, **kw)(
        jnp.asarray(rggb), jnp.float32(959.0))
    ft = t_fused.make_fused_blind_denoiser(net, BiasLUT().lut, device="cpu",
                                           **kw)
    dn_t, regs_t = ft(torch.from_numpy(rggb), 959.0)
    assert dn_t.shape == rggb.shape and tuple(regs_t.shape) == (2, 2, 2)
    for i in range(2):
        assert_regs_close(regs_t.numpy()[i], np.asarray(regs_j)[i])
    np.testing.assert_allclose(dn_t.numpy(), np.asarray(dn_j), atol=2e-4)
