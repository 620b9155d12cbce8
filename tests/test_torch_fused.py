"""The port's product path (yondx_torch.pipeline.fused) against the JAX
`make_fused_blind_denoiser`, with the shipped s2dt16 net on both sides
(the same committed params, fp32, CPU).

Tolerances: the output to atol 2e-4, regs of both rounds to rtol 1e-3.
The last test records how ill-conditioned beta2 is: a 1e-6 shift of the
frame moves it by more than 1e-3 (relative) on both sides, which is the
reading chip_smoke.py's card-vs-CPU phase holds its regs to.
"""
import os

import numpy as np
import jax.numpy as jnp
import pytest
import torch
from flax import serialization

from yondx.isp import bayer2rggb as j_bayer2rggb
from yondx.models import build_model
from yondx.pipeline.fused import make_fused_blind_denoiser as j_make
from yondx.vst.lut import BiasLUT as JBiasLUT

from yondx_torch.models.unets import S2DT16_ARCH, load_guided_s2d
from yondx_torch.pipeline.fused import make_fused_blind_denoiser as t_make
from yondx_torch.vst.lut import BiasLUT
from torch_test_util import _two_torch_threads  # noqa: F401

S2DT = os.path.join(os.path.dirname(__file__), "..", "checkpoints",
                    "Gaussian",
                    "Gaussian_GRUS2DT_mix_1to50c_norm_best_model.ckpt")
PRODUCT = dict(guided=True, max_iter=1, refine=True,
               sigma_corr="adaptive")


@pytest.fixture(scope="module")
def nets():
    with open(S2DT, "rb") as f:
        variables = serialization.msgpack_restore(f.read())["params"]
    return (build_model(dict(S2DT16_ARCH)), variables,
            load_guided_s2d(S2DT, device="cpu"))


def _frame(H, W, seed):
    """bench.py-style piecewise-flat Poisson-Gaussian Bayer frame."""
    rng = np.random.default_rng(seed)
    levels = rng.random((6, 8)) * 0.7 + 0.05
    clean = np.kron(levels, np.ones((H // 6, W // 8))).astype(np.float32)
    K, sig, scale = 8.74, 12.81, 959.0
    noisy = (K * rng.poisson(clean * scale / K)
             + rng.normal(0, sig, clean.shape)) / scale
    rggb = np.asarray(j_bayer2rggb(jnp.asarray(
        np.clip(noisy, 0, 1).astype(np.float32))))
    return rggb[None]


def assert_regs_close(got, ref):
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref), rtol=1e-3)


def _run_both(nets, rggb, jax_out=None, **kw):
    """Both packages' fused denoisers on `rggb`; `jax_out` is JAX's
    (dn, regs) when already computed."""
    model, variables, net = nets
    if jax_out is None:
        fj = j_make(model, variables, JBiasLUT().lut, **kw)
        jax_out = fj(jnp.asarray(rggb), jnp.float32(959.0))
    dn_j, regs_j = jax_out
    ft = t_make(net, BiasLUT().lut, device="cpu", **kw)
    dn_t, regs_t = ft(torch.from_numpy(rggb.copy()), 959.0)
    return (np.asarray(dn_j), np.asarray(regs_j), dn_t.numpy(),
            regs_t.numpy(), ft)


@pytest.fixture(scope="module")
def jax_product_a(nets):
    """JAX's product-config denoiser (use_pallas_nle False, its default),
    compiled once for frame (a), and its (dn, regs) on that frame."""
    model, variables, _ = nets
    fj = j_make(model, variables, JBiasLUT().lut, **PRODUCT)
    rggb = _frame(256, 384, 3)
    dn, regs = fj(jnp.asarray(rggb), jnp.float32(959.0))
    return fj, np.asarray(dn), np.asarray(regs)


@pytest.mark.parametrize("use_pallas_nle", [True, False])
def test_slice_matches_jax_unbanded(nets, jax_product_a, use_pallas_nle):
    """(a) RGGB [1,128,192,4], unbanded NLE."""
    rggb = _frame(256, 384, 3)
    dn_j, regs_j, dn_t, regs_t, ft = _run_both(
        nets, rggb, None if use_pallas_nle else jax_product_a[1:],
        use_pallas_nle=use_pallas_nle, **PRODUCT)
    assert dn_t.shape == rggb.shape and regs_t.shape == (2, 2)
    assert_regs_close(regs_t, regs_j)
    np.testing.assert_allclose(dn_t, dn_j, atol=2e-4)


def test_slice_matches_jax_banded(nets):
    """(b) RGGB [1,768,96,4] with nle_max_px=1<<17: _band_plan bands both
    NLE fits (one 256-row band of three)."""
    from yondx_torch.pipeline.fused import _band_plan
    rggb = _frame(1536, 192, 5)
    assert _band_plan(rggb.shape, 1 << 17, 256, 23) == (3, 1, 3)
    assert _band_plan(rggb.shape, 1 << 17, 256, 14) == (3, 1, 3)
    dn_j, regs_j, dn_t, regs_t, _ = _run_both(nets, rggb,
                                              nle_max_px=1 << 17, **PRODUCT)
    assert_regs_close(regs_t, regs_j)
    np.testing.assert_allclose(dn_t, dn_j, atol=2e-4)


def test_slice_matches_jax_small_frame(nets):
    """(c) _frame(40, 1024, 3) is a 36x1024 Bayer frame (its levels tile
    H//6 rows), RGGB [1,18,512,4]: planes of 18 rows, fewer than the
    23-sample texture halo, which the JAX package takes by periodic
    reflection. Unlike the 36x128 frame of test_torch_fused_eager.py,
    this one estimates K, so its collab round is well conditioned."""
    rggb = _frame(40, 1024, 3)
    assert rggb.shape == (1, 18, 512, 4)
    dn_j, regs_j, dn_t, regs_t, _ = _run_both(nets, rggb, **PRODUCT)
    assert dn_t.shape == rggb.shape
    assert abs(float(regs_j[0, 0]) * 959.0 - 8.74) < 0.1 * 8.74
    assert_regs_close(regs_t, regs_j)
    np.testing.assert_allclose(dn_t, dn_j, atol=2e-4)


def test_beta2_moves_under_1e6_shift(nets, jax_product_a):
    """Frame (a), the product config: shifting every pixel by +-1e-6 moves
    beta2 of some round by more than 1e-3 (relative) in the JAX package
    and in the port alike, while both agree on the unshifted frame to
    rtol 1e-3 (the tests above). Card and CPU runs of the port differ by
    rounding of that order, so their regs are held to the spread such
    shifts make (chip_smoke.py), not to a fixed rtol."""
    _, _, net = nets
    fj, _, base_j = jax_product_a
    rggb = _frame(256, 384, 3)
    ft = t_make(net, BiasLUT().lut, device="cpu", **PRODUCT)

    def regs_j(x):
        return np.asarray(fj(jnp.asarray(x), jnp.float32(959.0))[1])

    def regs_t(x):
        return ft(torch.from_numpy(x.copy()), 959.0)[1].numpy()

    for regs in (regs_j, regs_t):
        base = base_j if regs is regs_j else regs(rggb)
        moves = [np.abs(regs(rggb + np.float32(d)) / base - 1)
                 for d in (1e-6, -1e-6)]
        beta2_move = float(np.max(moves, axis=0)[:, 1].max())
        assert beta2_move > 1e-3, (regs.__name__, beta2_move)
