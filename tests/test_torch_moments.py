"""NLE box moments of yondx_torch against yondx (CPU, fp32).

The port's plain moments (yondx_torch.nle.boxfilter, the CPU path of the
K1 wrapper yondx_torch.nle.moments) against the JAX `nle_moments` (the
XLA path) and the Pallas kernel run in interpret mode
(`fused_moments(interpret=True)`), on all three maps. K1 itself runs only
on the GPU; chip_smoke.py holds it against this plain version there.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from yondx.nle import boxfilter as j_box
from yondx.nle.pallas_ops import fused_moments

from yondx_torch.nle import boxfilter as t_box
from yondx_torch.nle import moments
from torch_test_util import _one_torch_thread  # noqa: F401

K, INNER = 29, 19


def _x(shape, seed):
    return np.random.default_rng(seed).random(shape).astype(np.float32)


@pytest.mark.parametrize("shape", [(1, 64, 96, 4), (2, 300, 520, 4),
                                   (1, 2, 48, 70, 4)])
def test_plain_moments_match_jax_xla_path(shape):
    x = _x(shape, 0)
    got = moments.nle_moments(torch.from_numpy(x), K, INNER)
    ref = j_box.nle_moments(jnp.asarray(x), K, INNER)
    # both are per-plane centered fp32 prefix sums; the cumsum order
    # differs (torch vs XLA), a few ulps of the O(0.1) moments
    for g, r, tol in zip(got, ref, (2e-6, 1e-6, 1e-5)):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=tol)


def test_plain_moments_match_pallas_interpret_width_tiled():
    """300x520 planes: 3 row bands and 3 width tiles of the Pallas grid
    (wtile 256), texture included."""
    x = _x((1, 300, 520, 4), 1)
    got = moments.nle_moments(torch.from_numpy(x), K, INNER)
    ref = fused_moments(jnp.asarray(x), k=K, interpret=True, band=128)
    # the Pallas kernel is uncentered E[x^2]-E[x]^2 in fp32 (the same
    # 5e-5 its own tests hold it to against the XLA path)
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=5e-5)


def test_constant_plane_has_zero_texture():
    x = np.full((1, 40, 56, 4), 0.37, np.float32)
    mean, var, tex = moments.nle_moments(torch.from_numpy(x), K, INNER)
    rmean, rvar, rtex = j_box.nle_moments(jnp.asarray(x), K, INNER)
    assert torch.isfinite(tex).all() and float(tex.abs().max()) == 0.0
    np.testing.assert_allclose(mean.numpy(), np.asarray(rmean), atol=1e-7)
    np.testing.assert_array_equal(var.numpy(), np.asarray(rvar))
    np.testing.assert_array_equal(tex.numpy(), np.asarray(rtex))


def test_collab_flavours_match_jax_varfilt():
    """texture=False / mean=False: the collab fit's var of lr and
    (mean, var) of dn, against varfilt / mean_varfilt."""
    x = _x((1, 2, 64, 80, 4), 2)
    m0, v0, t0 = moments.nle_moments(torch.from_numpy(x), K, INNER,
                                     texture=False, mean=False)
    assert m0 is None and t0 is None
    np.testing.assert_allclose(
        v0.numpy(), np.maximum(np.asarray(j_box.varfilt(jnp.asarray(x), K)),
                               0.0), atol=1e-6)
    m1, v1, t1 = moments.nle_moments(torch.from_numpy(x), K, INNER,
                                     texture=False)
    rm, rv = j_box.mean_varfilt(jnp.asarray(x), K)
    assert t1 is None
    np.testing.assert_allclose(m1.numpy(), np.asarray(rm), atol=2e-6)
    np.testing.assert_allclose(v1.numpy(), np.asarray(rv), atol=1e-6)


def test_box_mean_and_varfilt_match_jax():
    x = _x((37, 45), 3)
    np.testing.assert_allclose(
        t_box.box_mean(torch.from_numpy(x), 15).numpy(),
        np.asarray(j_box.box_mean(jnp.asarray(x), 15)), atol=2e-6)
    np.testing.assert_allclose(
        t_box.varfilt(torch.from_numpy(x), 7).numpy(),
        np.asarray(j_box.varfilt(jnp.asarray(x), 7)), atol=1e-6)


def test_wrapper_takes_plain_version_on_cpu_and_counts_no_launch():
    moments.reset_launches()
    x = torch.from_numpy(_x((1, 48, 64, 4), 4))
    got = moments.nle_moments(x, K, INNER)
    ref = moments.nle_moments_plain(x, K, INNER)
    for g, r in zip(got, ref):
        assert torch.equal(g, r)
    assert moments.LAUNCHES["nle_moments"] == 0


@pytest.mark.parametrize("w", [5, 64])
@pytest.mark.parametrize("h", [1, 2, 8, 14, 15, 20, 23])
def test_wrapper_takes_small_planes_like_jax(h, w):
    """Planes narrower than a window (down to 1 row or 5 columns): the
    wrapper's CPU route against JAX, whose per-stage jnp.pad(mode=
    'reflect') reflects periodically, on all three maps."""
    x = _x((1, h, w, 4), 5)
    got = moments.nle_moments(torch.from_numpy(x), K, INNER)
    ref = j_box.nle_moments(jnp.asarray(x), K, INNER)
    # the tolerances of test_plain_moments_match_jax_xla_path
    for g, r, tol in zip(got, ref, (2e-6, 1e-6, 1e-5)):
        assert g.shape == x.shape
        np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=tol)


def test_wrapper_rejects_unknown_devices():
    with pytest.raises(RuntimeError):
        moments.nle_moments(torch.zeros((1, 48, 64, 4), device="meta"),
                            K, INNER)


def test_kernel_build_inputs_are_the_repo_sources():
    from yondx_torch import cuda_build
    srcs = [p.name for p in cuda_build._sources()]
    assert srcs == ["nle_moments.cu"]
    assert cuda_build.source_hash() == cuda_build.source_hash()
    assert cuda_build.BUILD_DIR.name == "_build"
    assert "arch=compute_90a,code=sm_90a" in cuda_build.ARCH_FLAGS
