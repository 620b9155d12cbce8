"""The port's engine path against the JAX package (CPU, fp32): the gru32
flagship net, CFA rotation and tiling, the NLE fits the engine calls,
VSTDenoiser, and YONDEngine's whole-frame and tiled rounds.

Inputs are made with numpy from a seed and handed to both sides.
Tolerances: the net atol 1e-4; rotation and tiling exact; regs rtol
1e-3; denoiser and engine outputs atol 2e-4. Each frame's self estimate
is first checked against the truth (K = 8.74 within 10% on the JAX side),
so no frame sits in the beta1-clamp regime where fp32 rounding decides
the collab round (ROADMAP section 3).
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization

from yondx.core import tiling as j_tiling
from yondx.isp import bayer as j_bayer
from yondx.models import build_model as j_build_model
from yondx.nle import nlf as j_nlf
from yondx.nle import robust as j_robust
from yondx.pipeline import PipelineConfig as JPipelineConfig
from yondx.pipeline import VSTDenoiser as JVSTDenoiser
from yondx.pipeline import YONDEngine as JYONDEngine
from yondx.vst.lut import BiasLUT as JBiasLUT

from yondx_torch.core import tiling as t_tiling
from yondx_torch.isp import bayer as t_bayer
from yondx_torch.models.convert import params_to_state_dict
from yondx_torch.models.registry import build_model, is_guided
from yondx_torch.models.unets import GRU32_ARCH, GuidedResUnet, load_model
from yondx_torch.nle import nlf as t_nlf
from yondx_torch.nle import robust as t_robust
from yondx_torch.pipeline.denoiser import SimpleDenoiser, VSTDenoiser
from yondx_torch.pipeline.engine import PipelineConfig, YONDEngine
from yondx_torch.vst.lut import BiasLUT
from torch_test_util import _one_torch_thread  # noqa: F401

GRU32 = os.path.join(os.path.dirname(__file__), "..", "checkpoints",
                     "Gaussian",
                     "Gaussian_GRU_mix_1to50c_norm_best_model.ckpt")
K_TRUE, SIG_TRUE, SCALE = 8.74, 12.81, 959.0
NF8 = {"name": "GuidedResUnet", "guided": True, "in_nc": 4, "out_nc": 4,
       "nf": 8, "nframes": 1, "res": True, "norm": True}


def _bayer(H, W, seed, grid=(6, 8), noise=True):
    """bench.py-style piecewise-flat Poisson-Gaussian Bayer frame (its
    clean levels with noise=False)."""
    rng = np.random.default_rng(seed)
    levels = rng.random(grid) * 0.7 + 0.05
    clean = np.kron(levels, np.ones((H // grid[0], W // grid[1])))
    if not noise:
        return clean.astype(np.float32)
    noisy = (K_TRUE * rng.poisson(clean * SCALE / K_TRUE)
             + rng.normal(0, SIG_TRUE, clean.shape)) / SCALE
    return np.clip(noisy, 0, 1).astype(np.float32)


def _rggb(bayer):
    return np.asarray(j_bayer.bayer2rggb(jnp.asarray(bayer)))[None]


def _t(a):
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _regs(pair):
    return np.array([float(v) for v in pair])


def _assert_k_true(beta1):
    """The frame estimates K: JAX's own K_est within 10% of the truth."""
    assert abs(beta1 * SCALE - K_TRUE) < 0.1 * K_TRUE, beta1 * SCALE


@pytest.fixture(scope="module")
def gru32():
    with open(GRU32, "rb") as f:
        variables = serialization.msgpack_restore(f.read())["params"]
    return (j_build_model(dict(GRU32_ARCH)), variables,
            load_model(GRU32_ARCH, GRU32, device="cpu"))


@pytest.fixture(scope="module")
def nf8():
    """A random-init nf=8 GuidedResUnet: flax params of the traced shapes
    drawn with numpy (kernels N(0, 1/fan_in), biases N(0, 1e-4)), carried
    over to the port."""
    model = j_build_model(dict(NF8))
    shapes = jax.eval_shape(model.init, jax.random.PRNGKey(0),
                            jnp.zeros((1, 16, 16, 4)), jnp.full((1,), 0.1))
    rng = np.random.default_rng(3)

    def draw(path, leaf):
        fan_in = int(np.prod(leaf.shape[:-1])) if len(leaf.shape) > 1 else 1
        std = np.sqrt(1.0 / fan_in) if path[-1].key == "kernel" else 1e-2
        return (rng.standard_normal(leaf.shape) * std).astype(np.float32)

    variables = jax.tree_util.tree_map_with_path(draw, shapes)
    net = GuidedResUnet(NF8)
    net.load_state_dict(params_to_state_dict(
        jax.tree.map(np.asarray, variables)), strict=True)
    return model, variables, net.eval()


# ---------------------------------------------------------------- models
def test_gru32_matches_flax(gru32):
    model, variables, net = gru32
    rng = np.random.default_rng(0)
    x = rng.random((2, 64, 64, 4)).astype(np.float32)
    t = np.array([0.05, 0.2], np.float32)
    ref = np.asarray(model.apply(variables, jnp.asarray(x), jnp.asarray(t)))
    with torch.no_grad():
        got = net(_t(x), _t(t)).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-4, rtol=0)
    assert sum(p.numel() for p in net.parameters()) == 11_173_668


def test_registry_builds_guided_unets_and_rejects_others():
    """Every arch name of the JAX registry builds (the comparison zoo
    too); a name neither registry knows raises KeyError."""
    from yondx.models.registry import MODEL_REGISTRY as J_REGISTRY
    from yondx_torch.models import comp
    from yondx_torch.models.registry import MODEL_REGISTRY
    assert isinstance(build_model(NF8), GuidedResUnet)
    assert is_guided(NF8) and is_guided({"name": "GuidedResUnetS2D"})
    assert not is_guided({"name": "DnCNN"})
    assert set(MODEL_REGISTRY) == set(J_REGISTRY)
    assert isinstance(build_model({"name": "DnCNN", "in_nc": 4, "out_nc": 4,
                                   "nf": 8, "depth": 3}), comp.DnCNN)
    with pytest.raises(KeyError, match="GuidedResUnet"):
        build_model({"name": "NoSuchNet"})


# ------------------------------------------------------ rotation, tiling
@pytest.mark.parametrize("cfa", [[[1, 2], [2, 3]], [[2, 1], [3, 2]],
                                 [[2, 3], [1, 2]], [[3, 2], [2, 1]]],
                         ids=["RGGB", "GRBG", "GBRG", "BGGR"])
def test_rot_bayer_matches_jax(cfa):
    x = np.random.default_rng(1).random((3, 6, 10)).astype(np.float32)
    assert t_bayer.rot_bayer_k(cfa) == j_bayer.rot_bayer_k(cfa)
    for rev in (False, True):
        for a in (x, x[0]):
            ref = np.asarray(j_bayer.rot_bayer(jnp.asarray(a), cfa, rev=rev))
            got = t_bayer.rot_bayer(torch.from_numpy(a), cfa, rev=rev)
            np.testing.assert_array_equal(got.numpy(), ref)
    with pytest.raises(ValueError):
        t_bayer.rot_bayer_k([[1, 1], [1, 1]])


@pytest.mark.parametrize("shape,tile,halo", [((70, 90), 32, 8),
                                             ((256, 384), 128, 32),
                                             ((40, 24, 3), 16, 20)])
def test_tiling_matches_jax(shape, tile, halo):
    x = np.random.default_rng(2).random(shape).astype(np.float32)
    assert t_tiling.tile_grid(shape[0], shape[1], tile, halo) == \
        j_tiling.tile_grid(shape[0], shape[1], tile, halo)
    ref, plan = j_tiling.np_tile_overlap(x, tile, halo)
    got, got_plan = t_tiling.np_tile_overlap(x, tile, halo)
    dev, dev_plan = t_tiling.tile_overlap(torch.from_numpy(x), tile, halo)
    assert plan == got_plan == dev_plan
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(dev.numpy(), ref)
    merged = np.asarray(j_tiling.untile_overlap(jnp.asarray(ref), plan, halo))
    np.testing.assert_array_equal(
        t_tiling.untile_overlap(dev, dev_plan, halo).numpy(), merged)
    np.testing.assert_array_equal(merged, x)


# ------------------------------------------------------------------- NLE
@pytest.fixture(scope="module")
def nle_pair():
    """A noisy RGGB frame [1, 96, 128, 4] with 2x2 flat cells wider than
    the k=29 window, and a denoised proxy: its clean levels blended with
    30% of the noisy frame."""
    noisy = _rggb(_bayer(192, 256, 5, (2, 2)))
    clean = _rggb(_bayer(192, 256, 5, (2, 2), noise=False))
    return noisy, (0.3 * noisy + 0.7 * clean).astype(np.float32)


def test_self_nlf_matches_jax(nle_pair):
    x, _ = nle_pair
    ref = _regs(j_nlf.self_nlf(jnp.asarray(x)))
    _assert_k_true(ref[0])
    np.testing.assert_allclose(_regs(t_nlf.self_nlf(_t(x))), ref, rtol=1e-3)
    bayer = np.asarray(j_bayer.rggb2bayer(jnp.asarray(x[0])))
    assert np.allclose(t_nlf.simple_nlf(_t(bayer)), ref, rtol=1e-3)


def test_collab_nlf_matches_jax(nle_pair):
    x, dn = nle_pair
    ref = _regs(j_nlf.collab_nlf(jnp.asarray(x), jnp.asarray(dn)))
    np.testing.assert_allclose(_regs(t_nlf.collab_nlf(_t(x), _t(dn))), ref,
                               rtol=1e-3)


def test_self_nlf_robust_matches_jax(nle_pair):
    x, _ = nle_pair
    ref = _regs(j_robust.self_nlf_robust(jnp.asarray(x)))
    _assert_k_true(ref[0])
    np.testing.assert_allclose(_regs(t_robust.self_nlf_robust(_t(x))), ref,
                               rtol=1e-3)


@pytest.mark.parametrize("self_reg", [None, (9e-3, 1.8e-4), (9e-3, 1e-7)],
                         ids=["no-self-reg", "self-reg", "low-b2-self-reg"])
def test_collab_nlf_robust_matches_jax(nle_pair, self_reg):
    x, dn = nle_pair
    ref = _regs(j_robust.collab_nlf_robust(jnp.asarray(x), jnp.asarray(dn),
                                           self_reg=self_reg))
    got = _regs(t_robust.collab_nlf_robust(_t(x), _t(dn), self_reg=self_reg))
    np.testing.assert_allclose(got, ref, rtol=1e-3)


# -------------------------------------------------------------- denoiser
@pytest.mark.parametrize("K,sigma", [(8.74, 12.81), (0.1, 3.0), (2.0, 40.0),
                                     (1e-4, 0.0)],
                         ids=["bench", "sg30", "sg20-exact", "clamp"])
def test_bias_curve_matches_jax(K, sigma):
    """The host curve the engine takes per round: a table blend for
    sigma/K <= 10, the exact evaluation beyond."""
    np.testing.assert_array_equal(BiasLUT().curve(K, sigma),
                                  JBiasLUT().curve(K, sigma))


@pytest.mark.parametrize("refine", [False, True], ids=["plain", "refine"])
def test_vst_denoiser_pair_matches_jax(gru32, refine):
    model, variables, net = gru32
    lr = _bayer(96, 128, 7)
    curve = JBiasLUT().curve(K_TRUE, SIG_TRUE)
    np.testing.assert_array_equal(BiasLUT().curve(K_TRUE, SIG_TRUE), curve)
    jd = JVSTDenoiser(model, variables, refine=refine,
                      sigma_corr="adaptive")
    td = VSTDenoiser(net, refine=refine, sigma_corr="adaptive",
                     device="cpu")
    ref = jd.denoise_pair(jnp.asarray(lr), curve, K_TRUE, SIG_TRUE, SCALE)
    got = td.denoise_pair(lr, curve, K_TRUE, SIG_TRUE, SCALE)
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=2e-4,
                                   rtol=0)
    # the tiled runner's frame-scoped override takes the same route
    ref_c = jd.denoise_pair(jnp.asarray(lr), curve, K_TRUE, SIG_TRUE,
                            SCALE, corr=1.25)[0]
    got_c = td.denoise_pair(lr, curve, K_TRUE, SIG_TRUE, SCALE,
                            corr=1.25)[0]
    np.testing.assert_allclose(got_c.numpy(), np.asarray(ref_c), atol=2e-4,
                               rtol=0)


def test_denoisers_reject_what_the_port_lacks(nf8):
    """Nothing of the denoisers is missing any more: the blind-spot
    variant (fbi=True; held to JAX in tests/test_torch_zoo_comp.py)
    runs its FBI_Net on the mosaic, the q10 floor and SimpleDenoiser
    run."""
    net = nf8[2]
    fbi = build_model({"name": "FBI_Net", "nf": 8, "num_of_layers": 3,
                       "in_nc": 1, "output_channel": 1})
    out = VSTDenoiser(fbi, guided=False, fbi=True, device="cpu")(
        _bayer(64, 64, 1, (2, 2)), np.zeros(2177, np.float32), K_TRUE,
        SIG_TRUE, SCALE)
    assert out.shape == (64, 64) and bool(torch.isfinite(out).all())
    # the q10 floor (ROADMAP item 4's refine part) now runs
    lr = _bayer(64, 64, 1, (2, 2))
    pair = VSTDenoiser(net, refine=True, refine_floor="q10",
                       device="cpu").denoise_pair(
        lr, np.zeros(2177, np.float32), K_TRUE, SIG_TRUE, SCALE)
    for t in pair:
        assert t.shape == (64, 64) and bool(torch.isfinite(t).all())
    out = SimpleDenoiser(net, guided=True, device="cpu")(
        _bayer(64, 64, 1, (2, 2)), t=0.1)
    assert out.shape == (64, 64) and bool(torch.isfinite(out).all())


# ---------------------------------------------------------------- engine
PIPE = {"full_est": True, "est_type": "simple+full", "k": 29,
        "full_dn": True, "vst_type": "exact", "bias_corr": "pre",
        "iter": "iter", "max_iter": 1, "sigma_corr": "adaptive"}


def _p():
    return {"wp": 1023, "bl": 64, "ratio": 1.0, "scale": SCALE,
            "gain": 1.0, "sigma": 0.0}


@pytest.mark.parametrize("route", ["tiled-rescue", "whole-replace"])
def test_engine_matches_jax(nf8, route):
    """iter_denoise_tiled on a 256x384 frame (3x2 tiles of 128, halo 32,
    batch 4: two chunks, the second padded) with the default rescue
    policy; iter_denoise on the whole frame with the 'replace' policy, so
    the second pass and its combine run."""
    model, variables, net = nf8
    pipe = dict(PIPE)
    if route.startswith("whole"):
        pipe.update(iter_policy="replace")
    lr = _bayer(256, 384, 3)
    jd = JVSTDenoiser(model, variables, refine=pipe.get("refine", False),
                      sigma_corr="adaptive")
    td = VSTDenoiser(net, refine=pipe.get("refine", False),
                     sigma_corr="adaptive", device="cpu")
    je = JYONDEngine(jd, JPipelineConfig.from_dict(pipe))
    te = YONDEngine(td, PipelineConfig.from_dict(pipe))
    if route.startswith("tiled"):
        ref = je.iter_denoise_tiled({"lr": lr}, _p(), tile=128, halo=32,
                                    batch=4)
        got = te.iter_denoise_tiled({"lr": lr}, _p(), tile=128, halo=32,
                                    batch=4)
    else:
        ref = je.iter_denoise({"lr": lr}, _p())
        got = te.iter_denoise({"lr": lr}, _p())
    _assert_k_true(ref["regs"][0][0])
    np.testing.assert_allclose(np.array(got["regs"]), np.array(ref["regs"]),
                               rtol=1e-3)
    assert [s["fired"] for s in got["signals"]] == \
        [s["fired"] for s in ref["signals"]]
    assert got["signals"][0]["fired"] == route.startswith("whole")
    assert len(got["raw_dns"]) == len(ref["raw_dns"]) == 2
    for g, r in zip(got["raw_dns"], ref["raw_dns"]):
        assert g.shape == r.shape == lr.shape
        np.testing.assert_allclose(g, r, atol=2e-4, rtol=0)


def test_engine_raises_for_estimates_it_lacks(nf8):
    """A file-based est_type without its file raises FileNotFoundError, and
    an est_type no source serves NotImplementedError, as in JAX."""
    lr = _bayer(64, 64, 1, (2, 2))
    for est_type, err in (("foi", FileNotFoundError),
                          ("nothing", NotImplementedError)):
        pipe = dict(PIPE, est_type=est_type)
        je = JYONDEngine(JVSTDenoiser(None, None),
                         JPipelineConfig.from_dict(pipe))
        with pytest.raises(err):
            je.iter_denoise({"lr": lr}, _p())
        te = YONDEngine(VSTDenoiser(nf8[2], device="cpu"),
                        PipelineConfig.from_dict(pipe))
        with pytest.raises(err):
            te.iter_denoise({"lr": lr}, _p())
