"""The port's held-out gate pieces against the JAX package (CPU, fp32):
the unprocess chain, the nine scene generators, build_scene, the
metrics, SyntheticSRGBDataset and run_heldout.

Inputs are the frozen specs' own seeds and numpy draws; scenes are cut
to size 128 with one crop (`dataclasses.replace`), not re-seeded.
Tolerances: unprocess clean 1e-6, wb and cam2rgb rtol 1e-6, pattern,
generators and dataset items exact; build_scene clean 1e-6, noisy 1e-5
(the Poisson stream must stay in step); metrics 1e-5; run_heldout rows
1e-3 dB (PSNR) and 1e-4 (SSIM).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from yondx.data import datasets as j_datasets
from yondx.data import unprocess as j_unprocess
from yondx.eval import heldout as j_heldout
from yondx.eval import metrics as j_metrics
from yondx.models import build_model as j_build_model
from yondx.pipeline import PipelineConfig as JPipelineConfig
from yondx.pipeline import VSTDenoiser as JVSTDenoiser
from yondx.pipeline import YONDEngine as JYONDEngine

from yondx_torch.core.rng import PRNGKey
from yondx_torch.data import datasets as t_datasets
from yondx_torch.data import unprocess as t_unprocess
from yondx_torch.eval import heldout as t_heldout
from yondx_torch.eval import metrics as t_metrics
from yondx_torch.models.convert import params_to_state_dict
from yondx_torch.models.unets import GuidedResUnet
from yondx_torch.pipeline.denoiser import VSTDenoiser
from yondx_torch.pipeline.engine import PipelineConfig, YONDEngine
from torch_test_util import _one_torch_thread  # noqa: F401

NF8 = {"name": "GuidedResUnet", "guided": True, "in_nc": 4, "out_nc": 4,
       "nf": 8, "nframes": 1, "res": True, "norm": True}


def _spec(mod, name, size=128, n_crops=1):
    spec = next(s for s in mod.SUITES["v3"] if s.name == name)
    return dataclasses.replace(spec, size=size, n_crops=n_crops)


# --------------------------------------------------------------- unprocess
@pytest.mark.parametrize("aug", [False, True], ids=["no-aug", "bayer-aug"])
@pytest.mark.parametrize("seed,kind,n", [(101, "voronoi", 2),
                                         (303, "photo", 1),
                                         (122, "satdisk", 3)])
def test_srgb_to_pseudo_raw_matches_jax(seed, kind, n, aug):
    rng = np.random.default_rng(seed)
    imgs = np.stack([j_heldout._GENERATORS[kind](rng, 128)
                     for _ in range(n)])
    ref = j_unprocess.srgb_to_pseudo_raw(jax.random.PRNGKey(seed),
                                         jnp.asarray(imgs),
                                         bayer_aug_enabled=aug)
    got = t_unprocess.srgb_to_pseudo_raw(PRNGKey(seed), imgs,
                                         bayer_aug_enabled=aug)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(ref[0]),
                               atol=1e-6, rtol=0)
    np.testing.assert_allclose(got[1].numpy(), np.asarray(ref[1]),
                               rtol=1e-6)
    np.testing.assert_allclose(got[2].numpy(), np.asarray(ref[2]),
                               rtol=1e-6)
    np.testing.assert_array_equal(got[3].numpy(), np.asarray(ref[3]))


def test_unprocess_steps_match_jax():
    x = np.random.default_rng(0).random((2, 32, 48, 3)).astype(np.float32)
    ccm = np.random.default_rng(1).random((3, 3)).astype(np.float32)
    for name in ("inverse_smoothstep", "gamma_expansion"):
        np.testing.assert_array_equal(
            getattr(t_unprocess, name)(x).numpy(),
            np.asarray(getattr(j_unprocess, name)(jnp.asarray(x))))
    np.testing.assert_array_equal(
        t_unprocess.apply_ccm(x, ccm).numpy(),
        np.asarray(jax.vmap(j_unprocess.apply_ccm, (0, None))(
            jnp.asarray(x), jnp.asarray(ccm))))
    np.testing.assert_array_equal(
        t_unprocess.safe_invert_gains(x * 1.2, 0.9, 1.7, 2.1).numpy(),
        np.asarray(j_unprocess.safe_invert_gains(
            jnp.asarray(x * 1.2), jnp.float32(0.9), jnp.float32(1.7),
            jnp.float32(2.1))))
    np.testing.assert_array_equal(
        t_unprocess.mosaic(x[0]).numpy(),
        np.asarray(j_unprocess.mosaic(jnp.asarray(x[0]))))
    for seed in (0, 7, 101):
        for t, j in zip(t_unprocess.random_ccm(PRNGKey(seed)),
                        j_unprocess.random_ccm(jax.random.PRNGKey(seed))):
            np.testing.assert_allclose(t, np.asarray(j), rtol=1e-6)
        assert [float(v) for v in t_unprocess.random_gains(PRNGKey(seed))] \
            == [float(v) for v in j_unprocess.random_gains(
                jax.random.PRNGKey(seed))]


# -------------------------------------------------------------- generators
@pytest.mark.parametrize("S", [64, 128])
@pytest.mark.parametrize("kind", sorted(j_heldout._GENERATORS))
def test_generators_match_jax(kind, S):
    got = t_heldout._GENERATORS[kind](np.random.default_rng(7), S)
    ref = j_heldout._GENERATORS[kind](np.random.default_rng(7), S)
    assert got.dtype == ref.dtype and got.shape == ref.shape == (S, S, 3)
    np.testing.assert_array_equal(got, ref)


def test_frozen_suites_match_jax():
    for suite in ("v1", "v2", "v3"):
        assert [dataclasses.asdict(s) for s in t_heldout.SUITES[suite]] == \
            [dataclasses.asdict(s) for s in j_heldout.SUITES[suite]]
    assert len(t_heldout.SUITES["v3"]) == 39


@pytest.mark.parametrize("name", ["voronoi_lo", "glyphs_mid", "satdisk_mid",
                                  "photo_hi"])
def test_build_scene_matches_jax(name):
    clean_r, noisy_r = j_heldout.build_scene(_spec(j_heldout, name))
    clean, noisy = t_heldout.build_scene(_spec(t_heldout, name))
    assert clean.shape == noisy.shape == (1, 128, 128)
    assert clean.dtype == noisy.dtype == np.float32
    np.testing.assert_allclose(clean, clean_r, atol=1e-6, rtol=0)
    np.testing.assert_allclose(noisy, noisy_r, atol=1e-5, rtol=0)


# ---------------------------------------------------------------- metrics
def test_metrics_match_jax():
    rng = np.random.default_rng(4)
    a = rng.random((2, 40, 56)).astype(np.float32)
    b = np.clip(a + rng.normal(0, 0.05, a.shape), 0, 1).astype(np.float32)
    assert abs(float(t_metrics.psnr(a, b))
               - float(j_metrics.psnr(a, b))) < 1e-5
    for x, y in ((a * 255, b * 255), (a[0, :, :48].reshape(40, 16, 3) * 255,
                                      b[0, :, :48].reshape(40, 16, 3) * 255)):
        got = float(t_metrics.matlab_ssim(x, y))
        ref = float(j_metrics.matlab_ssim(jnp.asarray(x), jnp.asarray(y)))
        assert abs(got - ref) < 1e-5, (got, ref)
    qa = t_metrics.quality_assess(a * 255, b * 255)
    qr = j_metrics.quality_assess(a * 255, b * 255)
    assert abs(qa["PSNR"] - qr["PSNR"]) < 1e-5
    assert abs(qa["SSIM"] - qr["SSIM"]) < 1e-5
    assert abs(t_metrics.cal_kld(a - b, a - 0.9 * b)
               - j_metrics.cal_kld(a - b, a - 0.9 * b)) < 1e-5


# ---------------------------------------------------------------- dataset
@pytest.mark.parametrize("version", [6, 7])
def test_synthetic_srgb_dataset_matches_jax(version):
    ref = j_datasets.SyntheticSRGBDataset(length=12, size=96, seed=38,
                                          cache=False, disk_cache="",
                                          version=version)
    got = t_datasets.SyntheticSRGBDataset(length=12, size=96, seed=38,
                                          cache=False, version=version)
    assert len(got) == 12
    for i in range(12):
        r, g = ref[i], got[i]
        assert g.dtype == r.dtype == np.uint8 and g.shape == (96, 96, 3)
        np.testing.assert_array_equal(g, r)
    np.testing.assert_array_equal(t_datasets._bilinear_resize(
        np.arange(12.0).reshape(3, 4), 10), j_datasets._bilinear_resize(
        np.arange(12.0).reshape(3, 4), 10))


# ------------------------------------------------------------ run_heldout
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


def test_run_heldout_matches_jax(nf8, monkeypatch):
    """Three scenes cut to 128 px and one crop (two v1 scenes and a
    photo), the product refine, through both engines."""
    model, variables, net = nf8
    names = ["ramp_lo", "glyphs_mid", "photo_mid"]
    for mod in (j_heldout, t_heldout):
        monkeypatch.setitem(mod.SUITES, "v3",
                            [_spec(mod, n) for n in names])
    pipe = {"est_type": "simple", "max_iter": 1}
    je = JYONDEngine(JVSTDenoiser(model, variables, refine=True),
                     JPipelineConfig(**pipe))
    te = YONDEngine(VSTDenoiser(net, refine=True, device="cpu"),
                    PipelineConfig(**pipe))
    ref = j_heldout.run_heldout(je, suite="v3")
    scenes = {}
    got = t_heldout.run_heldout(te, suite="v3", scenes=scenes)
    assert sorted(scenes) == sorted((n, None) for n in names)
    assert list(got) == list(ref) == names + ["_summary"]
    for name in names:
        g, r = got[name], ref[name]
        assert set(g) == set(r)
        assert abs(g["noisy_psnr"] - r["noisy_psnr"]) < 1e-3
        assert len(g["psnr"]) == len(r["psnr"]) == 2
        np.testing.assert_allclose(g["psnr"], r["psnr"], atol=1e-3, rtol=0)
        np.testing.assert_allclose(g["ssim"], r["ssim"], atol=1e-4, rtol=0)
        assert g["do_no_harm"] == r["do_no_harm"]
    gs, rs = got["_summary"], ref["_summary"]
    assert set(gs) == set(rs)
    assert gs["n_below_input"] == rs["n_below_input"]
    assert set(gs["per_class_gain"]) == set(rs["per_class_gain"])
    for key in ("mean_psnr", "mean_noisy", "mean_psnr_v1_subset",
                "glyphs_min_margin"):
        assert abs(gs[key] - rs[key]) < 1e-3, key
    # a second run reuses the built scenes
    again = t_heldout.run_heldout(te, suite="v3", scenes=scenes,
                                  scene_filter=["ramp"])
    assert list(again) == ["ramp_lo", "_summary"]
    assert again["ramp_lo"]["psnr"] == got["ramp_lo"]["psnr"]
