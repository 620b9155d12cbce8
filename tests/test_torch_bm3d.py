"""The port's host BM3D, the gather bias lookup, BM3DVSTDenoiser and the
entries that route `bm3d` against the JAX package's (CPU, fp32).

Tolerances:
- `native.bm3d` against `yondx.native.bm3d` ('ht' and 'full', a plane
  and a 3-channel image): the same source built with the same flags on
  one machine, so bit-equal is expected; held to 1e-6;
- `lookup_bias_curve` against JAX's gather: atol 1e-6 (float32 index
  arithmetic of the same expressions);
- BM3DVSTDenoiser on a [2, 32, 32, 4] stack: atol 1e-5 (the device ops
  around BM3D in eager float32, each of JAX's own order; BM3D then sees
  the same planes to an ulp, and its block matching has no tie here);
- one held-out photo scene cut to one 256-px crop through
  `eval_synth --cpu --heldout --denoiser bm3d` and scripts/eval_synth.py:
  the noisy PSNR to 1e-4 dB (the same scene), each round's PSNR within
  0.01 dB (the two packages' NLE fits agree to about 1e-4 relative, and
  BM3D's block matching may turn on such a difference), the do-no-harm
  flag equal.
"""
import dataclasses
import importlib.util
import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from yondx import native as j_native
from yondx.eval import heldout as j_heldout
from yondx.pipeline import BM3DVSTDenoiser as JBM3DVSTDenoiser
from yondx.vst import lut as j_lut

from yondx_torch import native
from yondx_torch.cli import eval_synth
from yondx_torch.cli import yond as t_yond
from yondx_torch.eval import heldout as t_heldout
from yondx_torch.pipeline.denoiser import BM3DVSTDenoiser
from yondx_torch.vst import lut as t_lut
from torch_test_util import _one_torch_thread  # noqa: F401

REPO = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
K_TRUE, SIG_TRUE, SCALE = 8.74, 12.81, 959.0


def _noisy(shape, seed, sigma=0.1):
    """Piecewise-flat plane(s) in [0, 1] with Gaussian noise."""
    rng = np.random.default_rng(seed)
    H, W = shape[:2]
    levels = rng.random((H // 8, W // 8) + tuple(shape[2:]))
    clean = np.kron(levels, np.ones((8, 8) + (1,) * (len(shape) - 2)))
    return (clean + rng.normal(0, sigma, shape)).astype(np.float32)


@pytest.mark.parametrize("stage", ["ht", "full"])
def test_bm3d_equals_jax_native(stage):
    assert j_native.available()
    for img, sigma in ((_noisy((48, 64), 1), 0.1),
                       (_noisy((48, 64, 3), 2, 0.2), 0.2)):
        want = j_native.bm3d(img, sigma, stage=stage)
        got = native.bm3d(img, sigma, stage=stage)
        assert got.shape == want.shape == img.shape
        assert got.dtype == np.float32
        np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)
        # the denoiser actually denoised
        if img.ndim == 2:
            assert np.std(got - img) > 0.5 * sigma


def test_bm3d_threads_give_the_serial_result():
    """The crops' calls on a thread pool equal the calls one by one."""
    from concurrent.futures import ThreadPoolExecutor
    imgs = [_noisy((32, 40, 4), s) for s in range(6)]
    serial = [native.bm3d(x, 0.1) for x in imgs]
    with ThreadPoolExecutor(max_workers=6) as pool:
        threaded = list(pool.map(lambda x: native.bm3d(x, 0.1), imgs))
    for a, b in zip(serial, threaded):
        np.testing.assert_array_equal(a, b)


def test_lookup_bias_curve_matches_jax():
    curve = j_lut.BiasLUT().curve(K_TRUE, SIG_TRUE)
    rng = np.random.default_rng(3)
    # DN values over every segment of the grid: linear, log, extension
    x = np.concatenate([rng.random(500) * 0.5, rng.random(500) * 959.0,
                        np.exp(rng.uniform(0, np.log(5e5), 500)),
                        [0.0, 1e-6, 959.0 * 64]]).astype(np.float32)
    want = np.asarray(j_lut.lookup_bias_curve(
        jnp.asarray(x), jnp.asarray(curve), K_TRUE))
    got = t_lut.lookup_bias_curve(torch.from_numpy(x),
                                  torch.from_numpy(curve), K_TRUE).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)
    # the Chebyshev fit samples the curve through the same interpolation
    np.testing.assert_allclose(
        t_lut.cheb_fit_curve(torch.from_numpy(curve)).numpy(),
        np.asarray(j_lut.cheb_fit_curve(jnp.asarray(curve))), atol=1e-6,
        rtol=0)


@pytest.mark.parametrize("bias_corr", ["pre", None])
def test_bm3d_vst_denoiser_matches_jax(bias_corr):
    rng = np.random.default_rng(5)
    levels = rng.random((2, 4, 4)) * 0.7 + 0.05
    clean = np.kron(levels, np.ones((1, 16, 16)))
    lr = np.clip((K_TRUE * rng.poisson(clean * SCALE / K_TRUE)
                  + rng.normal(0, SIG_TRUE, clean.shape)) / SCALE,
                 0, 1).astype(np.float32)                # [2, 64, 64]
    curve = j_lut.BiasLUT().curve(K_TRUE, SIG_TRUE)
    want = np.asarray(JBM3DVSTDenoiser(bias_corr=bias_corr)(
        jnp.asarray(lr), curve, K_TRUE, SIG_TRUE, SCALE))
    den = BM3DVSTDenoiser(bias_corr=bias_corr, device="cpu")
    out, raw = den.denoise_pair(lr, curve, K_TRUE, SIG_TRUE, SCALE)
    assert out is raw and out.shape == lr.shape and den.host_s > 0
    np.testing.assert_allclose(out.numpy(), want, atol=1e-5, rtol=0)
    single = den(lr[0], curve, K_TRUE, SIG_TRUE, SCALE)
    assert single.shape == lr.shape[1:]
    assert float(((out.numpy() - clean) ** 2).mean()) < \
        0.5 * float(((lr - clean) ** 2).mean())


RUNFILE = """\
mode: 'eval'
fast_ckpt: '{ckpt}'
model_name: 'Gaussian_Unet_mix_5to50_norm'
method_name: 'bm3d_gate'
pipeline:
  data_type: "ANY"
  full_est: True
  est_type: 'simple+full'
  k: 29
  full_dn: True
  vst_type: 'exact'
  bias_corr: 'pre'
  denoiser_type: 'bm3d'
  iter: 'iter'
  max_iter: 1
  clip: False
{extra}arch:
  name: 'UNetSeeInDark'
  guided: False
  in_nc: 4
  out_nc: 4
  nf: 32
  nframes: 1
  res: True
  norm: True
"""


def test_cli_bm3d_opt_in_gate_as_jax(tmp_path, monkeypatch):
    """denoiser_type bm3d: both CLIs raise RuntimeError with the same
    message without `allow_experimental_bm3d: true`, and build the BM3D
    denoiser with it. The JAX CLI's params template is zeros of the
    traced shapes (the checkpoint then fills it)."""
    from yondx.cli import yond as j_yond
    monkeypatch.chdir(tmp_path)

    def zeros_template(model, rng, input_shape, guided=None):
        shapes = jax.eval_shape(model.init, rng, jnp.zeros(input_shape))
        return jax.tree.map(lambda s: jnp.zeros(s.shape, s.dtype), shapes)

    monkeypatch.setattr(j_yond, "init_params", zeros_template)
    ckpt = os.path.join(REPO, "checkpoints", "Gaussian")
    gated, opted = tmp_path / "gated.yml", tmp_path / "opted.yml"
    gated.write_text(RUNFILE.format(ckpt=ckpt, extra=""))
    opted.write_text(RUNFILE.format(
        ckpt=ckpt, extra="  allow_experimental_bm3d: true\n"))
    with pytest.raises(RuntimeError) as j_err:
        j_yond.YOND(["-f", str(gated), "--cpu"])
    with pytest.raises(RuntimeError) as t_err:
        t_yond.YOND(["-f", str(gated), "--cpu"])
    assert str(t_err.value) == str(j_err.value)
    app = t_yond.YOND(["-f", str(opted), "--cpu"])
    assert isinstance(app.denoiser, BM3DVSTDenoiser)
    assert app.engine.denoiser is app.denoiser
    assert app.denoiser.bias_corr == "pre" and not app.denoiser.exact_inverse


def _reduced_suite(spec_name, size, n_crops, suite="v3"):
    spec = next(s for s in t_heldout.SUITES[suite] if s.name == spec_name)
    j_spec = next(s for s in j_heldout.SUITES[suite] if s.name == spec_name)
    return ([dataclasses.replace(spec, size=size, n_crops=n_crops)],
            [dataclasses.replace(j_spec, size=size, n_crops=n_crops)])


def _bm3d_scene_against_jax(tmp_path, monkeypatch, suite, scene, extra=()):
    """`scene` of `suite` cut to one crop of 256 px through the port's
    `eval_synth --cpu --heldout --suite <suite> --denoiser bm3d` and
    through scripts/eval_synth.py with the same flags (its XLA cache
    pointed into the test's tmp dir)."""
    monkeypatch.chdir(REPO)
    t_suite, j_suite = _reduced_suite(scene, 256, 1, suite)
    monkeypatch.setitem(t_heldout.SUITES, suite, t_suite)
    monkeypatch.setitem(j_heldout.SUITES, suite, j_suite)
    flags = ["--cpu", "--heldout", "--suite", suite, "--scene-filter",
             scene, "--denoiser", "bm3d", *extra]
    spec = importlib.util.spec_from_file_location(
        "jax_eval_synth", os.path.join(REPO, "scripts", "eval_synth.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    update = jax.config.update

    def redirect(key, value):
        if key == "jax_compilation_cache_dir":
            value = str(tmp_path / "xla_cache")
        return update(key, value)

    monkeypatch.setattr(jax.config, "update", redirect)
    monkeypatch.setattr(sys, "argv", ["eval_synth.py", *flags, "--json",
                                      str(tmp_path / "jax.json")])
    mod.main()
    want = json.loads((tmp_path / "jax.json").read_text())["rows"]
    args = eval_synth.parse_args(flags)
    eng = eval_synth.build_engine(args)
    got = eval_synth.run(args, engine=eng)
    w, g = want[scene], got[scene]
    assert g["noisy_psnr"] == pytest.approx(w["noisy_psnr"], abs=1e-4)
    assert len(g["psnr"]) == len(w["psnr"]) == 2
    np.testing.assert_allclose(g["psnr"], w["psnr"], atol=0.01, rtol=0)
    assert g["do_no_harm"] == w["do_no_harm"]
    assert g["psnr"][-1] > g["noisy_psnr"]
    assert eng.denoiser.host_s > 0
    return args


def test_eval_synth_bm3d_heldout_scene_matches_jax_script(tmp_path,
                                                          monkeypatch):
    """photo_mid cut to one crop of 256 px through the port's
    `eval_synth --cpu --heldout --suite v3 --denoiser bm3d` and through
    scripts/eval_synth.py with the same flags (its XLA cache pointed into
    the test's tmp dir)."""
    _bm3d_scene_against_jax(tmp_path, monkeypatch, "v3", "photo_mid")


# the flags docs/heldout/r5_bm3d_{v1,v2}_cpu.json record in their headers
# that eval_synth takes without --refine: v1's shrink_full_alpha 0.6 needs
# --refine in both packages' parsers (scripts/eval_synth.py:152-155), and
# without a refine neither it nor the shrink mode reaches the BM3D column
@pytest.mark.parametrize("suite, scene, extra", [
    ("v1", "ramp_lo", ["--shrink-mode", "iso"]),
    ("v2", "zone_mid2", []),
])
def test_eval_synth_bm3d_suite_matches_jax_script(tmp_path, monkeypatch,
                                                  suite, scene, extra):
    """A scene of the v1 / v2 BM3D columns (chip_smoke.py holds the whole
    columns to their CPU artifacts), cut to one crop of 256 px, under the
    artifact's header flags, through both eval_synth entries."""
    with open(os.path.join(REPO, "docs", "heldout",
                           f"r5_bm3d_{suite}_cpu.json")) as f:
        head = json.load(f)
    args = _bm3d_scene_against_jax(tmp_path, monkeypatch, suite, scene, extra)
    for key in ("model", "arch", "refine", "shrink", "shrink_mode", "suite",
                "est"):
        assert getattr(args, key) == head[key], key
