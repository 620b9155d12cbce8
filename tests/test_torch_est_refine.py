"""The port's PGE estimator, the engine's est_net hook, the Wiener
refine's every setting and the eval_synth entry, against the JAX
package (CPU, fp32).

Tolerances: est_UNet atol 1e-4 on the committed checkpoint; the engine's
regs rtol 1e-3; wiener_refine atol 2e-5; the parser exact.
"""
import argparse
import importlib.util
import itertools
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization

from yondx.isp import bayer as j_bayer
from yondx.models import build_model as j_build_model
from yondx.pipeline import PipelineConfig as JPipelineConfig
from yondx.pipeline import VSTDenoiser as JVSTDenoiser
from yondx.pipeline import YONDEngine as JYONDEngine
from yondx.pipeline import refine as j_refine

from yondx_torch.cli import eval_synth
from yondx_torch.models.comp import est_UNet
from yondx_torch.models.convert import params_to_state_dict
from yondx_torch.models.registry import build_model
from yondx_torch.models.unets import GuidedResUnet, load_model
from yondx_torch.pipeline import refine as t_refine
from yondx_torch.pipeline.denoiser import BM3DVSTDenoiser, VSTDenoiser
from yondx_torch.pipeline.engine import PipelineConfig, YONDEngine
from torch_test_util import _one_torch_thread  # noqa: F401

REPO = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
EST_CKPT = os.path.join(REPO, "checkpoints", "Gaussian",
                        "EstPGE_d3nf16_last_model.ckpt")
EST_ARCH = {"name": "est_UNet", "in_nc": 4, "out_nc": 2, "nf": 16,
            "depth": 3}
NF8 = {"name": "GuidedResUnet", "guided": True, "in_nc": 4, "out_nc": 4,
       "nf": 8, "nframes": 1, "res": True, "norm": True}
K_TRUE, SIG_TRUE, SCALE = 8.74, 12.81, 959.0


@pytest.fixture(scope="module")
def est():
    with open(EST_CKPT, "rb") as f:
        variables = serialization.msgpack_restore(f.read())["params"]
    return (j_build_model(dict(EST_ARCH)), variables,
            load_model(EST_ARCH, EST_CKPT, device="cpu"))


def test_est_unet_matches_flax(est):
    model, variables, net = est
    assert isinstance(net, est_UNet)
    assert isinstance(build_model(EST_ARCH), est_UNet)
    x = np.random.default_rng(0).random((2, 64, 64, 4)).astype(np.float32)
    for batch in (x, x[:1]):
        ref = np.asarray(model.apply(variables, jnp.asarray(batch)))
        with torch.no_grad():
            got = net(torch.from_numpy(batch)).numpy()
        assert got.shape == ref.shape
        np.testing.assert_allclose(got, ref, atol=1e-4, rtol=0)


def _bayer(N, H, W, seed):
    """bench.py-style piecewise-flat Poisson-Gaussian Bayer crops."""
    rng = np.random.default_rng(seed)
    levels = rng.random((N, 4, 4)) * 0.7 + 0.05
    clean = np.kron(levels, np.ones((1, H // 4, W // 4)))
    noisy = (K_TRUE * rng.poisson(clean * SCALE / K_TRUE)
             + rng.normal(0, SIG_TRUE, clean.shape)) / SCALE
    return np.clip(noisy, 0, 1).astype(np.float32)


def _nf8():
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


def test_engine_pge_est_net_matches_jax(est):
    """est_type 'pge' with the est_UNet as est_net: round-0 regs come
    from the net, (K, sigma) -> (beta1, sigma^2); the collab round and
    the outputs follow."""
    emodel, evars, enet = est
    model, variables, net = _nf8()

    def j_est(raw):
        x = j_bayer.bayer2rggb(jnp.asarray(raw, jnp.float32))
        out = np.asarray(emodel.apply(evars, jnp.clip(x, 0.0, 1.0)))
        return out.mean(axis=0) if out.ndim == 2 else out

    t_est = eval_synth.EstNet(enet, torch.device("cpu"))
    pipe = {"est_type": "pge", "max_iter": 1}
    je = JYONDEngine(JVSTDenoiser(model, variables), JPipelineConfig(**pipe),
                     est_models={"est_net": j_est})
    te = YONDEngine(VSTDenoiser(net, device="cpu"), PipelineConfig(**pipe),
                    est_models={"est_net": t_est})
    lr = _bayer(2, 128, 128, 5)
    p = {"wp": 1023, "bl": 64, "ratio": 1, "scale": SCALE, "gain": 1.0,
         "sigma": 0.0}
    ref = je.iter_denoise({"lr": lr}, dict(p))
    got = te.iter_denoise({"lr": lr}, dict(p))
    assert t_est.calls == 1
    r0 = j_est(lr)
    np.testing.assert_allclose(got["regs"][0], (r0[0], r0[1] ** 2),
                               rtol=1e-3)
    np.testing.assert_allclose(np.array(got["regs"]), np.array(ref["regs"]),
                               rtol=1e-3)
    for g, r in zip(got["raw_dns"], ref["raw_dns"]):
        np.testing.assert_allclose(g, r, atol=2e-4, rtol=0)
    # without an est_net, 'pge' reads the precomputed PGE_fullPict.npy,
    # absent here: FileNotFoundError, as in JAX
    te0 = YONDEngine(VSTDenoiser(net, device="cpu"), PipelineConfig(**pipe))
    with pytest.raises(FileNotFoundError, match="PGE_fullPict"):
        te0.iter_denoise({"lr": lr}, dict(p))


# ------------------------------------------------------------------ refine
@pytest.fixture(scope="module")
def refine_planes():
    """Piecewise-flat planes with a textured half the 'denoiser' smoothed
    away, a near-white strip, and quieter noise there (clipped)."""
    rng = np.random.default_rng(8)
    levels = np.kron(rng.random((2, 4, 6, 1)) * 0.9 + 0.05,
                     np.ones((1, 24, 24, 4))).astype(np.float32)
    yy, xx = np.mgrid[0:96, 0:144]
    tex = (0.06 * np.sin(0.9 * xx + 0.4 * yy) * (xx < 72))[None, :, :, None]
    clean = np.clip(levels + tex, 0, 1).astype(np.float32)
    clean[:, :10] = 0.99
    nsr = 0.03
    noise = rng.normal(0, nsr, clean.shape) * np.where(clean > 0.9, 0.3, 1.0)
    z_noisy = (clean + noise).astype(np.float32)
    z_dn = (levels + rng.normal(0, nsr * 0.2, clean.shape)).astype(
        np.float32)
    z_dn[:, :10] = 0.99
    return z_dn, z_noisy, nsr


@pytest.mark.parametrize(
    "floor,shrink,full_alpha",
    list(itertools.product(["bucket", "local", "q10", "fixed"],
                           ["off", "iso", "oriented"], [0.6, 1.0])))
def test_wiener_refine_matches_jax(refine_planes, floor, shrink,
                                   full_alpha):
    """Every floor x shrink x ramp setting, at the true noise variance
    and at 4x it (where the measured floors take over from the model and
    the fixed floor leaves the output as it was)."""
    z_dn, z_noisy, nsr = refine_planes
    kw = dict(noise_floor=floor, residual_shrink=shrink != "off",
              shrink_full_alpha=full_alpha,
              shrink_mode="iso" if shrink == "off" else shrink)
    for var in (nsr ** 2, (2 * nsr) ** 2):
        ref = j_refine.wiener_refine(jnp.asarray(z_dn), jnp.asarray(z_noisy),
                                     noise_var=var, x01=jnp.asarray(z_dn),
                                     **kw)
        got = t_refine.wiener_refine(torch.from_numpy(z_dn),
                                     torch.from_numpy(z_noisy),
                                     noise_var=var,
                                     x01=torch.from_numpy(z_dn), **kw)
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=2e-5,
                                   rtol=0)
        moved = float(np.abs(np.asarray(ref) - z_dn).max())
        assert moved > 1e-2 or (floor == "fixed" and var > nsr ** 2)


def test_vst_denoiser_takes_every_refine_setting():
    net = _nf8()[2]
    lr = _bayer(1, 64, 64, 2)[0]
    curve = np.zeros(2177, np.float32)
    for floor, shrink, mode, fa in (("q10", True, "iso", 0.6),
                                    ("local", False, "oriented", 1.0),
                                    ("fixed", True, "oriented", 0.8)):
        den = VSTDenoiser(net, refine=True, refine_floor=floor,
                          refine_shrink=shrink, refine_shrink_mode=mode,
                          refine_shrink_full_alpha=fa, device="cpu")
        out, raw = den.denoise_pair(lr, curve, K_TRUE, SIG_TRUE, SCALE)
        assert out.shape == raw.shape == lr.shape
        assert bool(torch.isfinite(out).all())


# -------------------------------------------------------------- the entry
def _jax_parser():
    """scripts/eval_synth.py's parser, caught at parse_args."""
    spec = importlib.util.spec_from_file_location(
        "jax_eval_synth", os.path.join(REPO, "scripts", "eval_synth.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)

    class Caught(Exception):
        pass

    orig = argparse.ArgumentParser.parse_args

    def catch(self, *a, **k):
        raise Caught(self)

    argparse.ArgumentParser.parse_args = catch
    try:
        mod.main()
    except Caught as e:
        return e.args[0]
    finally:
        argparse.ArgumentParser.parse_args = orig
    raise AssertionError("eval_synth.main never parsed its arguments")


def _actions(parser):
    return {a.dest: (tuple(a.option_strings), a.choices, a.default, a.type,
                     type(a).__name__, a.nargs)
            for a in parser._actions if a.dest != "help"}


def test_eval_synth_parser_matches_jax():
    ref = _actions(_jax_parser())
    got = _actions(eval_synth.build_parser())
    assert got.pop("device")[0] == ("--device",)
    assert got == ref
    args = eval_synth.parse_args(["--refine", "bucket", "--cpu"])
    assert args.shrink is True and args.device == "cpu"
    assert eval_synth.parse_args([]).shrink is False
    with pytest.raises(SystemExit):
        eval_synth.parse_args(["--shrink", "on"])
    bm3d = eval_synth.build_denoiser(eval_synth.parse_args(
        ["--denoiser", "bm3d", "--cpu"]))
    assert isinstance(bm3d, BM3DVSTDenoiser)
    assert (bm3d.bias_corr, bm3d.exact_inverse, bm3d.device.type) == \
        ("pre", False, "cpu")
    with pytest.raises(FileNotFoundError):
        eval_synth.build_denoiser(eval_synth.parse_args(
            ["--model", "no_such_model", "--cpu"]))


def test_eval_synth_heldout_cli_writes_artifact_layout(tmp_path,
                                                       monkeypatch):
    """One held-out scene (v1's zone_lo) through the entry a user types,
    on the CPU, with the s2dt16 checkpoint and the product refine: the
    JSON has the v3 artifact's top-level keys and the v1 artifact's row
    and summary keys."""
    monkeypatch.chdir(REPO)
    out = tmp_path / "out.json"
    rows = eval_synth.main([
        "--cpu", "--heldout", "--suite", "v1", "--scene-filter", "zone_lo",
        "--arch", "GuidedResUnetS2D", "--nf", "64", "--out-k", "3",
        "--tail-nf", "16", "--model", "Gaussian_GRUS2DT_mix_1to50c_norm",
        "--refine", "bucket", "--json", str(out)])
    rec = json.loads(out.read_text())

    def artifact(name):
        with open(os.path.join(REPO, "docs", "heldout", name)) as f:
            return json.load(f)

    assert list(rec) == list(artifact("r5_flagship_oriented_v3_tpu.json"))
    v1 = artifact("r4_flagship_pge_tpu.json")["rows"]
    assert set(rec["rows"]) == {"zone_lo", "_summary"}
    assert set(rec["rows"]["zone_lo"]) == set(v1["zone_lo"])
    assert set(rec["rows"]["_summary"]) == set(v1["_summary"])
    assert rec["refine"] == "bucket" and rec["shrink"] is True
    assert rec["suite"] == "v1" and rec["est"] == "robust"
    row = rows["zone_lo"]
    assert row["do_no_harm"] and row["psnr"][-1] > row["noisy_psnr"] + 2
