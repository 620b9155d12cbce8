"""The port's noise-estimate sources against the JAX package's (CPU, fp32):
the CLI's est_* blocks, the engine's est_net path and its file-based
estimates.

- `runfiles/YOND/SIDD_pge_pre_grumix.yml` (the gru32 flagship with
  refine, and its est_net block: the committed EstPGE_d3nf16) builds on
  both CLIs; the port's est net is the shared `EstNet` with the
  checkpoint's weights.
- `engine.iter_denoise` of the two CLIs' engines on one crop stack: the
  round-0 estimate is the est net's (beta1, sigma^2), rtol 1e-3 (the
  est_UNet forward agrees to 1e-4); regs of both rounds rtol 1e-3;
  outputs atol 2e-4 (the engine's tolerance, tests/test_torch_engine.py).
- `--input` with that runfile runs the self NLE whatever est_type says,
  in both packages (JAX's `denoise_any` -> `iter_denoise_tiled`): the
  outputs agree to atol 2e-4 and the est net is not called.
- `_file_based_est` on files the test writes: a cal_est pkl (a hit of its
  per-(camera, ISO) points and a miss that evaluates its polynomials,
  and a pipeline cal_est path that wins over est_type), FoiEst / LiuEst
  .mat return_params, Zou / PGE .npy rows (PGE's sigma squared): equal
  to JAX's, exactly.
"""
import os
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.io
import torch

from yondx.pipeline import PipelineConfig as JPipelineConfig
from yondx.pipeline import YONDEngine as JYONDEngine

from yondx_torch.cli import yond as t_yond
from yondx_torch.io.ckpt import load_checkpoint
from yondx_torch.models.comp import est_UNet
from yondx_torch.models.convert import params_to_state_dict
from yondx_torch.pipeline.engine import PipelineConfig, YONDEngine
from yondx_torch.pipeline.estnet import EstNet
from torch_test_util import _two_torch_threads  # noqa: F401

REPO = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
CKPTS = os.path.join(REPO, "checkpoints", "Gaussian")
PGE_RUNFILE = os.path.join(REPO, "runfiles", "YOND",
                           "SIDD_pge_pre_grumix.yml")
K_TRUE, SIG_TRUE, SCALE = 8.74, 12.81, 959.0


def _bayer(N, H, W, seed, grid=(4, 8)):
    """bench.py-style piecewise-flat Poisson-Gaussian Bayer crops."""
    rng = np.random.default_rng(seed)
    levels = rng.random((N,) + grid) * 0.7 + 0.05
    clean = np.kron(levels, np.ones((1, H // grid[0], W // grid[1])))
    noisy = (K_TRUE * rng.poisson(clean * SCALE / K_TRUE)
             + rng.normal(0, SIG_TRUE, clean.shape)) / SCALE
    return np.clip(noisy, 0, 1).astype(np.float32)


def _p():
    return {"wp": 1023, "bl": 64, "ratio": 1.0, "scale": SCALE,
            "gain": 1.0, "sigma": 0.0}


@pytest.fixture(scope="module")
def apps(tmp_path_factory):
    """Both CLIs' application objects from a copy of the pge runfile
    (fast_ckpt made absolute), argv with --input of a 256x384 frame and
    tiles of 128. The JAX CLI's params templates are zeros of the traced
    shapes, which the checkpoints then fill (an eager flax init takes
    tens of seconds here)."""
    from yondx.cli import yond as j_yond
    root = tmp_path_factory.mktemp("pge")
    text = open(PGE_RUNFILE).read().replace(
        "fast_ckpt: 'checkpoints/Gaussian'", f"fast_ckpt: '{CKPTS}'")
    runfile = root / "pge.yml"
    runfile.write_text(text)
    frame = root / "frame.npy"
    np.save(frame, _bayer(1, 256, 384, 8)[0])

    def zeros_template(model, rng, input_shape, guided=None):
        args = (jnp.zeros(input_shape),) + (
            (jnp.full((input_shape[0],), 0.1),) if guided else ())
        shapes = jax.eval_shape(model.init, rng, *args)
        return jax.tree.map(lambda s: jnp.zeros(s.shape, s.dtype), shapes)

    argv = ["-f", str(runfile), "--input", str(frame), "--tile", "128"]
    old = os.getcwd()
    os.chdir(root)                  # the CLIs write ./logs and ./images
    try:
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(j_yond, "init_params", zeros_template)
            j_app = j_yond.YOND(argv + ["--output", "j.npy", "--cpu"])
        t_app = t_yond.YOND(argv + ["--output", "t.npy", "--cpu"])
        yield root, j_app, t_app
    finally:
        os.chdir(old)


def test_cli_builds_the_est_net_of_the_pge_runfile(apps):
    _, j_app, t_app = apps
    assert set(t_app.est_models) == set(j_app.est_models) == {"est_net"}
    est = t_app.est_models["est_net"]
    assert isinstance(est, EstNet) and isinstance(est.model, est_UNet)
    assert t_app.engine.est_models is t_app.est_models
    assert t_app.pipe.est_type == "pge" and t_app.denoiser.refine
    want = params_to_state_dict(load_checkpoint(os.path.join(
        CKPTS, "EstPGE_d3nf16_last_model.ckpt"))["params"])
    got = est.model.state_dict()
    assert sorted(got) == sorted(want)
    for name in want:
        assert torch.equal(got[name], want[name]), name


def test_iter_denoise_with_the_est_net_matches_jax(apps):
    _, j_app, t_app = apps
    est = t_app.est_models["est_net"]
    lr = _bayer(2, 128, 128, 5)
    calls = est.calls
    ref = j_app.engine.iter_denoise({"lr": lr}, _p())
    got = t_app.engine.iter_denoise({"lr": lr}, _p())
    assert est.calls == calls + 1
    r0 = j_app.est_models["est_net"](lr)
    np.testing.assert_allclose(got["regs"][0], (r0[0], r0[1] ** 2),
                               rtol=1e-3)
    assert got["regs"][0] == (float(est.outputs[-1][0]),
                              float(est.outputs[-1][1]) ** 2)
    np.testing.assert_allclose(np.array(got["regs"]), np.array(ref["regs"]),
                               rtol=1e-3)
    assert len(got["raw_dns"]) == len(ref["raw_dns"]) == 2
    for g, r in zip(got["raw_dns"], ref["raw_dns"]):
        assert g.shape == r.shape == lr.shape
        np.testing.assert_allclose(g, r, atol=2e-4, rtol=0)


def test_input_with_the_pge_runfile_matches_jax_cli(apps):
    """What main() does with --input: the frame through denoise_any, the
    self NLE on the whole frame (est_type is not read on this path)."""
    root, j_app, t_app = apps
    est = t_app.est_models["est_net"]
    calls = est.calls
    for app in (j_app, t_app):
        app.denoise_any(app.parser.input, app.parser.output)
    assert est.calls == calls
    ref, got = np.load(root / "j.npy"), np.load(root / "t.npy")
    assert got.shape == ref.shape == (256, 384)
    np.testing.assert_allclose(got, ref, atol=2e-4, rtol=0)


# ----------------------------------------------------------- file sources
@pytest.fixture(scope="module")
def est_files(tmp_path_factory):
    root = tmp_path_factory.mktemp("est_files")
    base = root / "SIDD_Validation_Raw"
    base.mkdir()
    rng = np.random.default_rng(11)
    rows = {tag: rng.random((5, 2)) * [1e-2, 3e-2]
            for tag in ("FoiEst", "LiuEst", "Zou", "PGE")}
    for tag in ("FoiEst", "LiuEst"):
        scipy.io.savemat(base / f"{tag}_fullPict.mat",
                         {"return_params": rows[tag]})
    for tag in ("Zou", "PGE"):
        np.save(base / f"{tag}_fullPict.npy", rows[tag])
    record = {"sfrn": {"S6_00100": (2.5e-3, 4.1e-5)},
              "beta1": {"S6": [1.1e-6, 2.4e-4]},
              "beta2": {"S6": [3.0e-9, 1.3e-7, 6.0e-6]}}
    with open(root / "cal.pkl", "wb") as f:
        pickle.dump(record, f)
    return root


CASES = {
    "cal_est hit": ("cal_est", None, "0007_001_S6_00100_00060_3200_L"),
    "cal_est miss": ("cal_est", None, "0007_001_S6_00800_00060_3200_L"),
    "pipeline cal_est": ("foi", "cal.pkl", "0007_001_S6_00800_00060_3200_L"),
    "foi": ("foi", None, None), "liu": ("liu", None, None),
    "zou": ("zou", None, None), "pge": ("pge", None, None),
}


@pytest.mark.parametrize("case", list(CASES))
def test_file_based_est_matches_jax(est_files, case):
    est_type, cal_est, name = CASES[case]
    pipe = {"est_type": est_type}
    if cal_est:
        pipe["cal_est"] = str(est_files / cal_est)
    data = {"root_dir": str(est_files), "cal_est": str(est_files / "cal.pkl"),
            "name": name or "0007_001_S6_00100_00060_3200_L"}
    je = JYONDEngine(None, JPipelineConfig.from_dict(pipe))
    te = YONDEngine(type("Den", (), {"device": torch.device("cpu")}),
                    PipelineConfig.from_dict(pipe))
    for img_id in (0, 3):
        want = je._file_based_est(data, img_id, _p())
        got = te._file_based_est(data, img_id, _p())
        assert len(got) == 2
        assert tuple(map(float, got)) == tuple(map(float, want)), (case,
                                                                   img_id)
    if case == "pge":
        reg = np.load(est_files / "SIDD_Validation_Raw" / "PGE_fullPict.npy")
        assert got == (float(reg[3, 0]), float(reg[3, 1]) ** 2)
