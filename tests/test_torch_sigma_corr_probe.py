"""The port's sigma-corr blind-signal probe
(yondx_torch/cli/probe_sigma_corr_blind.py) against
scripts/probe_sigma_corr_blind.py, loaded from its file, on the CPU
(fp32), with the committed gru32 flagship.

One held-out scene cut to one crop and two corrs through both:
- clip_lo / clip_hi (fractions of the numpy-built scene): within 1e-6;
- the blind signals K_est, sigma_est, mad_ratio, nsr: rtol 1e-3, the
  robust self NLE's parity bound (tests/test_torch_engine.py);
- the PSNR at each corr: within 0.01 dB; best_corr equal;
- the port's extra `adaptive_corr` equals JAX's adaptive_sigma_corr on
  the same scene and estimate.
JAX's script builds a flax init only as load_checkpoint's template (every
leaf is then the file's): its abstract shapes serve as well and skip
~22 s of eager init on the CPU.
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

from yondx.eval import heldout as j_heldout
from yondx.isp.bayer import bayer2rggb as j_bayer2rggb
from yondx.models import registry as j_registry
from yondx.pipeline.denoiser import adaptive_sigma_corr as j_adaptive

from yondx_torch.cli import probe_sigma_corr_blind as probe
from yondx_torch.eval import heldout as t_heldout
from torch_test_util import _one_torch_thread  # noqa: F401

REPO = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
SCENE, CORRS = "glyphs_lo", ["1.03", "1.25"]
ART = os.path.join(REPO, "docs", "sigma_corr_blind_r5.json")


def _abstract_template(monkeypatch):
    real = j_registry.init_params
    monkeypatch.setattr(j_registry, "init_params", lambda *a, **k:
                        jax.eval_shape(lambda: real(*a, **k)))


def _jax_probe(monkeypatch, tmp_path):
    monkeypatch.chdir(REPO)
    _abstract_template(monkeypatch)
    build = j_heldout.build_scene
    monkeypatch.setattr(j_heldout, "build_scene",
                        lambda spec, n_crops=None: build(spec, 1))
    update = jax.config.update

    def redirect(key, value):
        if key == "jax_compilation_cache_dir":
            value = str(tmp_path / "xla_cache")
        return update(key, value)

    monkeypatch.setattr(jax.config, "update", redirect)
    spec = importlib.util.spec_from_file_location(
        "jax_probe", os.path.join(REPO, "scripts",
                                  "probe_sigma_corr_blind.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    out = tmp_path / "jax.json"
    monkeypatch.setattr(sys, "argv", ["probe", "--cpu", "--scenes", SCENE,
                                      "--corrs", *CORRS, "--out", str(out)])
    mod.main()
    return json.loads(out.read_text())


def test_probe_row_matches_jax(monkeypatch, tmp_path):
    want = _jax_probe(monkeypatch, tmp_path)["rows"][0]
    spec = dataclasses.replace(next(s for s in t_heldout.SUITES["v2"]
                                    if s.name == SCENE), n_crops=1)
    clean, noisy = t_heldout.build_scene(spec)
    eng = probe.build_engine(probe.parse_args(
        ["--cpu", "--ckpt-dir", os.path.join(REPO, "checkpoints",
                                             "Gaussian")]))
    got = probe.probe_row(eng, spec, clean, noisy, [float(c) for c in CORRS])
    assert set(want) | {"adaptive_corr"} == set(got)
    for key in ("scene", "kind", "K_true", "sigma_true", "corrs"):
        assert got[key] == want[key], key
    for key in ("clip_lo", "clip_hi"):
        assert abs(got[key] - want[key]) <= 1e-6, key
    for key in ("K_est", "sigma_est", "mad_ratio", "nsr"):
        np.testing.assert_allclose(got[key], want[key], rtol=1e-3,
                                   err_msg=key)
    np.testing.assert_allclose(got["psnrs"], want["psnrs"], atol=0.01,
                               rtol=0)
    assert got["best_corr"] == want["best_corr"]
    rggb = j_bayer2rggb(jnp.asarray(noisy))
    assert got["adaptive_corr"] == pytest.approx(float(j_adaptive(
        rggb, got["K_est"], got["sigma_est"], 959.0)), abs=1e-6)


def test_probe_cli_writes_the_artifact_layout(tmp_path):
    """The CLI writes the artifact's keys, plus adaptive_corr, for the
    scenes asked for; the default scene list is the artifact's 33."""
    with open(ART) as f:
        art = json.load(f)
    args = probe.parse_args(["--cpu"])
    names = [s.name for s in t_heldout.SUITES["v2"] if s.size == 512]
    assert names == [r["scene"] for r in art["rows"]] and len(names) == 33
    assert args.corrs == art["rows"][0]["corrs"]
    assert args.out == "sigma_corr_blind.json"
    scenes = {}
    spec = next(s for s in t_heldout.SUITES["v2"] if s.name == "ramp_lo")
    scenes[(spec.name, None)] = t_heldout.build_scene(
        dataclasses.replace(spec, size=128, n_crops=1))
    out = tmp_path / "probe.json"
    args = probe.parse_args(
        ["--cpu", "--scenes", "ramp_lo", "--corrs", "1.03", "1.08",
         "--ckpt-dir", os.path.join(REPO, "checkpoints", "Gaussian"),
         "--out", str(out)])
    rec = probe.run(args, scenes=scenes)
    assert json.loads(out.read_text()) == rec
    assert rec["model"] == art["model"]
    row = rec["rows"][0]
    assert set(row) == set(art["rows"][0]) | {"adaptive_corr"}
    assert row["gain_vs_103"] == max(row["psnrs"]) - row["psnrs"][0]
