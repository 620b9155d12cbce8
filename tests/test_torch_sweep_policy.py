"""The port's rescue-policy sweep (yondx_torch/cli/sweep_policy.py)
against scripts/sweep_policy.py, loaded from its file, on the CPU (fp32).

Tolerances:
- the grid and its acceptable region from the committed artifact's rows:
  exact (the same comparisons of the same numbers);
- ffrac (the input's noise floor against the self model): rtol 1e-3, the
  robust self NLE's own parity bound (tests/test_torch_engine.py); the
  floor statistics alone agree to 1e-4 (tests/test_torch_modules.py);
- one forced-replace scene row and fault rung 0.5 with the committed
  gru32 flagship: PSNRs within 0.01 dB; ffrac and frac within rtol 1e-3;
  agree, a relative difference of two noise models each held at rtol
  1e-3, within 2e-3 * (1 + |agree|) (rtol 1e-3 on each of the two
  variances of the ratio 1 + agree).
JAX's script builds a flax init only as load_checkpoint's template (every
leaf is then the file's): its abstract shapes serve as well and skip
~22 s of eager init per engine on the CPU.
"""
import copy
import dataclasses
import importlib.util
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from yondx.eval import heldout as j_heldout
from yondx.isp.bayer import bayer2rggb as j_bayer2rggb
from yondx.models import registry as j_registry
from yondx.nle.robust import self_nlf_robust as j_self_nlf_robust

from yondx_torch.cli import sweep_policy as sp
from yondx_torch.eval import heldout as t_heldout
from yondx_torch.pipeline.policy import DEFAULT_FLOOR_FRAC, DEFAULT_TOL
from torch_test_util import _one_torch_thread  # noqa: F401

REPO = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
ART = os.path.join(REPO, "docs", "policy_sweep_r5.json")


def _load_script(name):
    spec = importlib.util.spec_from_file_location(
        f"_jax_{name}", os.path.join(REPO, "scripts", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def jsp():
    return _load_script("sweep_policy")


@pytest.fixture(scope="module")
def art():
    with open(ART) as f:
        return json.load(f)


def _args(**kw):
    return sp.parse_args(["--cpu", "--ckpt-dir",
                          os.path.join(REPO, "checkpoints", "Gaussian")]
                         + [x for k, v in kw.items()
                            for x in (f"--{k}", str(v))])


def test_constants_equal_the_scripts(jsp):
    for name in ("TOLS", "FFS", "FAULT_LADDER", "RESCUE_GAIN_MIN"):
        assert getattr(sp, name) == getattr(jsp, name), name
    from yondx.pipeline.policy import (DEFAULT_FLOOR_FRAC as JFF,
                                       DEFAULT_TOL as JTOL)
    assert (DEFAULT_TOL, DEFAULT_FLOOR_FRAC) == (JTOL, JFF) == (0.15, 1.5)


def test_grid_of_the_artifact_rows(jsp, art):
    grid = sp.grid_verdicts(art["suite_rows"], art["fault_rows"])
    assert grid == art["grid"]
    assert grid == jsp.grid_verdicts(art["suite_rows"], art["fault_rows"])
    rec = sp.record(art["suite"], art["model"], art["platform"],
                    art["suite_rows"], art["fault_rows"])
    assert [list(p) for p in rec["ok_region"]] == art["ok_region"]
    assert len(rec["ok_region"]) == 10
    assert rec["defaults"] == art["defaults"] == {
        "tol": 0.15, "floor_frac": 1.5, "ok": True}
    assert json.loads(json.dumps(rec))["grid"] == art["grid"]


@pytest.mark.parametrize("ramp_big_ffrac,code", [(None, 0), (1.6, 1)],
                         ids=["artifact", "ramp_big-over-the-gate"])
def test_exit_rule(art, monkeypatch, tmp_path, ramp_big_ffrac, code):
    """main exits nonzero exactly when the defaults leave the acceptable
    region: ramp_big's harmful fire (-3.40 dB) enters at ffrac > 1.5."""
    rows = copy.deepcopy(art)
    if ramp_big_ffrac is not None:
        row = next(r for r in rows["suite_rows"] if r["scene"] == "ramp_big")
        row["ffrac"] = ramp_big_ffrac
    monkeypatch.setattr(sp, "regrid", lambda args, scenes=None: (
        rows["suite_rows"], rows["fault_rows"], rows))
    out = tmp_path / "sweep.json"
    with pytest.raises(SystemExit) as exc:
        sp.main(["--regrid", ART, "--out", str(out)])
    assert exc.value.code == code
    rec = json.loads(out.read_text())
    assert rec["defaults"]["ok"] is (code == 0)
    assert rec["platform"] == "tpu+regrid"
    if code:
        chosen = next(g for g in rec["grid"] if g["tol"] == 0.15
                      and g["floor_frac"] == 1.5)
        assert chosen["suite_harmful_fires"] == ["ramp_big"]


def _j_ffrac(jsp, lr, scale=(1.0, 1.0)):
    reg = j_self_nlf_robust(j_bayer2rggb(jnp.asarray(lr, jnp.float32)))
    return jsp._compute_ffrac(lr, (float(reg[0]) * scale[0],
                                   float(reg[1]) * scale[1]))


@pytest.mark.parametrize("name", ["ramp_big", "ramp_lo2", "glyphs_mid"])
def test_scene_ffrac_matches_jax(jsp, name):
    spec = next(s for s in t_heldout.SUITES["v2"] if s.name == name)
    _, lr = t_heldout.build_scene(spec)
    got = sp._compute_ffrac(lr, sp._self_reg(lr))
    want = _j_ffrac(jsp, lr)
    np.testing.assert_allclose(got, want, rtol=1e-3)
    if name == "ramp_big":
        # JAX's CPU value, which moves the 1.3 column of the grid
        assert abs(got - 1.3276) < 1e-3


def test_fault_ffrac_matches_jax(jsp, art):
    _, noisy = sp.fault_scene()
    b1, b2 = sp._self_reg(noisy)
    for row in art["fault_rows"]:
        f = row["fault_scale"]
        got = sp._compute_ffrac(noisy, (b1 * f, b2 * f * f))
        np.testing.assert_allclose(got, _j_ffrac(jsp, noisy, (f, f * f)),
                                   rtol=1e-3)
        # the rung is built by numpy: the artifact's value to 1e-3
        np.testing.assert_allclose(got, row["ffrac"], rtol=1e-3)


def _assert_row(got, want):
    for key in ("psnr_hold", "psnr_fire"):
        assert abs(got[key] - want[key]) < 0.01, (key, got, want)
    for key in ("ffrac", "frac"):
        np.testing.assert_allclose(got[key], want[key], rtol=1e-3,
                                   err_msg=key)
    assert abs(got["agree"] - want["agree"]) <= 2e-3 * (
        1 + abs(want["agree"])), (got["agree"], want["agree"])


def test_forced_row_and_rung_match_jax(jsp, monkeypatch):
    """A v1 scene cut to one crop and fault rung 0.5 through JAX's
    build_engine(args, 'replace') + sweep_suite / sweep_faults, and
    through the port's on the CPU, with the committed flagship."""
    spec, jspec = (dataclasses.replace(next(
        s for s in m.SUITES["v1"] if s.name == "glyphs_lo"), n_crops=1)
        for m in (t_heldout, j_heldout))
    monkeypatch.chdir(REPO)
    real = j_registry.init_params
    monkeypatch.setattr(j_registry, "init_params", lambda *a, **k:
                        jax.eval_shape(lambda: real(*a, **k)))
    monkeypatch.setitem(j_heldout.SUITES, "v1", [jspec])
    monkeypatch.setattr(jsp, "FAULT_LADDER", [0.5])
    jargs = _args(suite="v1")
    want_row = jsp.sweep_suite(jargs)[0]
    want_rung = jsp.sweep_faults(jargs)[0]

    eng = sp.build_engine(_args(), "replace")
    clean, noisy = t_heldout.build_scene(spec)
    got_row = sp.suite_row(eng, spec, clean, noisy)
    assert got_row["scene"] == want_row["scene"] == "glyphs_lo"
    assert abs(got_row["noisy_psnr"] - want_row["noisy_psnr"]) < 1e-4
    _assert_row(got_row, want_row)
    got_rung = sp.fault_row(eng, 0.5, *sp.fault_scene())
    assert got_rung["needs_rescue"] is want_rung["needs_rescue"] is True
    _assert_row(got_rung, want_rung)
    # the engine's own self estimate is back after the rung
    assert "_estimate_self" not in vars(eng)
