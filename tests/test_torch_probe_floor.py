"""The port's input-floor probe (yondx_torch/cli/probe_floor_discriminator.py)
against scripts/probe_floor_discriminator.py, loaded from its file, on the
CPU (fp32). No net.

The fault ladder's five rungs on the flat-block scene and one suite scene
(ramp_big, the gate's closest hold, cut from 1024 px to the ladder's 512
so that JAX compiles one shape) through both: ffrac, the floor and beta1
at rtol 1e-3 (the robust self NLE's parity bound,
tests/test_torch_engine.py), FIRE / hold equal; the port's rows print in
the script's layout. JAX's values are read at full
precision by wrapping its floor_frac and self_nlf_robust.
"""
import dataclasses

import numpy as np

from yondx.eval import heldout as j_heldout

from yondx_torch.cli import probe_floor_discriminator as probe
from yondx_torch.eval import heldout as t_heldout
from torch_test_util import _one_torch_thread  # noqa: F401
from torch_test_util import layout, load_jax_script, printed, record

SCENE = "ramp_big"


def _only(suites, name, **cut):
    return [dataclasses.replace(next(s for s in suites["v2"]
                                     if s.name == name), **cut)]


def test_probe_floor_discriminator_matches_jax(monkeypatch, tmp_path,
                                               capsys):
    monkeypatch.setitem(j_heldout.SUITES, "v2", _only(
        j_heldout.SUITES, SCENE, size=512))
    monkeypatch.setitem(t_heldout.SUITES, "v2", _only(
        t_heldout.SUITES, SCENE, size=512))
    mod = load_jax_script(monkeypatch, tmp_path, "probe_floor_discriminator",
                          [])
    fracs, regs = [], []
    record(monkeypatch, mod, "floor_frac", fracs)
    record(monkeypatch, mod, "self_nlf_robust", regs)
    mod.main()
    want = printed(capsys.readouterr().out, r"(fault|case|" + SCENE + ")")
    got = probe.main(["--cpu"])
    lines = printed(capsys.readouterr().out, r"(fault|case|" + SCENE + ")")
    assert [layout(x) for x in lines] == [layout(x) for x in want]
    assert len(want) == 1 + len(probe.FAULT_LADDER) + 1
    rows = got["faults"] + got["scenes"]
    assert [r["fault_scale"] for r in got["faults"]] == probe.FAULT_LADDER
    assert [r["case"] for r in got["scenes"]] == [SCENE]
    # JAX: one self fit for the ladder, one for the scene
    beta1 = [regs[0][0] * f for f in probe.FAULT_LADDER] + [regs[1][0]]
    for r, (ff, fl), b1, line in zip(rows, fracs, beta1, want[1:]):
        np.testing.assert_allclose([r["ffrac"], r["floor"], r["beta1"]],
                                   [ff, fl, b1], rtol=1e-3, err_msg=r["case"])
        assert r["fire"] == line.endswith("FIRE") == (ff > 1.5), r["case"]
    assert [r["fire"] for r in got["faults"]] == [False, True, True, True,
                                                  True]
    assert not got["scenes"][0]["fire"]


def test_probe_floor_discriminator_scene_list():
    """The 12 named v2 scenes, in suite order, and the ladder's rungs."""
    names = [s.name for s in t_heldout.SUITES["v2"] if s.name in probe.NAMES]
    assert len(names) == len(probe.NAMES) == 12
    assert probe.FAULT_LADDER == [1.0, 0.5, 0.25, 0.10, 0.04]
    scenes = {}
    spec = dataclasses.replace(_only(t_heldout.SUITES, "glyphs_lo")[0],
                               size=128, n_crops=1)
    scenes[("glyphs_lo", None)] = t_heldout.build_scene(spec)
    lr = scenes[("glyphs_lo", None)][1]
    reg = probe.self_reg(lr, "cpu")
    row = probe.case_row("glyphs_lo", lr, reg, "cpu")
    assert row["fire"] == (row["ffrac"] > probe.GATE)
    assert row["beta1"] == reg[0] and row["floor"] > 0
