"""The port's iteration-policy probes against the JAX scripts they port,
loaded from their files, on the CPU (fp32), with the committed gru32
flagship; each on one held-out scene cut to one crop of 256 px:

- yondx_torch/cli/probe_iter_policy.py against
  scripts/probe_iter_policy.py (voronoi_mid): it0 and every policy's
  PSNR within 0.01 dB (JAX's psnr wrapped, so read at full precision),
  the self and collab regs at rtol 1e-3 (the robust NLE's parity bound),
  the agreement within 2e-3 (1 + |agree|) (it subtracts two variances
  held at 1e-3) plus the print's half step, each policy's summary delta
  of the same sign where JAX's is over 0.02 dB from 0 (twice the PSNR
  bound);
- yondx_torch/cli/probe_droop.py against scripts/probe_droop.py
  (zone_mid): noisy, it0 and each round-1 source's PSNR within 0.01 dB;
  the self fit, the robust collab estimate and its two parts (the
  flat-mask fit, the MAD) at rtol 1e-3. Not its default radial_mid:
  round 0 leaves that scene 52.8-55.6 dB clean, so the flat-mask collab
  fit's texture sqrt(var_k(dn)) is rounding noise where dn is flat, and
  the fit reads K 12.2 in JAX and 328.8 in the port at 256 px, -378.7 and
  262.2 at 512 px (the same fields give the same fit in both packages,
  and the robust estimate falls back to the MAD: ROADMAP.md section 3).
Each port prints its script's rows in the script's layout.
"""
import numpy as np

import yondx.eval.metrics
import yondx.nle.nlf
import yondx.nle.robust

from yondx_torch.cli import probe_droop as droop
from yondx_torch.cli import probe_iter_policy as policy
from torch_test_util import _one_torch_thread  # noqa: F401
from torch_test_util import (cut_scenes, layout, load_jax_script, printed,
                             record)

CUT = (256, 1)


def test_probe_iter_policy_matches_jax(monkeypatch, tmp_path, capsys):
    psnrs, selfs, collabs = [], [], []
    record(monkeypatch, yondx.eval.metrics, "psnr", psnrs)
    record(monkeypatch, yondx.nle.robust, "self_nlf_robust", selfs)
    record(monkeypatch, yondx.nle.robust, "collab_nlf_robust", collabs)
    argv = ["--cpu", "--scenes", "voronoi_mid"]
    load_jax_script(monkeypatch, tmp_path, "probe_iter_policy", argv,
                    cut=CUT).main()
    pattern = r"(voronoi_mid|policy )"
    want = printed(capsys.readouterr().out, pattern)
    got = policy.run(policy.build_parser().parse_args(argv),
                     scenes=cut_scenes("v1", ["voronoi_mid"], *CUT))
    lines = printed(capsys.readouterr().out, pattern)
    assert [layout(x) for x in lines] == [layout(x) for x in want]
    row = got["rows"]["voronoi_mid"]
    # JAX's order: it0, the row's noisy, then each policy
    np.testing.assert_allclose(
        [row["it0"], row["noisy"], *(row[t] for t in policy.POLICIES)],
        psnrs, atol=0.01, rtol=0)
    np.testing.assert_allclose([row["self"], row["collab_reg"]],
                               [selfs[0], collabs[0]], rtol=1e-3)
    agree = float(want[0].split("agree=")[1].split()[0])
    assert abs(row["agree"] - agree) <= 2e-3 * (1 + abs(agree)) + 5e-4
    for tag, line in zip(policy.POLICIES, want[1:]):
        d = float(line.split("all=")[1].split()[0])
        s = got["summary"][tag]
        assert abs(s["all"] - d) <= 0.0105, tag
        if abs(d) > 0.02:
            assert np.sign(s["all"]) == np.sign(d), tag
        assert s["all"] == s["mid"] == s["min"], tag


def test_probe_droop_matches_jax(monkeypatch, tmp_path, capsys):
    psnrs, selfs, collabs, fits, mads = [], [], [], [], []
    record(monkeypatch, yondx.eval.metrics, "psnr", psnrs)
    record(monkeypatch, yondx.nle.robust, "self_nlf_robust", selfs)
    record(monkeypatch, yondx.nle.robust, "collab_nlf_robust", collabs)
    record(monkeypatch, yondx.nle.nlf, "collab_nlf", fits)
    record(monkeypatch, yondx.nle.robust, "mad_collab_estimate", mads)
    argv = ["--cpu", "--scenes", "zone_mid"]
    load_jax_script(monkeypatch, tmp_path, "probe_droop", argv,
                    cut=CUT).main()
    pattern = r"(== |   collab |   it1)"
    want = printed(capsys.readouterr().out, pattern)
    assert droop.build_parser().parse_args([]).scenes == ["radial_mid"]
    got = droop.run(droop.build_parser().parse_args(argv),
                    scenes=cut_scenes("v1", ["zone_mid"], *CUT))
    lines = printed(capsys.readouterr().out, pattern)
    assert [layout(x) for x in lines] == [layout(x) for x in want]
    row = got["zone_mid"]
    # JAX's order: the noisy PSNR, it0, then each round-1 source
    np.testing.assert_allclose(
        [row["noisy"], row["it0"], *(c["psnr"] for c in row["it1"].values())],
        psnrs, atol=0.01, rtol=0)
    assert list(row["it1"]) == ["collab", "true", "self"]
    # the robust collab estimate calls the MAD estimate first itself
    np.testing.assert_allclose(
        [row["comb"], row["fit"], row["mad"], row["self"]],
        [collabs[0], fits[0], mads[-1], selfs[0]], rtol=1e-3)
