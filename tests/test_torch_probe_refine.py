"""The port's guidance, refine and tail probes against the JAX scripts they
port, loaded from their files, on the CPU (fp32), with the committed
checkpoints; each on one held-out scene cut to one crop of 256 px. PSNRs
are JAX's at full precision (its psnr wrapped); values the scripts only
print are held within their print's half step plus the stated bound.

- yondx_torch/cli/probe_sigma_corr.py against scripts/probe_sigma_corr.py
  (ramp_mid, three corrs, the gru32 flagship): each PSNR within 0.01 dB,
  the best corr and the median equal;
- yondx_torch/cli/probe_alpha_boost.py against
  scripts/probe_alpha_boost.py (satdisk_mid): the PSNR under each alpha
  transform within 0.01 dB; alpha's quantiles and the fraction over 0.5
  within 1e-3 (alpha follows the self estimate, held at rtol 1e-3);
- yondx_torch/cli/probe_s2d_phase.py against scripts/probe_s2d_phase.py
  (ramp_mid, the gru32 flagship and the GRUS2D3 net): each net's PSNR
  within 0.01 dB, the grafted PSNR within 0.01 dB, each phase mean within
  1e-6 (a mean of errors that differ by ~1e-7), the low and grid MSEs
  and the grid share at rtol 1e-3.
Each port prints its script's rows in the script's layout.
"""
import numpy as np

import yondx.eval.metrics

from yondx_torch.cli import probe_alpha_boost as alpha
from yondx_torch.cli import probe_s2d_phase as s2d
from yondx_torch.cli import probe_sigma_corr as corr
from torch_test_util import _one_torch_thread  # noqa: F401
from torch_test_util import (_NUM, cut_scenes, layout, load_jax_script,
                             printed, record)

CUT = (256, 1)


def _nums(text):
    return [float(v) for v in _NUM.findall(text)]


def test_probe_sigma_corr_matches_jax(monkeypatch, tmp_path, capsys):
    psnrs = []
    record(monkeypatch, yondx.eval.metrics, "psnr", psnrs)
    argv = ["--cpu", "--scenes", "ramp_mid", "--corrs", "0.95", "1.03",
            "1.15"]
    load_jax_script(monkeypatch, tmp_path, "probe_sigma_corr", argv,
                    cut=CUT).main()
    pattern = r"(scene|ramp_mid|median)"
    want = printed(capsys.readouterr().out, pattern)
    got = corr.run(corr.build_parser().parse_args(argv),
                   scenes=cut_scenes("v2", ["ramp_mid"], *CUT))
    lines = printed(capsys.readouterr().out, pattern)
    assert lines[0] == want[0]
    assert [layout(x) for x in lines] == [layout(x) for x in want]
    np.testing.assert_allclose(got["rows"]["ramp_mid"], psnrs, atol=0.01,
                               rtol=0)
    assert got["best"]["ramp_mid"] == float(want[1].rsplit("=", 1)[1])
    assert got["median_best"] == float(want[2].rsplit(" ", 1)[1])
    assert corr.build_parser().parse_args([]).corrs == corr.CORRS


def test_probe_alpha_boost_matches_jax(monkeypatch, tmp_path, capsys):
    psnrs = []
    record(monkeypatch, yondx.eval.metrics, "psnr", psnrs)
    argv = ["--cpu", "--scenes", "satdisk_mid"]
    load_jax_script(monkeypatch, tmp_path, "probe_alpha_boost", argv,
                    cut=CUT).main()
    pattern = r"(== |   \S)"
    want = printed(capsys.readouterr().out, pattern)
    got = alpha.run(alpha.build_parser().parse_args(argv),
                    scenes=cut_scenes("v2", ["satdisk_mid"], *CUT))
    lines = printed(capsys.readouterr().out, pattern)
    assert [layout(x) for x in lines] == [layout(x) for x in want]
    row = got["satdisk_mid"]
    assert list(row["psnr"]) == [t for t, _ in alpha.TRANSFORMS]
    np.testing.assert_allclose(list(row["psnr"].values()), psnrs, atol=0.01,
                               rtol=0)
    q = [float(v) for v in
         want[0].split("q50/90/99 = ")[1].split()[0].split("/")]
    frac = float(want[0].rsplit("= ", 1)[1])
    np.testing.assert_allclose([row["q50"], row["q90"], row["q99"],
                                row["frac_hi"]], q + [frac], atol=1.5e-3,
                               rtol=0)


def test_probe_s2d_phase_matches_jax(monkeypatch, tmp_path, capsys):
    psnrs = []
    record(monkeypatch, yondx.eval.metrics, "psnr", psnrs)
    argv = ["--cpu", "--scenes", "ramp_mid"]
    load_jax_script(monkeypatch, tmp_path, "probe_s2d_phase", argv,
                    cut=CUT).main()
    pattern = r"(== |  \S)"
    want = printed(capsys.readouterr().out, pattern)
    got = s2d.run(s2d.build_parser().parse_args(argv),
                  scenes=cut_scenes("v1", ["ramp_mid"], *CUT, key=1))
    lines = printed(capsys.readouterr().out, pattern)
    assert [layout(x) for x in lines] == [layout(x) for x in want]
    row = got["ramp_mid"]
    # JAX's order: the noisy PSNR, then each net's
    np.testing.assert_allclose(
        [row["noisy"], row["flag"]["psnr"], row["s2d"]["psnr"]], psnrs,
        atol=0.01, rtol=0)
    for tag, line in zip(("flag", "s2d"), want[1:3]):
        vals = _nums(line.split("phase_means=")[1])
        r = row[tag]
        m = np.array(vals[:4])
        assert (np.abs(np.array(r["phase_means"]) - m)
                <= 1e-6 + 5e-3 * np.abs(m)).all(), (tag, r["phase_means"], m)
        np.testing.assert_allclose([r["low_mse"], r["grid_mse"]], vals[4:6],
                                   rtol=1e-3 + 5e-4, err_msg=tag)
        assert abs(r["grid_share"] - vals[6]) <= 5e-3 + 1e-3, tag
    graft = float(want[3].split("psnr=")[1].split()[0])
    assert abs(row["s2d_flag_grid"] - graft) <= 0.01 + 5e-3
