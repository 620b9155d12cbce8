"""The port's under-estimate probes against the JAX scripts they port,
loaded from their files, on the CPU (fp32):

- yondx_torch/cli/probe_underest_scene.py against
  scripts/probe_underest_scene.py: the four darkfields (numpy-built, the
  same in both) through the self estimator; the fit, MAD and combined
  (beta1, beta2) at rtol 1e-3 (the robust self NLE's parity bound,
  tests/test_torch_engine.py; JAX's values read at full precision by
  wrapping its self_estimate) for beta1, and for beta2 within 1e-3 of
  the variance the pair gives at the frame's mean, beta1 mu + beta2 (the
  v_est the row prints): darkfield08's fit has beta2 = -8.7e-6, 1% of
  that variance, and the flat mask turns on the moments' last bits
  (the port's fit on JAX's moments is JAX's to 1e-7; the two moment
  fields differ by 1.5e-7), so rtol 1e-3 on beta2 alone would ask 1e-5
  of it; v_est / v_true at rtol 1e-3;
- yondx_torch/cli/probe_underest_e2e.py against
  scripts/probe_underest_e2e.py: the engine on the four darkclip scenes
  with the gru32 flagship in fp32 on both sides (the scripts' bf16 is
  the card's setting): noisy / it0 / it1 PSNR within 0.01 dB (JAX's
  psnr wrapped), the self and collab regs at rtol 1e-3 (JAX's
  iter_denoise wrapped), whether the rescue fired equal.
Each port prints its script's rows in the script's layout (the e2e rows
add whether the rescue fired at the end).
"""
import numpy as np
import pytest
import torch

import yondx.eval
import yondx.models
from yondx.pipeline import YONDEngine as JYONDEngine

from yondx_torch.cli import probe_underest_e2e as e2e
from yondx_torch.cli import probe_underest_scene as scene
from torch_test_util import _one_torch_thread  # noqa: F401
from torch_test_util import layout, load_jax_script, printed, record


def test_probe_underest_scene_matches_jax(monkeypatch, tmp_path, capsys):
    mod = load_jax_script(monkeypatch, tmp_path, "probe_underest_scene", [])
    ests = []
    record(monkeypatch, mod, "self_estimate", ests)
    mod.main()
    want = printed(capsys.readouterr().out, r"darkfield")
    got = scene.main(["--cpu"])
    lines = printed(capsys.readouterr().out, r"darkfield")
    assert [layout(x) for x in lines] == [layout(x) for x in want]
    assert list(got) == [c[0] for c in scene.CASES] and len(ests) == 4
    for (name, row), est, line, (_, _, _, noisy) in zip(
            got.items(), ests, want, scene.scenes()):
        assert line.startswith(name)
        g = np.array([row["fit"], row["mad"], row["comb"]])
        mu = float(np.mean(np.clip(noisy, 0, 1)))
        np.testing.assert_allclose(g[:, 0], est[:, 0], rtol=1e-3,
                                   err_msg=name)
        v = np.abs(est[:, 0] * mu + est[:, 1])
        assert (np.abs(g[:, 1] - est[:, 1]) <= 1e-3 * v).all(), (name, g,
                                                                 est)
        ratio = float(line.rsplit("=", 1)[1])
        assert row["ratio"] == pytest.approx(ratio, rel=1e-3, abs=5e-4)


def test_probe_underest_e2e_matches_jax(monkeypatch, tmp_path, capsys):
    build = yondx.models.build_model
    monkeypatch.setattr(yondx.models, "build_model",
                        lambda arch, dtype=None, **k: build(arch, **k))
    psnrs, results = [], []
    record(monkeypatch, yondx.eval, "psnr", psnrs)
    real = JYONDEngine.iter_denoise

    def iter_denoise(self, *a, **k):
        res = real(self, *a, **k)
        results.append(res)
        return res

    monkeypatch.setattr(JYONDEngine, "iter_denoise", iter_denoise)
    mod = load_jax_script(monkeypatch, tmp_path, "probe_underest_e2e", [])
    mod.main()
    want = printed(capsys.readouterr().out, r"darkclip")
    eng = e2e.build_engine("cpu", torch.float32)
    got = e2e.run(e2e.build_parser().parse_args(["--cpu"]), engine=eng)
    lines = printed(capsys.readouterr().out, r"darkclip")
    assert [layout(x.rsplit(" rescue=", 1)[0]) for x in lines] == \
        [layout(x) for x in want]
    assert list(got) == [c[0] for c in e2e.CASES] and len(results) == 4
    psnrs = np.reshape(psnrs, (4, 3))
    for (name, row), p, res in zip(got.items(), psnrs, results):
        np.testing.assert_allclose([row["noisy"], row["it0"], row["it1"]], p,
                                   atol=0.01, rtol=0, err_msg=name)
        np.testing.assert_allclose([row["self"], row["collab"]],
                                   [res["regs"][0], res["regs"][-1]],
                                   rtol=1e-3, err_msg=name)
        assert row["fired"] == res["signals"][0]["fired"], name
